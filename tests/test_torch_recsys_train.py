"""Port conformance of recsys training: the row gradient of EmbeddingBag
(``kernels/embedding_bag``: ``embedding_bag_padded_bwd_ref``, the autograd
Functions behind ``embedding_bag`` and ``take_rows``), ``sgd_rows_``, and the
cells of ``repro_torch.configs.base.build_recsys_cell`` against the JAX
package's ``repro.configs.base.build_recsys_cell`` on the same seeded numpy
inputs.

Tolerances, and why:
- f32 gradients: 1e-5 relative and absolute. The port sums a row's terms in
  ascending (b, f) order in f32; XLA's scatter-add and einsum transposes sum
  in an order of their own.
- bf16 gradients: JAX's gradient of a bf16 table is bf16 and XLA rounds
  each partial sum of a row to bf16; the port sums in f32 and rounds once.
  So the port is held (a) against JAX's f32 gradient of the same bf16
  values within that one rounding (rtol 2⁻⁸, atol 1e-6), and (b) against
  JAX's bf16 gradient within the n roundings of a row's n terms: atol
  n·2⁻⁸·max|g| (measured on these inputs: JAX off the f32 gradient by up to
  1.35 at |g| ≤ 44 with 64 terms a row; the port by up to 0.11, half an
  ulp).
- The train cell, 5 steps, f32 tables: rtol 1e-5, atol 1e-6 (measured:
  at most 2.5e-7 apart, xdeepfm's cin_w0). bf16 tables: rtol 2⁻⁷ (one bf16
  ulp), atol 1e-4: a touched row's bf16 gradient can differ from JAX's in
  its last bit (see above), its SGD update then by one bf16 ulp, and the
  dense parameters downstream of it drift (measured: xdeepfm 6 table
  entries one ulp apart, cin_w0 2.1e-5, the loss 3.6e-5; the other archs
  within 2e-6).
- The loss curve of 25 AdamW steps: the JAX test's setting, rtol 1e-4.

The card case (marker ``kernels``, skipped without a card, no jax) holds
the CUDA gradient kernel against the plain version bit for bit.
"""
import functools

import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread as _one_torch_thread  # noqa: F401  (autouse)
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.configs import recsys_archs as tra
from repro_torch.kernels.embedding_bag import ops
from repro_torch.kernels.embedding_bag.ref import embedding_bag_padded_bwd_ref
from repro_torch.models import recsys as trec

pytestmark = pytest.mark.port

TOL = dict(rtol=1e-5, atol=1e-5)
ONE_BF16_ROUNDING = dict(rtol=2 ** -8, atol=1e-6)
CELL_TOL = dict(rtol=1e-5, atol=1e-6)
CELL_BF16_TOL = dict(rtol=2 ** -7, atol=1e-4)
ARCHS = ["dlrm-mlperf", "xdeepfm", "din", "autoint"]
B = 64
FORWARDS = {"dlrm-mlperf": "dlrm_forward", "xdeepfm": "xdeepfm_forward",
            "din": "din_forward", "autoint": "autoint_forward"}
FLOPS = {"dlrm-mlperf": "_dlrm_flops", "xdeepfm": "_xdeepfm_flops", "din": "_din_flops",
         "autoint": "_autoint_flops"}


@pytest.fixture(scope="module")
def jax_side():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import base as jbase
    from repro.configs import recsys_archs as jra
    from repro.kernels.embedding_bag import ref as jref
    from repro.models import recsys as jrec
    return dict(jax=jax, jnp=jnp, jbase=jbase, jra=jra, jref=jref, jrec=jrec)


def _f32(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x, np.float32)


def _np32(jnp, x):
    return np.asarray(x.astype(jnp.float32))


def _check_bf16_grad(got, expect_bf16, expect_f32, ids):
    """(a) one rounding off the f32 gradient, (b) within XLA's n bf16
    roundings of JAX's bf16 gradient (n: the most items of one row)."""
    np.testing.assert_allclose(got, expect_f32, **ONE_BF16_ROUNDING)
    n = int(np.bincount(np.asarray(ids).reshape(-1)).max())
    np.testing.assert_allclose(got, expect_bf16, rtol=0,
                               atol=n * 2 ** -8 * float(np.abs(expect_f32).max()))


def _dense(rows, row_grad, V):
    out = np.zeros((V,) + tuple(row_grad.shape[1:]), np.float32)
    out[rows.numpy()] = _f32(row_grad)
    return out


# ------------------------------------------------------------ the row gradient
def _bag_inputs(B_, F, V, D, dup, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, dup, (B_, F)).astype(np.int32) if dup else \
        rng.integers(0, V, (B_, F)).astype(np.int32)
    w = rng.uniform(0.1, 2, (B_, F)).astype(np.float32)
    w[::3, -1] = 0.0                                 # zero-weight padding
    g = rng.normal(size=(B_, D)).astype(np.float32)
    return ids, w, g


BWD_CASES = [(9, 4, 50, 8, 0), (16, 1, 30, 16, 3), (7, 5, 40, 10, 1), (33, 3, 1000, 128, 0),
             (12, 26, 64, 18, 5), (5, 2, 10, 1, 2)]


@pytest.mark.parametrize("weighted", [False, True], ids=["ones", "weighted"])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Bb,F,V,D,dup", BWD_CASES)
def test_bwd_ref_matches_jax_grad_of_padded_ref(jax_side, Bb, F, V, D, dup, dtype, combiner,
                                               weighted):
    """``jax.vjp`` of the JAX padded ref with respect to the table, against
    the plain row gradient scattered into a dense [V, D] (the untouched rows
    0 on both sides). ``dup`` > 0 draws every id from [0, dup): heavy
    repetition (1: all ids equal)."""
    jax, jnp, jref = jax_side["jax"], jax_side["jnp"], jax_side["jref"]
    ids, w, g = _bag_inputs(Bb, F, V, D, dup, seed=Bb * 31 + F + D)
    w = w if weighted else None
    table = np.random.default_rng(1).normal(size=(V, D)).astype(np.float32)
    jdt = getattr(jnp, dtype)

    def jax_grad(dt):
        _, vjp = jax.vjp(lambda t: jref.embedding_bag_padded_ref(
            t, jnp.asarray(ids), None if w is None else jnp.asarray(w), combiner),
            jnp.asarray(table).astype(dt))
        return _np32(jnp, vjp(jnp.asarray(g).astype(jdt).astype(dt))[0])

    expect = jax_grad(jdt)
    tg = torch.from_numpy(g).to(getattr(torch, dtype))
    rows, row_grad = embedding_bag_padded_bwd_ref(
        tg, torch.from_numpy(ids), None if w is None else torch.from_numpy(w), combiner, V)
    assert rows.dtype == torch.int64 and row_grad.dtype == torch.float32
    assert torch.equal(rows, torch.unique(torch.from_numpy(ids).long()))
    got = _dense(rows, row_grad, V)
    if dtype == "float32":
        np.testing.assert_allclose(got, expect, **TOL)
    else:
        _check_bf16_grad(_dense(rows, row_grad.to(torch.bfloat16), V), expect,
                         jax_grad(jnp.float32), ids)


@pytest.mark.parametrize("padding", [False, True], ids=["", "padding"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dup", [0, 1, 4])
def test_bwd_ref_matches_jax_grad_of_take(jax_side, dtype, dup, padding):
    """The transpose of ``jnp.take`` (XLA's scatter-add) against the plain
    row gradient with every id a bag of one, and ``take_rows``' sparse
    gradient against both. With padding, a third of the ids are −1: JAX
    takes row 0 there under a cotangent masked to 0 (DIN's clamp and mask);
    the port reads row 0 too and leaves those ids out of the gradient
    whatever their cotangent."""
    jax, jnp = jax_side["jax"], jax_side["jnp"]
    V, D = 60, 12
    ids, _, _ = _bag_inputs(20, 7, V, D, dup, seed=dup + 5)
    g = np.random.default_rng(dup).normal(size=(20, 7, D)).astype(np.float32)
    if padding:
        ids[np.random.default_rng(dup + 1).random(ids.shape) < 1 / 3] = -1
    valid = (ids >= 0)[..., None]
    table = np.random.default_rng(2).normal(size=(V, D)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def jax_grad(dt):
        _, vjp = jax.vjp(lambda t: jnp.take(t, jnp.asarray(np.maximum(ids, 0)), axis=0),
                         jnp.asarray(table).astype(dt))
        return _np32(jnp, vjp(jnp.asarray(g * valid).astype(jdt).astype(dt))[0])

    rows, row_grad = embedding_bag_padded_bwd_ref(
        torch.from_numpy(g.reshape(-1, D)).to(tdt), torch.from_numpy(ids.reshape(-1, 1)),
        None, "sum", V)
    assert bool((rows >= 0).all())
    got = _dense(rows, row_grad.to(tdt), V)
    if dtype == "float32":
        np.testing.assert_allclose(got, jax_grad(jdt), **TOL)
    else:
        _check_bf16_grad(got, jax_grad(jdt), jax_grad(jnp.float32), np.maximum(ids, 0))
    t = torch.from_numpy(table).to(tdt).requires_grad_(True)
    out = ops.take_rows(t, torch.from_numpy(ids))
    assert out.shape == (20, 7, D)
    assert torch.equal(out.detach(), t.detach()[np.maximum(ids, 0)])
    (sg,) = torch.autograd.grad(out, [t], torch.from_numpy(g).to(tdt))
    assert sg.is_sparse and sg.is_coalesced() and sg.dtype == tdt
    np.testing.assert_array_equal(sg.to_dense().float().numpy(),
                                  _dense(rows, row_grad.to(tdt), V))
    if padding:
        with pytest.raises(IndexError, match="-1"):
            embedding_bag_padded_bwd_ref(torch.ones((2, D)), torch.tensor([[-2], [-1]]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_embedding_bag_function_gradient(dtype, combiner):
    """``embedding_bag`` under autograd: the forward is the plain bag, the
    table's gradient the row gradient as a coalesced sparse tensor of the
    table's shape and dtype; asking for the weights' gradient raises."""
    ids, w, g = _bag_inputs(11, 4, 40, 16, 6, seed=3)
    tdt = getattr(torch, dtype)
    table = torch.from_numpy(np.random.default_rng(4).normal(size=(40, 16)).astype(
        np.float32)).to(tdt).requires_grad_(True)
    tw, tid = torch.from_numpy(w), torch.from_numpy(ids)
    out = ops.embedding_bag(table, tid, tw, combiner)
    assert torch.equal(out.detach(), ops.embedding_bag(table.detach(), tid, tw, combiner))
    (sg,) = torch.autograd.grad(out, [table], torch.from_numpy(g).to(tdt))
    assert sg.is_sparse and sg.is_coalesced() and sg.dtype == tdt and sg.shape == (40, 16)
    rows, row_grad = embedding_bag_padded_bwd_ref(torch.from_numpy(g).to(tdt), tid, tw,
                                                  combiner, 40)
    assert torch.equal(sg.indices()[0], rows)
    assert torch.equal(sg.values(), row_grad.to(tdt))
    tw.requires_grad_(True)
    out = ops.embedding_bag(table, tid, tw, combiner)
    with pytest.raises(NotImplementedError, match="per-sample weights"):
        torch.autograd.grad(out.sum(), [table, tw])


def test_bwd_ref_checks_rows_and_counts_no_launch():
    before = ops.bwd_launches
    ids = torch.tensor([[0, 5]], dtype=torch.int32)
    g = torch.ones((1, 3))
    rows, row_grad = ops.embedding_bag_bwd(g, ids, None, "sum", 6)
    assert rows.tolist() == [0, 5] and torch.equal(row_grad, torch.ones((2, 3)))
    assert ops.bwd_launches == before
    with pytest.raises(IndexError):
        embedding_bag_padded_bwd_ref(g, ids, None, "sum", 5)


@pytest.mark.parametrize("kind", ["empty", "all padding", "no padding", "mixed"])
def test_row_runs_groups_ids_with_padding_in_no_run(kind):
    """``row_runs`` against a plain grouping: the distinct ids ≥ 0 ascending,
    each run of ``order`` the items of one id in ascending position, the
    padding (−1) items before the first run."""
    from repro_torch.kernels.embedding_bag.ref import row_runs
    rng = np.random.default_rng(12)
    ids = {"empty": np.zeros((0, 3)), "all padding": np.full((4, 3), -1),
           "no padding": rng.integers(0, 5, (6, 3)),
           "mixed": np.where(rng.random((6, 3)) < 0.4, -1, rng.integers(0, 5, (6, 3)))}[kind]
    flat = ids.reshape(-1)
    order, rows, starts = row_runs(torch.from_numpy(ids.astype(np.int32)))
    expect = np.unique(flat[flat >= 0])
    assert rows.dtype == order.dtype == starts.dtype == torch.int64
    assert rows.tolist() == expect.tolist() and order.numel() == flat.size
    assert starts.tolist()[0] == int((flat < 0).sum()) and starts.tolist()[-1] == flat.size
    for u, r in enumerate(expect):
        run = order[starts[u]:starts[u + 1]].tolist()
        assert run == np.flatnonzero(flat == r).tolist()


# ------------------------------------------------------------ the SGD row update
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sgd_rows_equals_jax_dense_update(jax_side, dtype):
    """``sgd_rows_`` against JAX's ``tab_p - 0.01 * tab_g`` on the dense
    gradient, bit for bit (the same gradient on both sides); the untouched
    rows are unchanged bit for bit."""
    jnp = jax_side["jnp"]
    rng = np.random.default_rng(9)
    V, D = 50, 6
    p = rng.normal(size=(V, D)).astype(np.float32)
    rows = np.sort(rng.choice(V, 17, replace=False))
    vals = rng.normal(size=(17, D)).astype(np.float32) * 3
    dense = np.zeros((V, D), np.float32)
    dense[rows] = vals
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp, jg = jnp.asarray(p).astype(jdt), jnp.asarray(dense).astype(jdt)
    expect = _np32(jnp, jp - 0.01 * jg)
    tp = torch.from_numpy(p).to(tdt)
    before = tp.clone()
    grad = torch.sparse_coo_tensor(torch.from_numpy(rows)[None], torch.from_numpy(vals).to(tdt),
                                   (V, D), is_coalesced=True)
    trec.sgd_rows_(tp, grad, 0.01)
    np.testing.assert_array_equal(tp.float().numpy(), expect)
    untouched = np.setdiff1d(np.arange(V), rows)
    assert torch.equal(tp[untouched], before[untouched])
    lin = torch.from_numpy(p[:, 0].copy())                    # a 1-D table (linear_w)
    g1 = torch.sparse_coo_tensor(torch.from_numpy(rows)[None], torch.from_numpy(vals[:, 0]),
                                 (V,), is_coalesced=True)
    trec.sgd_rows_(lin, g1, 0.01)
    np.testing.assert_array_equal(lin.numpy(), np.asarray(jnp.asarray(p[:, 0])
                                                          - 0.01 * jnp.asarray(dense[:, 0])))
    uncoalesced = torch.sparse_coo_tensor(torch.tensor([[1, 1]]), torch.ones(2), (V,))
    with pytest.raises(TypeError, match="coalesced"):
        trec.sgd_rows_(lin, uncoalesced, 0.01)


# ------------------------------------------------------------ the cells
def _inputs(arch, cfg, seed=0, n=B):
    """Seeded numpy inputs of ``arch``'s forward (DIN history −1-padded)."""
    rng = np.random.default_rng(seed)
    if arch == "din":
        hist = rng.integers(0, cfg.n_items, (n, cfg.seq_len)).astype(np.int32)
        hist[rng.random((n, cfg.seq_len)) < 0.3] = -1
        return (rng.integers(0, cfg.n_items, n).astype(np.int32), hist,
                rng.integers(0, cfg.context_vocab, (n, cfg.n_context)).astype(np.int32))
    sizes = np.array(cfg.embedding.vocab_sizes)
    ids = (rng.random((n, len(sizes))) * sizes).astype(np.int32)
    if arch == "dlrm-mlperf":
        return rng.normal(size=(n, cfg.n_dense)).astype(np.float32), ids
    return (ids,)


def _cells(js, arch, shape="train_batch"):
    """(JAX cell on a one-device CPU mesh, port cell with no layout) of
    ``small_recsys()[arch]``."""
    jax, jbase, jra, jrec = js["jax"], js["jbase"], js["jra"], js["jrec"]
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    jcfg, tcfg = jra.small_recsys()[arch], tra.small_recsys()[arch]
    if arch in ("dlrm-mlperf", "din"):
        jmaker = jra._dlrm_inputs if arch == "dlrm-mlperf" else jra._din_inputs
    else:
        jmaker = jra._sparse_inputs(tcfg.embedding.n_fields)
    jcell = jbase.build_recsys_cell(jcfg, getattr(jrec, FORWARDS[arch]), jmaker,
                                    getattr(jra, FLOPS[arch]), shape, mesh, False)
    tcell = tbase.build_recsys_cell(tcfg, getattr(trec, FORWARDS[arch]), None,
                                    getattr(tra, FLOPS[arch]), shape, None)
    return jcell, tcell


def _start(js, arch, table_dtype, seed=3):
    """The same parameters and AdamW state (dense parameters only) on both
    sides: (JAX params, JAX state, port params, port state)."""
    jax, jnp, jrec, jbase = js["jax"], js["jnp"], js["jrec"], js["jbase"]
    cfg = js["jra"].small_recsys()[arch]
    raw = {k: np.asarray(v) for k, v in jrec.init_params(cfg, jax.random.key(seed)).items()}
    bf16 = table_dtype == "bfloat16"
    jp = {k: jnp.asarray(v).astype(jnp.bfloat16 if bf16 and k.endswith("table")
                                   else jnp.float32) for k, v in raw.items()}
    _, dense = jbase._split_table_params(jp)
    jstate = {"step": jnp.zeros((), jnp.int32),
              "m": {k: jnp.zeros_like(v) for k, v in dense.items()},
              "v": {k: jnp.zeros_like(v) for k, v in dense.items()}}
    tp = convert.recsys_params_from_numpy(raw, "cpu", getattr(torch, table_dtype))
    tstate = convert.adamw_state_from_numpy(
        {"step": 0, "m": {k: np.zeros_like(raw[k]) for k in dense},
         "v": {k: np.zeros_like(raw[k]) for k in dense}}, "cpu")
    return jp, jstate, tp, tstate


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_cell_matches_jax(jax_side, arch, table_dtype):
    """5 steps of the train cell from the same params, state, labels and
    inputs: every loss, parameter and AdamW moment."""
    jax, jnp = jax_side["jax"], jax_side["jnp"]
    jcell, tcell = _cells(jax_side, arch)
    assert tcell.step_kind == jcell.step_kind == "train" and tcell.donate == jcell.donate
    jp, js, tp, ts = _start(jax_side, arch, table_dtype)
    args = _inputs(arch, tra.small_recsys()[arch])
    labels = np.random.default_rng(1).integers(0, 2, B).astype(np.float32)
    jfn = jax.jit(jcell.fn)
    jin = [jnp.asarray(a) for a in args]
    tin = [torch.from_numpy(a) for a in args]
    tol = CELL_TOL if table_dtype == "float32" else CELL_BF16_TOL
    for _ in range(5):
        jp, js, jl = jfn(jp, js, jnp.asarray(labels), *jin)
        tp, ts, tl = tcell.fn(tp, ts, torch.from_numpy(labels), *tin)
        np.testing.assert_allclose(float(tl), float(jl), **tol)
    assert int(ts["step"]) == int(js["step"]) == 5
    assert set(tp) == set(jp)
    for k in jp:
        assert tp[k].dtype == getattr(torch, str(jp[k].dtype))
        np.testing.assert_allclose(_f32(tp[k]), _np32(jnp, jp[k]), **tol, err_msg=k)
    for part in ("m", "v"):
        for k in js[part]:
            np.testing.assert_allclose(_f32(ts[part][k]), _np32(jnp, js[part][k]), **tol,
                                       err_msg=f"{part}/{k}")


@pytest.mark.parametrize("arch", ARCHS)
def test_untouched_rows_are_bitwise_after_a_step(jax_side, arch):
    """After a train step, every table row the batch does not read is
    unchanged bit for bit (bf16 tables), and the touched rows moved."""
    jp, js, tp, ts = _start(jax_side, arch, "bfloat16")
    _, tcell = _cells(jax_side, arch)
    args = [torch.from_numpy(a) for a in _inputs(arch, tra.small_recsys()[arch], n=8)]
    labels = torch.ones(8)
    before = {k: v.clone() for k, v in tp.items()}
    cfg = tra.small_recsys()[arch]
    if arch == "din":
        target, hist, ctx = args
        touched = {"item_table": torch.cat([target, hist.clamp_min(0).reshape(-1)]),
                   "ctx_table": (ctx + torch.arange(cfg.n_context, dtype=torch.int32)
                                 * cfg.context_vocab).reshape(-1)}
    else:
        flat = (args[-1] + torch.from_numpy(cfg.embedding.offsets)).reshape(-1)
        touched = {"table": flat}
        if arch == "xdeepfm":
            touched["linear_w"] = flat
    new, _, _ = tcell.fn(tp, ts, labels, *args)
    for k, ids in touched.items():
        assert new[k] is tp[k]                               # updated in place
        hit = torch.zeros(new[k].shape[0], dtype=torch.bool)
        hit[ids.long()] = True
        assert torch.equal(new[k][~hit], before[k][~hit]), k
        assert not torch.equal(new[k][hit], before[k][hit]), k


@pytest.mark.parametrize("arch", ARCHS)
def test_recsys_train_step_decreases_loss(jax_side, arch):
    """Mirror of ``tests/test_models_gnn_recsys.py::
    test_recsys_train_step_decreases_loss``: 25 AdamW steps (lr 5e-3, no
    decay) on every parameter, tables included (their sparse row gradients
    made dense), at B = 64 from the same parameters and batch: the loss
    falls and follows JAX's curve within rtol 1e-4."""
    jax, jnp, jrec = jax_side["jax"], jax_side["jnp"], jax_side["jrec"]
    from repro.optim.adamw import AdamW as JAdamW
    from repro_torch.optim.adamw import AdamW as TAdamW
    cfg, tcfg = jax_side["jra"].small_recsys()[arch], tra.small_recsys()[arch]
    raw = {k: np.asarray(v) for k, v in jrec.init_params(cfg, jax.random.key(2)).items()}
    args = _inputs(arch, tcfg, seed=4)
    labels = np.random.default_rng(5).integers(0, 2, B).astype(np.float32)
    jfwd, tfwd = getattr(jrec, FORWARDS[arch]), getattr(trec, FORWARDS[arch])
    jopt, topt = JAdamW(lr=5e-3, weight_decay=0.0), TAdamW(lr=5e-3, weight_decay=0.0)
    jp = {k: jnp.asarray(v) for k, v in raw.items()}
    jo = jopt.init(jp)
    jin = [jnp.asarray(a) for a in args]

    @jax.jit
    def step(p, o):
        loss, g = jax.value_and_grad(
            lambda pp: jrec.bce_loss(jfwd(cfg, pp, *jin), jnp.asarray(labels)))(p)
        p, o = jopt.update(g, o, p)
        return p, o, loss

    tp = convert.recsys_params_from_numpy(raw, "cpu")
    to = topt.init(tp)
    tin = [torch.from_numpy(a) for a in args]
    jl, tl = [], []
    for _ in range(25):
        jp, jo, loss = step(jp, jo)
        jl.append(float(loss))
        leaves = {k: v.detach().requires_grad_(True) for k, v in tp.items()}
        loss = trec.bce_loss(tfwd(tcfg, leaves, *tin), torch.from_numpy(labels))
        names = sorted(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        grads = {k: g.to_dense() if g.is_sparse else g for k, g in zip(names, grads)}
        tp, to = topt.update(grads, to, tp)
        tl.append(float(loss))
    assert tl[-1] < tl[0] and jl[-1] < jl[0]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


@pytest.mark.parametrize("shape", ["serve_p99", "serve_bulk"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cell_is_the_forward(jax_side, arch, shape):
    """The serve cell's fn is the model's forward (bit for bit) and equals
    JAX's serve cell within the forward tolerance."""
    jnp = jax_side["jnp"]
    jcell, tcell = _cells(jax_side, arch, shape)
    assert tcell.step_kind == "serve" and tcell.model_flops == jcell.model_flops
    jp, _, tp, _ = _start(jax_side, arch, "bfloat16")
    args = _inputs(arch, tra.small_recsys()[arch], seed=6, n=24)
    tin = [torch.from_numpy(a) for a in args]
    out = tcell.fn(tp, *tin)
    assert torch.equal(out, getattr(trec, FORWARDS[arch])(tra.small_recsys()[arch], tp, *tin))
    np.testing.assert_allclose(out.numpy(), np.asarray(jcell.fn(jp, *map(jnp.asarray, args))),
                               **TOL)


def test_retrieval_cell_is_retrieval_scores(jax_side):
    jnp = jax_side["jnp"]
    jcell, tcell = _cells(jax_side, "autoint", "retrieval_cand")
    assert tcell.step_kind == "retrieval" and tcell.model_flops == jcell.model_flops
    rng = np.random.default_rng(3)
    q = rng.normal(size=(1, 8)).astype(np.float32)
    cand = rng.normal(size=(3000, 8)).astype(np.float32)
    s, i = tcell.fn(torch.from_numpy(q), torch.from_numpy(cand))
    es, ei = trec.retrieval_scores(torch.from_numpy(q), torch.from_numpy(cand), top_k=100)
    assert torch.equal(s, es) and torch.equal(i, ei)
    js, ji = jcell.fn(jnp.asarray(q), jnp.asarray(cand))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


# ------------------------------------------------------------ full width, no allocation
def _same_structure(t, j, jnp, label):
    if isinstance(j, dict):
        assert isinstance(t, dict) and set(t) == set(j), label
        for k in j:
            _same_structure(t[k], j[k], jnp, f"{label}/{k}")
        return
    assert isinstance(t, torch.Tensor) and t.device.type == "meta", label
    assert tuple(t.shape) == tuple(j.shape), label
    assert str(t.dtype).replace("torch.", "") == str(j.dtype), label


@pytest.mark.parametrize("shape", ["train_batch", "serve_p99", "serve_bulk", "retrieval_cand"])
@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_make_args_match_jax_cell_args(jax_side, arch, shape):
    """``make_args`` on the ``meta`` device against JAX's ``cell.args``
    (ShapeDtypeStructs): the same tree, shapes and dtypes, nothing
    allocated; the analytic FLOPs and collective bytes equal JAX's."""
    jax, jnp = jax_side["jax"], jax_side["jnp"]
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    jcell = jax_side["jra"].specs()[arch].cell(shape, mesh)
    tcell = tra.specs()[arch].cell(shape)
    assert (tcell.arch, tcell.shape, tcell.step_kind) == (jcell.arch, jcell.shape,
                                                          jcell.step_kind)
    assert tcell.model_flops == jcell.model_flops
    assert tcell.model_coll_bytes == jcell.model_coll_bytes
    assert tcell.donate == jcell.donate
    targs = tcell.make_args(torch.Generator(), "meta")
    assert len(targs) == len(jcell.args)
    for i, (t, j) in enumerate(zip(targs, jcell.args)):
        _same_structure(t, j, jnp, f"{arch}/{shape} arg {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_flops_match_jax(jax_side, arch):
    jra = jax_side["jra"]
    for batch in (1, 512, 65_536, 262_144):
        for train in (False, True):
            assert getattr(tra, FLOPS[arch])(batch, train) == getattr(jra, FLOPS[arch])(
                batch, train)


def test_cells_draw_real_inputs_on_the_cpu_when_asked():
    """make_args on the CPU at a small config: tables bf16, the rest f32,
    DIN history −1 after a length in [1, S], the AdamW state zeros of the
    dense parameters only, labels in {0, 1}; the step runs."""
    cfg = tra.small_recsys()["din"]
    cell = tbase.build_recsys_cell(cfg, trec.din_forward,
                                   functools.partial(tra._din_inputs, cfg=cfg),
                                   tra._din_flops, "train_batch")
    g = torch.Generator().manual_seed(0)
    cell_b = dict(tbase.RECSYS_SHAPES["train_batch"])
    params, state, labels, target, hist, ctx = cell.make_args(g, "cpu")
    assert params["item_table"].dtype == torch.bfloat16
    assert params["mlp/w0"].dtype == torch.float32
    assert set(state["m"]) == {k for k in params if not k.endswith("table")}
    assert labels.shape == (cell_b["batch"],) and set(labels.unique().tolist()) <= {0.0, 1.0}
    assert hist.shape == (cell_b["batch"], cfg.seq_len) and int(hist[:, 0].min()) >= 0
    valid = hist >= 0
    assert torch.equal(valid, valid.cummin(dim=1).values)       # −1 only after the history
    assert int(target.max()) < cfg.n_items and int(ctx.max()) < cfg.context_vocab
    n = 256
    _, state2, loss = cell.fn(params, state, labels[:n], target[:n], hist[:n], ctx[:n])
    assert int(state2["step"]) == 1 and bool(torch.isfinite(loss))


def test_cell_entry_points_need_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cell = tra.specs()["autoint"].cell("train_batch")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cell.make_args(torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tra.specs()["din"].cell("serve_p99").make_args(torch.Generator())
    small = tbase.build_recsys_cell(tra.small_recsys()["autoint"], trec.autoint_forward,
                                    tra._sparse_inputs((50,) * 8), tra._autoint_flops,
                                    "serve_p99")
    assert small.make_args(torch.Generator(), "cpu")[1].device.type == "cpu"


def test_layouts_of_more_ranks_are_refused():
    from repro_torch.dist.sharding import RankLayout
    spec = tra.specs()["dlrm-mlperf"]
    assert spec.cell("train_batch", RankLayout(1, 1, 1)).step_kind == "train"
    with pytest.raises(NotImplementedError, match="13c"):
        spec.cell("train_batch", RankLayout(1, 2, 1))


# ------------------------------------------------------------ on the card
@pytest.mark.kernels
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [1, 8, 10, 16, 18, 100, 128])
def test_cuda_bwd_kernel_matches_plain_bitwise(D, dtype):
    """The CUDA row-gradient kernel against the plain version on the card,
    bit for bit, over F, repetition, padding ids (−1), weights and
    combiners; two launches give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator(device="cuda").manual_seed(D)
    tdt = getattr(torch, dtype)
    for F, dup in ((1, 0), (3, 2), (26, 0), (40, 1), (7, 50), (5, -1)):
        Bb = 300
        ids = torch.randint(0, dup if dup > 0 else 100_000, (Bb, F), generator=g,
                            device="cuda", dtype=torch.int32)
        if dup < 0:                                      # padding: a third of the ids −1
            ids[torch.rand((Bb, F), generator=g, device="cuda") < 1 / 3] = -1
        grad = torch.randn((Bb, D), generator=g, device="cuda").to(tdt)
        w = torch.rand((Bb, F), generator=g, device="cuda") + 0.1
        w[::4, -1] = 0.0
        for combiner in ("sum", "mean"):
            for weights in (None, w):
                before = ops.bwd_launches
                rows, got = ops.embedding_bag_bwd(grad, ids, weights, combiner, 100_000)
                torch.cuda.synchronize()
                assert ops.bwd_launches == before + 1
                erows, expect = embedding_bag_padded_bwd_ref(grad, ids, weights, combiner)
                assert torch.equal(rows, erows)
                assert torch.equal(got.view(torch.int32), expect.view(torch.int32))
                _, again = ops.embedding_bag_bwd(grad, ids, weights, combiner, 100_000)
                assert torch.equal(again.view(torch.int32), got.view(torch.int32))
