"""Port conformance of the LM/MoE workload (``repro_torch.models.attention``,
``models.moe``, ``models.transformer``, ``configs.lm_archs``, the LM half
of ``configs.base`` and ``dist.sharding``).

Seeded numpy inputs and JAX's own parameter draws (carried across by
``convert.lm_params_from_numpy``) go through both packages, in f32
(``small_lm``'s dtype; bf16 rounds differently in XLA and torch on the CPU):

- ``rope`` and ``flash_attention`` over JAX's test grid, with gradients;
  ``cached_attention`` / ``decode_attention``: allclose 1e-5 / 1e-4.
- ``moe_ffn`` with capacity drops: the router's expert ids, the keep mask
  and the slots exact, the output and its gradients allclose.
- ``small_lm(moe=False/True)``'s ``forward``, ``lm_loss`` and gradients,
  ``prefill`` and ``serve_step``'s chunked prefill then decode.
- ``param_shapes``, ``n_params``, ``n_active_params``, the cells' formulas
  and every spec equal JAX's for the five archs.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread as _one_torch_thread  # noqa: F401  (autouse)
from repro_torch import convert
from repro_torch.configs import base as tbase, lm_archs as tla
from repro_torch.dist import sharding as tshd
from repro_torch.models import attention as tatt, moe as tmoe, transformer as ttf

pytestmark = pytest.mark.port

RTOL, ATOL = 1e-5, 1e-4
RNG = np.random.default_rng(3)


@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import base as jbase, lm_archs as jla
    from repro.dist import sharding as jshd
    from repro.models import attention as jatt, moe as jmoe, transformer as jtf
    return types.SimpleNamespace(jax=jax, jnp=jnp, base=jbase, la=jla, shd=jshd, att=jatt,
                                 moe=jmoe, tf=jtf)


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


def _normal(*shape):
    return RNG.normal(size=shape).astype(np.float32)


def _tree_close(jt, tt, rtol=RTOL, atol=ATOL, path=""):
    if isinstance(jt, dict):
        assert sorted(jt) == sorted(tt), path
        for k in jt:
            _tree_close(jt[k], tt[k], rtol, atol, f"{path}/{k}")
    else:
        _close(tt, jt, rtol, atol, path)


def _lm_params(J, cfg, seed=0):
    jp = J.tf.init_params(J.la.small_lm(moe=cfg.moe is not None), J.jax.random.key(seed))
    return jp, convert.lm_params_from_numpy(J.jax.tree.map(np.asarray, jp), "cpu")


# --------------------------------------------------------------- attention ---


@pytest.mark.parametrize("S,H,Dh,theta", [(16, 2, 8, 1e4), (40, 3, 64, 1e6), (7, 1, 128, 1e4)])
def test_rope_equals_jax(J, S, H, Dh, theta):
    x = _normal(2, S, H, Dh)
    pos = np.broadcast_to(np.arange(S)[None] + 5, (2, S)).astype(np.int32)
    _close(tatt.rope(torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(pos)), theta),
           J.att.rope(J.jnp.array(x), J.jnp.array(pos), theta), 1e-5, 1e-5)


def test_repeat_kv_equals_jax(J):
    k = _normal(2, 5, 3, 4)
    for n in (1, 3):
        assert np.array_equal(_np(tatt._repeat_kv(torch.from_numpy(k), n)),
                              np.asarray(J.att._repeat_kv(J.jnp.array(k), n)))


# JAX's grid (tests/test_models_lm.py), plus a non-causal case
GRID = [(2, 128, 128, 4, 2, 32, 64, 64, True), (1, 65, 65, 2, 2, 16, 32, 32, True),
        (2, 17, 81, 4, 1, 8, 32, 16, True), (1, 256, 256, 8, 8, 64, 256, 64, True),
        (1, 40, 70, 4, 2, 16, 16, 32, False)]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,Dh,qc,kc,causal", GRID)
def test_flash_attention_with_gradients_equals_jax(J, B, Sq, Sk, H, KV, Dh, qc, kc, causal):
    q, k, v = _normal(B, Sq, H, Dh), _normal(B, Sk, KV, Dh), _normal(B, Sk, KV, Dh)
    up = _normal(B, Sq, H, Dh)

    def jf(q, k, v):
        return (J.att.flash_attention(q, k, v, causal=causal, q_chunk=qc, kv_chunk=kc)
                * up).sum()

    jo = J.att.flash_attention(*(J.jnp.array(a) for a in (q, k, v)), causal=causal,
                               q_chunk=qc, kv_chunk=kc)
    jg = J.jax.grad(jf, argnums=(0, 1, 2))(*(J.jnp.array(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    to = tatt.flash_attention(tq, tk, tv, causal=causal, q_chunk=qc, kv_chunk=kc)
    _close(to, jo, 1e-5, 2e-5)
    tg = torch.autograd.grad((to * torch.from_numpy(up)).sum(), (tq, tk, tv))
    for a, b, name in zip(tg, jg, "qkv"):
        _close(a, b, msg=name)


@pytest.mark.parametrize("C,cache_len,score_bytes", [(1, 20, 1 << 30), (8, 12, 1 << 30),
                                                     (8, 0, 64 * 4 * 4), (5, 31, 1)])
def test_cached_and_decode_attention_equal_jax(J, monkeypatch, C, cache_len, score_bytes):
    """A chunk of C queries against a 40-position cache; ``SCORE_BYTES`` small
    takes the scores in slices of a few query rows (one, at 1)."""
    monkeypatch.setattr(tatt, "SCORE_BYTES", score_bytes)
    B, S, H, KV, Dh = 2, 40, 4, 2, 16
    q, kc, vc = _normal(B, C, H, Dh), _normal(B, S, KV, Dh), _normal(B, S, KV, Dh)
    want = J.att.cached_attention(J.jnp.array(q), J.jnp.array(kc), J.jnp.array(vc),
                                  J.jnp.int32(cache_len))
    got = tatt.cached_attention(torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
                                torch.tensor(cache_len, dtype=torch.int32))
    _close(got, want, 1e-5, 1e-5)
    if C == 1:
        want = J.att.decode_attention(J.jnp.array(q), J.jnp.array(kc), J.jnp.array(vc),
                                      J.jnp.int32(cache_len + 1))
        _close(tatt.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                     torch.from_numpy(vc), cache_len + 1), want, 1e-5, 1e-5)


# --------------------------------------------------------------------- MoE ---


def _jax_dispatch(J, params, x, cfg):
    """JAX's router and dispatch bookkeeping, as ``moe_ffn`` computes them."""
    jnp, jax = J.jnp, J.jax
    T = x.shape[0]
    E, k = cfg.n_experts, cfg.top_k
    C = int(max(1, -(-T * k // E) * cfg.capacity_factor))
    probs = jax.nn.softmax(x @ params["router"], axis=-1)
    gate, expert = jax.lax.top_k(probs, k)
    flat_e = expert.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    pos = jnp.arange(T * k) - jnp.searchsorted(e_sorted, e_sorted, side="left")
    keep = pos < C
    slot = jnp.where(keep, e_sorted * C + pos, E * C)
    return C, expert, order, keep, slot


@pytest.mark.parametrize("E,k,cf,T,shared", [(4, 2, 1.25, 24, 0), (4, 1, 0.5, 64, 0),
                                              (6, 2, 0.75, 40, 1), (4, 2, 4.0, 24, 1)])
def test_moe_ffn_with_capacity_drops_equals_jax(J, E, k, cf, T, shared):
    cfg = tmoe.MoEConfig(n_experts=E, top_k=k, d_ff_expert=16, capacity_factor=cf,
                         n_shared_experts=shared, d_ff_shared=12 * shared)
    jcfg = J.moe.MoEConfig(**dataclasses.asdict(cfg))
    assert tmoe.moe_params_shape(cfg, 8) == J.moe.moe_params_shape(jcfg, 8)
    params = {n: _normal(*s) * (1.0 if n == "router" else 0.3)
              for n, s in tmoe.moe_params_shape(cfg, 8).items()}
    x = _normal(T, 8)
    jparams = {n: J.jnp.array(v) for n, v in params.items()}
    C, expert, order, keep, slot = _jax_dispatch(J, jparams, J.jnp.array(x), jcfg)
    assert tmoe.capacity(T, cfg) == C
    probs, _, texpert = tmoe.route(torch.from_numpy(x), torch.from_numpy(params["router"]), cfg)
    assert np.array_equal(_np(texpert), np.asarray(expert))
    torder, _, tkeep, tslot = tmoe.dispatch(texpert, T, C, E)
    assert np.array_equal(_np(torder), np.asarray(order))
    assert np.array_equal(_np(tkeep), np.asarray(keep))
    assert np.array_equal(_np(tslot), np.asarray(slot))
    if cf < 1:
        assert not bool(tkeep.all())                          # drops on the path

    def jloss(p, x):
        out, aux = J.moe.moe_ffn(p, x, jcfg)
        return (out * J.jnp.array(up)).sum() + aux

    up = _normal(T, 8)
    jout, jaux = J.moe.moe_ffn(jparams, J.jnp.array(x), jcfg)
    jgp, jgx = J.jax.grad(jloss, argnums=(0, 1))(jparams, J.jnp.array(x))
    tp = {n: torch.from_numpy(v).requires_grad_(True) for n, v in params.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    tout, taux = tmoe.moe_ffn(tp, tx, cfg)
    _close(tout, jout)
    _close(taux, jaux, 1e-5, 1e-6)
    names = sorted(tp)
    grads = torch.autograd.grad((tout * torch.from_numpy(up)).sum() + taux,
                                [tp[n] for n in names] + [tx])
    for n, g in zip(names, grads):
        _close(g, jgp[n], msg=n)
    _close(grads[-1], jgx, msg="x")


# ---------------------------------------------------------------------- LM ---


def _batch(cfg, B=2, S=45):
    toks = RNG.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -3:] = -1                                        # ignored positions
    return toks, labels


@pytest.mark.parametrize("moe", [False, True])
def test_forward_lm_loss_and_gradients_equal_jax(J, moe):
    """S = 45 is not a multiple of the loss chunk (32): the padded labels
    and the −1 labels are ignored on both sides."""
    cfg = tla.small_lm(moe=moe)
    jcfg = J.la.small_lm(moe=moe)
    jp, tp = _lm_params(J, cfg)
    toks, labels = _batch(cfg)
    jx, jhead, jaux = J.tf.forward(jcfg, jp, J.jnp.array(toks))
    tx, thead, taux = ttf.forward(cfg, tp, torch.from_numpy(toks))
    _close(tx, jx)
    _close(thead, jhead)
    _close(taux, jaux, 1e-5, 1e-6)
    jl, jg = J.jax.value_and_grad(lambda p: J.tf.lm_loss(
        jcfg, p, J.jnp.array(toks), J.jnp.array(labels)))(jp)
    leaves = ttf.tree_map(lambda p: p.detach().requires_grad_(True), tp)
    tl = ttf.lm_loss(cfg, leaves, torch.from_numpy(toks), torch.from_numpy(labels))
    tg = ttf.tree_unflatten(leaves, torch.autograd.grad(tl, ttf.leaves(leaves)))
    _close(tl, jl, 1e-5, 1e-5)
    _tree_close(jg, tg)
    assert not tg["embed"].is_sparse


def test_remat_gives_the_same_gradients():
    cfg = tla.small_lm(moe=True)
    tp = ttf.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    toks, labels = (torch.from_numpy(a) for a in _batch(cfg, S=32))
    grads = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        leaves = ttf.tree_map(lambda p: p.detach().requires_grad_(True), tp)
        loss = ttf.lm_loss(c, leaves, toks, labels)
        grads.append(torch.autograd.grad(loss, ttf.leaves(leaves)))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("moe", [False, True])
def test_prefill_chunked_prefill_and_decode_equal_jax_and_forward(J, moe):
    """JAX's prefill against the port's; then the port's ``serve_step`` fills
    a fresh cache in chunks of 16 and decodes 3 tokens, each step's logits
    against the port's ``forward`` over the whole sequence and against
    JAX's ``serve_step``. The MoE's capacity factor is raised to 8 on both
    sides, so that no step drops a token: the capacity follows the step's
    token count, so a decode step of 3 tokens drops where ``forward`` over
    the whole sequence keeps (both packages alike)."""
    cfg, jcfg = tla.small_lm(moe=moe), J.la.small_lm(moe=moe)
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=8.0))
    jp, tp = _lm_params(J, cfg, 2)
    toks = RNG.integers(0, cfg.vocab_size, (3, 48)).astype(np.int32)
    jl, jcache = J.tf.prefill(jcfg, jp, J.jnp.array(toks), max_len=64)
    tl, tcache = ttf.prefill(cfg, tp, torch.from_numpy(toks), max_len=64)
    _close(tl, jl)
    _close(tcache["k"], jcache["k"])
    _close(tcache["v"], jcache["v"])

    def ref_logits(seq):
        x, head, _ = ttf.forward(cfg, tp, seq)
        return x[:, -1] @ head

    cache = ttf.init_kv_cache(cfg, 3, 64, device="cpu")
    jc = J.tf.init_kv_cache(jcfg, 3, 64)
    seq = torch.from_numpy(toks)
    for lo in range(0, 48, 16):
        nxt, logits, cache = ttf.serve_step(cfg, tp, seq[:, lo:lo + 16], cache, lo)
        jn, jlog, jc = J.tf.serve_step(jcfg, jp, J.jnp.array(toks[:, lo:lo + 16]), jc,
                                       J.jnp.int32(lo))
        _close(logits, jlog)
        _close(logits, ref_logits(seq[:, :lo + 16]))
    _close(logits, tl)
    cur = nxt
    for step in range(3):
        nxt, logits, cache = ttf.decode_step(cfg, tp, cur, cache, 48 + step)
        jn, jlog, jc = J.tf.decode_step(jcfg, jp, J.jnp.array(_np(cur)), jc,
                                        J.jnp.int32(48 + step))
        seq = torch.cat([seq, cur], dim=1)
        _close(logits, jlog)
        _close(logits, ref_logits(seq))
        assert nxt.dtype == torch.int32 and nxt.shape == (3, 1)
        cur = nxt
    _close(cache["k"], jc["k"])
    _close(cache["v"], jc["v"])


@pytest.mark.parametrize("moe", [False, True])
def test_small_lm_trains(moe):
    from repro_torch.optim.adamw import AdamW

    cfg = tla.small_lm(moe=moe)
    params = ttf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(RNG.integers(0, cfg.vocab_size, (4, 64)).astype(np.int32))
    labels = torch.roll(toks, -1, dims=1)
    opt = AdamW(lr=3e-3)
    ost = opt.init(params)
    with torch.no_grad():
        l0 = float(ttf.lm_loss(cfg, params, toks, labels))
    for _ in range(15):
        leaves = ttf.tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = ttf.lm_loss(cfg, leaves, toks, labels)
        g = ttf.tree_unflatten(leaves, torch.autograd.grad(loss, ttf.leaves(leaves)))
        params, ost = opt.update(g, ost, params)
    with torch.no_grad():
        l1 = float(ttf.lm_loss(cfg, params, toks, labels))
    assert np.isfinite(l1) and l1 < l0


# --------------------------------------------------- configs, specs, cells ---


ARCHS = list(tla.LM_CONFIGS)


def _fields(c):
    return {f: getattr(c, f) for f in c.__dataclass_fields__ if f not in ("dtype", "moe")}


@pytest.mark.parametrize("arch", ARCHS + ["small-dense", "small-moe"])
def test_configs_shapes_and_counts_equal_jax(J, arch):
    if arch.startswith("small"):
        t, j = tla.small_lm(arch == "small-moe"), J.la.small_lm(arch == "small-moe")
    else:
        t, j = tla.LM_CONFIGS[arch], J.la.LM_CONFIGS[arch]
    assert _fields(t) == _fields(j)
    assert (t.moe is None) == (j.moe is None)
    if t.moe is not None:
        assert dataclasses.asdict(t.moe) == dataclasses.asdict(j.moe)
    assert str(t.dtype).replace("torch.", "") == str(np.dtype(j.dtype))
    assert ttf.param_shapes(t) == J.tf.param_shapes(j)
    assert (t.n_params, t.n_active_params, t.padded_vocab) == \
        (j.n_params, j.n_active_params, j.padded_vocab)
    norm = lambda spec: [tshd._axes(e) for e in spec]
    js = J.shd.lm_param_specs(j)
    ts = tshd.lm_param_specs(t)
    assert sorted(ts) == sorted(js) and sorted(ts["layers"]) == sorted(js["layers"])
    for k in ts:
        if k == "layers":
            for n in ts[k]:
                assert norm(ts[k][n]) == norm(js[k][n]), n
        else:
            assert norm(ts[k]) == norm(js[k]), k


def test_batch_cache_and_expert_specs_equal_jax(J):
    norm = lambda spec: [tshd._axes(e) for e in spec]
    for mp in (False, True):
        assert norm(tshd.lm_batch_spec(mp)) == norm(J.shd.lm_batch_spec(mp))
        assert norm(tshd.lm_cache_spec(mp)) == norm(J.shd.lm_cache_spec(mp))
    assert norm(tshd.moe_expert_spec()) == norm(J.shd.moe_expert_spec())


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_formulas_and_arguments_equal_jax(J, arch):
    mesh = J.jax.make_mesh((1, 1), ("data", "model"))
    jspec, tspec = J.la.specs()[arch], tla.specs()[arch]
    assert tspec.skip == jspec.skip and list(tspec.shapes) == list(jspec.shapes)
    assert tspec.family == jspec.family == "lm"
    for shape in tspec.shapes:
        if shape in tspec.skip:
            assert tspec.cell(shape) is None
            continue
        jc, tc = jspec.cell(shape, mesh, False), tspec.cell(shape, None)
        assert (tc.model_flops, tc.model_coll_bytes, tc.note, tc.step_kind, tc.donate) == \
            (jc.model_flops, jc.model_coll_bytes, jc.note, jc.step_kind, jc.donate), shape
        got = [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
               for a in tc.make_args(None, "meta") for x in ttf.leaves(
                   a if isinstance(a, dict) else {"": a})]
        want = [(tuple(x.shape), str(x.dtype)) for x in J.jax.tree.leaves(jc.args)]
        assert got == want, shape
    assert tbase.lm_train_flops(tla.LM_CONFIGS[arch], 4, 128) == \
        J.base.lm_train_flops(J.la.LM_CONFIGS[arch], 4, 128)


def test_one_rank_cut_is_one_microbatch_of_the_same_step():
    for arch, mpd in (("qwen3-0.6b", 2), ("qwen2-moe-a2.7b", 1)):
        cell = tla.specs()[arch].cell("train_4k")
        cut = cell.one_rank_cut()
        assert cell.note == f"n_micro={256 // mpd}" and cut.note == "n_micro=1"
        assert cut.make_args(None, "meta")[2].shape == (mpd, 4096)
        assert f"{256 // mpd}" in cut.reduced and cut.one_rank_cut is None
        assert cut.model_flops * (256 // mpd) == cell.model_flops
    assert tla.specs()["qwen3-0.6b"].cell("train_4k", tshd.RankLayout(1, 16, 16)).one_rank_cut \
        is None


def _tiny_train(monkeypatch, jbase):
    """A train shape of 2 microbatches of 2 × 24 tokens in both packages."""
    tiny = dict(seq_len=24, global_batch=4, kind="train")
    monkeypatch.setitem(tbase.LM_SHAPES, "train_tiny", tiny)
    monkeypatch.setitem(jbase.LM_SHAPES, "train_tiny", tiny)


@pytest.mark.parametrize("moe", [False, True])
def test_small_train_cell_step_equals_jax_cell_step(J, monkeypatch, moe):
    """The train cell's step (two microbatches, WSD AdamW) at small_lm's
    widths on the port's drawn tokens against JAX's cell step on the same
    arrays: loss, parameters and moments within 1e-5 / 1e-4."""
    _tiny_train(monkeypatch, J.base)
    cfg, jcfg = tla.small_lm(moe), J.la.small_lm(moe)
    tc = tbase.build_lm_cell(cfg, "train_tiny", None, micro_per_device=1)
    jc = J.base.build_lm_cell(jcfg, "train_tiny", J.jax.make_mesh((1, 1), ("data", "model")),
                              False, micro_per_device=1)
    assert tc.note == jc.note == "n_micro=4"
    jp, tp = _lm_params(J, cfg, 4)
    args = tc.make_args(torch.Generator().manual_seed(3), "cpu", params=tp)
    jargs = J.jax.tree.map(lambda a: J.jnp.array(a.numpy()), args)
    jargs = (J.jax.tree.map(lambda a: a.astype(J.jnp.float32), jp),) + tuple(jargs[1:])
    jnew, jo, jl = jc.fn(*jargs)
    tnew, to, tl = tc.fn(*args)
    _close(tl, jl, 1e-5, 1e-5)
    _tree_close(jnew, tnew)
    _tree_close(jo["m"], to["m"])
    _tree_close(jo["v"], to["v"], 1e-4, 1e-9)


def test_serve_cells_run_at_small_widths(monkeypatch):
    """A prefill and a decode cell of small_lm at a 64-position cache: the
    step writes its chunk into the donated cache in place."""
    monkeypatch.setitem(tbase.LM_SHAPES, "prefill_tiny",
                        dict(seq_len=64, global_batch=2, kind="prefill"))
    monkeypatch.setitem(tbase.LM_SHAPES, "decode_tiny",
                        dict(seq_len=64, global_batch=2, kind="decode"))
    cfg = tla.small_lm(True)
    for shape, C in (("prefill_tiny", 64), ("decode_tiny", 1)):
        cell = tbase.build_lm_cell(cfg, shape, None)
        params, toks, cache, cl = cell.make_args(torch.Generator().manual_seed(0), "cpu")
        assert toks.shape == (2, C) and int(cl) == 64 - C
        nxt, logits, out = cell.fn(params, toks, cache, cl)
        assert out is cache and bool(cache["k"][:, :, 64 - C:].any())
        assert logits.shape == (2, cfg.padded_vocab) and torch.isfinite(logits).all()


def test_cells_across_ranks_refuse_their_step():
    """Across ranks the LM steps run (``test_torch_lm_ranks.py`` holds them
    against JAX): every arch's cells are built at (1, 16, 16), and the tiny
    cells, called on rank views with no world here, stop at their first
    collective instead of refusing."""
    import _torch_ranks as R

    lay = tshd.RankLayout(1, 16, 16)
    for arch, spec in tla.specs().items():
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            assert spec.cell(shape, lay).step_kind == LM_KINDS[shape], (arch, shape)
    for variant in R.LM_VARIANTS:
        R.lm_steps_on_views(tshd.RankLayout(1, 2, 2), variant)


LM_KINDS = {"train_4k": "train", "prefill_32k": "prefill", "decode_32k": "decode"}


def test_cached_attention_in_bf16_sums_exact_products_in_f32():
    """The bf16 cache's scores are exact bf16 products summed in f32 (JAX's
    ``preferred_element_type``): equal to the f32 computation on the same
    bf16 values within the output's bf16 rounding."""
    q, kc, vc = (torch.from_numpy(_normal(*s)).to(torch.bfloat16)
                 for s in ((2, 5, 4, 16), (2, 40, 2, 16), (2, 40, 2, 16)))
    got = tatt.cached_attention(q, kc, vc, 20)
    want = tatt.cached_attention(q.float(), kc.float(), vc.float(), 20)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got.float()), _np(want), rtol=2e-2, atol=2e-2)


def test_entry_points_default_to_the_card():
    """Without a card the LM entry points raise unless given the CPU."""
    cfg = tla.small_lm()
    if torch.cuda.is_available():
        pytest.skip("a card is there: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttf.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttf.init_kv_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tla.specs()["smollm-135m"].cell("decode_32k").make_args(None)
    assert ttf.init_kv_cache(cfg, 1, 8, device="cpu")["k"].shape == (2, 1, 8, 2, 16)
