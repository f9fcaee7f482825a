"""Port conformance of the recsys models (``repro_torch.models.recsys``) and
their configs.

Each of the four forwards, the lookups, ``retrieval_scores`` and
``bce_loss`` run in both packages on ``small_recsys()`` with the same
parameters (drawn by the JAX package's ``init_params``, carried across with
``convert.recsys_params_from_numpy``) and the same seeded numpy inputs, with
f32 and bf16 tables. ``lookup`` must agree bit for bit; the rest are f32
products and sums taken in another order on each side, compared within
rtol = atol = 1e-5.
"""
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread as _one_torch_thread  # noqa: F401  (autouse)
from repro_torch import convert
from repro_torch.configs import recsys_archs as tra
from repro_torch.models import recsys as trec

pytestmark = pytest.mark.port

TOL = dict(rtol=1e-5, atol=1e-5)
B = 24
ARCHS = ["dlrm-mlperf", "xdeepfm", "din", "autoint"]


@pytest.fixture(scope="module")
def jax_side():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import recsys_archs as jra
    from repro.models import recsys as jrec
    return jax, jnp, jra, jrec


def _inputs(arch, cfg, seed=0):
    """Seeded numpy inputs of ``arch``'s forward at batch B."""
    rng = np.random.default_rng(seed)
    if arch == "din":
        hist = rng.integers(0, cfg.n_items, (B, cfg.seq_len)).astype(np.int32)
        hist[rng.random((B, cfg.seq_len)) < 0.3] = -1            # padding
        return (rng.integers(0, cfg.n_items, B).astype(np.int32), hist,
                rng.integers(0, cfg.context_vocab, (B, cfg.n_context)).astype(np.int32))
    sizes = np.array(cfg.embedding.vocab_sizes)
    ids = (rng.random((B, len(sizes))) * sizes).astype(np.int32)
    if arch == "dlrm-mlperf":
        return rng.normal(size=(B, cfg.n_dense)).astype(np.float32), ids
    return (ids,)


def _params(jax_side, arch, table_dtype):
    """(JAX params, port params) for ``small_recsys()[arch]``: the same
    values, tables in ``table_dtype`` on both sides."""
    jax, jnp, jra, jrec = jax_side
    cfg = jra.small_recsys()[arch]
    raw = {k: np.asarray(v) for k, v in jrec.init_params(cfg, jax.random.key(3)).items()}
    jp = {k: jnp.asarray(v).astype(jnp.bfloat16 if table_dtype == "bfloat16"
                                   and k.endswith("table") else jnp.float32)
          for k, v in raw.items()}
    tp = convert.recsys_params_from_numpy(raw, "cpu", getattr(torch, table_dtype))
    return jp, tp


FORWARDS = {"dlrm-mlperf": "dlrm_forward", "xdeepfm": "xdeepfm_forward",
            "din": "din_forward", "autoint": "autoint_forward"}


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(jax_side, arch, table_dtype):
    jax, jnp, jra, jrec = jax_side
    jp, tp = _params(jax_side, arch, table_dtype)
    for k in tp:                                   # the parameters carried over
        assert np.array_equal(np.asarray(jp[k].astype(jnp.float32)), tp[k].float().numpy())
    jcfg, tcfg = jra.small_recsys()[arch], tra.small_recsys()[arch]
    args = _inputs(arch, tcfg)
    expect = np.asarray(getattr(jrec, FORWARDS[arch])(
        jcfg, jp, *(jnp.asarray(a) for a in args)))
    out = getattr(trec, FORWARDS[arch])(tcfg, tp, *(torch.from_numpy(a) for a in args))
    assert out.dtype == torch.float32 and out.shape == (B,)
    assert expect.dtype == np.float32
    np.testing.assert_allclose(out.numpy(), expect, **TOL)


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["dlrm-mlperf", "xdeepfm", "autoint"])
def test_lookup_is_bitwise(jax_side, arch, table_dtype):
    jax, jnp, jra, jrec = jax_side
    jp, tp = _params(jax_side, arch, table_dtype)
    spec = tra.small_recsys()[arch].embedding
    ids = _inputs(arch, tra.small_recsys()[arch])[-1]
    expect = jrec.lookup(jp["table"], jra.small_recsys()[arch].embedding, jnp.asarray(ids))
    out = trec.lookup(tp["table"], spec, torch.from_numpy(ids))
    assert out.dtype == getattr(torch, table_dtype)
    assert out.shape == (B, spec.n_fields, spec.dim)
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(expect.astype(jnp.float32)))


@pytest.mark.parametrize("weighted", [False, True], ids=["ones", "weighted"])
@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
def test_multi_hot_lookup_matches_jax(jax_side, table_dtype, weighted):
    jax, jnp, jra, jrec = jax_side
    jp, tp = _params(jax_side, "xdeepfm", table_dtype)
    spec = tra.small_recsys()["xdeepfm"].embedding
    ids = _inputs("xdeepfm", tra.small_recsys()["xdeepfm"])[0]
    w = np.random.default_rng(1).uniform(0.1, 2, ids.shape).astype(np.float32)
    w = w if weighted else None
    tol = 1e-5 if table_dtype == "float32" else 2e-2     # the JAX kernel test's limits
    out = trec.multi_hot_lookup(tp["table"], spec, torch.from_numpy(ids),
                                None if w is None else torch.from_numpy(w))
    assert out.shape == (B, spec.dim)
    for force in ("interpret", "ref"):
        expect = jrec.multi_hot_lookup(jp["table"], jra.small_recsys()["xdeepfm"].embedding,
                                       jnp.asarray(ids),
                                       None if w is None else jnp.asarray(w), force=force)
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(expect.astype(jnp.float32)), rtol=tol, atol=tol)


@pytest.mark.parametrize("N,chunk,top_k", [(1000, 256, 10), (4096, 1024, 100),
                                           (5, 131_072, 8), (300, 300, 20)])
def test_retrieval_scores_match_jax(jax_side, N, chunk, top_k):
    """Scores within the tolerance; ids equal except where two scores are a
    near-tie (the two sides round the dot products differently)."""
    jax, jnp, jra, jrec = jax_side
    rng = np.random.default_rng(N + top_k)
    user = rng.normal(size=(2, 16)).astype(np.float32)
    cand = rng.normal(size=(N, 16)).astype(np.float32)
    js, ji = jrec.retrieval_scores(jnp.asarray(user), jnp.asarray(cand), top_k, chunk)
    ts, ti = trec.retrieval_scores(torch.from_numpy(user), torch.from_numpy(cand), top_k,
                                   chunk)
    assert ts.shape == ti.shape == (2, top_k) and ti.dtype == torch.int32
    js, ji = np.asarray(js), np.asarray(ji)
    np.testing.assert_allclose(ts.numpy(), js, **TOL)
    diff = ti.numpy() != ji
    assert np.allclose(ts.numpy()[diff], js[diff], rtol=1e-5, atol=1e-5)
    if N < top_k:                  # the unfilled tail: -inf, id 0, as lax.top_k
        assert np.isneginf(ts.numpy()[:, N:]).all() and (ti.numpy()[:, N:] == 0).all()
        np.testing.assert_array_equal(ti.numpy(), ji)


def test_bce_loss_matches_jax(jax_side):
    jax, jnp, jra, jrec = jax_side
    rng = np.random.default_rng(2)
    logits = (rng.normal(size=512) * 6).astype(np.float32)
    labels = (rng.random(512) < 0.3).astype(np.float32)
    expect = float(jrec.bce_loss(jnp.asarray(logits), jnp.asarray(labels)))
    out = trec.bce_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(out), expect, **TOL)


def test_bf16_tables_round_as_jax(jax_side):
    """convert's f32 → bf16 cast is JAX's ``astype`` bit for bit."""
    jax, jnp, jra, jrec = jax_side
    x = np.random.default_rng(4).normal(size=4096).astype(np.float32) * 3
    x[:4] = [1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8), 0.0]       # exact halfway ties
    t = convert.recsys_params_from_numpy({"table": x, "w": x}, "cpu", torch.bfloat16)
    j = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(t["table"].float().numpy(), j)
    assert t["table"].dtype == torch.bfloat16 and t["w"].dtype == torch.float32


@pytest.mark.parametrize("name", ["DLRM", "XDEEPFM", "DIN", "AUTOINT"])
def test_full_width_configs_equal_jax(jax_side, name):
    """The port's copy of the public configs: the same fields, parameter
    shapes, padded rows, offsets and FLOP counts, with nothing allocated."""
    jax, jnp, jra, jrec = jax_side
    j, t = getattr(jra, name), getattr(tra, name)
    assert type(t).__name__ == type(j).__name__
    for f in ("name", "n_dense", "bot_mlp", "top_mlp", "cin_layers", "mlp", "n_items",
              "embed_dim", "seq_len", "attn_mlp", "n_context", "context_vocab",
              "n_attn_layers", "n_heads", "d_attn"):
        assert getattr(t, f, None) == getattr(j, f, None)
    assert t.param_shapes() == j.param_shapes()
    if hasattr(j, "embedding"):
        assert t.embedding.vocab_sizes == j.embedding.vocab_sizes
        assert t.embedding.dim == j.embedding.dim
        assert t.embedding.padded_rows == j.embedding.padded_rows
        np.testing.assert_array_equal(t.embedding.offsets, j.embedding.offsets)
        assert t.embedding.offsets.dtype == j.embedding.offsets.dtype
    flops = f"_{name.lower()}_flops"
    for batch in (512, 65_536, 262_144):
        for train in (False, True):
            assert getattr(tra, flops)(batch, train) == getattr(jra, flops)(batch, train)


def test_small_configs_and_shapes_equal_jax(jax_side):
    jax, jnp, jra, jrec = jax_side
    assert tra.MLPERF_TABLE_SIZES == jra.MLPERF_TABLE_SIZES
    assert tra.CRITEO39_SIZES == jra.CRITEO39_SIZES
    assert tra.DLRM.param_shapes()["table"] == (187_767_552, 128)
    for arch, cfg in tra.small_recsys().items():
        assert cfg.param_shapes() == jra.small_recsys()[arch].param_shapes()


def test_init_params_draws_the_jax_shapes_chunk_by_chunk(monkeypatch):
    monkeypatch.setattr(trec, "TABLE_CHUNK_ROWS", 100)        # 512 rows: 6 chunks
    cfg = tra.small_recsys()["dlrm-mlperf"]
    g = torch.Generator().manual_seed(0)
    p = trec.init_params(cfg, g, "cpu", torch.bfloat16)
    assert {k: tuple(v.shape) for k, v in p.items()} == cfg.param_shapes()
    assert p["table"].dtype == torch.bfloat16 and p["bot/w0"].dtype == torch.float32
    assert not p["bot/b0"].any() and p["table"][-1].any()        # every chunk drawn
    p2 = trec.init_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.bfloat16)
    assert all(torch.equal(p[k], p2[k]) for k in p)


def test_entry_points_refuse_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = tra.small_recsys()["dlrm-mlperf"]
    with pytest.raises(RuntimeError, match="CUDA"):
        trec.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.recsys_params_from_numpy({"table": np.zeros((4, 2))}, "cuda")


LOOKUP_SHARDED_CODE = r"""
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.models import recsys

d = np.load(IN)
spec = recsys.EmbeddingSpec(vocab_sizes=tuple(int(v) for v in d["vocab"]), dim=d["table"].shape[1])
mesh = jax.make_mesh((1, 4), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
out = {}
for dtype in ("float32", "bfloat16"):
    table = jnp.asarray(d["table"]).astype(dtype)
    fn = jax.shard_map(lambda t, i: recsys.lookup_sharded(t, spec, i, axis="model"),
                       mesh=mesh, in_specs=(P("model", None), P("data", None)),
                       out_specs=P("data", None, None))
    got = jax.jit(fn)(table, jnp.asarray(d["ids"]))
    out[dtype] = np.asarray(got.astype(jnp.float32))
    out[dtype + "/plain"] = np.asarray(recsys.lookup(table, spec, jnp.asarray(d["ids"]))
                                       .astype(jnp.float32))
np.savez(OUT, **out)
"""


def test_lookup_sharded_matches_jax_shard_map(tmp_path):
    """``lookup_sharded`` on 4 ranks (each holding a quarter of the rows)
    equals JAX's ``shard_map`` body on 4 host devices bit for bit, f32 and
    bf16, with ids on every edge of the row slices; every id is hit by
    exactly one rank."""
    import _torch_ranks as R
    from conftest import run_with_devices
    from repro_torch.launch import mesh

    vocab, dim = (300, 200, 12), 8
    offsets = np.concatenate([[0], np.cumsum(vocab)[:-1]])
    rng = np.random.default_rng(0)
    table = rng.normal(size=(sum(vocab), dim)).astype(np.float32)
    table[5, 0] = -0.0               # −0 plus the other slices' +0 is +0 in both packages
    edges = sorted({e for lo in range(0, 512, 128) for e in (lo - 1, lo, lo + 1, lo + 127)
                    if 0 <= e < 512})
    ids = (rng.random((len(edges) + 8, len(vocab))) * np.array(vocab)).astype(np.int32)
    for b, e in enumerate(edges):
        f = int(np.searchsorted(offsets, e, side="right") - 1)
        ids[b, f] = e - offsets[f]
    ids[-1, 0] = 5
    np.savez(tmp_path / "in.npz", table=table, ids=ids, vocab=np.array(vocab))
    jax = R.jax_run(run_with_devices, f"IN = {str(tmp_path / 'in.npz')!r}\n" + LOOKUP_SHARDED_CODE,
                    n_devices=4)
    for dtype in ("float32", "bfloat16"):
        got = mesh.spawn(R.lookup_body, model=4, device="cpu", threads=1, timeout_s=R.TIMEOUT_S,
                         args=(table, vocab, ids, dtype))
        for r, (out_dtype, rows, hits) in enumerate(got):
            assert out_dtype == getattr(torch, dtype)
            np.testing.assert_array_equal(rows.view(np.uint32), jax[dtype].view(np.uint32),
                                          err_msg=f"{dtype}, rank {r}")
            assert (hits == 1).all()
        np.testing.assert_array_equal(jax[dtype], jax[dtype + "/plain"])
