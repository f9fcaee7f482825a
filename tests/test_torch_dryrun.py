"""The port's dry run (``repro_torch.launch.dryrun``) and what it reads —
``configs.all_specs``, the peacock-lda cells, ``dist/analysis`` — against
the JAX package.

- ``sampler_epoch_bytes`` and ``model_shard_report`` equal JAX's exactly, at
  the paper's scale and over a grid; the shard table's rows equal JAX's but
  for the fit column's limit (80 GB, not 16).
- Each argument's per-rank block of the cells JAX's small dry run compiles
  (plus dlrm-mlperf's train cell and peacock-lda's serve and optimized train
  cells) equals ``NamedSharding.shard_shape`` on the same 4×2 or 2×2×2
  mesh, and ``model_flops``, ``model_coll_bytes``, ``note`` and ``extra``
  are equal.
- ``count_cost``'s matrix-product flops equal JAX's ``trace_cost`` flops for
  the serve and train steps of the small recsys configs, but xdeepfm's (its
  CIN outer product, stated below).
- The train cell's ``fn`` at a small ring equals JAX's ``make_ring_epoch``
  bit for bit on one rank and on a 2×1 world over gloo, and its collectives
  are JAX's.
- The registry names every JAX id; the CLI runs without jax.
"""
import functools
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_ranks as R
from _torch_port import one_torch_thread as _one_torch_thread  # noqa: F401  (autouse)
from repro_torch.configs import all_ids, base as tbase, peacock_lda as tpl
from repro_torch.configs import recsys_archs as tra
from repro_torch.core import distributed as tdist
from repro_torch.data import corpus as tcorpus, synthetic as tsynthetic
from repro_torch.dist import analysis as tan, sharding as shd
from repro_torch.dist.sharding import RankLayout
from repro_torch.launch import dryrun, mesh
from repro_torch.models import recsys as trec

pytestmark = pytest.mark.port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORWARDS = {"dlrm-mlperf": "dlrm_forward", "xdeepfm": "xdeepfm_forward",
            "din": "din_forward", "autoint": "autoint_forward"}
FLOPS = {"dlrm-mlperf": "_dlrm_flops", "xdeepfm": "_xdeepfm_flops", "din": "_din_flops",
         "autoint": "_autoint_flops"}

# (arch, shape, multi_pod): tests/test_dryrun_small.py's cells, plus dlrm's
# train cell, the other two LDA cells, graphsage-reddit's four and the LM
# archs' train, prefill and decode cells
CELLS = [("autoint", "serve_p99", False), ("peacock-lda", "train_segment", False),
         ("peacock-lda", "train_segment", True), ("dlrm-mlperf", "train_batch", False),
         ("peacock-lda", "serve_rt", False), ("peacock-lda", "train_segment_opt", False),
         ("graphsage-reddit", "full_graph_sm", False), ("graphsage-reddit", "minibatch_lg", True),
         ("graphsage-reddit", "ogb_products", False), ("graphsage-reddit", "molecule", True),
         ("graphsage-reddit", "molecule", False), ("smollm-135m", "train_4k", False),
         ("qwen3-0.6b", "train_4k", True), ("minicpm-2b", "prefill_32k", False),
         ("phi3.5-moe-42b-a6.6b", "train_4k", False), ("qwen2-moe-a2.7b", "decode_32k", True),
         ("qwen2-moe-a2.7b", "train_4k", False), ("smollm-135m", "decode_32k", False)]

JAX_SPECS = r"""
import json
import jax
from repro.configs import get_arch
from repro.launch.mesh import make_test_mesh
from repro.launch.dryrun import print_shard_table

mesh, mesh3 = make_test_mesh(4, 2), make_test_mesh(2, 2, n_pod=2)
is_sh = lambda x: isinstance(x, jax.sharding.Sharding)
out = {}
for arch, shape, mp in %(CELLS)r:
    cell = get_arch(arch).cell(shape, mesh3 if mp else mesh, mp)
    flat, _ = jax.tree_util.tree_flatten_with_path(cell.args)
    shs = jax.tree_util.tree_leaves(cell.in_shardings, is_leaf=is_sh)
    assert len(flat) == len(shs)
    out[f"{arch}/{shape}/{mp}"] = dict(
        leaves=[[jax.tree_util.keystr(p), list(sh.shard_shape(a.shape)), a.dtype.itemsize]
                for (p, a), sh in zip(flat, shs)],
        model_flops=cell.model_flops, model_coll_bytes=cell.model_coll_bytes,
        note=cell.note, extra=cell.extra)
rows = print_shard_table(as_json=False)
print("RESULT" + json.dumps(dict(cells=out, shard_rows=rows)))
"""


@pytest.fixture(scope="module")
def jax_specs():
    from conftest import run_with_devices

    out = run_with_devices(JAX_SPECS % dict(CELLS=CELLS), n_devices=8, timeout=600)
    line = next(ln for ln in out.splitlines() if ln.startswith("RESULT"))
    return json.loads(line[len("RESULT"):])


def _port_leaves(cell, layout):
    """[keystr path, per-rank block shape, itemsize] of every argument leaf,
    in JAX's flattening order (tuple index, then sorted dict keys)."""
    out = []

    def walk(path, arg, spec):
        if isinstance(arg, dict):
            for k in sorted(arg):
                walk(f"{path}['{k}']", arg[k], spec[k])
        elif isinstance(arg, (list, tuple)):
            for i, (a, sp) in enumerate(zip(arg, spec)):
                walk(f"{path}[{i}]", a, sp)
        else:
            out.append([path, list(shd.block_shape(arg.shape, spec, layout)), arg.element_size()])

    for i, (arg, spec) in enumerate(zip(cell.make_args(None, "meta"), cell.arg_specs)):
        walk(f"[{i}]", arg, spec)
    return out


@pytest.mark.parametrize("arch,shape,multi_pod", CELLS)
def test_per_rank_blocks_and_formulas_equal_jax(jax_specs, arch, shape, multi_pod):
    from repro_torch.configs import get_arch

    layout = RankLayout(2, 2, 2) if multi_pod else RankLayout(1, 4, 2)
    cell = get_arch(arch).cell(shape, layout)
    want = jax_specs["cells"][f"{arch}/{shape}/{multi_pod}"]
    got = _port_leaves(cell, layout)
    assert [g[0] for g in got] == [w[0] for w in want["leaves"]]
    for (path, shape_g, size_g), (_, shape_w, size_w) in zip(got, want["leaves"]):
        assert shape_g == shape_w, path
        # the port's uid is int64 holding uint32 values (JAX: uint32), so its
        # block takes twice the bytes; every other leaf has JAX's dtype width
        uid = cell.step_kind == "lda_train" and path == "[4]"
        assert size_g == (2 * size_w if uid else size_w), path
    assert cell.model_flops == want["model_flops"]
    assert cell.model_coll_bytes == want["model_coll_bytes"]
    assert cell.note == want["note"]
    assert json.loads(json.dumps(cell.extra)) == want["extra"]


def test_shard_table_rows_equal_jax_but_the_limit(jax_specs, capsys):
    rows = dryrun.print_shard_table(as_json=True)
    doc = json.loads(capsys.readouterr().out)["shard_table"]
    assert doc["rows"] == json.loads(json.dumps(rows))
    assert len(rows) == len(jax_specs["shard_rows"]) == 4
    for got, want in zip(rows, jax_specs["shard_rows"]):
        assert got.pop("fits_80gb_hbm") == (got["hbm_bytes_per_device"] < 80e9)
        want.pop("fits_16gb_hbm")
        assert got == want
    # the H100 reading of DESIGN.md §10: P = 1 does not fit 80 GB, P = 2 does
    assert [r["hbm_bytes_per_device"] < 80e9 for r in rows] == [False, True, True, True]
    assert round(rows[0]["hbm_bytes_per_device"] / 1e9, 1) == 104.5
    assert round(rows[1]["hbm_bytes_per_device"] / 1e9, 1) == 52.3


GRID = [(100_000, 1_000_000, 16, 1, 4.5e9), (100_000, 1_000_000, 16, 8, 4.5e9),
        (1024, 30_000, 4, 2, 1e6), (16, 300, 8, 3, 12_345.0), (100_000, 210_000, 256, 1, 4.7e6),
        (7, 13, 1, 1, 1.0), (50_000, 999_983, 12, 5, 3.3e8)]


@pytest.mark.parametrize("K,V,M,P,tokens", GRID)
def test_analytic_reports_equal_jax(K, V, M, P, tokens):
    from repro.dist import analysis as jan

    for kw in (dict(), dict(docs_per_shard=4096, doc_topic_cap=64),
               dict(docs_per_shard=300)):
        assert tan.model_shard_report(K, V, M, P, tokens, **kw) == \
            jan.model_shard_report(K, V, M, P, tokens, **kw)
    for n_mh, vocab, rebuild in ((4, V, 3), (3, None, 1), (1, V, 1), (8, 0, 2)):
        assert tan.sampler_epoch_bytes(tokens, K, 4.5, n_mh, vocab, rebuild) == \
            jan.sampler_epoch_bytes(tokens, K, 4.5, n_mh, vocab, rebuild)


def _small_makers(arch, tcfg):
    """(JAX input maker, port input maker) of ``small_recsys()[arch]`` (JAX's
    makers hard-code the full configs' widths)."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import base as jbase, recsys_archs as jra

    def jax_maker(shapes):
        def maker(B, mesh, bspec):
            return (tuple(jbase.sds((B,) + s, dt) for s, dt in shapes),
                    tuple(NamedSharding(mesh, bspec if s else P(bspec[0])) for s, _ in shapes))
        return maker

    if arch == "dlrm-mlperf":
        return (jax_maker([((tcfg.n_dense,), jnp.float32),
                           ((tcfg.embedding.n_fields,), jnp.int32)]),
                functools.partial(tra._dlrm_inputs, cfg=tcfg))
    if arch == "din":
        return (jax_maker([((), jnp.int32), ((tcfg.seq_len,), jnp.int32),
                           ((tcfg.n_context,), jnp.int32)]),
                functools.partial(tra._din_inputs, cfg=tcfg))
    return (jra._sparse_inputs(tcfg.embedding.n_fields),
            tra._sparse_inputs(tcfg.embedding.vocab_sizes))


def _small_cell(arch, shape):
    tcfg = tra.small_recsys()[arch]
    return tbase.build_recsys_cell(tcfg, getattr(trec, FORWARDS[arch]),
                                   _small_makers(arch, tcfg)[1], getattr(tra, FLOPS[arch]),
                                   shape)


@pytest.mark.parametrize("shape", ["serve_p99", "train_batch"])
@pytest.mark.parametrize("arch", list(FORWARDS))
def test_count_cost_flops_equal_jax_trace_cost(arch, shape):
    import jax
    from repro.configs import base as jbase, recsys_archs as jra
    from repro.dist import analysis as jan
    from repro.models import recsys as jrec

    jcfg, tcfg = jra.small_recsys()[arch], tra.small_recsys()[arch]
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    jcell = jbase.build_recsys_cell(jcfg, getattr(jrec, FORWARDS[arch]),
                                    _small_makers(arch, tcfg)[0], getattr(jra, FLOPS[arch]),
                                    shape, mesh, False)
    want = jan.trace_cost(jcell.fn, *jcell.args).flops
    cell = _small_cell(arch, shape)
    cost, _ = tan.count_cost(cell.fn, *cell.make_args(torch.Generator().manual_seed(0), "cpu"))
    B = tbase.RECSYS_SHAPES[shape]["batch"]
    diff = 0.0
    if arch == "xdeepfm":
        # JAX's einsum("bid,bjd,hij->bhd") forms the outer product x_l ⊗ x_0
        # as a dot_general with no contracting dim, 2·B·D·H_prev·F flops a
        # layer (its backward has two more); torch's einsum forms it as a
        # broadcast multiply, which is no matrix product. The contractions
        # with the CIN weights are counted the same on both sides.
        F, D = tcfg.embedding.n_fields, tcfg.embedding.dim
        h_prev, outer = F, 0.0
        for h in tcfg.cin_layers:
            outer += 2.0 * B * D * h_prev * F
            h_prev = h
        diff = outer * (3.0 if shape == "train_batch" else 1.0)
    assert cost.flops == want - diff
    # the kernels' bytes are charged by name: the forward's bag, the
    # backward's row gradients
    assert ("embedding_bag" in cost.kernels) == (arch != "din")
    assert ("embedding_bag_bwd" in cost.kernels) == (shape == "train_batch")
    assert cost.bytes > sum(k["bytes"] for k in cost.kernels.values())


def test_kernel_bodies_are_hidden_and_charged():
    from repro_torch.kernels.gibbs import ops as gops

    K, T = 16, 40
    g = torch.Generator().manual_seed(0)
    rows = [torch.randint(0, 5, (T, K), generator=g).float() for _ in range(3)]
    alpha, uid = torch.full((K,), 0.1), torch.arange(T)
    cost, z = tan.count_cost(gops.gibbs_argmax, *rows, alpha, 0.01, uid, 3, 300)
    want = 3 * T * K * 4 + K * 4 + T * 8 + T * 4
    assert cost.kernels == {"gibbs_argmax": {"calls": 1.0, "bytes": float(want)}}
    assert cost.bytes == cost.moved_bytes == want and cost.flops == 0
    assert torch.equal(z, gops.gibbs_argmax(*rows, alpha, 0.01, uid, 3, 300))


def test_moved_bytes_of_views_gathers_and_scatters():
    table, ids = torch.zeros((1000, 8)), torch.tensor([3, 7, 3])

    def step(t, i):
        rows = t.index_select(0, i)                 # gather: ids in, [3, 8] out
        t.index_copy_(0, i[:2], rows[:2] * 2)       # mul (in + out), then a scatter
        return rows.t()                             # a view: moves nothing

    cost, _ = tan.count_cost(step, table, ids)
    rows_b, ids_b = 3 * 8 * 4, 3 * 8
    mul = 2 * (2 * 8 * 4)              # [2, 8] in and out (the factor is a Python scalar)
    scatter = 2 * (2 * 8 + 2 * 8 * 4)  # its ids and source, read and written
    assert cost.moved_bytes == ids_b + rows_b + mul + scatter
    assert cost.bytes > cost.moved_bytes + 2 * 1000 * 8 * 4        # JAX's rule: the table
    assert cost.flops == 0


def _ring_cfg(sc, K, V, M):
    cap = sc.word_local.shape[2]
    return tdist.RingConfig(n_topics=K, vocab_size=V, rows_per_shard=sc.rows_per_shard,
                            docs_per_shard=sc.docs_per_shard, cap=cap, package_len=cap // 2,
                            n_rounds=M)


RING_K, RING_V, RING_EPOCHS = 12, 150, 3

JAX_RING = r"""
import numpy as np, jax, jax.numpy as jnp
from repro.core import distributed as dist
from repro.data import synthetic, corpus as corpus_mod
from repro.dist import analysis
corpus, _ = synthetic.lda_corpus(seed=0, n_docs=200, n_topics=8, vocab_size=%(V)d,
                                 doc_len_mean=10)
M, K = 2, %(K)d
mesh = jax.make_mesh((M, 1), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
sc = corpus_mod.shard_corpus(corpus, M, M, K, seed=1)
cap = sc.word_local.shape[2]
cfg = dist.RingConfig(n_topics=K, vocab_size=corpus.vocab_size, rows_per_shard=sc.rows_per_shard,
                      docs_per_shard=sc.docs_per_shard, cap=cap, package_len=cap // 2, n_rounds=M)
st = dist.device_arrays(sc, K)
alpha, beta = jnp.full((K,), 50.0 / K, jnp.float32), jnp.float32(0.01)
fn = dist.ring_epoch_parts(mesh, cfg)[0]
cost = analysis.trace_cost(fn, *st, alpha, beta, jnp.uint32(3))
epoch = dist.make_ring_epoch(mesh, cfg)
for ep in range(%(EPOCHS)d):
    st = epoch(*st, alpha, beta, jnp.uint32(ep * 977 + 3))
out = {name: np.asarray(x) for name, x in zip(("phi", "psi", "wl", "dl", "uid", "z"), st)}
out.update({"coll/" + k: np.asarray(v) for k, v in cost.collectives.items()})
np.savez(OUT, **out)
"""


def _ring_corpus():
    corpus, _ = tsynthetic.lda_corpus(seed=0, n_docs=200, n_topics=8, vocab_size=RING_V,
                                      doc_len_mean=10)
    return corpus


def test_train_cell_fn_at_one_rank_equals_jax_ring_epoch():
    import jax
    import jax.numpy as jnp
    from repro.core import distributed as jdist
    from repro.data import corpus as jcorpus

    corpus = _ring_corpus()
    sc = tcorpus.shard_corpus(corpus, 1, 1, RING_K, seed=1)
    cfg = _ring_cfg(sc, RING_K, RING_V, 1)
    cell = tpl.train_cell(cfg)
    assert cell.step_kind == "lda_train" and cell.note.startswith("M=1 ring")
    st = tdist.device_arrays(sc, RING_K, device="cpu")
    jsc = jcorpus.shard_corpus(corpus, 1, 1, RING_K, seed=1)
    jcfg = jdist.RingConfig(n_topics=RING_K, vocab_size=RING_V, rows_per_shard=jsc.rows_per_shard,
                            docs_per_shard=jsc.docs_per_shard, cap=cfg.cap,
                            package_len=cfg.package_len, n_rounds=1)
    jst = jdist.device_arrays(jsc, RING_K)
    epoch = jdist.make_ring_epoch(jax.make_mesh((1, 1), ("data", "model")), jcfg)
    alpha, jalpha = R.alpha0(RING_K), jnp.full((RING_K,), 50.0 / RING_K, jnp.float32)
    for ep in range(RING_EPOCHS):
        st = cell.fn(*st, alpha, torch.tensor(R.BETA), ep * 977 + 3)
        jst = epoch(*jst, jalpha, jnp.float32(R.BETA), jnp.uint32(ep * 977 + 3))
    for name, got, want in zip(("phi", "psi", "wl", "dl", "uid", "z"), st, jst):
        got = got.numpy().astype(np.uint32) if name == "uid" else got.numpy()
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=name)


def test_train_cell_fn_on_two_ranks_equals_jax_ring_epoch():
    from conftest import run_with_devices

    corpus = _ring_corpus()
    sc = tcorpus.shard_corpus(corpus, 2, 2, RING_K, seed=1)
    cfg = _ring_cfg(sc, RING_K, RING_V, 2)
    res = mesh.spawn(R.train_cell_body, data=2, model=1, device="cpu",
                     args=([sc], cfg, RING_EPOCHS), threads=1, timeout_s=R.TIMEOUT_S)
    layout = RankLayout(1, 2, 1)
    port = R.assemble_state([r[0] for r in res], cfg, layout)
    want = R.jax_run(run_with_devices, JAX_RING % dict(V=RING_V, K=RING_K, EPOCHS=RING_EPOCHS),
                     n_devices=2)
    for i, name in enumerate(("phi", "psi", "wl", "dl", "uid", "z")):
        got = port[i].astype(np.uint32) if name == "uid" else port[i]
        np.testing.assert_array_equal(got, want[name], err_msg=name)
    # the collectives of one epoch: JAX's jaxpr counts, by primitive; each
    # rank ships its wl, dl, uid and z one hop every round, and sums Ψ's
    # deltas once
    jax_coll = {k[len("coll/"):]: float(v) for k, v in want.items() if k.startswith("coll/")}
    cap = cfg.cap
    for calls, nbytes in (r[1:] for r in res):
        assert calls == jax_coll == {"ppermute": 8.0, "psum": 1.0}
        assert nbytes == {"ppermute": 2 * 2 * cap * (4 + 4 + 8 + 4), "psum": RING_K * 4.0}


def test_registry_names_every_jax_id():
    """Every id of JAX's registry, in its order, builds in the port with
    JAX's family, shapes and skips (the LM and GNN ids were the not-ported
    ones until they were ported)."""
    from repro.configs import all_specs as jax_specs
    from repro_torch.configs import all_specs, get_arch

    jspecs = jax_specs()
    assert all_ids() == list(jspecs) == list(all_specs())
    for arch in all_ids():
        spec = get_arch(arch)
        assert spec.family == jspecs[arch].family
        assert list(spec.shapes) == list(jspecs[arch].shapes)
        assert spec.skip == jspecs[arch].skip
    assert {get_arch(a).family for a in all_ids()} == {"lm", "gnn", "recsys", "lda"}
    with pytest.raises(KeyError):
        get_arch("no-such-arch")


def test_block_shape_is_the_local_view_shape():
    layout = RankLayout(2, 4, 2, rank=11)
    x = torch.empty((2, 8, 6, 5), device="meta")
    for spec in (shd.pod_ring_spec(), shd.pod_wshard_spec(), (None, "data"), ()):
        assert shd.block_shape(x.shape, spec, layout) == \
            tuple(shd.local_view(x, spec, layout).shape)
    with pytest.raises(ValueError):
        shd.block_shape((7, 3), shd.ring_spec(), layout)


def test_one_rank_steps_on_the_cpu():
    """``OneRank`` on the CPU: a small recsys arch's serve and train steps and
    a small LDA ring, each run and counted (no time or memory: no card)."""
    small = tbase.ArchSpec("autoint-small", "recsys", tbase.RECSYS_SHAPES,
                           lambda shape, layout: _small_cell("autoint", shape))
    corpus = _ring_corpus()
    cfg = _ring_cfg(tcorpus.shard_corpus(corpus, 1, 1, RING_K, seed=1), RING_K, RING_V, 1)
    lda = tbase.ArchSpec("lda-small", "lda", {"train_segment": {}},
                         lambda shape, layout: tpl.train_cell(cfg))
    one = dryrun.OneRank("cpu")
    serve = one.record(small, "serve_p99")
    train = one.record(small, "train_batch")
    ring = one.record(lda, "train_segment")
    for rec in (serve, train, ring):
        assert rec["status"] == "ok", rec
        assert rec["step_ms"] is None and rec["measured"] == "not measured: no card"
        assert all(n == 0 for n in rec["launches"].values())      # the plain versions
    assert serve["cost"]["flops"] > 0 and serve["useful_flops_ratio"] > 0
    assert set(train["cost"]["kernels"]) == {"embedding_bag", "embedding_bag_bwd"}
    assert ring["cost"]["flops"] == 0
    assert ring["cost"]["kernels"]["gibbs_argmax"]["calls"] == 2     # two packages
    assert one.record(small, "serve_p99") is serve                  # run once


def test_one_rank_steps_of_small_gnn_and_lm_cells_on_the_cpu(monkeypatch):
    """``OneRank`` on the CPU: small_gnn's full-graph and sampled train cells
    and small_lm's train cell of 8 microbatches, which the record runs cut
    to one (``reduced``), and a decode cell sharing the train cell's
    parameters (cast to the cell's dtype, small_lm's f32)."""
    from repro_torch.configs import gnn_archs as tga, lm_archs as tla

    sage = tga.small_gnn()
    tiny = {"full_graph_sm": dict(n_nodes=40, n_edges=150, d_feat=16, n_classes=4, kind="full"),
            "minibatch_lg": dict(batch_nodes=8, kind="sampled")}
    gnn = tbase.ArchSpec("sage-small", "gnn", tiny,
                         lambda shape, layout: tbase.build_gnn_cell(sage, shape, tiny[shape], None))
    monkeypatch.setitem(tbase.LM_SHAPES, "train_tiny",
                        dict(seq_len=24, global_batch=8, kind="train"))
    monkeypatch.setitem(tbase.LM_SHAPES, "decode_tiny",
                        dict(seq_len=32, global_batch=2, kind="decode"))
    lm = tbase.make_lm_arch(tla.small_lm(True))
    one = dryrun.OneRank("cpu")
    full, sampled = one.record(gnn, "full_graph_sm"), one.record(gnn, "minibatch_lg")
    train, decode = one.record(lm, "train_tiny"), one.record(lm, "decode_tiny")
    for rec in (full, sampled, train, decode):
        assert rec["status"] == "ok", rec
        assert rec["measured"] == "not measured: no card"
        assert all(n == 0 for n in rec["launches"].values())      # the plain versions
    assert set(full["cost"]["kernels"]) == {"embedding_bag_bwd"}
    assert set(sampled["cost"]["kernels"]) == {"embedding_bag", "embedding_bag_bwd"}
    assert "embedding_bag_bwd" in train["cost"]["kernels"]        # the MoE and embed scatters
    assert train["reduced"] == "one microbatch (1 x 24 tokens) of the global batch's 8 (B = 8)"
    assert "reduced" not in decode and train["cost"]["flops"] > decode["cost"]["flops"] > 0


def test_cells_across_ranks_refuse_their_step():
    lay = RankLayout(1, 16, 16)
    cell = tra.specs()["autoint"].cell("serve_p99", lay)
    with pytest.raises(NotImplementedError, match="13b"):
        cell.fn()
    with pytest.raises(NotImplementedError, match="serve_rt"):
        tpl.spec().cell("serve_rt", lay).fn()
    lda = tpl.spec().cell("train_segment", lay)
    views = [shd.local_view(a, sp, lay) for a, sp in zip(lda.make_args(None, "meta"),
                                                          lda.arg_specs)]
    args = tuple(views[:7]) + (0.01, 0)
    with pytest.raises(RuntimeError, match="process groups"):       # no world here
        lda.fn(*args)


def _run_cli(*argv):
    code = ("import sys\n"
            "from repro_torch.launch import dryrun\n"
            f"rc = dryrun.main({list(argv)!r})\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'repro' or m.startswith('repro.')]\n"
            "assert not bad, bad\n"
            "sys.exit(rc)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env=env, cwd=ROOT)


def test_cli_records_every_jax_id_at_both_meshes_without_jax():
    from repro.configs import all_specs as jax_specs

    proc = _run_cli("--all", "--device", "meta", "--json")
    assert proc.returncode == 0, proc.stderr[-3000:]
    recs = [json.loads(ln) for ln in proc.stdout.splitlines()]
    seen = {(r["arch"], r["shape"], r["mesh"]) for r in recs}
    for arch, spec in jax_specs().items():
        for shape in spec.shapes:
            for m in ("16x16", "2x16x16"):
                assert (arch, shape, m) in seen
    jspecs = jax_specs()
    for r in recs:
        assert "not ported" not in r.get("reason", "")
        if r["shape"] in jspecs[r["arch"]].skip:
            # long_500k: skipped with JAX's own reason
            assert r["status"] == "skip" and r["reason"] == jspecs[r["arch"]].skip[r["shape"]]
            continue
        assert r["status"] == "ok", r
        one = r["one_rank"]
        assert one["status"] == "not_run"
        assert ("reduced" in one) == (r["shape"] == "train_4k")   # the LM train steps
        if r["arch"] == "peacock-lda":
            # Φ or P̂ of one rank at V = 210,000: 84 GB
            assert one["fits_80gb_hbm"] is False and one["arguments_bytes"] > 84e9
            assert r["arguments_fit_80gb_hbm"]
        chips = 512 if r["mesh"] == "2x16x16" else 256
        assert r["chips"] == chips
        want = r["model_flops"] / (chips * dryrun.F32_FLOPS)
        assert math.isclose(r["roofline"]["compute_s"], want)
    lda = [r for r in recs if r["arch"] == "peacock-lda" and r["shape"] == "train_segment"]
    assert {r["mesh"] for r in lda} == {"16x16", "2x16x16"}
    assert all("sampler_traffic" in r for r in lda)


def test_cli_verify_names_its_roadmap_item():
    """--verify is the launch gate on the default P = 2 alias session: exit
    0, and --json the report with the five passes (the subprocess holds no
    jax)."""
    proc = _run_cli("--verify", "--json")
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    doc = json.loads(proc.stdout)
    assert doc["ok"] is True
    assert [p["pass"] for p in doc["passes"]] == ["sharding", "smem", "determinism",
                                                  "concurrency", "lint"]
    sharding = doc["session"]["sharding"]
    assert sharding["ppermute_formula"] == 12
    assert (sharding["ppermute_counted"], sharding["model_gathers_counted"]) == ([8] * 4, [2] * 4)
    table = _run_cli("--shard-table", "--json")
    assert table.returncode == 0
    rows = json.loads(table.stdout)["shard_table"]["rows"]
    assert [r["fits_80gb_hbm"] for r in rows] == [False, True, True, True]
