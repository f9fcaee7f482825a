"""The dry run's mirror world (``launch.mesh.mirror_ranks``): one rank of a
production mesh run alone, every other rank taken to hold its values.

- Each collective of ``dist.collectives`` on a mirror layout equals a real
  gloo world in which every rank passes the same tensor: integers bit for
  bit, floats within rtol 1e-6, on every rank of (1, 2, 2) and (2, 1, 2).
- ``mirror_ranks``' rank lists are ``init_ranks``' at (1, 2, 2), (2, 1, 2)
  and (2, 2, 2).
- For one small cell of each family (recsys, GNN, dense LM, MoE LM, LDA
  ``train_segment`` and its optimized form, LDA ``serve_rt``) rank 0's
  mirror step on ``Cell.rank_args`` issues the collective log of rank 0 of
  the real gloo world on the global arguments' views (in order: primitive,
  shape, dtype, bytes), and its outputs have the same shapes.
- LDA ``train_segment``'s collectives by primitive are JAX's
  ``trace_cost(...).collectives`` of its own cell at the same mesh.
- ``rank_args`` draws every block at ``make_args``' block shape and dtype,
  with ids, word rows and edges in range, and LDA counts that no rank epoch
  takes below zero; an LM train cell's rank cut folds its loop's
  collectives back to the whole step's.
- ``launch.dryrun --device cpu`` records ``rank_step`` ok for small cells,
  ``--device meta`` records it ``not_run``.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_ranks as R
from _torch_port import one_torch_thread as _one_torch_thread  # noqa: F401  (autouse)
from repro_torch.configs import base as tbase, peacock_lda as tpl, recsys_archs as tra
from repro_torch.core import sparse as tsparse
from repro_torch.dist import analysis as tan, sharding as shd
from repro_torch.launch import dryrun, mesh

pytestmark = pytest.mark.port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = [(1, 2, 2), (2, 1, 2)]


@pytest.fixture(scope="module")
def worlds():
    """Each mesh of ``MESHES`` and (2, 2, 2) as a real gloo world: every
    rank's groups, primitives and (not at (2, 2, 2)) small cells."""
    out = {}
    for shape in MESHES + [(2, 2, 2)]:
        names = R.MIRROR_CELLS if shape in MESHES else ()
        out[shape] = mesh.spawn(R.mirror_world_body, pods=shape[0], data=shape[1],
                                model=shape[2], device="cpu", args=(names,), threads=1,
                                timeout_s=R.TIMEOUT_S)
    return out


def _held(got, want, where):
    """Integers bit for bit, floats within rtol 1e-6 (nested dicts, lists)."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for k in want:
            _held(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            _held(a, b, f"{where}[{i}]")
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.shape == want.shape and got.dtype == want.dtype, where
        if np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got, want, err_msg=where)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0, err_msg=where)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_mirror_primitives_equal_a_world_passing_one_tensor(worlds, shape):
    for rank, res in enumerate(worlds[shape]):
        layout = mesh.mirror_ranks(*shape, rank=rank, device="cpu")
        _held(R.mirror_primitives(layout), res["primitives"], f"rank {rank}")


@pytest.mark.parametrize("shape", MESHES + [(2, 2, 2)], ids=lambda s: "x".join(map(str, s)))
def test_mirror_groups_are_init_ranks_groups(worlds, shape):
    for rank, res in enumerate(worlds[shape]):
        layout = mesh.mirror_ranks(*shape, rank=rank, device="cpu")
        assert layout.backend == "mirror" and layout.rank == rank
        assert all(layout.group(n)[0] is None for n in R.MIRROR_GROUPS)
        assert R.mirror_groups(layout) == res["groups"], rank


def test_mirror_layout_never_enters_torch_distributed(monkeypatch):
    """A mirror layout's collectives touch neither ``torch.distributed`` nor
    a card's workspaces (``_card``, ``_CardGroup``)."""
    import torch.distributed as dist
    from repro_torch.dist import collectives as coll

    def refuse(*args, **kw):
        raise AssertionError("a mirror layout entered torch.distributed or a card group")

    for name in ("all_reduce", "all_gather", "reduce_scatter_tensor", "batch_isend_irecv",
                 "barrier", "all_gather_object", "get_rank"):
        monkeypatch.setattr(dist, name, refuse)
    monkeypatch.setattr(coll, "_card", refuse)
    monkeypatch.setattr(coll, "_CardGroup", refuse)
    assert not dist.is_initialized()
    R.mirror_primitives(mesh.mirror_ranks(2, 2, 2, rank=5, device="cpu"))


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name", R.MIRROR_CELLS)
def test_mirror_cell_step_issues_rank0s_collectives(worlds, shape, name):
    layout = mesh.mirror_ranks(*shape, device="cpu")
    got = R.mirror_cells(layout, [name])[name]
    want = worlds[shape][0]["cells"][name]
    assert got[0] == want[0], name
    assert got[1] == want[1], name
    assert got[0], f"{name}: no collective"


JAX_COUNTS = r"""
import json
from repro.configs import get_arch
from repro.dist import analysis
from repro.launch.mesh import make_test_mesh
out = {}
for name, mesh, mp in (("1x2x2", make_test_mesh(2, 2), False),
                       ("2x1x2", make_test_mesh(1, 2, n_pod=2), True)):
    for shape in ("train_segment", "train_segment_opt"):
        cell = get_arch("peacock-lda").cell(shape, mesh, mp)
        out[name + "/" + shape] = dict(analysis.trace_cost(cell.fn, *cell.args).collectives)
print("RESULT" + json.dumps(out))
"""


def test_lda_train_collective_counts_equal_jax_trace_cost():
    """JAX's own train_segment cells at (1, 2, 2) and (2, 1, 2) against the
    port's mirror step of the same ring (JAX traces its production cell
    abstractly; the port runs a small ring of the same M, whose
    collectives by primitive do not depend on the widths)."""
    from conftest import run_with_devices

    out = run_with_devices(JAX_COUNTS, n_devices=4, timeout=600)
    want = json.loads(next(ln for ln in out.splitlines() if ln.startswith("RESULT"))[6:])
    for shape in MESHES:
        layout = mesh.mirror_ranks(*shape, device="cpu")
        for name, jshape in (("lda_train", "train_segment"),
                             ("lda_train_opt", "train_segment_opt")):
            cell = R.mirror_cell(name, layout)
            cost, _ = tan.count_cost(cell.fn, *cell.rank_args(torch.Generator().manual_seed(0),
                                                              "cpu", layout))
            key = "x".join(map(str, shape)) + "/" + jshape
            assert cost.collectives == want[key], key
            M = shape[1] * shape[2]
            assert cost.collectives == {"ppermute": 4.0 * M, "psum": 1.0}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _block_leaves(tree, spec, layout):
    """(block shape, dtype) of each tensor leaf of ``make_args``' meta tree."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _block_leaves(tree[k], spec[k], layout)]
    if isinstance(tree, (list, tuple)):
        return [x for a, s in zip(tree, spec) for x in _block_leaves(a, s, layout)]
    if isinstance(tree, torch.Tensor):
        return [(shd.block_shape(tree.shape, spec, layout), tree.dtype)]
    return []


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name", R.MIRROR_CELLS)
def test_rank_args_are_blocks_of_make_args(shape, name):
    """Every drawn tensor has its block's shape and ``make_args``' dtype
    (beta and the seed, Python scalars in ``make_args``, are a 0-d f32
    tensor and an int)."""
    layout = mesh.mirror_ranks(*shape, device="cpu")
    cell = R.mirror_cell(name, layout)
    meta = cell.make_args(None, "meta")
    drawn = cell.rank_args(torch.Generator().manual_seed(1), "cpu", layout)
    want = [x for a, s in zip(meta, cell.arg_specs) for x in _block_leaves(a, s, layout)]
    got = [(tuple(t.shape), t.dtype) for t in _leaves(list(drawn))
           if isinstance(t, torch.Tensor)]
    if cell.step_kind == "lda_train":     # the seed: an int, as make_args draws it
        assert isinstance(drawn[8], int) and want[-1] == ((), torch.int32)
        want = want[:-1]
    assert got == want, name


@pytest.mark.parametrize("shape", MESHES + [(1, 4, 1)], ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("optimized", [False, True], ids=["dense", "optimized"])
def test_lda_rank_counts_never_go_negative(monkeypatch, shape, optimized):
    """A rank epoch in the mirror world from ``rank_args``: after every
    package Φ and Ψ stay ≥ 0; at the end Φ still counts the sampled
    sub-block's valid tokens and Ψ keeps its total (ring × the stack's)."""
    layout = mesh.mirror_ranks(*shape, device="cpu")
    cfg = R.mirror_ring_config(layout, optimized)
    cell = tpl.train_cell(cfg, layout, n_pods=shape[0])
    args = cell.rank_args(torch.Generator().manual_seed(3), "cpu", layout)
    phi, psi, wl, z = args[0], args[1], args[2], args[5]
    ring = shape[1] * shape[2]
    me = shd.flat_ring_index(layout)
    stack_z = z.reshape(-1, cfg.cap).long()
    np.testing.assert_array_equal(psi.reshape(-1).numpy(),
                                  ring * np.bincount(stack_z.reshape(-1).numpy(),
                                                     minlength=cfg.n_topics))
    assert int(phi.sum()) == cfg.cap and int(phi.min()) >= 0
    assert int(wl.max()) < cfg.rows_per_shard and int(args[3].max()) < cfg.docs_per_shard
    np.testing.assert_array_equal(
        args[4].reshape(-1).numpy(),
        np.arange(me * ring * cfg.cap, (me + 1) * ring * cfg.cap))
    real, seen = tsparse.move_counts, []

    def checked(phi_, psi_, *rest):
        out = real(phi_, psi_, *rest)
        seen.append((int(phi_.min()), int(psi_.min())))
        return out

    monkeypatch.setattr(tsparse, "move_counts", checked)
    psi_total = int(psi.sum())
    cell.fn(*args)
    assert len(seen) == ring * cfg.cap // cfg.package_len
    assert min(min(s) for s in seen) >= 0
    assert int(phi.sum()) == cfg.cap and int(phi.min()) >= 0
    assert int(psi.sum()) == psi_total and int(psi.min()) >= 0


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_rank_args_ids_edges_and_r_cache_in_range(shape):
    layout = mesh.mirror_ranks(*shape, device="cpu")
    g = lambda: torch.Generator().manual_seed(2)
    # recsys: each field's ids within its vocabulary
    cell = R.mirror_cell("recsys_train", layout)
    ids = cell.rank_args(g(), "cpu", layout)[4]
    vocab = torch.tensor(tra.small_recsys()["dlrm-mlperf"].embedding.vocab_sizes)
    assert bool(((ids >= 0) & (ids < vocab[None, :])).all())
    # GNN: edges between real nodes or at the last padded one, in [0, N)
    cell = R.mirror_cell("gnn_full", layout)
    feats, src, dst, labels, mask = cell.rank_args(g(), "cpu", layout)[2:]
    N = cell.make_args(None, "meta")[2].shape[0]
    for e in (src, dst):
        assert int(e.min()) >= 0 and int(e.max()) < N
    assert set(mask.unique().tolist()) <= {0.0, 1.0}
    cell = R.mirror_cell("gnn_sampled", layout)
    feats, neigh, labels = cell.rank_args(g(), "cpu", layout)[2:]
    sizes = [f.shape[0] * layout.world_size for f in feats]
    for i, nb in enumerate(neigh):
        assert int(nb.min()) >= -1 and int(nb.max()) < sizes[i + 1]
    # LM: tokens within the vocabulary
    for name in ("lm_train", "moe_decode"):
        cell = R.mirror_cell(name, layout)
        args = cell.rank_args(g(), "cpu", layout)
        toks = args[2] if name == "lm_train" else args[1]
        assert int(toks.min()) >= 0 and int(toks.max()) < 251
    # serve_rt: the ring's sum of any R topic stays a topic; P̂ a distribution
    # over the mirror world's table
    cell = R.mirror_cell("lda_serve", layout)
    pvk, alpha, r_topic, r_value, words = cell.rank_args(g(), "cpu", layout)
    ring = shape[1] * shape[2]
    assert int(r_topic.max()) * ring < 60 and bool((pvk > 0).all())
    np.testing.assert_allclose((pvk.sum(0) * ring).numpy(), 1.0, rtol=1e-5)
    assert int(words.min()) >= -1 and int(words.max()) < 512 and bool((words[:, 0] >= 0).all())


@pytest.mark.parametrize("name", ["lm_train", "moe_train"])
def test_lm_rank_cut_folds_the_loop_to_the_whole_step(name):
    """The rank cut runs 1 of the n_micro microbatches: its folded
    collectives (the loop's × n_micro) are the whole step's as counted, in
    calls and bytes; AdamW's in-place update writes the donated buffers."""
    layout = mesh.mirror_ranks(1, 2, 2, device="cpu")
    cell = R.mirror_cell(name, layout)
    cut = cell.rank_cut()
    assert cut.reduced.startswith(f"1 of the global batch's ") and "folded" in cut.reduced
    args = cell.rank_args(torch.Generator().manual_seed(0), "cpu", layout)
    full, _ = tan.count_cost(cell.fn, *args)
    args = cell.rank_args(torch.Generator().manual_seed(0), "cpu", layout)
    params = args[0]
    part, out = tan.count_cost(cut.fn, *args)
    assert out[0]["embed"] is params["embed"] and out[1]["m"]["embed"] is args[1]["m"]["embed"]
    assert part.folded_collectives == full.collectives
    assert part.folded_collective_bytes == pytest.approx(full.collective_bytes, rel=1e-12)
    assert full.folded_collective_bytes == full.collective_bytes
    assert sum(part.collectives.values()) < sum(full.collectives.values())


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


def test_cli_rank_step_on_the_cpu_and_on_meta():
    """graphsage-reddit's molecule cell at both production meshes: on the
    CPU its rank step runs (no time or memory measured), counted, with its
    collectives by primitive and JAX's roofline rule for the collective
    term; ``--rank-steps 16x16`` leaves the 2×16×16 one out; on ``meta`` no
    rank step runs."""
    proc = _run_cli("--arch", "graphsage-reddit", "--shape", "molecule", "--both-meshes",
                    "--device", "cpu", "--json")
    assert proc.returncode == 0, proc.stderr[-3000:]
    recs = [json.loads(ln) for ln in proc.stdout.splitlines()]
    assert [r["mesh"] for r in recs] == ["16x16", "2x16x16"]
    for r in recs:
        rs = r["rank_step"]
        assert rs["status"] == "ok", rs
        assert rs["step_ms"] is None and rs["measured"] == "not measured: no card"
        assert rs["cost"]["flops"] > 0 and "embedding_bag_bwd" in rs["cost"]["kernels"]
        assert set(rs["collectives"]) == {"all_gather", "psum", "reduce_scatter"}
        assert rs["collectives"] == rs["collectives_folded"]
        assert rs["collective_bytes"] == sum(v["bytes"] for v in rs["collectives"].values())
        traced = rs["collective_bytes"] * r["chips"]
        assert r["collective_bytes_traced"] == traced
        want = max(r["model_coll_bytes"], traced) / (r["chips"] * dryrun.NVLINK_BYTES_PER_S)
        assert r["roofline"]["collective_s"] == pytest.approx(want, rel=1e-12)
        assert all(n == 0 for n in rs["launches"].values())       # the plain versions
    proc = _run_cli("--arch", "graphsage-reddit", "--shape", "molecule", "--both-meshes",
                    "--device", "cpu", "--json", "--rank-steps", "16x16", "--skip-cost")
    recs = [json.loads(ln) for ln in proc.stdout.splitlines()]
    assert recs[0]["rank_step"]["status"] == "ok" and "collectives" not in recs[0]["rank_step"]
    assert recs[1]["rank_step"] == {"status": "not_run", "reason": "--rank-steps 16x16"}
    proc = _run_cli("--all", "--device", "meta", "--json")
    assert proc.returncode == 0, proc.stderr[-3000:]
    for r in (json.loads(ln) for ln in proc.stdout.splitlines()):
        if r["status"] == "ok":
            assert r["rank_step"]["status"] == "not_run"
            assert r["rank_step"]["reason"] == "--device meta: no step runs"
            assert "collective_bytes_traced" not in r


def test_rank_selected():
    sel = dryrun.rank_selected
    assert sel("all", "dlrm-mlperf", "serve_p99", "2x16x16")
    assert not sel("none", "dlrm-mlperf", "serve_p99", "16x16")
    which = "16x16,peacock-lda,xdeepfm@2x16x16,din/serve_p99@2x16x16,-qwen3-0.6b/train_4k"
    assert sel(which, "dlrm-mlperf", "serve_p99", "16x16")
    assert sel(which, "peacock-lda", "serve_rt", "2x16x16")
    assert sel(which, "xdeepfm", "train_batch", "2x16x16")
    assert sel(which, "din", "serve_p99", "2x16x16")
    assert not sel(which, "din", "train_batch", "2x16x16")
    assert not sel(which, "dlrm-mlperf", "serve_p99", "2x16x16")
    assert sel(which, "qwen3-0.6b", "decode_32k", "16x16")
    assert not sel(which, "qwen3-0.6b", "train_4k", "16x16")
    assert not sel("all,-autoint@16x16", "autoint", "serve_p99", "16x16")


def test_rank_step_records_a_failed_step():
    """A rank step that raises is a recorded ``fail`` naming the error, as a
    one-rank step's is; the mesh record stays ok."""
    def boom(generator, device, layout):
        raise RuntimeError("no draw")

    def build(shape, layout):
        return dataclasses.replace(R.small_cell(("gnn", shape, R.GNN_TINY[shape]), layout),
                                   rank_args=boom)

    spec = tbase.ArchSpec("sage-small", "gnn", R.GNN_TINY, build)
    rec = dryrun.run_cell(spec, "full_graph_sm", False, None, dryrun.RankStep("cpu"))
    assert rec["status"] == "ok" and "collective_bytes_traced" not in rec
    assert rec["rank_step"]["status"] == "fail"
    assert rec["rank_step"]["error"] == "RuntimeError: no draw"
