"""Port conformance of the recsys cells across ranks (``configs.base.
build_recsys_cell`` with a ``RankLayout``): the tables row-sharded over
"model" (``models.recsys.ShardedReads``), the batch split over "dp", held
against the JAX package's GSPMD-partitioned cells of the same small configs.

One JAX subprocess on 4 XLA host devices runs JAX's own cells under
``jax.jit`` with the cells' in/out shardings (inside
``repro.dist.sharding.ambient_mesh_scope``); two spawned gloo worlds (4
ranks, then 2) run the port's steps on each rank's views of the same global
arguments (parameters drawn with numpy by ``init_params``' law, carried
across by ``convert``):

- all four archs' train (3 steps, f32 tables) and serve (bf16 tables) at
  (1, 2, 2), din's train at (2, 1, 2) (two pods: "dp" is (pod, data)):
  against JAX, with ``test_torch_recsys_train.py``'s tolerances: the cell
  tolerance rtol 1e-5, atol 1e-6 (the dense gradients are summed over ranks
  in another order than one device's), the forward's 1e-5;
- at (1, 1, 4) and (1, 1, 2) (no data split) each step equals the port's
  one-rank step bit for bit: a shard reads its rows through the kernel and
  sums its gradient rows in the one-rank order; retrieval at (1, 1, 2)
  merges the two slices' top-k into the one-rank top-k, ties included;
- every replica of a table shard and of every dense parameter and moment is
  bit-identical after the steps (``assemble_checked``);
- the collectives ``count_cost`` counts on each rank equal the port's own
  formula (``port_collectives``), beside JAX's ``model_coll_bytes``.
"""
import pickle

import numpy as np
import pytest

import _torch_ranks as R
from _torch_port import one_torch_thread as _one_torch_thread  # noqa: F401  (autouse)
from repro_torch.configs import recsys_archs as tra
from repro_torch.dist import sharding as shd
from repro_torch.launch import mesh

pytestmark = pytest.mark.port

ARCHS = ["dlrm-mlperf", "xdeepfm", "din", "autoint"]
CELL_TOL = dict(rtol=1e-5, atol=1e-6)
SERVE_TOL = dict(rtol=1e-5, atol=1e-5)
B, B_SERVE, STEPS = 64, 24, 3
N_CAND, D_CAND = 3000, 8


def _raw(arch, seed=3):
    """Parameters of ``small_recsys()[arch]`` drawn with numpy by the init
    law of both packages' ``init_params`` (biases 0, tables N(0, 1/dim),
    other weights N(0, 2/fan_in)), f32."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, s in sorted(tra.small_recsys()[arch].param_shapes().items()):
        if name.split("/")[-1].startswith("b"):
            out[name] = np.zeros(s, np.float32)
        elif len(s) == 2 and name.endswith("table"):
            out[name] = (rng.normal(size=s) / np.sqrt(s[1])).astype(np.float32)
        else:
            fan_in = s[0] if len(s) >= 2 else 1
            out[name] = (rng.normal(size=s) * np.sqrt(2.0 / fan_in)).astype(np.float32)
    return out


def _train_args(arch, raw, seed):
    cfg = tra.small_recsys()[arch]
    dense = {k: v for k, v in raw.items() if not (k.endswith("table") or k == "linear_w")}
    zeros = {k: np.zeros_like(v) for k, v in dense.items()}
    state = {"step": np.zeros((), np.int32), "m": zeros, "v": dict(zeros)}
    labels = np.random.default_rng(seed).integers(0, 2, B).astype(np.float32)
    return (raw, state, labels, *R.recsys_inputs(arch, cfg, seed, B))


def _serve_args(arch, raw, seed):
    return (raw, *R.recsys_inputs(arch, tra.small_recsys()[arch], seed + 10, B_SERVE))


def _retrieval_args():
    rng = np.random.default_rng(3)
    return ({}, rng.normal(size=(1, D_CAND)).astype(np.float32),
            rng.normal(size=(N_CAND, D_CAND)).astype(np.float32))


@pytest.fixture(scope="module")
def runs():
    """label → (mesh, build, global numpy args, steps) of the 4-rank and
    the 2-rank worlds."""
    pytest.importorskip("jax")
    raws = {arch: _raw(arch) for arch in ARCHS}
    four, two = {}, {}
    for i, arch in enumerate(ARCHS):
        train = ("recsys", arch, "train_batch", "float32")
        four[f"{arch}/train/122"] = ((1, 2, 2), train, _train_args(arch, raws[arch], i), STEPS)
        four[f"{arch}/serve/122"] = ((1, 2, 2), ("recsys", arch, "serve_p99", "bfloat16"),
                                     _serve_args(arch, raws[arch], i), 1)
        four[f"{arch}/train/114"] = ((1, 1, 4), train, _train_args(arch, raws[arch], i), STEPS)
    four["din/train/212"] = ((2, 1, 2), ("recsys", "din", "train_batch", "float32"),
                             _train_args("din", raws["din"], 7), STEPS)
    two["dlrm-mlperf/train/112"] = ((1, 1, 2), ("recsys", "dlrm-mlperf", "train_batch", "bfloat16"),
                                    _train_args("dlrm-mlperf", raws["dlrm-mlperf"], 5), STEPS)
    two["din/serve/112"] = ((1, 1, 2), ("recsys", "din", "serve_p99", "bfloat16"),
                            _serve_args("din", raws["din"], 5), 1)
    two["retrieval/112"] = ((1, 1, 2), ("recsys", "autoint", "retrieval_cand", "float32"),
                            _retrieval_args(), 1)
    # every candidate scores the same: the merge must keep the lower ids
    two["retrieval/112/tied"] = ((1, 1, 2), ("recsys", "autoint", "retrieval_cand", "float32"),
                                 ({}, np.ones((1, 4), np.float32), np.ones((200, 4), np.float32)),
                                 1)
    return four, two


JAX_CELLS = r"""
import pickle
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import base as jbase, recsys_archs as jra
from repro.dist import sharding as jshd
from repro.models import recsys as jrec

FWD = %(FWD)r
FLOPS = %(FLOPS)r
with open(IN, "rb") as f:
    runs = pickle.load(f)
out = {}
for label, (shape, build, args, steps) in runs.items():
    _, arch, cell_shape, tdt = build
    multi_pod = shape[0] > 1
    dims, names = (shape, ("pod", "data", "model")) if multi_pod else \
        (shape[1:], ("data", "model"))
    mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(dims), names)
    cfg = jra.small_recsys()[arch]
    maker = {"dlrm-mlperf": jra._dlrm_inputs, "din": jra._din_inputs}.get(
        arch, jra._sparse_inputs(getattr(cfg, "embedding", None) and cfg.embedding.n_fields))
    cell = jbase.build_recsys_cell(cfg, getattr(jrec, FWD[arch]), maker,
                                   getattr(jra, FLOPS[arch]), cell_shape, mesh, multi_pod)
    fn = jax.jit(cell.fn, in_shardings=cell.in_shardings, out_shardings=cell.out_shardings)
    params = {k: jnp.asarray(v).astype(jnp.dtype(tdt) if k.endswith("table") else jnp.float32)
              for k, v in args[0].items()}
    with jshd.ambient_mesh_scope(mesh, multi_pod):
        if cell.step_kind == "retrieval":
            s, i = fn(*map(jnp.asarray, args[1:]))
            out[label + "/scores"], out[label + "/ids"] = np.asarray(s), np.asarray(i)
        elif cell.step_kind == "serve":
            out[label + "/out"] = np.asarray(fn(params, *map(jnp.asarray, args[1:])).astype(
                jnp.float32))
        else:
            state = jax.tree.map(jnp.asarray, args[1])
            rest = [jnp.asarray(a) for a in args[2:]]
            for step in range(steps):
                params, state, loss = fn(params, state, *rest)
                out[f"{label}/loss{step}"] = np.asarray(loss)
            out.update({f"{label}/p/{k}": np.asarray(v.astype(jnp.float32))
                        for k, v in params.items()})
            out.update({f"{label}/{part}/{k}": np.asarray(v)
                        for part in ("m", "v") for k, v in state[part].items()})
np.savez(OUT, **out)
"""


@pytest.fixture(scope="module")
def results(runs, tmp_path_factory):
    """(port, jax_out), made one after another (so the module holds one
    world or one subprocess at a time): the port's 4-rank and 2-rank worlds
    (label → each rank's outputs, losses, collectives, bytes) and JAX's
    sharded cells of the runs held against JAX (not the bit-for-bit (1, 1, M)
    ones) in one subprocess on 4 host devices."""
    from conftest import run_with_devices

    four, two = runs
    wanted = {k: v for k, v in {**four, **two}.items()
              if "/122" in k or "/212" in k or k == "retrieval/112"}
    path = tmp_path_factory.mktemp("recsys_ranks") / "runs.pkl"
    with open(path, "wb") as f:
        pickle.dump(wanted, f)
    code = f"IN = {str(path)!r}\n" + JAX_CELLS % dict(FWD=R.RECSYS_FORWARDS,
                                                        FLOPS=R.RECSYS_FLOPS)

    def world(runs, data, model):
        res = mesh.spawn(R.cells_across_ranks, data=data, model=model, device="cpu",
                         args=(runs,), threads=1, timeout_s=R.TIMEOUT_S)
        return {label: [r[label] for r in res] for label in runs}

    port = {**world(four, 2, 2), **world(two, 1, 2)}
    return port, R.jax_run(run_with_devices, code, n_devices=4)


@pytest.fixture(scope="module")
def port(results):
    return results[0]


@pytest.fixture(scope="module")
def jax_out(results):
    return results[1]


def assemble_checked(views, spec, layout):
    """The global array from the ranks' views, after checking that every
    rank holding the same block holds the same bits."""
    first = {}
    for r, v in enumerate(views):
        key = tuple(i for _, i in shd.block_index(spec, layout, r))
        if key in first:
            assert np.asarray(v).tobytes() == np.asarray(views[first[key]]).tobytes(), \
                f"rank {r}'s block {key} differs from rank {first[key]}'s"
        else:
            first[key] = r
    return shd.assemble(views, spec, layout)


def _assembled(label, runs, port):
    """(params, m, v) or the output, assembled from the ranks' views."""
    shape, build, _, _ = {**runs[0], **runs[1]}[label]
    lay = shd.RankLayout(*shape)
    cell = R.small_cell(build, lay)
    ranks = port[label]
    if cell.step_kind == "train":
        pspec, ospec = cell.arg_specs[0], cell.arg_specs[1]
        params = {k: assemble_checked([r[0][0][k] for r in ranks], pspec[k], lay)
                  for k in ranks[0][0][0]}
        state = {part: {k: assemble_checked([r[0][1][part][k] for r in ranks], ospec[part][k], lay)
                        for k in ranks[0][0][1][part]} for part in ("m", "v")}
        for r in ranks:
            assert r[1] == ranks[0][1]                      # the same loss on every rank
        return params, state
    if cell.step_kind == "serve":
        return assemble_checked([r[0] for r in ranks], (shd.dp_axes(lay.pods > 1),), lay)
    for r in ranks:
        for got, want in zip(r[0], ranks[0][0]):
            assert got.tobytes() == want.tobytes()          # the merged top-k on every rank
    return ranks[0][0]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_across_ranks_equals_jax_sharded_cell(runs, port, jax_out, arch):
    """(1, 2, 2): the loss of each step, every updated table row-slice and
    dense parameter and the AdamW moments, against JAX's GSPMD cell."""
    label = f"{arch}/train/122"
    params, state = _assembled(label, runs, port)
    losses = port[label][0][1]
    np.testing.assert_allclose(losses, [float(jax_out[f"{label}/loss{i}"]) for i in range(STEPS)],
                               **CELL_TOL)
    for k, v in params.items():
        np.testing.assert_allclose(v, jax_out[f"{label}/p/{k}"], **CELL_TOL, err_msg=k)
    for part in ("m", "v"):
        for k, v in state[part].items():
            np.testing.assert_allclose(v, jax_out[f"{label}/{part}/{k}"], **CELL_TOL,
                                       err_msg=f"{part}/{k}")


def test_train_on_two_pods_equals_jax_sharded_cell(runs, port, jax_out):
    """din at (2, 1, 2): the batch split over (pod, data), the tables over
    "model", against JAX's multi-pod cell."""
    label = "din/train/212"
    params, state = _assembled(label, runs, port)
    np.testing.assert_allclose(port[label][0][1],
                               [float(jax_out[f"{label}/loss{i}"]) for i in range(STEPS)],
                               **CELL_TOL)
    for k, v in params.items():
        np.testing.assert_allclose(v, jax_out[f"{label}/p/{k}"], **CELL_TOL, err_msg=k)
    for k, v in state["v"].items():
        np.testing.assert_allclose(v, jax_out[f"{label}/v/{k}"], **CELL_TOL, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_across_ranks_equals_jax_sharded_cell(runs, port, jax_out, arch):
    label = f"{arch}/serve/122"
    np.testing.assert_allclose(_assembled(label, runs, port), jax_out[f"{label}/out"],
                               **SERVE_TOL)


def _one_rank(label, runs):
    shape, build, args, steps = {**runs[0], **runs[1]}[label]
    cell = R.small_cell(build)
    out, losses, _ = R.run_cell(cell, R.cell_args(build, args), steps)
    return R.to_numpy(out), losses


def _bitwise(a, b, what):
    assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), what


@pytest.mark.parametrize("label", [f"{a}/train/114" for a in ARCHS] +
                         ["dlrm-mlperf/train/112", "din/serve/112"])
def test_one_data_shard_equals_the_one_rank_step_bit_for_bit(runs, port, label):
    """(1, 1, M): the tables split M ways, the batch whole on every rank:
    every loss, table, dense parameter and moment (or the served logits)
    bit for bit with the port's one-rank step."""
    want, losses = _one_rank(label, runs)
    got = _assembled(label, runs, port)
    if "/serve/" in label:
        _bitwise(got, want, label)
        return
    assert port[label][0][1] == losses
    for k, v in got[0].items():
        _bitwise(v, want[0][k], k)
    for part in ("m", "v"):
        for k, v in got[1][part].items():
            _bitwise(v, want[1][part][k], f"{part}/{k}")


def test_retrieval_merge_equals_one_rank_and_jax(runs, port, jax_out):
    """Candidates split over "model" at (1, 1, 2): the merged top-k equals
    the one-rank ``retrieval_scores`` bit for bit (ids and scores) and JAX's
    sharded cell within the forward tolerance (ids exactly)."""
    label = "retrieval/112"
    s, i = _assembled(label, runs, port)
    (ws, wi), _ = _one_rank(label, runs)
    _bitwise(s, ws, "scores")
    _bitwise(i, wi, "ids")
    np.testing.assert_allclose(s, jax_out[label + "/scores"], **SERVE_TOL)
    np.testing.assert_array_equal(i, jax_out[label + "/ids"])


def test_retrieval_merge_keeps_lower_ids_first_on_ties(runs, port):
    """Equal scores across two slices merge lower id first, as one rank's
    stable top-k: 200 candidates that all score the same, so the top 100 are
    ids 0 … 99, all of the rank holding rows 0 … 99, equal to one rank's."""
    s, i = _assembled("retrieval/112/tied", runs, port)
    np.testing.assert_array_equal(i, np.arange(100, dtype=np.int32)[None])
    assert np.all(s == s[0, 0])
    (_, wi), _ = _one_rank("retrieval/112/tied", runs)
    _bitwise(i, wi, "ids")


def _reads(arch, cfg):
    """(items a sample, width, table dtype's bytes if the table's, else
    None) of each table read of ``arch``'s forward."""
    if arch == "din":
        return [(1 + cfg.seq_len, cfg.embed_dim), (cfg.n_context, cfg.embed_dim)]
    F, D = cfg.embedding.n_fields, cfg.embedding.dim
    return [(F, D)] + ([(F, 1)] if arch == "xdeepfm" else [])


def _read_bytes(arch, b_local, table_bytes):
    """Each table read's [b, items, width] rows in bytes: the table's dtype,
    but f32 for xdeepfm's ``linear_w`` (its second read)."""
    reads = _reads(arch, tra.small_recsys()[arch])
    return [b_local * items * width * (4 if j else table_bytes) if arch == "xdeepfm" else
            b_local * items * width * table_bytes for j, (items, width) in enumerate(reads)]


def port_collectives(arch, b_local, table_bytes, n_dense, n_dp):
    """The port's collectives of one train step on one rank (calls, payload
    bytes by JAX primitive name): forward, each table read's sum over
    "model" ([b, items, width] in the table's dtype; xdeepfm's ``linear_w``
    is f32); the loss's sum over "dp"; backward, where the batch is split
    (``n_dp`` > 1), each read's all_gather over "dp" of its cotangent rows
    and its ids; the dense gradients' one sum over "dp"."""
    reads = _reads(arch, tra.small_recsys()[arch])
    rows = _read_bytes(arch, b_local, table_bytes)
    ids = [b_local * items * 4 for items, _ in reads]
    psum = ({"psum": len(reads) + 2.0}, {"psum": float(sum(rows) + 4 + 4 * n_dense)})
    if n_dp == 1:
        return psum
    return ({**psum[0], "all_gather": 2.0 * len(reads)},
            {**psum[1], "all_gather": float(sum(rows) + sum(ids))})


@pytest.mark.parametrize("label", [f"{a}/train/122" for a in ARCHS] + ["din/train/212"] +
                         [f"{a}/train/114" for a in ARCHS] + ["dlrm-mlperf/train/112"])
def test_collectives_of_a_train_step_match_the_ports_formula(runs, port, label):
    """Each rank's collectives in its first step (``count_cost``) equal
    ``port_collectives``; JAX's ``model_coll_bytes`` (the dense table
    gradient's reduce) stays the cell's formula and exceeds them."""
    shape, build, args, _ = {**runs[0], **runs[1]}[label]
    arch = build[1]
    n_dp = shape[0] * shape[1]
    n_dense = sum(v.size for k, v in args[0].items()
                  if not (k.endswith("table") or k == "linear_w"))
    want = port_collectives(arch, B // n_dp, 2 if build[3] == "bfloat16" else 4, n_dense, n_dp)
    for r in port[label]:
        assert (r[2], r[3]) == want, (label, r[2], r[3])
    cell = R.small_cell(build, shd.RankLayout(*shape))
    assert cell.model_coll_bytes > sum(want[1].values())


def test_serve_and_retrieval_collectives(runs, port):
    """A serve step sums each table read over "model"; retrieval gathers
    each rank's counts and top-k (scores and ids) over "model"."""
    for label in [f"{a}/serve/122" for a in ARCHS] + ["din/serve/112"]:
        shape, build, _, _ = {**runs[0], **runs[1]}[label]
        rows = _read_bytes(build[1], B_SERVE // shape[1], 2)
        for r in port[label]:
            assert (r[2], r[3]) == ({"psum": float(len(rows))}, {"psum": float(sum(rows))})
    for label, n in (("retrieval/112", N_CAND), ("retrieval/112/tied", 200)):
        k = min(100, n // 2)                # each rank's entries: min(top_k, its rows)
        for r in port[label]:
            assert (r[2], r[3]) == ({"all_gather": 4.0}, {"all_gather": 2 * 8.0 + 2 * k * 4.0})
