"""Port conformance of graphsage-reddit's cells across ranks
(``configs.base.build_gnn_cell`` with a ``RankLayout``): node and edge rows
split over every mesh axis (``sharding.gnn_rows_spec``), the weights
replicated, held against the JAX package's GSPMD-partitioned cells.

The four cells (full_graph_sm, minibatch_lg, ogb_products, molecule) at
``small_gnn()``'s widths on small shapes (nodes spread over every rank; 32
molecules of 30 atoms, so graphs straddle ranks) run 3 steps at (1, 2, 2)
and (1, 1, 2): JAX's cells under ``jax.jit`` with their in/out shardings
(inside ``repro.dist.sharding.ambient_mesh_scope``) on 4 XLA host devices,
the port's in a spawned gloo world of 4 ranks and one of 2, on each rank's
views of the same global arguments (JAX's parameter draw carried across by
``convert``, the inputs drawn by the port's ``make_args``). Held, with
``test_torch_gnn.py``'s tolerance rtol = atol = 1e-5 (f32 sums taken in
another order: over edge chunks, then over ranks):

- each step's loss, the updated parameters and the AdamW moments, against
  JAX's sharded cell;
- every rank's parameters and moments bit-identical (replicated weights);
- the collectives ``count_cost`` counts on each rank, against the port's
  own formula (``port_collectives``).
"""
import pickle

import numpy as np
import pytest
import torch

import _torch_ranks as R
from repro_torch.configs import gnn_archs as tga
from repro_torch.dist import sharding as shd
from repro_torch.launch import mesh
from repro_torch.models import gnn as tgnn

pytestmark = pytest.mark.port

TOL = dict(rtol=1e-5, atol=1e-5)
STEPS = 3
SHAPES = {
    "full_graph_sm": dict(n_nodes=500, n_edges=2000, d_feat=16, n_classes=4, kind="full"),
    "minibatch_lg": dict(batch_nodes=8, kind="sampled"),
    "ogb_products": dict(n_nodes=1000, n_edges=3500, d_feat=16, n_classes=4, kind="full"),
    "molecule": dict(n_nodes=30, n_edges=64, batch=32, d_feat=16, n_classes=4, kind="pool"),
}
MESHES = {"122": (1, 2, 2), "112": (1, 1, 2)}


@pytest.fixture(scope="module")
def runs():
    """label → (mesh, build, global numpy args, steps)."""
    pytest.importorskip("jax")
    import jax
    from repro.configs import gnn_archs as jga
    from repro.models import gnn as jgnn

    raw = {k: np.asarray(v) for k, v in
           jgnn.init_params(jga.small_gnn(), jax.random.key(5)).items()}
    out = {}
    for i, (kind, shape) in enumerate(SHAPES.items()):
        build = ("gnn", kind, shape)
        cell = R.small_cell(build)
        args = R.to_numpy(list(cell.make_args(torch.Generator().manual_seed(10 + i), "cpu")))
        args[0] = raw
        for name, layout in MESHES.items():
            out[f"{kind}/{name}"] = (layout, build, args, STEPS)
    return out


JAX_CELLS = r"""
import pickle
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import base as jbase, gnn_archs as jga
from repro.dist import sharding as jshd

with open(IN, "rb") as f:
    runs = pickle.load(f)
out = {}
for label, (shape, build, args, steps) in runs.items():
    _, kind, cell_shape = build
    mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape[1:]),
                ("data", "model"))
    cell = jbase.build_gnn_cell(jga.small_gnn(), kind, cell_shape, mesh, False)
    fn = jax.jit(cell.fn, in_shardings=cell.in_shardings, out_shardings=cell.out_shardings)
    tree = lambda a: jax.tree.map(jnp.asarray, a)
    params, state, rest = tree(args[0]), tree(args[1]), [tree(a) for a in args[2:]]
    with jshd.ambient_mesh_scope(mesh, False):
        for step in range(steps):
            params, state, loss = fn(params, state, *rest)
            out[f"{label}/loss{step}"] = np.asarray(loss)
    out.update({f"{label}/p/{k}": np.asarray(v) for k, v in params.items()})
    out.update({f"{label}/{part}/{k}": np.asarray(v)
                for part in ("m", "v") for k, v in state[part].items()})
np.savez(OUT, **out)
"""


@pytest.fixture(scope="module")
def results(runs, tmp_path_factory):
    """(port, jax_out), made one after another (so the module holds one
    world or one subprocess at a time): the port's worlds of 4 and 2 ranks
    (label → each rank's outputs, losses, collectives, bytes) and JAX's
    sharded cells in one subprocess on 4 host devices."""
    from conftest import run_with_devices

    path = tmp_path_factory.mktemp("gnn_ranks") / "runs.pkl"
    with open(path, "wb") as f:
        pickle.dump(runs, f)

    def world(name, data, model):
        sub = {k: v for k, v in runs.items() if k.endswith(name)}
        res = mesh.spawn(R.cells_across_ranks, data=data, model=model, device="cpu",
                         args=(sub,), threads=1, timeout_s=R.TIMEOUT_S)
        return {label: [r[label] for r in res] for label in sub}

    port = {**world("122", 2, 2), **world("112", 1, 2)}
    return port, R.jax_run(run_with_devices, f"IN = {str(path)!r}\n" + JAX_CELLS, n_devices=4)


def _replicated(ranks, part):
    """The ranks' copies of a replicated dict (params, or a moment), after
    checking they hold the same bits."""
    first = ranks[0]
    for r in ranks[1:]:
        for k, v in part(r).items():
            assert v.tobytes() == part(first)[k].tobytes(), k
    return part(first)


@pytest.mark.parametrize("name", list(MESHES))
@pytest.mark.parametrize("kind", list(SHAPES))
def test_train_across_ranks_equals_jax_sharded_cell(results, kind, name):
    port, jax_out = results
    label = f"{kind}/{name}"
    ranks = port[label]
    for r in ranks:
        assert r[1] == ranks[0][1]                              # one loss on every rank
    np.testing.assert_allclose(ranks[0][1], [float(jax_out[f"{label}/loss{i}"])
                                             for i in range(STEPS)], **TOL)
    params = _replicated(ranks, lambda r: r[0][0])
    for k, v in params.items():
        np.testing.assert_allclose(v, jax_out[f"{label}/p/{k}"], **TOL, err_msg=k)
    for part in ("m", "v"):
        for k, v in _replicated(ranks, lambda r: r[0][1][part]).items():
            np.testing.assert_allclose(v, jax_out[f"{label}/{part}/{k}"], **TOL,
                                       err_msg=f"{part}/{k}")
    assert all(int(r[0][1]["step"]) == STEPS for r in ranks)


def port_collectives(kind, shape, layout):
    """The port's collectives of one train step on one rank (calls, payload
    bytes by JAX primitive name), for ``small_gnn()`` (2 layers):

    - full graph, each layer: the all_gather of h's rows (the halo), the
      reduce-scatter of the sums [N, d] and of the degrees [N]; the loss's
      two sums (pooled: the labels' all_gather and the graph sums [G + 1,
      C] and counts [G + 1]); backward, the second layer's transposes (the
      first reads the features, which need no gradient);
    - sampled: the all_gather of levels 1 and 2 (features) and of the new
      level-1 rows, the last's reduce-scatter backward; the loss's sum;
    - the gradients' one sum over "world"."""
    cfg = tga.small_gnn()
    W = int(np.prod(layout))
    d_in, d_h, C = cfg.d_in, cfg.d_hidden, cfg.n_classes
    grads = 4.0 * sum(int(np.prod(s)) for s in tgnn.param_shapes(cfg).values())
    if kind == "minibatch_lg":
        sizes = [shape["batch_nodes"]]
        for f in cfg.fanouts:
            sizes.append(sizes[-1] * f)
        ag = 4.0 * (sizes[1] // W * d_in + sizes[2] // W * d_in + sizes[1] // W * d_h)
        return ({"all_gather": 3.0, "psum": 2.0, "reduce_scatter": 1.0},
                {"all_gather": ag, "psum": 4.0 + grads, "reduce_scatter": 4.0 * sizes[1] * d_h})
    G = shape.get("batch", 1)
    N = -(-shape["n_nodes"] * G // 512) * 512
    ag = 4.0 * (N // W) * (d_in + d_h + d_h)
    rs = 4.0 * (N * d_in + N + N * d_h + N + N * d_h)
    if kind == "molecule":
        spec = shd.divisible_rows_spec(G, shd.RankLayout(*layout))
        n_blocks = int(np.prod([dict(zip(("pod", "data", "model"), layout))[a]
                                for a in shd._axes(spec[0])]))
        return ({"all_gather": 4.0, "reduce_scatter": 5.0, "psum": 3.0},
                {"all_gather": ag + 4.0 * G // n_blocks, "reduce_scatter": rs,
                 "psum": 4.0 * (G + 1) * C + 4.0 * (G + 1) + grads})
    return ({"all_gather": 3.0, "reduce_scatter": 5.0, "psum": 3.0},
            {"all_gather": ag, "reduce_scatter": rs, "psum": 8.0 + grads})


@pytest.mark.parametrize("name", list(MESHES))
@pytest.mark.parametrize("kind", list(SHAPES))
def test_collectives_of_a_step_match_the_ports_formula(results, runs, kind, name):
    """Each rank's collectives in its first step equal ``port_collectives``."""
    port, _ = results
    label = f"{kind}/{name}"
    want = port_collectives(kind, SHAPES[kind], runs[label][0])
    for r in port[label]:
        assert (r[2], r[3]) == want, (label, r[2], r[3])
