"""Port conformance of the GNN workload (``repro_torch.data.sampler``,
``repro_torch.models.gnn``, ``configs.gnn_archs``, the GNN half of
``configs.base`` and ``dist.sharding``) and of the deterministic scatter
route it runs on (``kernels.embedding_bag.ops.segment_sum`` /
``gather_rows``).

- The sampler (``random_graph``, ``NeighborSampler``) is numpy only: bit for
  bit against JAX's.
- ``segment_sum`` and ``gather_rows`` against an f64 numpy scatter, each
  one's gradient the other's forward.
- ``_mean_aggregate`` (and its chunk invariance), ``forward_full``,
  ``forward_sampled`` and the three losses with their gradients, on the same
  parameters (JAX's draw carried across by ``convert.gnn_params_from_numpy``)
  and seeded numpy inputs: allclose rtol = atol = 1e-5 (f32 sums taken in
  another order on each side).
- A train cell's step at a small size equals JAX's cell step; the shapes,
  specs and formulas equal JAX's.
"""
import types

import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread as _one_torch_thread  # noqa: F401  (autouse)
from repro_torch import convert
from repro_torch.configs import base as tbase, gnn_archs as tga
from repro_torch.data import sampler as tsmp
from repro_torch.dist import sharding as tshd
from repro_torch.kernels.embedding_bag import ops as bag_ops
from repro_torch.models import gnn as tgnn

pytestmark = pytest.mark.port

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import base as jbase, gnn_archs as jga
    from repro.data import sampler as jsmp
    from repro.dist import sharding as jshd
    from repro.models import gnn as jgnn
    return types.SimpleNamespace(jax=jax, jnp=jnp, base=jbase, ga=jga, smp=jsmp, shd=jshd,
                                 gnn=jgnn)


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _params(J, cfg, seed=0):
    """(JAX params, port params): JAX's draw, carried across."""
    jp = J.gnn.init_params(cfg, J.jax.random.key(seed))
    return jp, convert.gnn_params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, "cpu")


def _grads_close(jg, tg):
    assert sorted(jg) == sorted(tg)
    for k in jg:
        np.testing.assert_allclose(_np(tg[k]), np.asarray(jg[k]), err_msg=k, **TOL)


def _port_grad(loss_fn, params):
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = loss_fn(leaves)
    names = sorted(leaves)
    return loss, dict(zip(names, torch.autograd.grad(loss, [leaves[k] for k in names])))


# ------------------------------------------------------------- the sampler ---


@pytest.mark.parametrize("seed,n,deg,d,c,signal", [(0, 300, 8, 16, 4, 0.6), (1, 200, 6, 16, 4, 1.0),
                                                   (7, 57, 3, 5, 7, 2.0)])
def test_random_graph_equals_jax_bit_for_bit(J, seed, n, deg, d, c, signal):
    a = J.smp.random_graph(seed, n, deg, d, c, feature_signal=signal)
    b = tsmp.random_graph(seed, n, deg, d, c, feature_signal=signal)
    for name in ("indptr", "indices", "feats", "labels"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    for x, y in zip(a.edge_list(), b.edge_list()):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert (a.n_nodes, a.n_edges) == (b.n_nodes, b.n_edges)


@pytest.mark.parametrize("fanouts,seeds", [((4, 3), 16), ((5, 3), 40), ((2,), 9)])
def test_neighbor_sampler_equals_jax_bit_for_bit(J, fanouts, seeds):
    kw = dict(n_nodes=200, avg_degree=4, d_feat=8, n_classes=3)
    ga, gb = J.smp.random_graph(3, **kw), tsmp.random_graph(3, **kw)
    sa, sb = J.smp.NeighborSampler(ga, fanouts, seed=2), tsmp.NeighborSampler(gb, fanouts, seed=2)
    for batch in range(3):                       # the rng state carries across calls
        ids = np.arange(batch * seeds, (batch + 1) * seeds) % kw["n_nodes"]
        fa, na, la = sa.sample(ids)
        fb, nb, lb = sb.sample(ids)
        assert len(fa) == len(fb) == len(fanouts) + 1
        for x, y in zip(fa + na + [la], fb + nb + [lb]):
            assert x.dtype == y.dtype and np.array_equal(x, y)


# ---------------------------------------------- segment_sum / gather_rows ---


@pytest.mark.parametrize("N,n,D", [(200, 37, 8), (64, 5, 1), (300, 400, 33), (1, 1, 3)])
def test_segment_sum_and_gather_rows_against_numpy(N, n, D):
    rng = np.random.default_rng(N + D)
    rows = rng.normal(size=(N, D)).astype(np.float32)
    seg = rng.integers(0, n, N).astype(np.int32)
    want = np.zeros((n, D), np.float64)
    np.add.at(want, seg, rows.astype(np.float64))
    r = torch.from_numpy(rows).requires_grad_(True)
    out = bag_ops.segment_sum(r, torch.from_numpy(seg), n)
    assert out.dtype == torch.float32 and out.shape == (n, D)
    np.testing.assert_allclose(_np(out), want, rtol=1e-5, atol=1e-5)
    # the gradient of segment_sum is gather_rows of the upstream gradient
    up = torch.from_numpy(rng.normal(size=(n, D)).astype(np.float32))
    (g,) = torch.autograd.grad(out, r, up)
    assert torch.equal(g, bag_ops.gather_rows(up, torch.from_numpy(seg)))
    np.testing.assert_array_equal(_np(g), _np(up)[seg])
    # and the gradient of gather_rows is segment_sum of the upstream gradient
    x = torch.from_numpy(rng.normal(size=(n, D)).astype(np.float32)).requires_grad_(True)
    ids = torch.from_numpy(seg)
    y = bag_ops.gather_rows(x, ids)
    np.testing.assert_array_equal(_np(y), _np(x)[seg])
    up2 = torch.from_numpy(rng.normal(size=(N, D)).astype(np.float32))
    (gx,) = torch.autograd.grad(y, x, up2)
    assert torch.equal(gx, bag_ops.segment_sum(up2, ids, n))


def test_segment_sum_sums_bf16_rows_in_f32_once():
    rng = np.random.default_rng(4)
    rows = torch.from_numpy(rng.normal(size=(500, 4)).astype(np.float32)).to(torch.bfloat16)
    seg = torch.from_numpy(rng.integers(0, 3, 500).astype(np.int32))
    out = bag_ops.segment_sum(rows, seg, 3)
    want = torch.zeros(3, 4, dtype=torch.float64).index_add_(0, seg.long(), rows.double())
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, want.float().to(torch.bfloat16))


def test_gather_rows_of_any_id_shape_and_its_dense_gradient():
    x = torch.arange(12.0).reshape(6, 2).requires_grad_(True)
    ids = torch.tensor([[0, 5, 5], [2, 0, 1]], dtype=torch.int32)
    y = bag_ops.gather_rows(x, ids)
    assert y.shape == (2, 3, 2) and torch.equal(y, x.detach()[ids.long()])
    (g,) = torch.autograd.grad(y.sum(), x)
    assert not g.is_sparse
    assert torch.equal(g[:, 0], torch.tensor([2.0, 1, 1, 0, 0, 2]))


@pytest.mark.parametrize("V,n,E,chunk", [(50, 40, 123, 16), (50, 40, 123, 1024), (7, 3, 64, 64)])
def test_gather_segment_sum_against_numpy_and_its_transpose(V, n, E, chunk):
    rng = np.random.default_rng(V + E + chunk)
    x = rng.normal(size=(V, 6)).astype(np.float32)
    src = rng.integers(0, V, E).astype(np.int32)
    dst = rng.integers(0, n, E).astype(np.int32)
    want = np.zeros((n, 6), np.float64)
    np.add.at(want, dst, x[src].astype(np.float64))
    xt = torch.from_numpy(x).requires_grad_(True)
    s, d = torch.from_numpy(src), torch.from_numpy(dst)
    out = bag_ops.gather_segment_sum(xt, s, d, n, chunk)
    assert out.shape == (n, 6)
    np.testing.assert_allclose(_np(out), want, rtol=1e-5, atol=1e-5)
    # in one chunk it is segment_sum of gather_rows, bit for bit
    if chunk >= E:
        assert torch.equal(out, bag_ops.segment_sum(bag_ops.gather_rows(xt, s), d, n))
    # its gradient is itself with src and dst swapped
    up = torch.from_numpy(rng.normal(size=(n, 6)).astype(np.float32))
    (g,) = torch.autograd.grad(out, xt, up)
    assert not g.is_sparse
    assert torch.equal(g, bag_ops.gather_segment_sum(up, d, s, V, chunk))
    want_g = np.zeros((V, 6), np.float64)
    np.add.at(want_g, src, _np(up)[dst].astype(np.float64))
    np.testing.assert_allclose(_np(g), want_g, rtol=1e-5, atol=1e-5)


def test_segment_sum_refuses_ids_out_of_range_on_the_cpu():
    with pytest.raises(IndexError):
        bag_ops.segment_sum(torch.ones(3, 2), torch.tensor([0, 4, 1], dtype=torch.int32), 4)


# ------------------------------------------------------------- the model ----


@pytest.mark.parametrize("chunk", [16, 64, 1024])
def test_mean_aggregate_equals_jax_and_numpy(J, chunk):
    rng = np.random.default_rng(5)
    N, E, d = 50, 200, 8
    h = rng.normal(size=(N, d)).astype(np.float32)
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, N, E).astype(np.int32)
    got = tgnn._mean_aggregate(torch.from_numpy(h), torch.from_numpy(src),
                               torch.from_numpy(dst), N, chunk)
    want = J.gnn._mean_aggregate(J.jnp.array(h), J.jnp.array(src), J.jnp.array(dst), N, chunk)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    expect = np.zeros((N, d), np.float64)
    np.add.at(expect, dst, h[src].astype(np.float64))
    expect /= np.maximum(np.bincount(dst, minlength=N), 1.0)[:, None]
    np.testing.assert_allclose(_np(got), expect, **TOL)


def test_edge_chunking_invariant():
    rng = np.random.default_rng(6)
    N, E = 40, 123
    h = torch.from_numpy(rng.normal(size=(N, 8)).astype(np.float32))
    src = torch.from_numpy(rng.integers(0, N, E).astype(np.int32))
    dst = torch.from_numpy(rng.integers(0, N, E).astype(np.int32))
    a = tgnn._mean_aggregate(h, src, dst, N, edge_chunk=16)
    b = tgnn._mean_aggregate(h, src, dst, N, edge_chunk=1024)
    np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-6)


def _graph(seed=0, n=120, deg=5):
    cfg = tga.small_gnn()
    g = tsmp.random_graph(seed, n, deg, cfg.d_in, cfg.n_classes, feature_signal=0.6)
    src, dst = g.edge_list()
    mask = (np.random.default_rng(seed).random(n) < 0.7).astype(np.float32)
    return cfg, g, src, dst, mask


@pytest.mark.parametrize("chunk", [64, 512])
def test_forward_full_and_loss_full_with_gradients_equal_jax(J, chunk):
    import dataclasses

    cfg, g, src, dst, mask = _graph()
    cfg = dataclasses.replace(cfg, edge_chunk=chunk)
    jp, tp = _params(J, cfg)
    jnp_, t = J.jnp.array, torch.from_numpy
    args_j = (jnp_(g.feats), jnp_(src), jnp_(dst))
    args_t = (t(g.feats), t(src), t(dst))
    np.testing.assert_allclose(_np(tgnn.forward_full(cfg, tp, *args_t)),
                               np.asarray(J.gnn.forward_full(cfg, jp, *args_j)), **TOL)
    jl, jg = J.jax.value_and_grad(lambda p: J.gnn.loss_full(
        cfg, p, *args_j, jnp_(g.labels), jnp_(mask)))(jp)
    tl, tg = _port_grad(lambda p: tgnn.loss_full(cfg, p, *args_t, t(g.labels), t(mask)), tp)
    np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
    _grads_close(jg, tg)


def test_forward_sampled_and_loss_sampled_with_gradients_equal_jax(J):
    cfg = tga.small_gnn()
    g = tsmp.random_graph(1, n_nodes=200, avg_degree=6, d_feat=cfg.d_in, n_classes=cfg.n_classes)
    feats, neigh, labels = tsmp.NeighborSampler(g, cfg.fanouts, seed=0).sample(np.arange(24))
    assert any((n < 0).any() for n in neigh)          # padding on the path
    jp, tp = _params(J, cfg, 1)
    fj, nj = [J.jnp.array(f) for f in feats], [J.jnp.array(n) for n in neigh]
    ft, nt = [torch.from_numpy(f) for f in feats], [torch.from_numpy(n) for n in neigh]
    np.testing.assert_allclose(_np(tgnn.forward_sampled(cfg, tp, ft, nt)),
                               np.asarray(J.gnn.forward_sampled(cfg, jp, fj, nj)), **TOL)
    jl, jg = J.jax.value_and_grad(
        lambda p: J.gnn.loss_sampled(cfg, p, fj, nj, J.jnp.array(labels)))(jp)
    tl, tg = _port_grad(lambda p: tgnn.loss_sampled(cfg, p, ft, nt, torch.from_numpy(labels)), tp)
    np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
    _grads_close(jg, tg)


def test_forward_sampled_activation_gradient_is_dense_and_equals_jax(J):
    """At the second layer the bag's table is the activation h[1]: its
    gradient (the dense row sums) reaches the level-1 features."""
    cfg = tga.small_gnn()
    g = tsmp.random_graph(2, n_nodes=150, avg_degree=5, d_feat=cfg.d_in, n_classes=cfg.n_classes)
    feats, neigh, labels = tsmp.NeighborSampler(g, cfg.fanouts, seed=1).sample(np.arange(12))
    jp, tp = _params(J, cfg, 2)
    nj, nt = [J.jnp.array(n) for n in neigh], [torch.from_numpy(n) for n in neigh]
    want = J.jax.grad(lambda f: J.gnn.loss_sampled(
        cfg, jp, f, nj, J.jnp.array(labels)))([J.jnp.array(f) for f in feats])
    ft = [torch.from_numpy(f).requires_grad_(True) for f in feats]
    got = torch.autograd.grad(tgnn.loss_sampled(cfg, tp, ft, nt, torch.from_numpy(labels)), ft)
    for a, b in zip(got, want):
        assert not a.is_sparse
        np.testing.assert_allclose(_np(a), np.asarray(b), **TOL)


def test_loss_graph_pool_with_gradients_equals_jax(J):
    """Eight graphs of six nodes and eight padding nodes whose graph id is
    n_graphs (dropped by both sides' segment sums)."""
    cfg = tga.small_gnn()
    rng = np.random.default_rng(7)
    n_graphs, per, pad = 8, 6, 8
    N = n_graphs * per + pad
    x = rng.normal(size=(N, cfg.d_in)).astype(np.float32)
    src = rng.integers(0, N, 60).astype(np.int32)
    dst = rng.integers(0, N, 60).astype(np.int32)
    gid = np.concatenate([np.repeat(np.arange(n_graphs), per), np.full(pad, n_graphs)])
    gid = gid.astype(np.int32)
    labels = rng.integers(0, cfg.n_classes, n_graphs).astype(np.int32)
    jp, tp = _params(J, cfg, 3)
    ja = [J.jnp.array(a) for a in (x, src, dst, gid)]
    ta = [torch.from_numpy(a) for a in (x, src, dst, gid)]
    jl, jg = J.jax.value_and_grad(lambda p: J.gnn.loss_graph_pool(
        cfg, p, *ja, n_graphs, J.jnp.array(labels)))(jp)
    tl, tg = _port_grad(lambda p: tgnn.loss_graph_pool(
        cfg, p, *ta, n_graphs, torch.from_numpy(labels)), tp)
    np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
    _grads_close(jg, tg)


def test_full_batch_training_learns():
    """The port's own step (AdamW, lr 1e-2) on a homophilous random graph, as
    JAX's test trains its: the loss falls by 30% in 30 steps."""
    from repro_torch.optim.adamw import AdamW

    cfg, g, src, dst, _ = _graph(0, 300, 8)
    params = tgnn.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = AdamW(lr=1e-2, weight_decay=0.0)
    ost = opt.init(params)
    x, s, d, y = (torch.from_numpy(a) for a in (g.feats, src, dst, g.labels))
    mask = torch.ones(g.n_nodes)
    losses = []
    for _ in range(30):
        loss, grads = _port_grad(lambda p: tgnn.loss_full(cfg, p, x, s, d, y, mask), params)
        params, ost = opt.update(grads, ost, params)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.7
    acc = float((tgnn.forward_full(cfg, params, x, s, d).argmax(1) == y).float().mean())
    assert acc > 0.5


def test_init_params_draws_he_normal_on_the_given_device():
    cfg = tga.small_gnn()
    p = tgnn.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    q = tgnn.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert sorted(p) == sorted(tgnn.param_shapes(cfg))
    for k, s in tgnn.param_shapes(cfg).items():
        assert tuple(p[k].shape) == s and p[k].dtype == torch.float32
        assert torch.equal(p[k], q[k])
        if len(s) == 1:
            assert not p[k].any()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tgnn.init_params(cfg, torch.Generator().manual_seed(0))


# --------------------------------------------------- configs, specs, cells ---


def test_shapes_configs_and_specs_equal_jax(J):
    assert tga.GNN_SHAPES == J.ga.GNN_SHAPES
    for shape in tga.GNN_SHAPES.values():
        a, b = J.ga._cfg_for(shape), tga.cfg_for(shape)
        assert {f: getattr(a, f) for f in a.__dataclass_fields__} == \
            {f: getattr(b, f) for f in b.__dataclass_fields__}
        assert tgnn.param_shapes(b) == J.gnn.param_shapes(a)
        assert tshd.gnn_param_specs(tgnn.param_shapes(b)) == {
            k: tuple(v) for k, v in J.shd.gnn_param_specs(J.gnn.param_shapes(a)).items()}
    a, b = J.ga.small_gnn(), tga.small_gnn()
    assert tgnn.param_shapes(b) == J.gnn.param_shapes(a) and a.fanouts == b.fanouts
    for mp in (False, True):
        assert tshd.gnn_rows_spec(mp) == tuple(J.shd.gnn_rows_spec(mp))
    for pods, data, model in ((1, 4, 2), (2, 2, 2), (1, 16, 16), (2, 16, 16), (1, 1, 1)):
        mesh = types.SimpleNamespace(shape={"pod": pods, "data": data, "model": model})
        lay = tshd.RankLayout(pods, data, model)
        for n in (1, 2, 3, 8, 128, 96, 512):
            for mp in (False, True):
                # JAX writes an entry of one axis either way: 'x' or ('x',)
                got = [tshd._axes(e) for e in tshd.divisible_rows_spec(n, lay, mp)]
                want = [tshd._axes(e) for e in J.shd.divisible_rows_spec(n, mesh, mp)]
                assert got == want, (n, mp, lay)


@pytest.mark.parametrize("shape", list(tga.GNN_SHAPES))
def test_cell_formulas_equal_jax(J, shape):
    mesh = J.jax.make_mesh((1, 1), ("data", "model"))
    jc = J.ga.spec().cell(shape, mesh, False)
    tc = tga.spec().cell(shape, None)
    assert (tc.model_flops, tc.model_coll_bytes, tc.note, tc.step_kind, tc.donate) == \
        (jc.model_flops, jc.model_coll_bytes, jc.note, jc.step_kind, jc.donate)
    args = tc.make_args(None, "meta")
    leaves_t = []

    def walk(a):
        if isinstance(a, dict):
            for k in sorted(a):
                walk(a[k])
        elif isinstance(a, (list, tuple)):
            for x in a:
                walk(x)
        else:
            leaves_t.append((tuple(a.shape), str(a.dtype).replace("torch.", "")))
    walk(args)
    leaves_j = [(tuple(x.shape), str(x.dtype)) for x in J.jax.tree.leaves(jc.args)]
    assert leaves_t == leaves_j


def _tiny_shapes():
    return {"full": dict(n_nodes=40, n_edges=150, d_feat=16, n_classes=4, kind="full"),
            "pool": dict(n_nodes=6, n_edges=10, batch=8, d_feat=16, n_classes=4, kind="pool")}


@pytest.mark.parametrize("kind", ["full_graph_sm", "molecule", "minibatch_lg"])
def test_small_train_cell_step_equals_jax_cell_step(J, kind):
    """The cell's own step (gradient + AdamW) at small_gnn's widths on the
    port's drawn inputs, against JAX's cell step on the same arrays: the
    loss and every updated parameter and moment within 1e-5."""
    cfg = tga.small_gnn()
    shape = {"full_graph_sm": _tiny_shapes()["full"], "molecule": _tiny_shapes()["pool"],
             "minibatch_lg": dict(batch_nodes=8, kind="sampled")}[kind]
    tc = tbase.build_gnn_cell(cfg, kind, shape, None)
    args = tc.make_args(torch.Generator().manual_seed(4), "cpu")
    mesh = J.jax.make_mesh((1, 1), ("data", "model"))
    jc = J.base.build_gnn_cell(J.ga.small_gnn(), kind, shape, mesh, False)

    def to_j(a):
        if isinstance(a, dict):
            return {k: to_j(v) for k, v in a.items()}
        if isinstance(a, (list, tuple)):
            return [to_j(x) for x in a]
        return J.jnp.array(a.numpy())

    jargs = [to_j(a) for a in args]
    jp, jo, jl = jc.fn(*jargs)
    tp, to, tl = tc.fn(*args)
    np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
    _grads_close(jp, tp)
    _grads_close(jo["m"], to["m"])
    _grads_close(jo["v"], to["v"])
    assert int(to["step"]) == int(jo["step"]) == 1


def test_cells_across_ranks_refuse_their_step():
    lay = tshd.RankLayout(1, 16, 16)
    for shape in tga.GNN_SHAPES:
        with pytest.raises(NotImplementedError, match="13f"):
            tga.spec().cell(shape, lay).fn()
