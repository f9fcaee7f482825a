"""The port's collectives and process plumbing.

``compressed_psum`` over 8 pods (gloo over CPU processes) against the JAX
package's on 8 XLA host devices, bit for bit for two seeds, and unbiased
over 24 seeds; ``elastic_aggregate`` over 4 pods with one dead against
JAX's; the ring shift, all-reduce and all-gather; ``local_view``/``assemble``
round trips for every layout; ``init_ranks``/``spawn`` refusing worlds the
host cannot hold; on a card, two ranks that share it summing and gathering
through its workspaces as through host memory; and, on a machine with at
least two cards, the same collectives over NCCL.
"""
import numpy as np
import pytest
import torch

import _torch_ranks as R
from _torch_port import one_torch_thread as _one_torch_thread  # noqa: F401  (autouse)
from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import RankLayout
from repro_torch.launch import mesh

pytestmark = pytest.mark.port

COMPRESSED_CODE = r"""
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.dist import collectives
mesh = jax.make_mesh((8,), ("pod",), axis_types=(jax.sharding.AxisType.Auto,))
g = np.random.default_rng(0).normal(size=(8, 1000)).astype(np.float32) * 0.01
out = {}
for s in (3, 5):
    f = jax.jit(jax.shard_map(
        lambda x, s=s: collectives.compressed_psum({"w": x[0]}, "pod", seed=s)["w"][None],
        mesh=mesh, in_specs=P("pod"), out_specs=P("pod"), check_vma=False))
    out[str(s)] = np.asarray(f(jnp.array(g)))
np.savez(OUT, **out)
"""

ELASTIC_CODE = r"""
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.dist import collectives
mesh = jax.make_mesh((4,), ("pod",), axis_types=(jax.sharding.AxisType.Auto,))
phi_ref = jnp.ones((4, 6, 5), jnp.int32) * 10
phi = phi_ref + (jnp.arange(4)[:, None, None] + 1)
live = jnp.array([1, 1, 0, 1], jnp.int32)
def body(phi, phi_ref, live):
    merged, n_live = collectives.elastic_aggregate(phi[0], phi_ref[0], live[0])
    return merged[None], n_live[None]
f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("pod"),) * 3,
                          out_specs=(P("pod"), P("pod")), check_vma=False))
merged, n_live = f(phi, phi_ref, live)
np.savez(OUT, merged=np.asarray(merged), n_live=np.asarray(n_live))
"""


def test_compressed_psum_matches_jax_and_is_unbiased(subproc):
    g = np.random.default_rng(0).normal(size=(8, 1000)).astype(np.float32) * 0.01
    seeds = [3, 5] + list(range(100, 124))
    views = mesh.spawn(R.compressed_body, pods=8, device="cpu", args=(g, seeds), threads=1, timeout_s=R.TIMEOUT_S)
    jax = R.jax_run(subproc, COMPRESSED_CODE, n_devices=8)
    for i, s in enumerate((3, 5)):
        for r in range(8):
            np.testing.assert_array_equal(views[r][i], jax[str(s)][r], err_msg=f"seed {s}")
    exact = g.sum(axis=0)
    scale = np.abs(exact).max()
    rel = np.abs(views[0][0] - exact).max() / scale
    assert rel < 0.05, rel
    mean_err = np.abs(np.mean([v for v in views[0][2:]], axis=0) - exact).max() / scale
    assert mean_err < rel, (mean_err, rel)


def test_elastic_aggregate_matches_jax(subproc):
    phi_ref = np.full((6, 5), 10, np.int32)
    live = [1, 1, 0, 1]
    views = mesh.spawn(R.elastic_body, pods=4, device="cpu", args=(phi_ref, [1, 2, 3, 4], live),
                       threads=1, timeout_s=R.TIMEOUT_S)
    jax = R.jax_run(subproc, ELASTIC_CODE, n_devices=4)
    for r, (merged, n_live) in enumerate(views):
        np.testing.assert_array_equal(merged, jax["merged"][r])
        assert n_live == int(jax["n_live"][r]) == 3
    assert (views[0][0] == 10 + 1 + 2 + 4).all()


def _check_collectives(views, n):
    for r, (a, b, s, mx, g) in enumerate(views):
        src = (r - 1) % n
        base = np.arange(6) + 10 * src
        np.testing.assert_array_equal(a, base)
        np.testing.assert_array_equal(b, base * 2)
        np.testing.assert_array_equal(s, n * np.arange(6) + 10 * sum(range(n)))
        np.testing.assert_array_equal(mx, np.arange(6) + 10 * (n - 1))
        np.testing.assert_array_equal(g, np.stack([np.arange(6) + 10 * q for q in range(n)]))


def test_ring_shift_and_reductions():
    _check_collectives(mesh.spawn(R.collectives_body, data=3, device="cpu", args=("cpu",),
                                  threads=1, timeout_s=R.TIMEOUT_S), 3)


@pytest.mark.multigpu
def test_collectives_over_nccl_across_cards():
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs at least 2 CUDA cards, this host has {n}")
    _check_collectives(mesh.spawn(R.collectives_body, data=n, backend="nccl", device="cuda",
                                  args=("cuda",), timeout_s=R.TIMEOUT_S), n)


@pytest.mark.kernels
def test_ranks_sharing_one_card_sum_and_gather_through_its_workspaces():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for card, host in mesh.spawn(R.card_collectives_body, data=2, device="cuda",
                                 ranks_per_device=2, timeout_s=R.TIMEOUT_S):
        x = np.arange(len(card[0]), dtype=np.int64)
        np.testing.assert_array_equal(card[0], 3 * x - 3)
        np.testing.assert_array_equal(card[1], np.maximum(x, 2 * x - 3))
        for a, b in zip(card, host):
            np.testing.assert_array_equal(a, b)


LAYOUTS = {
    "ring": (shd.ring_spec(), lambda p, d, m: (d * m, 5, 3), (1, 4, 2)),
    "replicated": (shd.replicated(), lambda p, d, m: (7,), (1, 2, 2)),
    "wshard": (shd.wshard_spec(), lambda p, d, m: (d, 4 * m, 3), (1, 2, 3)),
    "wshard_stack": (shd.wshard_stack_spec(), lambda p, d, m: (d, d, 2 * m), (1, 3, 2)),
    "pod": (shd.pod_spec(), lambda p, d, m: (p, 6), (3, 2, 1)),
    "pod_ring": (shd.pod_ring_spec(), lambda p, d, m: (p, d * m, 2, 3), (2, 2, 2)),
    "pod_wshard": (shd.pod_wshard_spec(), lambda p, d, m: (p, d, 2 * m, 3), (2, 2, 2)),
    "pod_wshard_stack": (shd.pod_wshard_stack_spec(), lambda p, d, m: (p, d, d, 3 * m),
                         (2, 3, 2)),
}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_local_view_and_assemble_round_trip(name):
    """Every rank's view has JAX's per-device block shape, the views tile the
    global array, and ``assemble`` inverts ``local_view``."""
    spec, shape_of, (p, d, m) = LAYOUTS[name]
    layout = RankLayout(p, d, m)
    x = np.arange(np.prod(shape_of(p, d, m))).reshape(shape_of(p, d, m))
    views = [shd.local_view(x, spec, layout, rank=r) for r in range(layout.world_size)]
    split = {"ring": (1, 5, 3), "replicated": (7,), "wshard": (1, 4, 3),
             "wshard_stack": (1, 3, 2), "pod": (1, 6), "pod_ring": (1, 1, 2, 3),
             "pod_wshard": (1, 1, 2, 3), "pod_wshard_stack": (1, 1, 3, 3)}[name]
    assert all(v.shape == split for v in views)
    np.testing.assert_array_equal(shd.assemble(views, spec, layout), x)
    t = torch.from_numpy(x)
    for r in range(layout.world_size):
        np.testing.assert_array_equal(shd.local_view(t, spec, layout, rank=r).numpy(), views[r])


def test_rank_numbering_is_jax_mesh_order():
    layout = RankLayout(2, 3, 2)
    coords = [layout.coords(r) for r in range(layout.world_size)]
    assert coords == [(p, d, m) for p in range(2) for d in range(3) for m in range(2)]
    assert [shd.flat_ring_index(layout.at(r)) for r in range(6)] == list(range(6))
    assert shd.ring_perm(3) == [(0, 1), (1, 2), (2, 0)]
    assert (shd.ring_size(layout), shd.data_ring_size(layout), shd.model_axis_size(layout)) == (6, 3, 2)
    assert [shd.round_up(n, 8) for n in (0, 1, 8, 9)] == [0, 8, 8, 16]
    with pytest.raises(ValueError):
        RankLayout(1, 2, 2, rank=4)


def test_init_ranks_refuses_more_ranks_than_device_slots():
    n = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match="device slots"):
        mesh.init_ranks(data=2, model=n + 1, device="cuda", ranks_per_device=1, rank=0,
                        world_size=2 * (n + 1))
    with pytest.raises(RuntimeError, match="device slots"):
        mesh.spawn(R.collectives_body, data=2 * max(n, 1) + 1, device="cuda",
                   ranks_per_device=2, args=("cuda",))
    with pytest.raises(ValueError, match="NCCL"):
        mesh.check_world(1, "cpu", "nccl", 1)
    with pytest.raises(ValueError, match="pods\\*data\\*model"):
        mesh.init_ranks(data=2, device="cpu", rank=0, world_size=3)
