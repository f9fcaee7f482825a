"""Port conformance of EmbeddingBag.

On the CPU: the plain PyTorch version against the JAX package's
``ops.embedding_bag`` on the same numpy inputs, both its Pallas kernel in
interpret mode and its ``ref``, within the JAX test's own tolerances
(``tests/test_kernels_embedding_bag.py``): 1e-5 in f32, where only the order
of the weighted sum differs, and 2e-2 in bf16, where the plain version
rounds the weights to bf16 and the kernel does not. A bag of one row with
weight 1 is the row itself, so there the plain version equals ``jnp.take``
bit for bit.

On a CUDA card (tests marked ``kernels``; they skip without one; they import
no jax): the hand-written kernel against the plain version on the card, on
both its paths (16-byte vectors, and scalar loads for other row widths and
unaligned tables). The wrapper's choice of path and launch geometry is plain
Python and is tested here on the CPU.
"""
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread as _one_torch_thread  # noqa: F401  (autouse)
from repro_torch.kernels.embedding_bag import ops
from repro_torch.kernels.embedding_bag.kernel import (
    AHEAD,
    WARPS_PER_BLOCK,
    bag_geometry,
    embedding_bag_cuda,
)
from repro_torch.kernels.embedding_bag.ref import embedding_bag_padded_ref

pytestmark = pytest.mark.port

# the JAX test's grid (tests/test_kernels_embedding_bag.py:14-17)
GRID = [(8, 4, 100, 128), (16, 1, 1000, 16), (5, 7, 64, 256), (32, 3, 50, 128),
        (1, 2, 10, 512), (64, 8, 2048, 32)]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(B, F, V, D, seed=11):
    rng = np.random.default_rng(seed + B * 7 + F * 131 + V + D)
    table = rng.normal(size=(V, D)).astype(np.float32)
    ids = rng.integers(0, V, (B, F)).astype(np.int32)
    w = rng.uniform(0.1, 2, (B, F)).astype(np.float32)
    return table, ids, w


def _port(table, ids, w, combiner, dtype="float32", device="cpu"):
    t = torch.from_numpy(table).to(device, getattr(torch, dtype))
    tw = None if w is None else torch.from_numpy(w).to(device)
    return ops.embedding_bag(t, torch.from_numpy(ids).to(device), tw, combiner)


def _f32(x) -> np.ndarray:
    return np.asarray(x.float().cpu() if isinstance(x, torch.Tensor) else x, np.float32)


@pytest.fixture(scope="module")
def jax_bag():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.embedding_bag import ops as jops

    def run(table, ids, w, combiner, force, dtype="float32"):
        t = jnp.asarray(table).astype(getattr(jnp, dtype))
        jw = None if w is None else jnp.asarray(w)
        out = jops.embedding_bag(t, jnp.asarray(ids), jw, combiner, force=force)
        return np.asarray(out.astype(jnp.float32))
    return run


@pytest.mark.parametrize("force", ["interpret", "ref"])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("B,F,V,D", GRID)
def test_plain_matches_jax(jax_bag, B, F, V, D, combiner, force):
    table, ids, w = _inputs(B, F, V, D)
    out = _port(table, ids, w, combiner)
    assert out.dtype == torch.float32 and out.shape == (B, D)
    np.testing.assert_allclose(out.numpy(), jax_bag(table, ids, w, combiner, force),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("weighted", [False, True], ids=["ones", "weighted"])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("force", ["interpret", "ref"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_dtypes_match_jax(jax_bag, dtype, force, combiner, weighted):
    table, ids, w = _inputs(4, 3, 64, 128)
    w = w if weighted else None
    out = _port(table, ids, w, combiner, dtype)
    assert out.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_f32(out), jax_bag(table, ids, w, combiner, force, dtype),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_zero_weight_padding_is_ignored(jax_bag):
    table = np.random.default_rng(3).normal(size=(10, 8)).astype(np.float32)
    ids = np.array([[1, 2, 0], [3, 0, 0]], np.int32)
    w = np.array([[1.0, 1.0, 0.0], [1.0, 0.0, 0.0]], np.float32)
    expect = np.stack([table[1] + table[2], table[3]])
    for combiner, scale in (("sum", [1.0, 1.0]), ("mean", [0.5, 1.0])):
        out = _port(table, ids, w, combiner).numpy()
        np.testing.assert_allclose(out, expect * np.array(scale)[:, None], rtol=1e-6)
        np.testing.assert_allclose(out, jax_bag(table, ids, w, combiner, "interpret"),
                                   rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bag_of_one_is_take_bitwise(dtype):
    """F = 1, weight 1: the row itself, bit for bit (``jnp.take``)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    table, ids, _ = _inputs(300, 1, 1000, 18)
    jt = jnp.asarray(table).astype(getattr(jnp, dtype))
    expect = np.asarray(jnp.take(jt, jnp.asarray(ids[:, 0]), axis=0).astype(jnp.float32))
    out = _port(table, ids, None, "sum", dtype)
    assert out.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(_f32(out), expect)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True], ids=["ones", "weighted"])
def test_ragged_matches_jax(combiner, weighted):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.embedding_bag import ops as jops
    rng = np.random.default_rng(5)
    table = rng.normal(size=(30, 16)).astype(np.float32)
    flat = np.array([1, 2, 3, 7, 7, 9], np.int32)
    seg = np.array([0, 0, 1, 1, 1, 2], np.int32)
    w = rng.uniform(0.1, 2, 6).astype(np.float32) if weighted else None
    expect = jops.embedding_bag_ragged(jnp.asarray(table), jnp.asarray(flat),
                                       jnp.asarray(seg), 4,
                                       None if w is None else jnp.asarray(w), combiner)
    out = ops.embedding_bag_ragged(torch.from_numpy(table), torch.from_numpy(flat),
                                   torch.from_numpy(seg), 4,
                                   None if w is None else torch.from_numpy(w), combiner)
    assert out.shape == (4, 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), rtol=1e-6, atol=1e-6)
    if not weighted and combiner == "sum":
        np.testing.assert_allclose(out.numpy()[:3], np.stack(
            [table[1] + table[2], table[3] + 2 * table[7], table[9]]), rtol=1e-6)


def test_cpu_tensors_use_plain_version_and_do_not_count():
    before = ops.launches
    table, ids, w = _inputs(8, 4, 100, 16)
    t, i, tw = torch.from_numpy(table), torch.from_numpy(ids), torch.from_numpy(w)
    assert torch.equal(ops.embedding_bag(t, i, tw, "mean"),
                       embedding_bag_padded_ref(t, i, tw, "mean"))
    assert ops.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    table, ids, w = _inputs(8, 4, 100, 16)
    with pytest.raises(ValueError, match="CUDA"):
        embedding_bag_cuda(torch.from_numpy(table), torch.from_numpy(ids),
                           torch.from_numpy(w))


# ------------------------------------------------------------- on the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain einsum stays f32


@pytest.mark.kernels
@pytest.mark.parametrize("weighted", [False, True], ids=["ones", "weighted"])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("F", [1, 3, 26, 40])
@pytest.mark.parametrize("D", [8, 10, 16, 18, 128, 512, 600])
def test_cuda_kernel_matches_plain(D, F, dtype, combiner, weighted):
    """The kernel against the plain version on the card. In bf16 the plain
    version rounds the weights to bf16 and the kernel does not, which near a
    cancelling sum of 26 or more terms is more than the JAX limit of 2e-2;
    so weighted bf16 bags are held (a) against the plain version with
    weights that are bf16 values, within 2e-2, and (b) with the raw weights
    against the plain version in f32 on the same table values, within the
    one rounding to bf16 the kernel makes (2⁻⁸ relative) plus 1e-5."""
    _card()
    table, ids, w = _inputs(67, F, 5000, D)
    w = w if weighted else None
    if weighted:
        w[::5, -1] = 0.0                       # zero-weight padding
    bf16 = dtype == "bfloat16"
    w_plain = torch.from_numpy(w).to(torch.bfloat16).float().numpy() \
        if weighted and bf16 else w
    before = ops.launches
    out = _port(table, ids, w_plain, combiner, dtype, "cuda")
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    assert out.dtype == getattr(torch, dtype) and out.shape == (67, D)
    t = torch.from_numpy(table).to("cuda", getattr(torch, dtype))
    tid = torch.from_numpy(ids).cuda()
    cw = None if w is None else torch.from_numpy(w_plain).cuda()
    plain = embedding_bag_padded_ref(t, tid, cw, combiner)
    if F == 1 and not weighted:
        assert torch.equal(out, plain)       # a bag of one: the row, bit for bit
    np.testing.assert_allclose(_f32(out), _f32(plain), rtol=TOL[dtype], atol=TOL[dtype])
    if weighted and bf16:
        raw = torch.from_numpy(w).cuda()
        out = ops.embedding_bag(t, tid, raw, combiner)
        exact = embedding_bag_padded_ref(t.float(), tid, raw, combiner)
        np.testing.assert_allclose(_f32(out), _f32(exact), rtol=2 ** -8 + 1e-5, atol=1e-5)


@pytest.mark.kernels
def test_cuda_kernel_indexes_past_two_to_the_31():
    """A bf16 table of more than 2³¹ elements: rows past element 2³¹ come
    back bit for bit (64-bit offsets), as bags of one and as a multi-hot sum."""
    _card()
    V, D = (1 << 24) + 4096, 128                  # 2.15e9 elements, 4.3 GB
    table = torch.zeros((V, D), dtype=torch.bfloat16, device="cuda")
    rows = torch.tensor([0, 5, (1 << 24) - 1, 1 << 24, V - 2, V - 1], device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    table[rows] = torch.randn((len(rows), D), generator=g, device="cuda").to(torch.bfloat16)
    ids = rows.to(torch.int32)
    one = ops.embedding_bag(table, ids[:, None])
    assert torch.equal(one, table[rows])
    bag = ops.embedding_bag(table, ids.reshape(2, 3))
    plain = embedding_bag_padded_ref(table, ids.reshape(2, 3))
    torch.testing.assert_close(bag.float(), plain.float(), rtol=2e-2, atol=2e-2)
    del table
    torch.cuda.empty_cache()


# ------------------------------------------- the wrapper's path and geometry
@pytest.mark.parametrize("D,elem,lanes", [
    (7, 2, 0), (8, 2, 1), (9, 2, 0), (10, 2, 0), (18, 2, 0), (64, 2, 8), (128, 2, 16),
    (600, 2, 32), (7, 4, 0), (8, 4, 2), (9, 4, 0), (64, 4, 16), (128, 4, 32), (600, 4, 32)])
def test_bag_geometry_path_by_row_width(D, elem, lanes):
    """A row of a whole number of 16-byte vectors takes the vector path, with
    its vector count rounded up to a power of two (at most 32) lanes a bag;
    any other width the scalar path (lanes 0)."""
    assert bag_geometry(D, elem, 100, 1, True)[0] == lanes


@pytest.mark.parametrize("D,elem", [(8, 2), (128, 2), (8, 4), (128, 4)])
def test_bag_geometry_unaligned_takes_scalar_path(D, elem):
    """A table or output that is not 16-byte aligned (a view offset by one
    element) goes to the scalar path at any width."""
    assert bag_geometry(D, elem, 100, 26, True)[0] > 0
    assert bag_geometry(D, elem, 100, 26, False) == (0, 1, 13)


def test_bag_geometry_empty_bags_take_scalar_path():
    assert bag_geometry(128, 2, 100, 0, True) == (0, 1, 13)


@pytest.mark.parametrize("F", [1, 2, 3, 4, 5, 8, 12, 26, 40, 64])
def test_bag_geometry_fills_whole_windows(F):
    """A group's items in a run, bags × F, fill whole windows of AHEAD row
    loads, with the fewest bags that do."""
    bags = bag_geometry(128, 2, 10_000, F, True)[1]
    assert bags * F % AHEAD == 0 and all(b * F % AHEAD for b in range(1, bags))


def test_bag_geometry_at_the_bulk_gather():
    """262,144 × 26 bags of one 256-byte row: 16 lanes a bag, 8 bags a
    group, two groups a warp, so 425,984 runs and one block for each 8 of
    them (the launch caps the grid at the card's resident blocks)."""
    assert bag_geometry(128, 2, 262_144 * 26, 1, True) == (16, 8, 53_248)
    # the serve_p99 gather: 832 runs, one a warp
    assert bag_geometry(128, 2, 512 * 26, 1, True) == (16, 8, 104)


@pytest.mark.parametrize("D", [8, 128])
@pytest.mark.parametrize("F", [1, 3, 26, 40])
@pytest.mark.parametrize("B", [1, 2, 31, 33, 1000])
def test_bag_geometry_runs_cover_every_bag_once(B, F, D):
    """The vector kernel's walk (grid-stride over runs; group g of a warp
    takes bags run · groups · bags + g + groups · m, m < bags, below B)
    reaches each of the B bags exactly once, with the grid ``bag_geometry``
    gives and with that grid capped at two blocks, as the launch caps it on
    a card that holds few resident, so warps loop over several runs."""
    lanes, bags, blocks = bag_geometry(D, 2, B, F, True)
    groups = 32 // lanes
    n_runs = -(-B // (groups * bags))
    assert blocks * WARPS_PER_BLOCK >= n_runs
    for grid in (blocks, min(blocks, 2)):
        n_warps = grid * WARPS_PER_BLOCK
        seen = [b for warp in range(n_warps) for run in range(warp, n_runs, n_warps)
                for g in range(groups) for m in range(bags)
                if (b := run * groups * bags + g + groups * m) < B]
        assert sorted(seen) == list(range(B))


# ------------------------------------------------ on the card: path edges
def _check_on_card(t, tid, w, combiner="sum"):
    """Kernel against the plain version on the card: a bag of one with no
    weights bit for bit, otherwise within the limits (weighted bf16 bags as
    ``test_cuda_kernel_matches_plain`` holds them)."""
    bf16 = t.dtype == torch.bfloat16
    tw = None if w is None else torch.from_numpy(w).cuda()
    w_plain = tw.to(torch.bfloat16).float() if tw is not None and bf16 else tw
    out = ops.embedding_bag(t, tid, w_plain, combiner)
    plain = embedding_bag_padded_ref(t, tid, w_plain, combiner)
    assert out.dtype == t.dtype and out.shape == plain.shape
    if tid.shape[1] == 1 and w is None:
        assert torch.equal(out, plain)
    tol = TOL["bfloat16" if bf16 else "float32"]
    np.testing.assert_allclose(_f32(out), _f32(plain), rtol=tol, atol=tol)
    if tw is not None and bf16:
        exact = embedding_bag_padded_ref(t.float(), tid, tw, combiner)
        np.testing.assert_allclose(_f32(ops.embedding_bag(t, tid, tw, combiner)), _f32(exact),
                                   rtol=2 ** -8 + 1e-5, atol=1e-5)


@pytest.mark.kernels
@pytest.mark.parametrize("weighted", [False, True], ids=["ones", "weighted"])
@pytest.mark.parametrize("F", [1, 26, 40])
@pytest.mark.parametrize("B", [1, 2, 31, 33])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [7, 8, 9, 64, 128])
def test_cuda_kernel_path_edges(D, dtype, B, F, weighted):
    """Row widths on both sides of a multiple of 16 bytes, B not a multiple
    of the bags a warp takes, F of one bag, of 26 (not a multiple of the
    window) and of 40."""
    _card()
    table, ids, w = _inputs(B, F, 3000, D)
    if weighted:
        w[::3, -1] = 0.0
    t = torch.from_numpy(table).to("cuda", getattr(torch, dtype))
    _check_on_card(t, torch.from_numpy(ids).cuda(), w if weighted else None)
    if weighted:
        _check_on_card(t, torch.from_numpy(ids).cuda(), w, "mean")


@pytest.mark.kernels
@pytest.mark.parametrize("dtype,D", [("bfloat16", 128), ("float32", 8), ("bfloat16", 64)])
@pytest.mark.parametrize("shift", ["row", "element"])
def test_cuda_kernel_table_view_offset(dtype, D, shift):
    """A table that is a view into a larger one, offset by one row (still
    16-byte aligned here: the vector path) or by one element (unaligned: the
    scalar path), bags of one bit for bit and weighted bags of 26 within the
    limits."""
    _card()
    V = 2000
    big, ids, w = _inputs(64, 26, V + 1, D)
    flat = torch.from_numpy(big).to("cuda", getattr(torch, dtype)).reshape(-1)
    lo = D if shift == "row" else 1
    t = flat[lo:lo + V * D].view(V, D)
    assert t.is_contiguous()
    assert (t.data_ptr() % 16 == 0) == (shift == "row")
    tid = torch.from_numpy(ids % V).cuda()
    _check_on_card(t, tid.reshape(-1, 1).contiguous(), None)
    _check_on_card(t, tid, w)
