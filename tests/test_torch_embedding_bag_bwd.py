"""The plan of the CUDA row-gradient kernel (``kernels/embedding_bag/kernel.py``:
``bwd_tiles``, ``long_runs``, ``bwd_vec``, ``bwd_copy``), on CPU tensors.

The kernel splits the runs that ``ref.row_runs`` groups by id into long runs
(more than ``LONG_RUN`` items: one warp a (run, slice of ``LONG_COLS``
columns), longest run first) and short runs (one warp a tile of consecutive
runs). The plan is torch ops on the runs' device, so it is checked here
without a card: every run in exactly one class, the long runs longest first
and stably, every (run, column) summed by exactly one warp, each short-run
tile bounded in items, the thresholds' edges. The kernel's bits against the
plain version are checked on the card (``test_torch_recsys_train.py``,
marker ``kernels``, and ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread as _one_torch_thread  # noqa: F401  (autouse)
from repro_torch.kernels.embedding_bag.kernel import (
    LONG_COLS,
    LONG_RUN,
    TILE_ITEMS,
    bwd_copy,
    bwd_tiles,
    bwd_vec,
    long_runs,
)
from repro_torch.kernels.embedding_bag.ref import row_runs

pytestmark = pytest.mark.port

L = LONG_RUN


def _runs(lengths, padding=0, seed=0):
    """(order, starts, N) of ids whose run lengths are ``lengths`` (ids in
    ascending order), shuffled, with ``padding`` items of id −1."""
    rng = np.random.default_rng(seed)
    ids = np.concatenate([np.repeat(np.arange(len(lengths)), lengths),
                          np.full(padding, -1)]).astype(np.int32)
    rng.shuffle(ids)
    order, rows, starts = row_runs(torch.from_numpy(ids)[:, None])
    assert rows.tolist() == [u for u, n in enumerate(lengths) if n]
    return order, starts, ids.size


KINDS = {
    "edges": [L - 1, L, L + 1, 1, L + 1, L, L - 1, 2 * L, L + 2],
    "all short": [1, 2, 3, L, 5, L - 1] * 7,
    "all long": [L + 1, 3 * L, L + 1, 1000, 20_000, L + 1],
    "one run": [L + 1],
    "one short run": [L],
    "dlrm-like": [21_845, 16_384] + [6_553] * 3 + [67] * 40 + [2] * 300 + [1] * 500,
    "ties": [700, 300, 700, 300, 700, 300, 5, 700],
}


def _counts(starts):
    return (starts[1:] - starts[:-1]).numpy()


@pytest.mark.parametrize("padding", [0, 777])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_every_run_lies_in_one_class(kind, padding):
    """A run is long iff it has more than LONG_RUN items: the long ones are
    exactly the entries of ``long_runs`` before its −1s, each once, and the
    list holds as many entries as there can be long runs."""
    _, starts, N = _runs(KINDS[kind], padding)
    counts = _counts(starts)
    by_len = long_runs(starts, N, L).numpy()
    assert by_len.size == min(counts.size, N // (L + 1))
    found = by_len[by_len >= 0]
    assert (by_len[found.size:] == -1).all()
    assert sorted(found.tolist()) == np.flatnonzero(counts > L).tolist()


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_long_runs_come_longest_first_stably(kind):
    _, starts, N = _runs(KINDS[kind], seed=1)
    counts = _counts(starts)
    by_len = long_runs(starts, N, L).numpy()
    expect = [u for u in np.argsort(-counts, kind="stable") if counts[u] > L]
    assert by_len[:len(expect)].tolist() == expect


@pytest.mark.parametrize("tile_items", [1, 7, TILE_ITEMS, 1000])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_tiles_partition_the_runs(kind, tile_items):
    """Tile t takes runs tiles[t] .. tiles[t + 1] − 1: together every run
    once, in order, and a tile's short runs hold at most tile_items items
    plus its last run's."""
    _, starts, N = _runs(KINDS[kind], padding=50, seed=2)
    counts = _counts(starts)
    tiles = bwd_tiles(starts, N, tile_items).numpy()
    assert tiles.size == max(1, -(-N // tile_items)) + 1
    assert tiles[0] == 0 and tiles[-1] == counts.size and (np.diff(tiles) >= 0).all()
    for a, b in zip(tiles[:-1], tiles[1:]):
        short = counts[a:b][counts[a:b] <= L]
        if short.size:
            assert short[:-1].sum() < tile_items


def _cover(starts, N, D, elem_size, ptr):
    """How many times the two kernels sum each (run, column): [U, D], as the
    kernels walk the plan (long: work item i is run by_len[i // slices] at
    columns (i % slices) · LONG_COLS …; short: every run of each tile, the
    long ones left out, in passes of 32 lanes × vec columns)."""
    counts = _counts(starts)
    seen = np.zeros((counts.size, D), np.int64)
    by_len = long_runs(starts, N, L).numpy()
    slices = -(-D // LONG_COLS)
    copy = bwd_copy(D, elem_size, ptr)
    for i in range(by_len.size * slices):
        u = by_len[i // slices]
        if u < 0:
            break
        c0 = (i % slices) * LONG_COLS
        c1 = min(c0 + LONG_COLS, D)
        assert (c0 * elem_size) % copy == 0 and ((c1 - c0) * elem_size) % copy == 0
        seen[u, c0:c1] += 1
    vec = bwd_vec(D, elem_size, ptr)
    tiles = bwd_tiles(starts, N, TILE_ITEMS).numpy()
    for a, b in zip(tiles[:-1], tiles[1:]):
        for u in range(a, b):
            if counts[u] > L:
                continue
            for base in range(0, D, 32 * vec):
                for lane in range(32):
                    d0 = base + lane * vec
                    if d0 < D:
                        seen[u, d0:d0 + vec] += 1
    return seen


@pytest.mark.parametrize("elem_size", [4, 2], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("D", [1, 10, 16, 18, 100, 128])
def test_work_sums_each_run_column_once(D, elem_size):
    _, starts, N = _runs(KINDS["edges"] + KINDS["dlrm-like"][:40], padding=100, seed=3)
    assert (_cover(starts, N, D, elem_size, 0) == 1).all()


@pytest.mark.parametrize("elem_size", [4, 2], ids=["float32", "bfloat16"])
def test_work_sums_each_run_column_once_unaligned(elem_size):
    """A gradient one element off 16-byte alignment: smaller loads and
    copies, the same cover."""
    _, starts, N = _runs(KINDS["edges"], seed=4)
    assert bwd_copy(128, elem_size, elem_size) == elem_size
    assert bwd_vec(128, elem_size, elem_size) == 1
    assert (_cover(starts, N, 128, elem_size, elem_size) == 1).all()


@pytest.mark.parametrize("D,elem_size,ptr,vec,copy", [
    (128, 2, 0, 4, 16), (128, 4, 0, 4, 16), (256, 2, 0, 4, 16), (10, 2, 0, 1, 4),
    (18, 2, 0, 1, 4), (16, 2, 0, 1, 16), (1, 4, 0, 1, 4), (1, 2, 0, 1, 2), (100, 2, 0, 4, 8),
    (128, 2, 2, 1, 2), (128, 4, 4, 1, 4), (128, 2, 8, 4, 8)])
def test_load_widths(D, elem_size, ptr, vec, copy):
    """Short-run loads: the fewest elements (up to 4 and 16 bytes, dividing
    the row and the address) that let 32 lanes cover the row; long-run
    copies: the most bytes."""
    assert bwd_vec(D, elem_size, ptr) == vec
    assert bwd_copy(D, elem_size, ptr) == copy


def test_no_long_work_when_no_run_can_be_long():
    """N ≤ LONG_RUN items: no run can be long, the list is empty (the
    wrapper then launches only the short-run kernel)."""
    _, starts, N = _runs([L // 2, L // 2])
    assert N <= L and long_runs(starts, N, L).numel() == 0


def test_cuda_entry_points_refuse_cpu_tensors():
    """On a CPU tensor the kernel's wrappers raise, so ``ops`` is the only
    way to the plain version (there is no fallback inside them)."""
    from repro_torch.kernels.embedding_bag.kernel import (
        bwd_plan_cuda, embedding_bag_bwd_cuda, embedding_bag_bwd_runs_cuda)
    order, starts, N = _runs([3, L + 1])
    grad = torch.zeros((N, 4))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        embedding_bag_bwd_cuda(grad, torch.zeros((N, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        embedding_bag_bwd_runs_cuda(grad, order, starts, 1)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        bwd_plan_cuda(starts, N)
