"""ctypes wrappers of the CUDA EmbeddingBag kernels: the forward
(``csrc/embedding_bag.cu``) and its gradient with respect to the table
(``csrc/embedding_bag_bwd.cu``).

The forward replaces the TPU kernel
``repro.kernels.embedding_bag.kernel.embedding_bag_pallas``; the gradient
replaces no TPU kernel (JAX takes ``jnp.take``'s transpose, an XLA
scatter-add). The gradient is one launch of its library: a plan (the
short-run tiles; the runs longer than ``LONG_RUN`` items, longest first),
a short-run and a long-run kernel; ``bwd_tiles`` and ``long_runs`` are the
plan's plain versions, ``bwd_vec`` and ``bwd_copy`` its load widths. Each
library is built at its first launch (``repro_torch.kernels.load``).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch import kernels as kernels_mod
from repro_torch.kernels import LaunchPlan, check_arg

from repro_torch.kernels.embedding_bag.ref import row_runs

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None
_bwd_fn = None

WARPS_PER_BLOCK = 8      # kThreads / 32 in the source
AHEAD = 8                # kAhead: row loads a lane of the vector path has in flight


@functools.lru_cache(maxsize=1024)
def bag_geometry(D: int, elem_size: int, B: int, F: int, aligned: bool):
    """Path and launch geometry of the kernel → (lanes, bags, blocks).

    ``lanes`` 0 is the scalar path: one warp a bag, ``blocks`` = ⌈B / 8⌉.
    Otherwise the vector path: 16-byte loads, ``lanes`` (a power of two ≤ 32)
    lanes a bag, so a warp serves 32 / lanes bags at once; each group of
    lanes takes ``bags`` bags a run, enough (bag, f) items to fill whole
    windows of ``AHEAD`` row loads; ``blocks`` gives each warp one run, and
    the launch caps it at the blocks the card holds resident (the occupancy
    API's count for the kernel, times the SMs), so each warp loops over
    runs. The vector path needs F ≥ 1, a row of a whole number of 16-byte
    vectors and ``aligned``: the table and the output 16-byte aligned.
    """
    row_bytes = D * elem_size
    if F == 0 or row_bytes % 16 or not aligned:
        return 0, 1, max(1, -(-B // WARPS_PER_BLOCK))
    vpr = row_bytes // 16
    lanes = min(32, 1 << (vpr - 1).bit_length())
    bags = AHEAD // math.gcd(AHEAD, F)
    runs = -(-B // (32 // lanes * bags))
    return lanes, bags, max(1, -(-runs // WARPS_PER_BLOCK))


@functools.lru_cache(maxsize=1024)
def bag_plan(D: int, dtype: int, B: int, F: int, aligned: bool, mean: int) -> LaunchPlan:
    """The launch ``embedding_bag_cuda`` makes (``dtype`` 0: f32, 1: bf16):
    the path and grid of ``bag_geometry``."""
    lanes, bags, blocks = bag_geometry(D, 2 if dtype else 4, B, F, aligned)
    t = "bf16" if dtype else "float"
    kernel = (f"embedding_bag_kernel_vector<{t}, {lanes}>" if lanes
              else f"embedding_bag_kernel_scalar<{t}>")
    return LaunchPlan("embedding_bag", kernel, (("F", F), ("D", D), ("mean", mean),
                                                ("dtype", dtype), ("lanes", lanes),
                                                ("bags", bags), ("blocks", blocks)))


def _launcher():
    global _fn
    if _fn is None:
        fn = kernels_mod.load("embedding_bag").embedding_bag_launch
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, ctypes.c_longlong] + [ctypes.c_int] * 7 + [p, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def embedding_bag_cuda(table, ids, weights=None, combiner: str = "sum") -> torch.Tensor:
    """Launch the kernel on the current stream. table [V, D] f32 or bf16, ids
    [B, F] int32 in [0, V) (not checked: that would sync the host), weights
    [B, F] f32 or None (all ones) → [B, D] in the table's dtype. f32
    accumulation in the order f = 0 … F−1, one rounding at the end; the path
    (16-byte vectors or scalar loads) and grid from ``bag_geometry``."""
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"embedding_bag_cuda needs CUDA tensors, got {dev}")
    if table.dtype not in _DTYPES:
        raise TypeError(f"table has dtype {table.dtype}, expected float32 or bfloat16")
    if combiner not in ("sum", "mean"):
        raise ValueError(f"combiner must be 'sum' or 'mean', got {combiner!r}")
    if table.dim() != 2 or ids.dim() != 2:
        raise ValueError("table must be [V, D] and ids [B, F]")
    (V, D), (B, F) = table.shape, ids.shape
    if not 0 < D < 2 ** 31 or not 0 <= F < 2 ** 31:
        raise ValueError(f"D={D} or F={F} out of range")
    check_arg("table", table, table.dtype, (V, D), dev)
    check_arg("ids", ids, torch.int32, (B, F), dev)
    if weights is not None:
        check_arg("weights", weights, torch.float32, (B, F), dev)
    out = torch.empty((B, D), dtype=table.dtype, device=dev)
    t_ptr, o_ptr = table.data_ptr(), out.data_ptr()
    ints = kernels_mod.launch_args(bag_plan(D, _DTYPES[table.dtype], B, F,
                                            (t_ptr | o_ptr) % 16 == 0, int(combiner == "mean")))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launcher()(
            t_ptr, ids.data_ptr(), None if weights is None else weights.data_ptr(), B, *ints,
            o_ptr, stream)
    if err:
        raise RuntimeError(f"embedding_bag kernel launch failed: CUDA error {err}")
    return out


LONG_RUN = 256           # runs of more items go to the long-run kernel
LONG_COLS = 32           # kLongCols: columns of a long run's slice, one a lane
TILE_ITEMS = 64          # items of `order` whose runs a warp of the short-run kernel takes


def _widest(D: int, elem_size: int, ptr: int) -> int:
    """The most bytes, up to 16, that divide a row of D elements and the
    address ``ptr`` (at least one element)."""
    n = 16
    while n > elem_size and ((D * elem_size) % n or ptr % n):
        n //= 2
    return n


def bwd_vec(D: int, elem_size: int, ptr: int) -> int:
    """Elements a lane of the short-run kernel loads at once: the fewest,
    among the widths of up to 4 elements and 16 bytes that divide a row of D
    elements and the address ``ptr``, that let 32 lanes cover the row (D =
    128 bf16: 4, so every lane is live); the widest if none does."""
    vec = min(4, _widest(D, elem_size, ptr) // elem_size)
    while vec > 1 and 32 * (vec // 2) >= D:
        vec //= 2
    return vec


def bwd_copy(D: int, elem_size: int, ptr: int) -> int:
    """Bytes a copy of the long-run kernel moves into shared memory: the most,
    up to 16, that divide a row of D elements and the address ``ptr``. A
    slice starts at a multiple of ``LONG_COLS`` columns, so it divides every
    slice's offset and length too."""
    return _widest(D, elem_size, ptr)


def bwd_tiles(starts, N: int, tile_items: int):
    """The short-run kernel's tiles, as the plan's ``tiles_kernel`` makes
    them (its plain version) → [⌈N / tile_items⌉ + 1] int64: tile t takes the
    runs (starts [U + 1] int64, into an ``order`` of N items) whose first
    item lies in the stretch [t, t + 1) · tile_items of the items in runs,
    tiles[t] ≤ u < tiles[t + 1]: every run in one tile, each tile's runs
    consecutive, and a tile's items at most tile_items plus its last run's."""
    n_tiles = max(1, -(-N // tile_items))
    edges = torch.arange(0, (n_tiles + 1) * tile_items, tile_items, device=starts.device)
    return torch.searchsorted(starts[:-1], starts[:1] + edges)


def long_runs(starts, N: int, long_run: int):
    """The long-run kernel's work, as the plan's ``select_long_kernel`` and
    ``sort_long_kernel`` make it (their plain version) → by_len [M] int64:
    the runs of more than ``long_run`` items, longest first (stable:
    ascending run within a length), then −1s, where M = min(U, N //
    (long_run + 1)) is the most there can be. Run by_len[i // slices] at the
    columns (i % slices) · LONG_COLS up to ``LONG_COLS`` more is the kernel's
    work item i, slices = ⌈D / LONG_COLS⌉."""
    U = starts.numel() - 1
    M = min(U, N // (long_run + 1))
    counts = starts[1:] - starts[:-1]
    found = torch.nonzero_static(counts > long_run, size=M, fill_value=-1)[:, 0]
    key = torch.where(found >= 0, counts[found], -1)
    return found[torch.argsort(key, descending=True, stable=True)]


@functools.lru_cache(maxsize=1024)
def bwd_plans(F: int, D: int, dtype: int, vec: int, copy: int, mean: int):
    """Every launch ``embedding_bag_bwd_runs_cuda`` can make for a [B, D]
    gradient of F ids a bag (``dtype`` 0: f32, 1: bf16; ``vec`` from
    ``bwd_vec``, ``copy`` from ``bwd_copy``): the plan's kernels (the tiles;
    where a run is long, the long runs' selection and sort), the short-run
    kernel and the long-run kernel. The launch function's int arguments
    ride the last two."""
    t, lib = ("bf16" if dtype else "float"), "embedding_bag_bwd"
    ints = (("F", F), ("D", D), ("mean", mean), ("dtype", dtype), ("vec", vec), ("copy", copy))
    return (LaunchPlan(lib, "tiles_kernel"), LaunchPlan(lib, "select_long_kernel"),
            LaunchPlan(lib, "sort_long_kernel"),
            LaunchPlan(lib, f"short_runs_kernel<{t}, {vec}>", ints),
            LaunchPlan(lib, f"long_runs_kernel<{t}, {copy}>", ints))


_long_streams = {}


def _long_stream(dev):
    """The second stream of ``dev`` the long runs' plan and kernel run on,
    of a higher priority than the default so that their blocks are placed
    first."""
    s = _long_streams.get(dev.index)
    if s is None:
        s = _long_streams[dev.index] = torch.cuda.Stream(dev, priority=-1)
    return s


def typed_entry_points(lib):
    """The gradient library ``lib``'s three entry points, typed: (launch,
    plan, scratch)."""
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    launch = lib.embedding_bag_bwd_launch
    launch.argtypes = [p] * 4 + [q, q] + [i] * 6 + [q, q, p, p, p, p]
    plan = lib.embedding_bag_bwd_plan_launch
    plan.argtypes = [p, q, q, q, q, p, p]
    launch.restype = plan.restype = i
    scratch = lib.embedding_bag_bwd_scratch
    scratch.argtypes = [q, q, q, q, p]
    scratch.restype = q
    return launch, plan, scratch


def _bwd_lib():
    global _bwd_fn
    if _bwd_fn is None:
        _bwd_fn = typed_entry_points(kernels_mod.load("embedding_bag_bwd"))
    return _bwd_fn


def _scratch(starts, N: int):
    """(scratch int64 on the runs' device, M, n_tiles) of a call."""
    layout = (ctypes.c_longlong * 4)()
    n = _bwd_lib()[2](starts.numel() - 1, N, TILE_ITEMS, LONG_RUN, layout)
    return torch.empty(n, dtype=torch.int64, device=starts.device), layout[0], layout[1]


def bwd_plan_cuda(starts, N: int):
    """The plan's kernels alone on the current stream, for checking them
    against ``bwd_tiles`` and ``long_runs`` (at ``TILE_ITEMS`` and
    ``LONG_RUN``) → (tiles, by_len)."""
    if starts.device.type != "cuda":
        raise ValueError(f"bwd_plan_cuda needs CUDA tensors, got {starts.device}")
    U = starts.numel() - 1
    scratch, M, n_tiles = _scratch(starts, N)
    with torch.cuda.device(starts.device):
        err = _bwd_lib()[1](starts.data_ptr(), U, N, TILE_ITEMS, LONG_RUN, scratch.data_ptr(),
                            torch.cuda.current_stream(starts.device).cuda_stream)
    if err:
        raise RuntimeError(f"embedding_bag_bwd plan launch failed: CUDA error {err}")
    return scratch[M:M + n_tiles + 1], scratch[:M]


def embedding_bag_bwd_cuda(grad_out, ids, weights=None, combiner: str = "sum"):
    """Launch the gradient kernel on the current stream. grad_out [B, D] f32
    or bf16, ids [B, F] int32, rows of the table or −1 (not checked: that
    would sync the host), weights [B, F] f32 or None → (rows [U] int64
    ascending, the distinct ids; row_grad [U, D] f32), each row's items summed in f32 in
    ascending (b, f) order (``ref.embedding_bag_padded_bwd_ref``). The stable
    sort that groups the ids into runs is ``ref.row_runs``."""
    dev = grad_out.device
    if dev.type != "cuda":
        raise ValueError(f"embedding_bag_bwd_cuda needs CUDA tensors, got {dev}")
    if grad_out.dim() != 2 or ids.dim() != 2:
        raise ValueError("grad_out must be [B, D] and ids [B, F]")
    check_arg("ids", ids, torch.int32, (grad_out.shape[0], ids.shape[1]), dev)
    order, rows, starts = row_runs(ids)
    return rows, embedding_bag_bwd_runs_cuda(grad_out, order, starts, ids.shape[1], weights,
                                             combiner)


def embedding_bag_bwd_runs_cuda(grad_out, order, starts, F: int, weights=None,
                                combiner: str = "sum"):
    """The kernel alone, on runs already grouped by ``ref.row_runs`` (order
    [N] int64, starts [U + 1] int64, N = B·F) → row_grad [U, D] f32. One
    launch of the library: the tiles and the short-run kernel on the current
    stream; where a run can be long, the long runs' plan and kernel on a
    second stream (``_long_stream``) that waits for the current one, which
    then waits for it in turn."""
    dev = grad_out.device
    if dev.type != "cuda":
        raise ValueError(f"embedding_bag_bwd_cuda needs CUDA tensors, got {dev}")
    if grad_out.dtype not in _DTYPES:
        raise TypeError(f"grad_out has dtype {grad_out.dtype}, expected float32 or bfloat16")
    if combiner not in ("sum", "mean"):
        raise ValueError(f"combiner must be 'sum' or 'mean', got {combiner!r}")
    if grad_out.dim() != 2:
        raise ValueError("grad_out must be [B, D]")
    B, D = grad_out.shape
    if not 0 < D < 2 ** 31 or not 0 <= F < 2 ** 31:
        raise ValueError(f"D={D} or F={F} out of range")
    U, N = starts.numel() - 1, B * F
    check_arg("grad_out", grad_out, grad_out.dtype, (B, D), dev)
    check_arg("order", order, torch.int64, (N,), dev)
    check_arg("starts", starts, torch.int64, (U + 1,), dev)
    if weights is not None:
        check_arg("weights", weights, torch.float32, (B, F), dev)
    out = torch.empty((U, D), dtype=torch.float32, device=dev)
    if U == 0:
        return out
    elem, ptr = grad_out.element_size(), grad_out.data_ptr()
    plans = bwd_plans(F, D, _DTYPES[grad_out.dtype], bwd_vec(D, elem, ptr),
                      bwd_copy(D, elem, ptr), int(combiner == "mean"))
    ints = kernels_mod.launch_args(plans[-1])
    scratch, _, _ = _scratch(starts, N)
    with torch.cuda.device(dev):
        err = _bwd_lib()[0](
            ptr, order.data_ptr(), starts.data_ptr(),
            None if weights is None else weights.data_ptr(), U, N, *ints, TILE_ITEMS, LONG_RUN,
            scratch.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream, _long_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"embedding_bag_bwd kernel launch failed: CUDA error {err}")
    return out
