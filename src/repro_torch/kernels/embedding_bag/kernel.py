"""ctypes wrapper of the CUDA EmbeddingBag kernel (``csrc/embedding_bag.cu``).

Replaces the TPU kernel ``repro.kernels.embedding_bag.kernel.embedding_bag_pallas``.
The library is built at the first launch (``repro_torch.kernels.load``).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch import kernels as kernels_mod
from repro_torch.kernels import check_arg

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None

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
    lanes, bags, blocks = bag_geometry(D, table.element_size(), B, F,
                                       (t_ptr | o_ptr) % 16 == 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launcher()(
            t_ptr, ids.data_ptr(), None if weights is None else weights.data_ptr(), B, F, D,
            int(combiner == "mean"), _DTYPES[table.dtype], lanes, bags, blocks, o_ptr,
            stream)
    if err:
        raise RuntimeError(f"embedding_bag kernel launch failed: CUDA error {err}")
    return out
