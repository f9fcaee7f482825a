"""ctypes wrapper of the CUDA EmbeddingBag kernel (``csrc/embedding_bag.cu``).

Replaces the TPU kernel ``repro.kernels.embedding_bag.kernel.embedding_bag_pallas``.
The library is built at the first launch (``repro_torch.kernels.load``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels as kernels_mod
from repro_torch.kernels import check_arg

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = kernels_mod.load("embedding_bag").embedding_bag_launch
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, p, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def embedding_bag_cuda(table, ids, weights=None, combiner: str = "sum") -> torch.Tensor:
    """Launch the kernel on the current stream. table [V, D] f32 or bf16, ids
    [B, F] int32 in [0, V) (not checked: that would sync the host), weights
    [B, F] f32 or None (all ones) → [B, D] in the table's dtype. f32
    accumulation in the order f = 0 … F−1, one rounding at the end."""
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
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launcher()(
            table.data_ptr(), ids.data_ptr(),
            None if weights is None else weights.data_ptr(), B, F, D,
            int(combiner == "mean"), _DTYPES[table.dtype], out.data_ptr(), stream)
    if err:
        raise RuntimeError(f"embedding_bag kernel launch failed: CUDA error {err}")
    return out
