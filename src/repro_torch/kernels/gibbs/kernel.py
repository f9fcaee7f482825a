"""ctypes wrapper of the CUDA Gibbs/RT-LDA argmax kernel (``csrc/gibbs_argmax.cu``).

Replaces the TPU kernel ``repro.kernels.gibbs.kernel.gibbs_argmax_pallas``.
The library is built at the first launch (``repro_torch.kernels.load``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import kernels as kernels_mod
from repro_torch.kernels import LaunchPlan, check_arg

_fn = None


@functools.lru_cache(maxsize=1024)
def gibbs_argmax_plan(T: int, K: int) -> LaunchPlan:
    """The launch ``gibbs_argmax_cuda`` makes for T rows of K topics."""
    return LaunchPlan("gibbs_argmax", "gibbs_argmax_kernel", (("T", T), ("K", K)))


def _launcher():
    global _fn
    if _fn is None:
        fn = kernels_mod.load("gibbs_argmax").gibbs_argmax_launch
        p = ctypes.c_void_p
        fn.argtypes = [p, p, ctypes.c_longlong, p, p, p, p, ctypes.c_uint32,
                       ctypes.c_float, ctypes.c_float, ctypes.c_int,
                       ctypes.c_int, p, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def gibbs_argmax_cuda(phi_rows, psi_rows, theta_rows, alpha, beta, token_uid,
                      seed: int, vocab_size: int,
                      temperature: float = 1.0) -> torch.Tensor:
    """Launch the kernel on the current stream. Same contract as ``ref.gibbs_argmax_ref``:
    phi/theta [T, K] f32, psi [T, K] or [K] f32, alpha [K] f32, beta a
    one-element f32 tensor, token_uid [T] int64 holding uint32 values → [T] int32.
    """
    T, K = phi_rows.shape
    dev = phi_rows.device
    if dev.type != "cuda":
        raise ValueError(f"gibbs_argmax_cuda needs CUDA tensors, got {dev}")
    if not 0 < K < 2 ** 31 or not 0 <= vocab_size < 2 ** 24:
        raise ValueError(f"K={K} or vocab_size={vocab_size} out of range")
    check_arg("phi_rows", phi_rows, torch.float32, (T, K), dev)
    check_arg("theta_rows", theta_rows, torch.float32, (T, K), dev)
    check_arg("psi_rows", psi_rows, torch.float32,
              (K,) if psi_rows.dim() == 1 else (T, K), dev)
    check_arg("alpha", alpha, torch.float32, (K,), dev)
    check_arg("beta", beta.reshape(1), torch.float32, (1,), dev)
    check_arg("token_uid", token_uid, torch.int64, (T,), dev)
    T_arg, K_arg = kernels_mod.launch_args(gibbs_argmax_plan(T, K))
    out = torch.empty(T, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launcher()(
            phi_rows.data_ptr(), psi_rows.data_ptr(),
            0 if psi_rows.dim() == 1 else K, theta_rows.data_ptr(),
            alpha.data_ptr(), beta.data_ptr(), token_uid.data_ptr(),
            int(seed) & 0xFFFF_FFFF, float(vocab_size), float(temperature),
            T_arg, K_arg, out.data_ptr(), stream)
    if err:
        raise RuntimeError(f"gibbs_argmax kernel launch failed: CUDA error {err}")
    return out
