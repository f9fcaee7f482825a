"""ctypes wrappers of the CUDA alias-table build (``csrc/alias_build.cu``) and
MH probe (``csrc/mh_resample.cu``).

They replace the TPU kernels ``repro.kernels.alias.kernel.alias_build_pallas``
and ``mh_resample_pallas``. Each library is built at its first launch
(``repro_torch.kernels.load``). The wrappers check their tensors, allocate the
outputs, launch on the current stream and raise if the launch fails.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import kernels as kernels_mod
from repro_torch.kernels import LaunchPlan, check_arg

_fns = {}
_P = ctypes.c_void_p
_I = ctypes.c_int


def _launcher(name: str, argtypes):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(kernels_mod.load(name), f"{name}_launch")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _need_cuda(name: str, x: torch.Tensor) -> torch.device:
    if x.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {x.device}")
    return x.device


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


@functools.lru_cache(maxsize=1024)
def alias_build_plan(R: int, K: int) -> LaunchPlan:
    """The launch ``alias_build_cuda`` makes for R rows of K slots (``nw``:
    the scratch's 32-bit words a row and kind, one bit per 32-slot tile)."""
    return LaunchPlan("alias_build", "alias_build_kernel",
                      (("R", R), ("K", K), ("nw", -(-K // 1024))))


def alias_build_cuda(weights, scale, out=None):
    """Launch the Walker sweep over every row at once: weights [R, K] f32 and
    the mean-1 scale [R] f32 (from ``ops._scale``) → (prob [R, K] f32, alias
    [R, K] int32), written into ``out`` when given. The kernel forms
    wn = weights·scale and the small/large partition itself; the tables equal
    ``ref.build_alias_ref(*ops._prepare(weights, scale))`` bit for bit."""
    dev = _need_cuda("alias_build_cuda", weights)
    R, K = weights.shape
    if not 0 < K < 2 ** 31 - 1024:
        raise ValueError(f"K={K} out of range")
    check_arg("weights", weights, torch.float32, (R, K), dev)
    check_arg("scale", scale, torch.float32, (R,), dev)
    if out is None:
        out = (torch.empty((R, K), dtype=torch.float32, device=dev),
               torch.empty((R, K), dtype=torch.int32, device=dev))
    prob, alias = out
    check_arg("prob", prob, torch.float32, (R, K), dev)
    check_arg("alias", alias, torch.int32, (R, K), dev)
    R_arg, K_arg, nw = kernels_mod.launch_args(alias_build_plan(R, K))
    # scratch: per row and kind, one bit per 32-slot tile that holds a slot of
    # that kind
    bitmaps = torch.empty((R, 2, nw), dtype=torch.int32, device=dev)
    fn = _launcher("alias_build", [_P, _P, _I, _I, _I, _P, _P, _P, _P])
    with torch.cuda.device(dev):
        err = fn(weights.data_ptr(), scale.data_ptr(), R_arg, K_arg, nw,
                 prob.data_ptr(), alias.data_ptr(), bitmaps.data_ptr(), _stream(dev))
    if err:
        raise RuntimeError(f"alias_build kernel launch failed: CUDA error {err}")
    return prob, alias


# slot bounds of the MH kernel that holds a pair row in registers
# (``mh_resample_kernel_regs<16 | 32>``); longer rows take the generic kernel
MH_SLOT_BOUNDS = (16, 32)


def mh_slot_bound(cap: int) -> int:
    """The register kernel's slot bound for pair rows of ``cap`` slots: the
    least of ``MH_SLOT_BOUNDS`` that holds them, or 0 for the generic kernel,
    which reads the row from memory for each lookup."""
    return next((b for b in MH_SLOT_BOUNDS if cap <= b), 0)


@functools.lru_cache(maxsize=1024)
def mh_resample_plan(T: int, K: int, cap: int, n_mh: int) -> LaunchPlan:
    """The launch ``mh_resample_cuda`` makes for T tokens of K topics and
    pair rows of ``cap`` slots: the register kernel of ``mh_slot_bound(cap)``
    slots, or the generic one."""
    bound = mh_slot_bound(cap)
    kernel = f"mh_resample_kernel_regs<{bound}>" if bound else "mh_resample_kernel"
    return LaunchPlan("mh_resample", kernel, (("n_mh", n_mh), ("T", T), ("K", K),
                                              ("cap", cap), ("slot_bound", bound)))


def mh_resample_cuda(phi, psi, doc_topic, doc_count, wq, wp, wa, alpha, ap, aa,
                     w, d, z, uid, seed2: int, beta, alpha_sum,
                     vocab_size: int, n_mh: int) -> torch.Tensor:
    """Launch the MH probe, one thread per token → z_new [T] int32, with the
    pair row in registers when ``mh_slot_bound(cap)`` is not 0.

    Same contract as ``ref.mh_resample_ref``, with int32 w/d/z, int64 uid
    holding uint32 values, and ``beta``/``alpha_sum`` 0-dim f32 tensors on
    the card.
    """
    dev = _need_cuda("mh_resample_cuda", phi)
    rows, K = phi.shape
    D, cap = doc_topic.shape
    T = w.shape[0]
    if not (0 < K < 2 ** 24 and 0 <= vocab_size < 2 ** 24 and 0 <= n_mh < 2 ** 29):
        raise ValueError(f"K={K}, vocab_size={vocab_size} or n_mh={n_mh} out of range")
    for name, x, dtype, shape in (
            ("phi", phi, torch.int32, (rows, K)), ("psi", psi, torch.int32, (K,)),
            ("doc_topic", doc_topic, torch.int32, (D, cap)),
            ("doc_count", doc_count, torch.int32, (D, cap)),
            ("wq", wq, torch.float32, (rows, K)), ("wp", wp, torch.float32, (rows, K)),
            ("wa", wa, torch.int32, (rows, K)), ("alpha", alpha, torch.float32, (K,)),
            ("ap", ap, torch.float32, (K,)), ("aa", aa, torch.int32, (K,)),
            ("w", w, torch.int32, (T,)), ("d", d, torch.int32, (T,)),
            ("z", z, torch.int32, (T,)), ("uid", uid, torch.int64, (T,)),
            ("beta", beta, torch.float32, ()), ("alpha_sum", alpha_sum, torch.float32, ())):
        check_arg(name, x, dtype, shape, dev)
    ints = kernels_mod.launch_args(mh_resample_plan(T, K, cap, n_mh))
    out = torch.empty(T, dtype=torch.int32, device=dev)
    fn = _launcher("mh_resample", [_P] * 14 + [ctypes.c_uint32, _P, _P, ctypes.c_float]
                   + [_I] * 5 + [_P, _P])
    with torch.cuda.device(dev):
        err = fn(phi.data_ptr(), psi.data_ptr(), doc_topic.data_ptr(),
                 doc_count.data_ptr(), wq.data_ptr(), wp.data_ptr(), wa.data_ptr(),
                 alpha.data_ptr(), ap.data_ptr(), aa.data_ptr(), w.data_ptr(),
                 d.data_ptr(), z.data_ptr(), uid.data_ptr(), int(seed2) & 0xFFFF_FFFF,
                 beta.data_ptr(), alpha_sum.data_ptr(), float(vocab_size), *ints,
                 out.data_ptr(), _stream(dev))
    if err:
        raise RuntimeError(f"mh_resample kernel launch failed: CUDA error {err}")
    return out
