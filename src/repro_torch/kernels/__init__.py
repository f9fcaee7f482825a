"""Build and load the port's hand-written CUDA kernels.

Each ``repro_torch/csrc/<name>.cu`` exports a plain C entry point. At first
use it is compiled by ``nvcc`` for Hopper (``sm_90a``) into
``build/repro_torch/lib<name>.so`` at the root of the checkout and loaded with
``ctypes``; PyTorch's headers are never included, so a build takes seconds.
A library is rebuilt when any source under ``csrc/`` is newer than it.

Every wrapper computes its :class:`LaunchPlan` (the instantiation and the C
``int`` arguments it passes) before it launches and passes the arguments
``launch_args`` checked; ``repro_torch.analysis.smem`` holds the same plans,
and the built kernels' own block, registers and shared memory
(``attributes``), to sm_90's limits.

Nothing here runs at import time: the CPU tests import every module on a
machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# -fmad=false and no --use_fast_math: the kernels' float op order and their
# accurate logf must match the plain PyTorch versions they are checked against.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``nvcc`` on PATH, else ``$CUDA_HOME/bin``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return path


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def kernel_names() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile each stale library, one ``nvcc`` per source, all started together.

    Returns the compiler output (register and shared-memory use, from
    ``-Xptxas=-v``) of each library built; raises if any build fails.
    """
    names = kernel_names() if names is None else list(names)
    newest = max(p.stat().st_mtime for p in CSRC.iterdir())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists() and out.stat().st_mtime >= newest:
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs.append((name, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = {}, []
    for name, tmp, out, proc in jobs:
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            failed.append(f"nvcc failed for {name}:\n{logs[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``lib<name>.so``, built first if it is stale."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def check_arg(name: str, x: torch.Tensor, dtype, shape, device) -> None:
    """Raise unless ``x`` is a contiguous ``dtype`` tensor of ``shape`` on ``device``."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


# sm_90's launch limits (CUDA C++ Programming Guide, compute capability 9.0)
MAX_THREADS_PER_BLOCK = 1024
SHARED_DEFAULT = 48 * 1024      # a block's shared bytes without an opt-in
SHARED_OPT_IN = 227 * 1024      # with cudaFuncSetAttribute(MaxDynamicSharedMemorySize)
REGISTERS_PER_SM = 65_536
INT32_MAX = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """One kernel launch as its wrapper is about to make it: the library
    (``csrc/<library>.cu``), the kernel instantiation as the library's
    ``<library>_attributes`` names it, and the C ``int`` arguments of the
    launch function (name, value). The block, the dynamic shared bytes and
    the grid are the launch function's own: ``attributes`` reports the
    first two, and every grid in ``csrc`` is one-dimensional and no larger
    than an ``int`` argument (or the card's resident blocks, or, in
    ``embedding_bag_bwd``, about a 128th of the items)."""

    library: str
    kernel: str
    int_args: Tuple[Tuple[str, int], ...] = ()


def plan_problems(plan: LaunchPlan) -> List[str]:
    """The ``int`` arguments of ``plan`` that int32 cannot carry; empty when
    the launch can pass them."""
    return [f"int argument {name} = {v:,} overflows int32" for name, v in plan.int_args
            if not -INT32_MAX - 1 <= v <= INT32_MAX]


def check_plan(plan: LaunchPlan) -> LaunchPlan:
    """Raise ``ValueError`` unless every ``int`` argument of ``plan`` fits
    int32 (ctypes would cut an overlong one silently); returns ``plan``."""
    problems = plan_problems(plan)
    if problems:
        raise ValueError(f"{plan.library}: launch of {plan.kernel} refused: "
                         + "; ".join(problems))
    return plan


@functools.lru_cache(maxsize=4096)
def launch_args(plan: LaunchPlan) -> Tuple[int, ...]:
    """The ``int`` arguments of ``plan``, in order, once ``check_plan`` has
    passed it: what a wrapper passes to its launch function. Cached, so a
    shape is checked once and a launch pays a lookup."""
    return tuple(v for _, v in check_plan(plan).int_args)


def shared_limit(opt_in: bool) -> int:
    """The most shared bytes a block may take on sm_90, with or without the
    source's opt-in."""
    return SHARED_OPT_IN if opt_in else SHARED_DEFAULT


# the fields of each entry <library>_attributes reports, in order
ATTRIBUTE_FIELDS = ("regs", "static_smem", "dynamic_smem", "max_dynamic_smem", "local_bytes",
                    "binary_version", "ptx_version", "max_threads", "threads", "blocks_per_sm",
                    "opt_in")


def attributes(name: str) -> List[Dict[str, object]]:
    """The built library ``lib<name>.so``'s kernels as the card reports them
    (``cudaFuncGetAttributes`` and the occupancy API, through its
    ``<name>_attributes`` entry point): one dict a kernel instantiation its
    launch can reach, ``kernel`` and ``library`` beside
    ``ATTRIBUTE_FIELDS``. Needs the card; launches nothing."""
    fn = getattr(load(name), f"{name}_attributes")
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_char_p), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = []
    for i in range(fn(-1, None, None)):
        kname = ctypes.c_char_p()
        vals = (ctypes.c_longlong * len(ATTRIBUTE_FIELDS))()
        err = fn(i, ctypes.byref(kname), vals)
        if err:
            raise RuntimeError(f"{name}_attributes({i}) failed: CUDA error {err}")
        out.append({"library": name, "kernel": kname.value.decode(),
                    **dict(zip(ATTRIBUTE_FIELDS, vals))})
    return out


# each kernel's launch counter: (kernel, its ops module, the counter's name)
LAUNCH_COUNTERS = (
    ("gibbs_argmax", "repro_torch.kernels.gibbs.ops", "launches"),
    ("alias_build", "repro_torch.kernels.alias.ops", "build_launches"),
    ("mh_resample", "repro_torch.kernels.alias.ops", "mh_launches"),
    ("embedding_bag", "repro_torch.kernels.embedding_bag.ops", "launches"),
    ("embedding_bag_bwd", "repro_torch.kernels.embedding_bag.ops", "bwd_launches"),
)


def launch_counts() -> Dict[str, int]:
    """Kernel name → the launches its ``ops`` wrapper has counted."""
    import importlib

    return {name: getattr(importlib.import_module(mod), attr)
            for name, mod, attr in LAUNCH_COUNTERS}


def reset_launch_counts() -> None:
    """Set every kernel's launch counter to 0."""
    import importlib

    for _, mod, attr in LAUNCH_COUNTERS:
        setattr(importlib.import_module(mod), attr, 0)
