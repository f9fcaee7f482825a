"""Build and load the port's hand-written CUDA kernels.

Each ``repro_torch/csrc/<name>.cu`` exports a plain C entry point. At first
use it is compiled by ``nvcc`` for Hopper (``sm_90a``) into
``build/repro_torch/lib<name>.so`` at the root of the checkout and loaded with
``ctypes``; PyTorch's headers are never included, so a build takes seconds.
A library is rebuilt when any source under ``csrc/`` is newer than it.

Nothing here runs at import time: the CPU tests import every module on a
machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

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
