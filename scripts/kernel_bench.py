"""Shared pieces of the kernel benches (``alias_build_bench.py``,
``bag_mh_bench.py``): the import path, the card line, builds of edited
copies of a kernel's source, CUDA-event timing and timing in turns.

A variant is another source with the committed C entry point, built with
the committed flags into ``build/<bench>/``. To time an earlier kernel whose
entry point differs, write a shim that renames the old entry point with a
``#define`` before ``#include``-ing the old source and defines the committed
one on top of it.
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (os.path.join(ROOT, "src"), ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def need_card(bench: str) -> bool:
    """Print the card's name and power limit and torch's version; False
    (with a message) when there is no CUDA card."""
    if not torch.cuda.is_available():
        print(f"{bench}: needs a CUDA card", file=sys.stderr)
        return False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {card.stdout.strip()}; torch {torch.__version__}", flush=True)
    return True


def start_builds(specs, bench: str):
    """One ``nvcc`` per ``NAME=PATH.cu`` spec, all started together →
    [(name, source path, library path, process)]."""
    from repro_torch import kernels
    out_dir = os.path.join(ROOT, "build", bench)
    os.makedirs(out_dir, exist_ok=True)
    jobs = []
    for spec in specs:
        name, src = spec.split("=", 1)
        so = os.path.join(out_dir, f"lib{name}.so")
        proc = subprocess.Popen([kernels.nvcc(), *kernels.NVCC_FLAGS, "-o", so, src],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, src, so, proc))
    return jobs


def finish_build(name, proc):
    """Wait for one build; raise with the compiler's output if it failed."""
    log = proc.communicate()[0]
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{log}")


def event_ms(fn, reps: int, stat=np.median) -> float:
    """``stat`` of ``reps`` CUDA-event times of ``fn`` after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(stat(times))


def in_turns(fns: dict, time) -> dict:
    """``time(fn)`` of each of ``fns`` in the order a, b, …, b, a →
    {name: [first, second]}."""
    names = list(fns)
    ms = {n: [] for n in names}
    for n in names + names[::-1]:
        ms[n].append(time(fns[n]))
    return ms


def fmt_turns(ms: dict, note=lambda name, times: "") -> str:
    return "; ".join(f"{n} {' / '.join(f'{t:.4f}' for t in ts)} ms{note(n, ts)}"
                     for n, ts in ms.items())
