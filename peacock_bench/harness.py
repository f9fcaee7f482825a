"""What every cell shares: finding a cell's files by name, the host spans
the benchmark records around the program's public calls, the profiler's
reduction to busy time, top operations and labelled idle gaps, and the
result line.

Layout, all found by the names in ``BENCHMARK.json``:

- ``configs/<config>.json``: a configuration's sizes and settings;
- ``traffic/<traffic>.json``: a traffic mix, the driver that offers it and
  its parameters;
- ``workloads/<cell>.json``: a cell's configuration and traffic, by name,
  and the limits of its comparison;
- ``drivers/<kind>.py``: one kind of traffic, ``run(ctx) -> dict``;
- ``metrics/<metric>.py``: one per-layer metric, ``read(record)`` returning
  a number, or None where the record holds nothing to read;
- ``reference/``: the plain reference that decides ``correct``.
"""
from __future__ import annotations

import bisect
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # top-level names, compared whole


def load_json(kind: str, name: str) -> dict:
    with open(os.path.join(BENCH, kind, f"{name}.json")) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    path = os.path.join(BENCH, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"peacock_bench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str, section: str) -> List[dict]:
    """The entries of ``section`` that the cell reports: those that list it,
    and those that list no cells."""
    return [m for m in bench[section] if cell in m.get("workloads", [cell])]


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


class StopWindow(Exception):
    """Raised from a callback when the measured window has closed."""


# ------------------------------------------------------------------ spans --

class Spans:
    """Host spans (name, start, end) on the ``time.perf_counter`` clock,
    from any thread, kept in memory; recorded only in a traced run, where
    they label the device's idle gaps."""

    def __init__(self, on: bool = True):
        self.on = on
        self._lock = threading.Lock()
        self.items: List[tuple] = []

    def add(self, name: str, t0: float, t1: float) -> None:
        if self.on:
            with self._lock:
                self.items.append((name, t0, t1))

    def span(self, name: str):
        spans = self

        class _Span:
            def __enter__(self):
                self.t0 = time.perf_counter()

            def __exit__(self, *exc):
                spans.add(name, self.t0, time.perf_counter())
        return _Span()


# ------------------------------------------------------------------ trace --

class Trace:
    """``torch.profiler`` over the measured window when ``on``; a no-op
    otherwise. ``reduce`` turns the device's activity between two host
    times into busy seconds, the operations that took most time and the
    idle gaps, each labelled by the first of ``priority``'s host spans open
    at its start."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None
        # offset from perf_counter seconds to the profiler's wall-clock ns
        self.offset_ns = time.time_ns() - time.perf_counter_ns()

    def prepare(self) -> None:
        """Start and stop the profiler once, in set-up: its first start
        initialises the tracer, which takes seconds."""
        if not self.on:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        """Trace the card's activity only: the host's spans are the
        benchmark's own, so no host operation is traced."""
        if not self.on:
            return
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()

    def stop(self) -> None:
        if self.prof is not None:
            self.prof.__exit__(None, None, None)

    def reduce(self, t0: float, t1: float, spans: Spans, priority) -> Optional[dict]:
        if self.prof is None:
            return None
        from torch.autograd import DeviceType
        lo = self.offset_ns + int(t0 * 1e9)
        hi = self.offset_ns + int(t1 * 1e9)
        ops: Dict[str, float] = {}
        iv = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
                continue
            s, f = max(e.start_ns(), lo), min(e.end_ns(), hi)
            if f <= s:
                continue
            iv.append((s, f))
            ops[e.name()] = ops.get(e.name(), 0.0) + (f - s) / 1e9
        iv.sort()
        busy, gaps, cur_s, cur_f = 0, [], lo, lo
        for s, f in iv:
            if s > cur_f:
                busy += cur_f - cur_s
                gaps.append((cur_f, s))
                cur_s = s
            cur_f = max(cur_f, f)
        busy += cur_f - cur_s
        if hi > cur_f:
            gaps.append((cur_f, hi))
        merged = {p: _merge([(self.offset_ns + int(a * 1e9), self.offset_ns + int(b * 1e9))
                             for n, a, b in spans.items if n == p]) for p in priority}
        idle: Dict[str, float] = {}
        for a, b in gaps:
            label = next((p for p in priority if _inside(merged[p], a)), "other host work")
            idle[label] = idle.get(label, 0.0) + (b - a) / 1e9
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {"busy_s": busy / 1e9, "window_s": (hi - lo) / 1e9, "ops": ops,
                "breakdown": {"device_ops": top(ops), "idle_gaps": top(idle)}}


def _merge(iv):
    """Sorted, merged (starts, ends) of intervals."""
    starts, ends = [], []
    for s, f in sorted(iv):
        if ends and s <= ends[-1]:
            ends[-1] = max(ends[-1], f)
        else:
            starts.append(s)
            ends.append(f)
    return starts, ends


def _inside(merged, t) -> bool:
    starts, ends = merged
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t < ends[i]


# ---------------------------------------------------------------- context --

@dataclasses.dataclass
class Context:
    """What a driver gets: the cell's files, the run's arguments, and the
    run's host spans and trace."""

    cell: str
    config: dict
    workload: dict
    traffic: dict
    seed: int
    seconds: float
    trace: Trace
    spans: Spans
    t_start: float
    device: str = "cuda"
    mode: str = "program"     # "program", "control", or "fault:<name>" (readings only)
    rate: Optional[float] = None   # an offered rate other than the cell's (sweeps only)

    @property
    def params(self) -> dict:
        return self.traffic["params"]


def judge(checks: Dict[str, tuple]) -> bool:
    return all(v <= lim for v, lim in checks.values())


def check_lines(checks: Dict[str, tuple]) -> List[str]:
    return [f"check {k}: {v!r} (limit {lim!r}) {'ok' if v <= lim else 'FAILED'}"
            for k, (v, lim) in checks.items()]


def result_line(res: dict, bench: dict, cell: str, trace_on: bool, chips: int) -> dict:
    """The contract's last line from a driver's result."""
    import torch

    out: Dict[str, Any] = {"correct": judge(res["checks"]),
                           "attempted": res["attempted"], "failed": res["failed"]}
    metrics = {}
    if trace_on:
        for m in cell_metrics(bench, cell, "per_layer"):
            v = load_module("metrics", m["name"]).read(res["record"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell_metrics(bench, cell, "end_to_end"):
            metrics[m["name"]] = {"value": res["e2e"][m["name"]], "unit": m["unit"]}
    out["metrics"] = metrics
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
           "memory_peak_bytes": res["memory_peak_bytes"]}
    tr = res["record"].get("trace")
    if trace_on and tr is not None:
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
        out["breakdown"] = tr["breakdown"]
    out["device"] = dev
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in res["checks"].items()}
    return out


def run_cell(cell: str, seed: int, seconds: float, trace_on: bool, t_start: float,
             device: str = "cuda", mode: str = "program", rate: Optional[float] = None) -> dict:
    """One run of a cell: its driver over its configuration and traffic."""
    workload = load_json("workloads", cell)
    traffic = load_json("traffic", workload["traffic"])
    ctx = Context(cell=cell, config=load_json("configs", workload["config"]),
                  workload=workload, traffic=traffic, seed=int(seed), seconds=float(seconds),
                  trace=Trace(trace_on), spans=Spans(trace_on), t_start=t_start, device=device,
                  mode=mode, rate=rate)
    return load_module("drivers", traffic["driver"]).run(ctx)
