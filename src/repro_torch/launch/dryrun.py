"""Production dry run: every (architecture × shape × mesh) cell, per rank,
against the H100 (port of ``repro.launch.dryrun``).

The JAX dry run lowers and compiles each cell on 512 fake host devices and
reads XLA's memory analysis. The port runs one process per rank and has no
compiler to ask, so each cell gets three records:

* **the mesh record**, at JAX's production meshes (16×16 = 256 ranks, and
  2×16×16 = 512 with ``--multi-pod``; ``launch/mesh.py`` of the JAX
  package): the cell is built for that mesh and its global arguments, empty
  ``meta`` tensors, are cut by their specs to one rank's block
  (``dist/sharding.block_shape``). It holds those bytes by role,
  ``model_flops``, ``model_coll_bytes``, ``note``, the cell's ``extra``
  (``sampler_traffic``), and the roofline terms against the H100: the
  useful FLOPs over every rank's f32 peak, one rank's argument bytes read
  once over its HBM rate, the collective bytes over every rank's NVLink.
  ``status`` is ``ok``, ``skip`` (with JAX's reason: the LM archs'
  ``long_500k``) or ``fail`` (with the error), as JAX records a failed build.
* **the one-rank record** (``one_rank``), the counterpart of JAX's compile
  and ``memory_analysis``: the same cell built for one rank, its arguments
  drawn on the card and ``timed_steps(family, step_kind)`` steps run after
  one warm-up step (an LM prefill step, which takes seconds, is timed on the
  warm-up step itself, which runs under ``count_cost``'s dispatch mode and
  is the cell's first call: its record says ``timed_on_counted_step``):
  ``step_ms`` (their median, CUDA events: a step of
  milliseconds alone can take a host stall), ``live_bytes_per_device``
  (``max_memory_allocated`` over the steps, after
  ``reset_peak_memory_stats``), ``fits_80gb_hbm``, the flops, bytes and
  moved bytes ``dist/analysis.count_cost`` counts over the warm-up step,
  ``useful_flops_ratio`` and its roofline share (the larger of the flops
  over the f32 peak and the moved bytes over the HBM rate, over
  ``step_ms``; above 1 where the traffic stayed in the 50 MB L2 cache). A
  cell whose one-rank arguments exceed the card's 80 GB is recorded with
  the reckoned bytes and not run (peacock-lda's Φ or P̂ is 84 GB at V = 210,000; the MoE
  archs' train cells, every ``decode_32k`` and all ``prefill_32k`` but
  smollm-135m's). A step that runs out of memory is a ``fail`` naming the
  error. Each arch's parameters are drawn once and shared by its shapes
  (cast to each cell's dtype). Where the cell has a ``one_rank_cut`` (an LM
  train step, 128 microbatches at one rank) the record runs the cut cell and
  says what it cuts under ``reduced``.
* **the rank step** (``rank_step``), the counterpart of JAX's compile,
  ``memory_analysis``, cost and HLO collective mix for one device of the
  production mesh: rank 0's step of the cell built for that mesh, on this
  device alone, the other ranks stood in by a mirror world
  (``launch.mesh.mirror_ranks``; ``RankStep``), its views drawn at their
  block shapes (``Cell.rank_args``); the same step fields as the one-rank
  record, and ``collectives`` (JAX primitive → calls and payload bytes).
  Where the cell has a ``rank_cut`` (an LM train step: 8 or 16
  microbatches at a rank) the record runs the cut cell, says so under
  ``reduced`` and folds the cut loop's collectives back to the whole step
  (``collectives_folded``). The mesh record's collective term is then JAX's:
  the larger of ``model_coll_bytes`` and those bytes times the chips
  (``collective_bytes_traced``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch autoint --shape serve_p99
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out FILE]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device meta --json

``--all`` records both meshes unless ``--multi-pod`` picks the 2×16×16 one
(a record compiles nothing here, unlike JAX's, whose ``--all`` takes one).
  PYTHONPATH=src python -m repro_torch.launch.dryrun --shard-table [--json]

``--device`` is ``cuda`` by default and raises when there is no card;
``meta`` records the mesh records alone (no step runs, nothing is drawn;
the one-rank and rank steps ``not_run``); ``cpu`` runs the one-rank and
rank steps on the host, where no time or memory is measured (for small
cells).
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import subprocess
import sys
import time
import traceback

import torch

from repro_torch import kernels, resolve_device
from repro_torch.dist import analysis
from repro_torch.dist import sharding as shd

# NVIDIA H100 SXM data sheet
HBM_BYTES_PER_S = 3.35e12    # HBM3
F32_FLOPS = 67e12            # f32 outside the tensor cores: every GEMM of the
                             # port's cells runs in f32 with TF32 off
NVLINK_BYTES_PER_S = 450e9   # NVLink 4, one direction
HBM_BYTES = 80e9             # device memory

# JAX's production meshes as (pods, data, model)
MESHES = {False: (1, 16, 16), True: (2, 16, 16)}
TIMED_STEPS = 3              # a one-rank step's time is their median


def timed_steps(family: str, step_kind: str, rank: bool = False) -> int:
    """The timed steps of a cell's one-rank or rank (``rank``) record after
    its warm-up: one for an LM train cell and an LDA ring epoch, whose step
    takes seconds, so that a host stall of milliseconds does not move it;
    none for an LM prefill cell and a rank's LM train cell, whose warm-up
    step (seconds, large ops, under ``count_cost``) is the timed one (the
    dry run's time on the card); ``TIMED_STEPS`` for every other cell."""
    if family == "lm" and step_kind in ("train", "prefill"):
        return 0 if step_kind == "prefill" or rank else 1
    if step_kind == "lda_train":
        return 1
    return TIMED_STEPS

def mesh_layout(multi_pod: bool) -> shd.RankLayout:
    return shd.RankLayout(*MESHES[multi_pod])


def mesh_name(multi_pod: bool) -> str:
    return "x".join(str(n) for n in MESHES[multi_pod] if multi_pod or n != 1)


def _rank_bytes(arg, spec, layout: shd.RankLayout) -> float:
    """Bytes of one rank's block of ``arg`` (a tensor, a dict or list of
    them, or a Python scalar, which JAX holds as a 0-dim 4-byte array)."""
    if isinstance(arg, dict):
        return sum(_rank_bytes(arg[k], spec[k], layout) for k in arg)
    if isinstance(arg, (list, tuple)):
        return sum(_rank_bytes(a, s, layout) for a, s in zip(arg, spec))
    if isinstance(arg, torch.Tensor):
        return float(math.prod(shd.block_shape(arg.shape, spec, layout)) * arg.element_size())
    return 4.0


def argument_bytes(cell, layout: shd.RankLayout) -> dict:
    """Role → bytes of one rank's blocks of ``cell``'s arguments under
    ``layout`` (from ``meta`` stand-ins: nothing is allocated)."""
    out: dict = {}
    for arg, spec, role in zip(cell.make_args(None, "meta"), cell.arg_specs, cell.arg_roles):
        out[role] = out.get(role, 0.0) + _rank_bytes(arg, spec, layout)
    return out


def _terms(flops: float, mem_bytes: float, coll_bytes: float, chips: int) -> dict:
    return {"compute_s": flops / (chips * F32_FLOPS),
            "memory_s": mem_bytes / HBM_BYTES_PER_S,
            "collective_s": coll_bytes / (chips * NVLINK_BYTES_PER_S)}


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def _shapes(tree):
    """The shapes of a parameter tree (a dict of tensors, nested or not)."""
    if isinstance(tree, dict):
        return tuple((k, _shapes(tree[k])) for k in sorted(tree))
    return tuple(tree.shape)


class OneRank:
    """The one-rank steps of a dry run on ``device``: each arch's parameters
    drawn once (``params``), each (arch, shape) run once (``records``)."""

    def __init__(self, device, skip_cost: bool = False, seed: int = 0):
        self.dev = resolve_device(device)
        self.skip_cost = skip_cost
        self.seed = seed
        self.params: dict = {}
        self.records: dict = {}
        self.card = None
        if self.dev.type == "cuda":
            self.card = card_line()
            torch.backends.cuda.matmul.allow_tf32 = False    # the GEMMs stay f32

    def release(self, arch: str) -> None:
        """Give back ``arch``'s parameters (after its last shape)."""
        self.params.pop(arch, None)
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def record(self, spec, shape: str) -> dict:
        key = (spec.arch_id, shape)
        if key not in self.records:
            self.records[key] = self._run(spec, shape)
        return self.records[key]

    def _run(self, spec, shape: str) -> dict:
        rec: dict = {"device": str(self.dev)}
        if self.card:
            rec["card"] = self.card
        try:
            cell = spec.cell(shape, None)
            if cell.one_rank_cut is not None:
                cell = cell.one_rank_cut()
                rec["reduced"] = cell.reduced
            args_b = sum(argument_bytes(cell, shd.RankLayout(1, 1, 1)).values())
        except Exception as e:  # noqa: BLE001 — a failed build is a recorded bug
            rec.update(status="fail", error=f"build: {type(e).__name__}: {e}")
            return rec
        rec["arguments_bytes"] = args_b
        if self.dev.type == "meta":
            rec.update(status="not_run", reason="--device meta: no step runs",
                       fits_80gb_hbm=bool(args_b < HBM_BYTES))
            return rec
        if args_b >= HBM_BYTES:
            rec.update(status="not_run", fits_80gb_hbm=False,
                       reason=f"one rank's arguments take {args_b / 1e9:.1f} GB, more than "
                              f"the card's {HBM_BYTES / 1e9:.0f} GB")
            return rec
        args = None
        try:
            args = self._args(spec.arch_id, cell)
            rec.update(self._step(cell, args, spec.family))
            rec["status"] = "ok"
        except torch.cuda.OutOfMemoryError as e:
            rec.update(status="fail", fits_80gb_hbm=False,
                       error=f"OutOfMemoryError: {str(e).splitlines()[0]}")
        except Exception as e:  # noqa: BLE001 — a failed step is a recorded bug
            rec.update(status="fail", error=f"{type(e).__name__}: {e}",
                       traceback=traceback.format_exc()[-2000:])
        finally:
            del args
            gc.collect()
            if self.dev.type == "cuda":
                torch.cuda.empty_cache()
        return rec

    def _args(self, arch: str, cell):
        g = torch.Generator(device=self.dev).manual_seed(self.seed)
        takes_params = cell.arg_roles[:1] == ("params",)
        params = self.params.get(arch) if takes_params else None
        if params is not None and _shapes(params) != _shapes(cell.make_args(None, "meta")[0]):
            params = None                # graphsage-reddit: each shape its own widths
        args = cell.make_args(g, self.dev, params=params)
        if takes_params:
            self.params[arch] = args[0]
        return args

    def _step(self, cell, args, family: str) -> dict:
        return run_step(cell, args, family, self.dev, self.skip_cost)[0]


def run_step(cell, args, family: str, dev, skip_cost: bool = False,
             rank: bool = False) -> dict:
    """The warm-up step of ``cell`` on ``args`` (under ``count_cost`` unless
    ``skip_cost``: the flops and bytes of a step), then the timed steps on
    the card (``timed_steps``): (the record's step fields, the warm-up's
    ``Cost`` or None)."""
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    kernels.reset_launch_counts()
    out: dict = {}
    cost = None
    n = timed_steps(family, cell.step_kind, rank)
    if cuda:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if n == 0:
            torch.cuda.reset_peak_memory_stats()
            a.record()
    if skip_cost:
        cell.fn(*args)
    else:
        cost, _ = analysis.count_cost(cell.fn, *args)
    sync()
    if cuda:
        times = []
        if n == 0:                      # the warm-up step is the timed one
            b.record()
            b.synchronize()
            times.append(float(a.elapsed_time(b)))
        else:
            torch.cuda.reset_peak_memory_stats()
        for _ in range(n):
            a.record()
            cell.fn(*args)
            b.record()
            b.synchronize()
            times.append(float(a.elapsed_time(b)))
        live = int(torch.cuda.max_memory_allocated())
        out.update(step_ms=sorted(times)[len(times) // 2], timed_steps=len(times),
                   timed_on_counted_step=n == 0,
                   live_bytes_per_device=live, fits_80gb_hbm=bool(live < HBM_BYTES))
    else:
        cell.fn(*args)
        out.update(step_ms=None, live_bytes_per_device=None,
                   fits_80gb_hbm=None, measured="not measured: no card")
    if not skip_cost:
        out["cost"] = {"flops": cost.flops, "bytes": cost.bytes,
                       "moved_bytes": cost.moved_bytes,
                       "kernels": cost.kernels, "collectives": cost.collectives,
                       "collective_bytes": cost.collective_bytes}
        out["useful_flops_ratio"] = (cell.model_flops / cost.flops) if cost.flops else None
        terms = _terms(cost.flops, cost.moved_bytes, 0.0, 1)
        out["roofline"] = terms
        out["bottleneck"] = max(terms, key=terms.get)
        if out.get("step_ms"):
            out["roofline_share"] = max(terms.values()) / (out["step_ms"] / 1e3)
    out["launches"] = kernels.launch_counts()
    return out, cost


class NotRun:
    """A rank step left out of a dry run: its record says why."""

    def __init__(self, reason: str):
        self.reason = reason

    def record(self, spec, shape: str, multi_pod: bool) -> dict:
        return {"status": "not_run", "reason": self.reason}


def by_primitive(calls: dict, nbytes: dict) -> dict:
    """JAX primitive → {"calls", "bytes"} of one step's collectives."""
    return {k: {"calls": calls[k], "bytes": nbytes[k]} for k in sorted(calls)}


class RankStep:
    """The rank steps of a dry run's mesh records on ``device``: rank 0 of
    the cell built for the production mesh, run on this device alone with
    the other ranks stood in by a mirror world (``launch.mesh.mirror_ranks``:
    every rank holds rank 0's values, so each collective returns what the
    real world returns when every rank passes the same tensor, and charges
    what it charges there). The arguments are the rank's views drawn at
    their block shapes (``Cell.rank_args``). The counterpart of JAX's
    compile, ``memory_analysis``, cost and HLO collective mix for one
    device of the mesh: ``step_ms``, ``live_bytes_per_device``,
    ``fits_80gb_hbm``, the counted ``cost``, the ``collectives`` by JAX
    primitive (calls and payload bytes of the step as run, and
    ``collectives_folded`` to the whole step where ``rank_cut`` runs fewer
    trips of its loop, said under ``reduced``) and the kernels' launches."""

    def __init__(self, device, skip_cost: bool = False, seed: int = 0):
        self.dev = resolve_device(device)
        self.skip_cost = skip_cost
        self.seed = seed
        self.card = card_line() if self.dev.type == "cuda" else None

    def record(self, spec, shape: str, multi_pod: bool) -> dict:
        from repro_torch.launch import mesh

        rec: dict = {"device": str(self.dev), "rank": 0}
        if self.card:
            rec["card"] = self.card
        if self.dev.type == "meta":
            rec.update(status="not_run", reason="--device meta: no step runs")
            return rec
        args, t0 = None, time.perf_counter()
        base = torch.cuda.memory_allocated(self.dev) if self.dev.type == "cuda" else 0
        try:
            layout = mesh.mirror_ranks(*MESHES[multi_pod], rank=0, device=self.dev)
            cell = spec.cell(shape, layout)
            if cell.rank_cut is not None:
                cell = cell.rank_cut()
                rec["reduced"] = cell.reduced
            g = torch.Generator(device=self.dev).manual_seed(self.seed)
            args = cell.rank_args(g, self.dev, layout)
            out, cost = run_step(cell, args, spec.family, self.dev, self.skip_cost, rank=True)
            if base and out.get("live_bytes_per_device") is not None:
                out["live_bytes_per_device"] -= base   # what stayed allocated before the draw
                out["fits_80gb_hbm"] = bool(out["live_bytes_per_device"] < HBM_BYTES)
            rec.update(out)
            if cost is not None:
                rec["collectives"] = by_primitive(cost.collectives, cost.collective_bytes)
                rec["collectives_folded"] = by_primitive(cost.folded_collectives,
                                                         cost.folded_collective_bytes)
                rec["collective_bytes"] = sum(cost.folded_collective_bytes.values())
            rec["status"] = "ok"
        except torch.cuda.OutOfMemoryError as e:
            rec.update(status="fail", fits_80gb_hbm=False,
                       error=f"OutOfMemoryError: {str(e).splitlines()[0]}")
        except Exception as e:  # noqa: BLE001 — a failed step is a recorded bug
            rec.update(status="fail", error=f"{type(e).__name__}: {e}",
                       traceback=traceback.format_exc()[-2000:])
        finally:
            del args
            gc.collect()
            if self.dev.type == "cuda":
                torch.cuda.empty_cache()
            rec["wall_s"] = time.perf_counter() - t0
        return rec


def rank_selected(which: str, arch: str, shape: str, mesh: str) -> bool:
    """Whether ``--rank-steps which`` runs the rank step of ``arch``'s cell
    ``shape`` at ``mesh``: a comma list of ``all``, ``none``, meshes
    (``16x16``), arch ids, ``arch/shape`` and ``arch@mesh`` or
    ``arch/shape@mesh``; an item with a leading ``-`` leaves its cells out."""
    items = {w.strip() for w in which.split(",")}
    names = {mesh, arch, f"{arch}@{mesh}", f"{arch}/{shape}", f"{arch}/{shape}@{mesh}"}
    if names & {w[1:] for w in items if w.startswith("-")}:
        return False
    return "all" in items or bool(items & names)


def run_cell(spec, shape: str, multi_pod: bool, one_rank=None, rank_step=None) -> dict:
    """The mesh record of ``spec``'s cell ``shape`` at the production mesh,
    with ``one_rank``'s record of the same cell under ``"one_rank"`` and
    ``rank_step``'s (a ``RankStep``) under ``"rank_step"``. Where the rank
    step counted its collectives, the roofline's collective term is JAX's:
    the larger of ``model_coll_bytes`` and the rank's (folded) bytes times
    the chips (``collective_bytes_traced``)."""
    layout = mesh_layout(multi_pod)
    chips = layout.world_size
    rec: dict = {"arch": spec.arch_id, "shape": shape, "mesh": mesh_name(multi_pod),
                 "chips": chips}
    try:
        cell = spec.cell(shape, layout)
    except Exception as e:  # noqa: BLE001 — a failed build is a recorded bug
        rec["status"] = "fail"
        rec["error"] = f"build: {type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        return rec
    if cell is None:
        rec["status"] = "skip"
        rec["reason"] = spec.skip.get(shape, "")
        return rec
    rec["note"] = cell.note
    if cell.extra:
        rec.update(cell.extra)
    try:
        by_role = argument_bytes(cell, layout)
        total = sum(by_role.values())
        rec["bytes_per_device"] = {"arguments": total, "by_role": by_role}
        rec["arguments_fit_80gb_hbm"] = bool(total < HBM_BYTES)
        rec["model_flops"] = cell.model_flops
        rec["model_coll_bytes"] = cell.model_coll_bytes
        terms = _terms(cell.model_flops, total, cell.model_coll_bytes, chips)
        rec["roofline"] = terms
        rec["bottleneck"] = max(terms, key=terms.get)
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — a failed cell is a recorded bug
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        return rec
    if one_rank is not None:
        rec["one_rank"] = one_rank.record(spec, shape)
    if rank_step is not None:
        with_rank_step(rec, spec, rank_step)
    return rec


def with_rank_step(rec: dict, spec, rank_step) -> dict:
    """``rec`` (an ok mesh record of ``spec``'s cell) with ``rank_step``'s
    record of the cell under ``"rank_step"`` and, where it counted the
    collectives, JAX's collective term in the roofline."""
    if rec.get("status") != "ok":
        return rec
    rs = rec["rank_step"] = rank_step.record(spec, rec["shape"], rec["mesh"] == mesh_name(True))
    if rs.get("collective_bytes") is not None:
        chips, terms = rec["chips"], rec["roofline"]
        traced = rs["collective_bytes"] * chips
        rec["collective_bytes_traced"] = traced
        terms["collective_s"] = max(rec["model_coll_bytes"], traced) / (
            chips * NVLINK_BYTES_PER_S)
        rec["bottleneck"] = max(terms, key=terms.get)
    return rec


def print_shard_table(n_topics: int = 100_000, vocab: int = 1_000_000,
                      data_shards: int = 16, out=None,
                      as_json: bool = False) -> list:
    """Replicated-vs-word-sharded per-device memory table at paper scale
    (10⁵ topics × 10⁶ words; DESIGN.md §10), each row against the H100's
    80 GB.

    Token count is the paper's regime (~10⁹ queries × 4.5 tokens); it only
    enters the rotation-traffic column, never the memory fit."""
    n_tokens = 4.5e9
    recs = []
    if not as_json:
        print(f"# §10 word-sharded model parallelism @ K={n_topics:,} "
              f"V={vocab:,} (data ring M={data_shards}):", flush=True)
        print("#   P   phi+tables/dev      theta/dev      HBM/dev  <80GB  "
              "rotation/dev/epoch", flush=True)
    for p in (1, 2, 4, 8):
        r = analysis.model_shard_report(
            n_topics, vocab, data_shards, p, n_tokens,
            docs_per_shard=4096, doc_topic_cap=64)
        model = r["phi_bytes_per_device"] + r["tables_bytes_per_device"]
        hbm = r["hbm_bytes_per_device"]
        fits = hbm < HBM_BYTES
        r["fits_80gb_hbm"] = bool(fits)
        recs.append(r)
        if not as_json:
            print(f"#  {p:2d}   {model/1e9:10.1f} GB   "
                  f"{r['theta_bytes_per_device']/1e9:8.3f} GB"
                  f"   {hbm/1e9:8.1f} GB   {'yes' if fits else ' no'}  "
                  f"{r['rotation_bytes_per_epoch']/1e9:12.1f} GB",
                  flush=True)
    if as_json:
        print(json.dumps({"shard_table": {
            "n_topics": n_topics, "vocab": vocab,
            "data_shards": data_shards, "n_tokens": n_tokens,
            "rows": recs,
        }}, indent=2), flush=True)
    if out:
        with open(out, "a") as f:
            for r in recs:
                f.write(json.dumps({"shard_table": r}) + "\n")
    return recs


def _summary(rec: dict) -> str:
    head = f"# {rec['arch']}/{rec['shape']} [{rec['mesh']}]"
    if rec["status"] == "skip":
        return f"{head} SKIP: {rec['reason']}"
    if rec["status"] == "fail":
        return f"{head} FAIL: {rec['error']}"
    line = (f"{head} OK args/rank={rec['bytes_per_device']['arguments'] / 1e9:.3f}GB "
            f"bottleneck={rec['bottleneck']}")
    rs = rec.get("rank_step")
    if rs is not None:
        line += f" | rank step: {rs['status']}"
        if rs.get("step_ms") is not None:
            coll = ", ".join(f"{k} {v['bytes'] / 1e6:.1f} MB"
                             for k, v in rs.get("collectives_folded", {}).items())
            line += (f" step={rs['step_ms']:.3f}ms live={rs['live_bytes_per_device'] / 1e9:.2f}GB"
                     f" collectives {coll or 'none'} (model_coll_bytes / chips "
                     f"{rec['model_coll_bytes'] / rec['chips'] / 1e6:.1f} MB)")
        elif rs.get("reason") or rs.get("error"):
            line += f" ({rs.get('reason') or rs.get('error')})"
    one = rec.get("one_rank")
    if one is not None:
        line += f" | one rank: {one['status']}"
        if one.get("step_ms") is not None:
            line += (f" step={one['step_ms']:.3f}ms live={one['live_bytes_per_device'] / 1e9:.2f}GB"
                     f" roofline share={one.get('roofline_share', float('nan')):.3f}"
                     f" ({one.get('bottleneck')}) on {one.get('card')}")
        elif one.get("reason") or one.get("error"):
            line += f" ({one.get('reason') or one.get('error')})"
    st = rec.get("sampler_traffic")
    if st:
        line += (f"\n#   sampler HBM/epoch: dense={st['dense_bytes_per_epoch']/1e9:.1f}GB "
                 f"alias={st['alias_bytes_per_epoch']/1e9:.1f}GB "
                 f"(x{st['dense_over_alias']:.0f} less with --sampler alias)")
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true",
                    help="16x16 and 2x16x16 (the default of --all without --multi-pod)")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    ap.add_argument("--skip-cost", action="store_true",
                    help="run the one-rank and rank steps without count_cost's step")
    ap.add_argument("--rank-steps", default="all",
                    help="which mesh records run their rank step: all (default), none, "
                         "or a comma list of meshes (16x16), arch ids, arch/shape and "
                         "arch@mesh or arch/shape@mesh, a leading - leaving its cells out; "
                         "the others record it not_run")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cpu (small cells) or meta (no step runs)")
    ap.add_argument("--shard-table", action="store_true",
                    help="print the replicated-vs-word-sharded per-device "
                         "memory/rotation table at paper scale (§10) against "
                         "the H100's 80 GB and exit")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output only (suppresses the human "
                         "`#` lines; with --shard-table emits one JSON document)")
    ap.add_argument("--verify", action="store_true",
                    help="run the repro_torch.analysis launch gate (sharding / sm_90 "
                         "launch budgets / determinism / concurrency / lint) on the "
                         "default P=2 alias session and exit 0/1 (--json: the report)")
    args = ap.parse_args(argv)

    if args.verify:
        from repro_torch.analysis import preflight as pf

        report = pf.run_preflight(pf.SessionSpec())
        print(report.to_json(indent=2) if args.json else report.render())
        return 0 if report.ok else 1
    if args.shard_table:
        print_shard_table(out=args.out, as_json=args.json)
        return 0

    from repro_torch.configs import all_ids, all_specs

    specs = all_specs()
    # a record costs no compile here, so --all covers both meshes unless
    # --multi-pod picks the one
    both = args.both_meshes or (args.all and not args.multi_pod)
    meshes = [False, True] if both else [args.multi_pod]
    if args.all:
        ids = all_ids()
    elif args.arch is None:
        ap.error("give --arch, --all or --shard-table")
    else:
        if args.arch not in specs:
            ap.error(f"unknown arch '{args.arch}'; known: {sorted(all_ids())}")
        ids = [args.arch]
    one_rank = OneRank(args.device, skip_cost=args.skip_cost)
    rank_step = RankStep(args.device, skip_cost=args.skip_cost)
    if one_rank.card and not args.json:
        print(f"# card: {one_rank.card}", flush=True)
    t0 = time.perf_counter()
    for arch in ids:
        spec = specs[arch]
        shapes = [args.shape] if args.shape else list(spec.shapes)
        recs = [run_cell(spec, s, mp, one_rank) for s in shapes for mp in meshes]
        one_rank.release(arch)             # before the rank steps: their peak is their own
        for rec in recs:
            with_rank_step(rec, spec, rank_step if rank_selected(args.rank_steps, arch,
                                                                 rec["shape"], rec["mesh"])
                           else NotRun(f"--rank-steps {args.rank_steps}"))
        for rec in recs:
            line = json.dumps(rec)
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
            if not args.json:
                print(_summary(rec), flush=True)
    if not args.json:
        print(f"# dry run: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
