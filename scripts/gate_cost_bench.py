#!/usr/bin/env python3
"""What the launch gate's changes to the main path cost on the card.

    python3 scripts/gate_cost_bench.py [--capb 2400,24000] [--reps 200] [--turns 4]

Two measurements, each of two forms in turns (a, b, b, a, ...) in one
process or world, so both see the same card and host:

* **the word-sharded round's model gather** (``core/distributed.py``):
  each rank's two [M, capb] int32 bucket planes (the visiting stack's doc
  and z) gathered over the "model" group of a 2×2 mesh of 4 gloo ranks
  sharing the card, stacked in one ``all_gather`` (the port's
  ``distributed.model_gather``, called here) and as one ``all_gather`` a
  plane (the form it replaced). ms a round on rank 0, host clock around
  ``torch.cuda.synchronize``; both must give the same [M, P·capb] planes.
  ``--capb`` 2,400 is ``chip_smoke.py``'s 2×2 bucket (cap 4,800 over P = 2).
* **the plan a launch pays** (``kernels.launch_args`` of the wrapper's
  cached plan function, as each wrapper calls them): µs a call on this host
  for ``gibbs_argmax``, the embedding bag and its gradient at dlrm-mlperf's
  shapes.

Prints the card's name and power limit; needs one CUDA card.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import kernel_bench as kb  # noqa: E402  (puts src/ on the path)


def gather_forms(layout, planes):
    """{form: fn() → gathered [2, M, P·capb] planes} over the "model" group."""
    from repro_torch.core import distributed as dist
    from repro_torch.dist import collectives as coll

    def stacked():
        return dist.model_gather(torch.stack(planes), layout)

    def per_plane():
        return torch.stack([coll.all_gather(a, layout, "model").permute(1, 0, 2)
                            .reshape(a.shape[0], -1) for a in planes])

    return {"stacked": stacked, "per_plane": per_plane}


def gather_rank(layout, capbs, reps, turns):
    """Rank body: ms a round of each form, in turns, at each capb."""
    import torch.distributed as dist
    out = {}
    for capb in capbs:
        g = torch.Generator().manual_seed(layout.rank)
        planes = [torch.randint(0, 1 << 20, (2, capb), generator=g, dtype=torch.int32).cuda()
                  for _ in range(2)]
        forms = gather_forms(layout, planes)
        if not torch.equal(forms["stacked"](), forms["per_plane"]()):
            raise AssertionError(f"capb={capb}: the two gathers differ")
        times = {k: [] for k in forms}
        order = [k for t in range(turns) for k in (("stacked", "per_plane") if t % 2 == 0
                                                   else ("per_plane", "stacked"))]
        for name in order:
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                forms[name]()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) / reps * 1e3)
        out[capb] = times
    return out


def plan_us(reps=20_000):
    """µs a call of each wrapper's plan and checked arguments on this host,
    as the wrapper makes it (a cached shape)."""
    from repro_torch import kernels
    from repro_torch.kernels.embedding_bag import kernel as ek
    from repro_torch.kernels.gibbs import kernel as gk

    cases = {"gibbs_argmax (8,192 x 100,000)":
             lambda: kernels.launch_args(gk.gibbs_argmax_plan(8192, 100_000)),
             "embedding_bag (512 x 26, bf16 D=128)":
             lambda: kernels.launch_args(ek.bag_plan(128, 1, 512, 26, True, 0)),
             "embedding_bag_bwd (bf16 D=128, F=1)":
             lambda: kernels.launch_args(ek.bwd_plans(1, 128, 1, 4, 16, 0)[-1])}
    out = {}
    for name, fn in cases.items():
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out[name] = (time.perf_counter() - t0) / reps * 1e6
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--capb", default="2400,24000")
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--turns", type=int, default=4)
    args = ap.parse_args(argv)
    if not kb.need_card("gate_cost_bench"):
        return 1
    from repro_torch.launch import mesh
    capbs = [int(c) for c in args.capb.split(",")]
    res = mesh.spawn(gather_rank, data=2, model=2, device="cuda", ranks_per_device=4,
                     backend="gloo", args=(capbs, args.reps, args.turns))
    for capb in capbs:
        for name in ("stacked", "per_plane"):
            t = res[0][capb][name]
            print(f"[model-gather] 2x2 on one card, two [2, {capb}] int32 planes, {name}: "
                  f"ms a round (rank 0, {args.reps} rounds a turn) turns "
                  f"{[round(x, 4) for x in t]}, median {float(np.median(t)):.4f}; ranks' "
                  f"medians {[round(float(np.median(r[capb][name])), 4) for r in res]}",
                  flush=True)
    for name, us in plan_us().items():
        print(f"[plan-check] {name}: {us:.2f} us a call", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
