#!/usr/bin/env python3
"""The readings the comparison's limits are set from, many runs in one
process: each seed with the program, with the control (the reference in
bfloat16 in the program's place) or with a planted fault, and for serving
cells at several offered rates (the sweep that finds the knee).

    python3 peacock_bench/readings.py --workload peacock-lda.train \
        --seeds 11,12,13 --modes program,control,fault:half --seconds 2

One JSON line a run: the seed, the mode, the rate, each compared number and
the end-to-end metrics. Not part of a benchmark run.
"""
import argparse
import gc
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, BENCH)
sys.path.insert(0, os.path.join(os.path.dirname(BENCH), "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default="program")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--rates", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    import harness

    rates = [float(r) for r in args.rates.split(",") if r] or [None]
    for seed in (int(s) for s in args.seeds.split(",")):
        for mode in args.modes.split(","):
            for rate in rates:
                t = time.perf_counter()
                res = harness.run_cell(args.workload, seed, args.seconds, False, t,
                                       device=args.device, mode=mode, rate=rate)
                rec = res["record"]
                out = {"seed": seed, "mode": mode, "rate": rate, "failed": res["failed"],
                       "checks": {k: v for k, (v, _) in res["checks"].items()},
                       "correct": harness.judge(res["checks"]),
                       "e2e": res["e2e"], "peak_gib": res["memory_peak_bytes"] / 2 ** 30,
                       "run_s": time.perf_counter() - t}
                for k in ("batch_rows", "batch_ms", "gen_lag_ms"):
                    if k in rec and rec[k]:
                        out[k + "_mean"] = sum(rec[k]) / len(rec[k])
                if rec.get("gen_lag_ms"):
                    import stats
                    out["gen_lag_p99_ms"] = stats.percentile(rec["gen_lag_ms"], 99)
                if rec.get("cache_lookups"):
                    out["hit_rate"] = rec["cache_hits"] / rec["cache_lookups"]
                if rec.get("gc_pause_ms") is not None:
                    gcp = rec["gc_pause_ms"]
                    out["gc"] = {g: [len([p for p, h in gcp if h == g]),
                                     round(sum(p for p, h in gcp if h == g), 1),
                                     round(max([p for p, h in gcp if h == g] or [0]), 1)]
                                 for g in (0, 1, 2)}
                if "epochs" in rec:
                    out["epochs"] = rec["epochs"]
                print(json.dumps(out), flush=True)
                del res, rec
                gc.collect()
                if args.device == "cuda":
                    torch.cuda.empty_cache()
    print(json.dumps({"forbidden_modules": harness.forbidden_modules(),
                      "card": harness.card_line()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
