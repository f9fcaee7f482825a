#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result.

    python3 peacock_bench/run.py --workload peacock-lda.train --seed 7 \
        --seconds 20 --trace 0

From the root of a checkout, on a machine with the cell's cards. The cell's
files are found by its name (``harness.py``). With ``--trace 0`` the last
line of standard output holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics from a profiled window; the last lines
of standard error name each number the comparison held against its limit.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, BENCH)
sys.path.insert(0, os.path.join(os.path.dirname(BENCH), "src"))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import harness

    bench = harness.benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]
    own = harness.load_json("workloads", args.workload)
    named = {k: cells[args.workload][k] for k in ("config", "traffic")}
    if {k: own[k] for k in named} != named:
        print(f"workloads/{args.workload}.json names {own}, BENCHMARK.json {named}",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    res = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules of {bad} were loaded in the process that ran the cell", file=sys.stderr)
        return 4
    line = harness.result_line(res, bench, args.workload, bool(args.trace), chips)
    print(f"card: {harness.card_line()}", file=sys.stderr)
    for k, v in res.get("notes", {}).items():
        print(f"{k}: {v}", file=sys.stderr)
    for s in harness.check_lines(res["checks"]):
        print(s, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
