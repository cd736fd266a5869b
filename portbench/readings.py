"""Readings of the numbers that decide ``correct``, over many seeds in one
process: the port's sound runs (the lower readings) or the control's (the
upper readings) at a cell's own size, from which the limits in
``limits/<cell>.json`` are set.

    python3 -m portbench.readings --workload <cell> --seeds 11,12,13 [--control | --fault F] [--seconds 3]

Each seed is a whole run of the cell (set-up, a short window at the cell's
load, the comparison); one JSON line per seed, then the largest (sound) or
smallest (control, fault) reading of each number. ``--fault`` plants one of
``portbench/faults.py``'s faults in the port. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from contextlib import nullcontext

from portbench import faults, harness
from portbench.run import CHECKOUT


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.readings", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", choices=sorted(faults.FAULTS))
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    harness.setup_env(CHECKOUT)
    import torch

    if not torch.cuda.is_available():
        print("portbench.readings: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.Cell(CHECKOUT / "BENCHMARK.json", args.workload)
    seen: dict = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        with faults.FAULTS[args.fault]() if args.fault else nullcontext():
            line, checks = harness.run(cell, seed, args.seconds, False, "cuda:0",
                                       time.perf_counter(), control=args.control)
        for name, value, _ in checks:
            seen.setdefault(name, []).append(value)
        print(json.dumps({"seed": seed, "control": args.control, "fault": args.fault,
                          "correct": line["correct"],
                          "attempted": line["attempted"],
                          "checks": {n: v for n, v, _ in checks}}), flush=True)
    pick = min if args.control or args.fault else max
    print(json.dumps({"workload": args.workload, "control": args.control, "fault": args.fault,
                      "reading": {n: pick(v) for n, v in seen.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
