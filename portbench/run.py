"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the port (``pnnp_tpu_torch``). With ``--trace 0`` the line carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, the
device's busy time over a bounded profiled pass and the breakdown. The
last lines on standard error, and the line's last key, give each number
compared with the plain reference beside its limit. The run needs a CUDA
device and fails without one.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent


def parse(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m portbench.run", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from portbench import harness

    harness.setup_env(CHECKOUT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("portbench: no CUDA device; the benchmark runs only on one", file=sys.stderr)
        return 2
    cell = harness.Cell(CHECKOUT / "BENCHMARK.json", args.workload)
    chips = int(cell.spec.get("chips", 1))
    if torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    line, checks = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda:0",
                               T_START)
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
