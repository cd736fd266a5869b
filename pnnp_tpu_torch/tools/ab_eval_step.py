#!/usr/bin/env python3
"""Time the port's fused bf16 eval step in one tree, for A/B runs on one card.

    python3 pnnp_tpu_torch/tools/ab_eval_step.py ROOT [ROOT ...]

For each ROOT (a checkout of the repository, e.g. the parent commit unpacked
with ``git archive`` next to the working tree) a fresh process imports
``pnnp_tpu_torch`` from that tree and times the step of ``chip_smoke.py``
phase 4 on a full Sony frame ``[1, 1424, 2128, 4]`` at nf=32: five medians
of 10 CUDA-event timings after 5 warm-ups, the host time to enqueue a step,
and the host and wall time of one ``ssim_flat`` call. Give the trees in
turns (parent, change, change, parent) to compare two versions. Prints one
JSON line per tree. Needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time


def measure(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import pnnp_tpu_torch.kernels.ssim as K
    from pnnp_tpu_torch.models import UNetSeeInDark
    from pnnp_tpu_torch.train.steps import make_eval_metrics_step

    dev = torch.device("cuda")
    h, w = 1424, 2128
    rng = np.random.default_rng(1)
    lr = torch.from_numpy(rng.uniform(0, 0.4, (1, h, w * 4)).astype(np.float32)).to(dev)
    hr = torch.from_numpy(rng.uniform(0, 1, (1, h, w * 4)).astype(np.float32)).to(dev)
    net = UNetSeeInDark(nf=32, dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(0)).to(dev).eval()
    step = make_eval_metrics_step(net)
    call = lambda: step(lr, hr, 1.0, correct=True)
    for _ in range(5):
        call()
    torch.cuda.synchronize()
    medians = []
    for _ in range(5):
        times = []
        for _ in range(10):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        medians.append(statistics.median(times))

    def host_and_wall(fn, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / n * 1e3, (time.perf_counter() - t0) / n * 1e3

    enqueue_ms, step_wall_ms = host_and_wall(call, 20)
    x, y = hr[0] * 255.0, lr[0] * 255.0
    for _ in range(5):
        K.ssim_flat(x, y)
    ssim_host_ms, ssim_wall_ms = host_and_wall(lambda: K.ssim_flat(x, y), 200)
    return {"root": root, "card": torch.cuda.get_device_name(0),
            "bf16_step_ms_medians": medians, "enqueue_ms_per_step": enqueue_ms,
            "wall_ms_per_step": step_wall_ms, "ssim_flat_host_us": ssim_host_ms * 1e3,
            "ssim_flat_wall_us": ssim_wall_ms * 1e3}


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(measure(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    for root in argv:  # one process per tree: each imports its own package
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
