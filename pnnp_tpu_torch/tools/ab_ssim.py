#!/usr/bin/env python3
"""Time the SSIM kernel's routes against other builds of ``csrc/ssim.cu``, on one card.

    python3 -m pnnp_tpu_torch.tools.ab_ssim [--against NAME=PATH ...] [--iters 100]

This tree's kernel (``pnnp_tpu_torch/csrc/ssim.cu``, as ``this``) and each
``--against`` source (for example the parent commit's ``ssim.cu``, unpacked
with ``git archive`` under the git-ignored ``_checkout/``) are built into
libraries of their own and loaded side by side. At the raw Sony and IMX686
frames (C = 4: both routes) and at ``rgb_quality``'s sRGB Sony and IMX686
frames (C = 3: ``generic``), every build's routes are timed in turns (this,
the others, then the same in reverse, ``--rounds`` times): the mean of
``--iters`` back-to-back launches between two CUDA events, after
``--warmup`` launches, on scratch allocated once. Every build's sum is held
to this build's within 1e-5 of the mean. Prints the card's name and power
limit, then one JSON line: per frame the microseconds of each build and
route (mean of its runs, and each run), the byte and operation bound
(H100 SXM: 3.35 TB/s, 67 TFLOP/s fp32; 89 operations a window, 3 a lane)
and each time's share of it. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
OPS_PER_WINDOW = 89  # 5 separable 7+7-tap sums (60) + the SSIM formula (29)
FRAMES = {"sony": (1424, 2128, 4), "imx686": (1736, 2312, 4),
          "sony_srgb": (2848, 4256, 3), "imx686_srgb": (3472, 4624, 3)}
AGREE = 1e-5  # of the mean SSIM, between builds
C1, C2 = (0.01 * 255.0) ** 2, (0.03 * 255.0) ** 2  # data range 255


def frame_pair(shape, seed=2):
    """A structured [H, W*C] pair on [0, 255]: vertical gradient, channel
    scale, noise (chip_smoke.py's kernel frames)."""
    rng = np.random.default_rng(seed)
    H, W, C = shape
    grad = np.linspace(0, 200, H, dtype=np.float32)[:, None, None]
    chans = (np.arange(C, dtype=np.float32) + 1.0)[None, None, :] * 20.0
    x = np.clip(grad + chans + rng.uniform(0, 40, shape).astype(np.float32), 0, 255)
    y = np.clip(x + rng.normal(0, 12, shape).astype(np.float32), 0, 255)
    return x.reshape(H, W * C), y.reshape(H, W * C)


def bound_us(H, W, C):
    """The least time for one call: x and y read once (and the sum written)
    at the memory's rate, against the fp32 operations at the peak rate."""
    n_bytes = 2 * H * W * C * 4 + 8
    ops = (H - 6) * (W - 6) * C * OPS_PER_WINDOW + H * W * C * 3
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e6, ops / FP32_FLOP_PER_S * 1e6
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def load_builds(sources: dict) -> dict:
    """Build every source at once (nvcc, as the package's kernels: one
    process each) and load it, declaring the two entries every version of
    ``ssim.cu`` has."""
    from pnnp_tpu_torch.kernels.build import build_all

    libs = {}
    for name, so in zip(sources, build_all(sources.values())):
        lib = libs[name] = ctypes.CDLL(str(so))
        lib.pnnp_ssim_num_partials.argtypes = [ctypes.c_int] * 4
        lib.pnnp_ssim_num_partials.restype = ctypes.c_int
        lib.pnnp_ssim_sum.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.pnnp_ssim_sum.restype = ctypes.c_int
    return libs


def launcher(lib, xf, yf, C, route):
    """One launch of ``route`` of ``lib`` on scratch allocated once; returns
    the call and the float64 sum it writes."""
    from pnnp_tpu_torch.kernels.ssim import ROUTES

    H, L = xf.shape
    r = ROUTES.index(route)
    partials = torch.empty(lib.pnnp_ssim_num_partials(H, L, C, r), dtype=torch.float64,
                           device=xf.device)
    out = torch.zeros((), dtype=torch.float64, device=xf.device)
    stream = torch.cuda.current_stream(xf.device).cuda_stream

    def call():
        err = lib.pnnp_ssim_sum(xf.data_ptr(), yf.data_ptr(), H, L, C, C1, C2, r,
                                partials.data_ptr(), out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"SSIM {route} launch failed: CUDA error {err}")

    return call, out


def loop_us(fn, warmup, iters):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters * 1e3


def measure(builds: dict, iters: int = 100, warmup: int = 5, rounds: int = 2,
            frames: dict = FRAMES) -> dict:
    """``builds``: name -> loaded library, ``this`` first."""
    dev = torch.device("cuda")
    out = {}
    for frame, shape in frames.items():
        H, W, C = shape
        xf, yf = (torch.from_numpy(a).to(dev) for a in frame_pair(shape))
        routes = ("hopper", "generic") if C == 4 else ("generic",)
        arms = [(b, r) for r in routes for b in builds]
        calls = {arm: launcher(builds[arm[0]], xf, yf, C, arm[1]) for arm in arms}
        runs = {arm: [] for arm in arms}
        for _ in range(rounds):
            for arm in arms + arms[::-1]:
                runs[arm].append(loop_us(calls[arm][0], warmup, iters))
        n = (H - 6) * (W - 6) * C
        ref = float(calls[(next(iter(builds)), routes[0])][1]) / n
        gaps = {f"{b}:{r}": abs(float(calls[(b, r)][1]) / n - ref) for b, r in arms}
        if max(gaps.values()) >= AGREE:
            raise AssertionError(f"ssim builds disagree at {frame}: {gaps}")
        bound, bound_by = bound_us(H, W, C)
        us = {f"{b}:{r}": statistics.mean(v) for (b, r), v in runs.items()}
        out[frame] = {"shape": [H, W * C], "C": C, "bound_us": bound, "bound_by": bound_by,
                      "us": us, "share": {k: bound / v for k, v in us.items()},
                      "runs_us": {f"{b}:{r}": v for (b, r), v in runs.items()},
                      "gap_to_this": gaps}
        print(f"{frame} {[H, W * C]}: " + ", ".join(
            f"{k} {v:.3f} us ({bound / v:.0%})" for k, v in us.items())
            + f"; bound {bound:.1f} us", flush=True)
        del xf, yf, calls
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", action="append", default=[], metavar="NAME=PATH",
                    help="another ssim.cu to build and time beside this tree's")
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_ssim: needs a CUDA device", file=sys.stderr)
        return 2
    from pnnp_tpu_torch.kernels.ssim import SOURCE

    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card, flush=True)
    sources = {"this": SOURCE}
    for spec in args.against:
        name, _, path = spec.partition("=")
        if not path or name in sources:
            ap.error(f"--against takes NAME=PATH with a new NAME, got {spec!r}")
        sources[name] = Path(path)
    builds = load_builds(sources)
    result = measure(builds, args.iters, args.warmup, args.rounds)
    print(json.dumps({"card": card, "device": torch.cuda.get_device_name(0),
                      "builds": {k: str(v._name) for k, v in builds.items()},
                      "iters": args.iters, "frames": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
