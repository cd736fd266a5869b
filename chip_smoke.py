#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``pnnp_tpu_torch``) on one card.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases, each failing loudly (an exception ends the run with a non-zero exit
and no result line):

1. the card's name and power limit; build every CUDA source of the port
   (one ``nvcc`` per source, all started together);
2. every kernel against its plain PyTorch version on the card, at the test
   shapes (both routes of the SSIM kernel wherever each applies) and at the
   full Sony and IMX686 frames, run to run bit-identity, and a bright
   low-variance frame against a float64 evaluation;
3. the port's main path at full width: ``pnnp_tpu_torch.trainer.main
   --mode eval`` over a synthetic 2848x4256 SID fixture (2 scenes) with a
   seeded N(0, 0.02) nf=32 UNetSeeInDark checkpoint, the Sony values of
   ``runfiles/SonyA7S2/ELD.yml``; the kernels' launch counts (in all and by
   route) are read around exactly that run, and one frame's SSIM is
   recomputed by the plain version;
4. timings with CUDA events after warm-up: the fused eval step in bf16 and
   in f32 at the full frame (median per call, plus a torch.profiler
   breakdown by kernel and the device's idle share), and each kernel route
   (mean over back-to-back launches, the two routes in turns) at the Sony
   and IMX686 frames against its bound and its plain version.

Output: one ``timings`` JSON line, one ``kernels`` JSON line (a row per
SSIM route: ``ssim`` is the ``hopper`` route of the main path,
``ssim_generic`` the first CUDA version), the
``nvidia-smi`` name/power-limit line, and last
``{"ok": true, "device": {...}}``. Exits non-zero without CUDA.
"""

from __future__ import annotations

import json
import math
import os
import pickle
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, 700 W): device memory and fp32 outside
# the tensor cores. The SSIM kernel's work is fp32 CUDA-core arithmetic.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TOL = 1e-4
SONY, IMX686 = (1424, 2128, 4), (1736, 2312, 4)  # packed full frames [H, W, C]
STRIP = 16  # the hopper route's shortest strip (csrc/ssim.cu MIN_STRIP)
KERNEL_SHAPES = [(7, 7, 4), (70, 96, 4), (71, 96, 4), (96, 131, 3),
                 (201, 140, 4), SONY, IMX686,
                 # strip edges, and widths one pixel into a warp's halo / the next warp
                 (STRIP + 6, 121, 4), (STRIP + 7, 127, 4), (2 * STRIP + 5, 126, 4)]
DRIFT = (1424, 256, 4)  # bright low-variance frame for the running-sum check
MOSAIC_H, MOSAIC_W = 2848, 4256  # Sony A7S2 full frame, packed [1424, 2128, 4]
SSIM_OPS_PER_WINDOW = 89  # 5 separable 7+7-tap sums (60) + the SSIM formula (29)


def _structured(shape, seed):
    """Vertical gradient + per-channel scale + noise, on [0, 255]."""
    rng = np.random.default_rng(seed)
    H, W, C = shape
    grad = np.linspace(0, 200, H, dtype=np.float32)[:, None, None]
    chans = (np.arange(C, dtype=np.float32) + 1.0)[None, None, :] * 20.0
    x = np.clip(grad + chans + rng.uniform(0, 40, shape).astype(np.float32), 0, 255)
    y = np.clip(x + rng.normal(0, 12, shape).astype(np.float32), 0, 255)
    return x, y


def _bright(shape, seed):
    """200 + N(0, 0.5): large window sums, small variances."""
    rng = np.random.default_rng(seed)
    x = (200.0 + rng.normal(0, 0.5, shape)).astype(np.float32)
    y = (x + rng.normal(0, 0.5, shape)).astype(np.float32)
    return x, y


def _ssim_f64(x, y, data_range=255.0):
    """Mean SSIM of an [H, W, C] pair in float64 (uniform filter, valid crop)."""
    from scipy.ndimage import uniform_filter

    x, y = x.astype(np.float64), y.astype(np.float64)
    box = lambda a: uniform_filter(a, size=(7, 7, 1))[3:-3, 3:-3]
    ux, uy = box(x), box(y)
    cn = 49.0 / 48.0
    vx, vy = cn * (box(x * x) - ux * ux), cn * (box(y * y) - uy * uy)
    vxy = cn * (box(x * y) - ux * uy)
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    return float(np.mean((2 * ux * uy + c1) * (2 * vxy + c2)
                         / ((ux * ux + uy * uy + c1) * (vx + vy + c2))))


def _routes(C):
    return ("hopper", "generic") if C == 4 else ("generic",)


def _check(cond, what):
    if not cond:
        raise AssertionError(what)


def _time_ms(fn, warmup, iters):
    """Median of per-call CUDA-event times (ms) after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _loop_ms(fn, warmup, iters):
    """Mean time (ms) of ``iters`` back-to-back calls between two CUDA
    events, after ``warmup`` calls: for kernels, whose launch overhead would
    otherwise dominate a per-call timing."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _profile(fn, step_ms, steps=3):
    """Device time by kernel, by class of kernel and by the op that launched
    it, over ``steps`` calls (torch.profiler), per call; and the device's
    idle share against the event-timed call time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    rows, ops, by_class = [], [], {}
    for e in prof.key_averages():
        if e.self_device_time_total <= 0:
            continue
        ms = e.self_device_time_total / steps / 1e3
        # A CPU op reports the device time of the kernels it launched: kept
        # apart from the kernels, so that busy time counts each kernel once.
        if e.device_type != DeviceType.CUDA:
            ops.append([e.key, ms])
            continue
        rows.append([e.key[:80], ms])
        cls = _kernel_class(e.key)
        by_class[cls] = by_class.get(cls, 0.0) + ms
    rows.sort(key=lambda r: -r[1])
    ops.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    return {"device_busy_ms": busy, "idle_share": 1.0 - busy / step_ms,
            "by_class_ms": by_class, "top_kernels_ms": rows[:10],
            "top_ops_ms": ops[:8]}


def _kernel_class(name):
    """Coarse class of a device kernel, by its name, for the step breakdown."""
    low = name.lower()
    if "ssim" in low:
        return "ssim kernel"
    if any(k in low for k in ("xmma", "cutlass", "cudnn", "conv", "gemm")):
        return "cudnn convolution and its layout transforms"
    for key, cls in (("catarray", "concat"), ("max_pool", "max pool"),
                     ("reduce", "reductions"), ("elementwise", "elementwise")):
        if key in low:
            return cls
    return "other"


def _launcher(K, xf, yf, C, route):
    """One launch of an SSIM route on scratch allocated once: back to back,
    it times the kernel and not the wrapper's allocations."""
    H, L = xf.shape
    partials = torch.empty(K._library().pnnp_ssim_num_partials(H, L, C, K.ROUTES.index(route)),
                           dtype=torch.float64, device=xf.device)
    out = torch.empty((), dtype=torch.float64, device=xf.device)
    return lambda: K._launch(xf, yf, C, 255.0, route, partials, out)


def phase_build():
    from pnnp_tpu_torch.kernels import SOURCES, build_all

    t0 = time.perf_counter()
    build_all(SOURCES)
    print(f"build: {len(SOURCES)} CUDA source(s) in {time.perf_counter() - t0:.2f} s",
          flush=True)


def _to_dev(pair, dev):
    H, W, C = pair[0].shape
    return [torch.from_numpy(a.reshape(H, W * C)).to(dev) for a in pair]


def phase_kernel_checks(dev):
    """Each SSIM route against the plain version at every shape it takes;
    returns the largest |kernel - plain| of the mean, by route."""
    import pnnp_tpu_torch.kernels.ssim as K

    max_err = dict.fromkeys(K.ROUTES, 0.0)
    for shape in KERNEL_SHAPES:
        H, W, C = shape
        xf, yf = _to_dev(_structured(shape, 0), dev)
        n = C * (H - 6) * (W - 6)
        ref = float(K.ssim_flat_plain(xf, yf, C))
        errs = {}
        for route in _routes(C):
            a = K._ssim_call_sum(xf, yf, C, route=route)
            b = K._ssim_call_sum(xf, yf, C, route=route)
            torch.cuda.synchronize()
            _check(torch.equal(a, b), f"ssim {route} {shape}: two launches differ")
            errs[route] = abs(float(a) / n - ref)
            max_err[route] = max(max_err[route], errs[route])
            _check(errs[route] < TOL, f"ssim {route} {shape}: kernel {float(a) / n} "
                                      f"vs plain {ref}")
        if shape in (SONY, IMX686):
            gap = abs(float(K._ssim_call_sum(xf, yf, C, route="hopper"))
                      - float(K._ssim_call_sum(xf, yf, C, route="generic"))) / n
            _check(gap < 1e-5, f"ssim routes differ by {gap} at {shape}")
        # the entry points, on the default route
        a = K.ssim_flat(xf, yf, C)
        s = K.ssim_flat_sum(xf, yf, C)
        ref_sum = float(K.ssim_sum_plain(xf.reshape(H, W, C), yf.reshape(H, W, C)))
        _check(abs(float(a) - ref) < TOL, f"ssim_flat {shape}: {float(a)} vs plain {ref}")
        _check(abs(float(s) - ref_sum) < TOL * n,
               f"ssim_flat_sum {shape}: kernel {float(s)} vs plain {ref_sum}")
        if shape == (201, 140, 4):  # the banded and [H, W, C] entries
            band = lambda t: t.reshape(H, W, C).permute(2, 0, 1).reshape(C * H, W)
            _check(abs(float(K.ssim_banded(band(xf), band(yf), C)) - ref) < TOL,
                   "ssim_banded disagrees")
            _check(abs(float(K.ssim_kernel(xf.reshape(H, W, C),
                                           yf.reshape(H, W, C))) - ref) < TOL,
                   "ssim_kernel disagrees")
        print(f"kernel check ssim {shape}: |kernel - plain| = "
              + ", ".join(f"{r} {e:.3e}" for r, e in errs.items()), flush=True)

    x, y = _bright(DRIFT, 0)
    H, W, C = DRIFT
    xf, yf = _to_dev((x, y), dev)
    ref = _ssim_f64(x, y)
    n = C * (H - 6) * (W - 6)
    for route in _routes(C):
        err = abs(float(K._ssim_call_sum(xf, yf, C, route=route)) / n - ref)
        _check(err < TOL, f"ssim {route} drift frame {DRIFT}: {err} from float64")
        print(f"kernel check ssim {route} bright frame {DRIFT}: |kernel - float64| = "
              f"{err:.3e}", flush=True)
    return max_err


def _smoke_runfile(root):
    from pnnp_tpu_torch.config import load_runfile

    eld = load_runfile(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "runfiles", "SonyA7S2", "ELD.yml"))
    infos = os.path.join(root, "infos")
    dst = dict(eld["dst"], root_dir=root, infos_dir=infos, H=MOSAIC_H, W=MOSAIC_W)
    dst.pop("mode", None)
    # fewer than 41 scenes leave the default 250 split empty: sweep ratio 100
    dst_eval = dict(dst, dataset="SID_Dataset", dstname="SID", mode="eval",
                    ratio_list=[100])
    return {
        "mode": "eval",
        "checkpoint": os.path.join(root, "saved_model"),
        "fast_ckpt": os.path.join(root, "checkpoints"),
        "model_name": eld["model_name"],
        "result_dir": os.path.join(root, "images"),
        "num_workers": 2,
        "brightness_correct": True,
        "dst": dst,
        "dst_eval": dst_eval,
        "arch": dict(eld["arch"]),
        "hyper": dict(eld["hyper"]),
    }


def phase_main_path(dev):
    import yaml

    import pnnp_tpu_torch.kernels.ssim as K
    from pnnp_tpu_torch.data.fixtures import make_sid_fixture
    from pnnp_tpu_torch.models import UNetSeeInDark, params_to_jax
    from pnnp_tpu_torch.train.checkpoint import save_checkpoint
    from pnnp_tpu_torch.trainer import main as trainer_main

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="pnnp_smoke_") as root:
        t0 = time.perf_counter()
        make_sid_fixture(root, n_scenes=2, H=MOSAIC_H, W=MOSAIC_W)
        run = _smoke_runfile(root)
        nf = int(run["arch"]["nf"])
        seeded = UNetSeeInDark(nf=nf, generator=torch.Generator().manual_seed(0))
        ckpt = os.path.join(run["fast_ckpt"], f"{run['model_name']}_best_model.ckpt")
        save_checkpoint(ckpt, params_to_jax(seeded.state_dict()), meta={"epoch": 0})
        yml = os.path.join(root, "run.yml")
        with open(yml, "w") as f:
            yaml.safe_dump(run, f)
        print(f"main path: fixture + checkpoint in {time.perf_counter() - t0:.1f} s "
              f"(nf={nf}, {MOSAIC_H}x{MOSAIC_W})", flush=True)

        os.chdir(root)  # logs/ and metrics/ land in the temp dir
        try:
            torch.cuda.synchronize()
            K.launches = 0
            K.launches_by_route = dict.fromkeys(K.ROUTES, 0)
            t0 = time.perf_counter()
            trainer = trainer_main(["-f", yml, "--mode", "eval", "--nofig"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {"ssim": K.launches, "by_route": dict(K.launches_by_route)}
        finally:
            os.chdir(cwd)
        print(f"main path: --mode eval over 2 full frames in {wall:.2f} s, "
              f"launches {launches}", flush=True)

        with open(os.path.join(root, "metrics", f"{run['model_name']}_metrics.pkl"),
                  "rb") as f:
            metrics = pickle.load(f)
        _check(len(metrics) == 2, f"metrics pkl holds {len(metrics)} frames, not 2")
        _check(all(math.isfinite(v) for pair in metrics.values() for v in pair),
               f"non-finite metrics {metrics}")
        _check(launches["ssim"] >= 2, f"SSIM kernel launched {launches['ssim']} times")
        _check(launches["by_route"]["hopper"] == launches["ssim"]
               and launches["by_route"]["generic"] == 0,
               f"main-path SSIM launches by route {launches['by_route']}: not all hopper")
        _check(all(p.is_cuda for p in trainer.model.parameters()),
               "model parameters are not on the card")
        _check(trainer.model.conv1_1.weight.dtype == torch.bfloat16,
               "main path did not serve in bf16")

        # one frame again, its SSIM recomputed by the plain version on the card
        batch = trainer.dataset_eval[0]
        lr = torch.from_numpy(batch["lr"]).to(dev)
        hr = torch.from_numpy(batch["hr"]).to(dev)
        dnf, m = trainer._fused_eval(lr, hr, float(batch["ratio"][0]),
                                     ori=False, correct=True)
        H = hr.shape[1]
        plain = float(K.ssim_flat_plain(dnf[0] * 255.0,
                                        hr[0].clamp(0, 1).reshape(H, -1) * 255.0))
        err = max(abs(float(m["ssim"]) - plain),
                  abs(metrics[batch["name"]][1] - plain))
        _check(err < TOL, f"main-path frame SSIM {float(m['ssim'])} / "
                          f"{metrics[batch['name']][1]} vs plain {plain}")
        print(f"main path: metrics {metrics}; frame-0 SSIM |kernel - plain| = {err:.3e}",
              flush=True)
    return launches, err


def phase_timings(dev):
    import pnnp_tpu_torch.kernels.ssim as K
    from pnnp_tpu_torch.models import UNetSeeInDark
    from pnnp_tpu_torch.train.steps import make_eval_metrics_step

    h, w = MOSAIC_H // 2, MOSAIC_W // 2
    rng = np.random.default_rng(1)
    lr = torch.from_numpy(rng.uniform(0, 0.4, (1, h, w * 4)).astype(np.float32)).to(dev)
    hr = torch.from_numpy(rng.uniform(0, 1, (1, h, w * 4)).astype(np.float32)).to(dev)
    mpix = h * w * 4 / 1e6
    step_ms, profiles = {}, {}
    # bf16 first: the f32 step turns TF32 off for the rest of the process
    for dtype in (torch.bfloat16, torch.float32):
        net = UNetSeeInDark(nf=32, dtype=dtype,
                            generator=torch.Generator().manual_seed(0)).to(dev).eval()
        step = make_eval_metrics_step(net)
        call = lambda: step(lr, hr, 1.0, correct=True)
        name = str(dtype).replace("torch.", "")
        step_ms[name] = _time_ms(call, warmup=3, iters=10)
        profiles[name] = _profile(call, step_ms[name])
        del net, step, call
    torch.cuda.empty_cache()

    # each route at the two full frames, in turns (hopper, generic, generic,
    # hopper), against its bound; the plain version at the Sony frame. The
    # kernels are timed on scratch allocated once (see _launcher).
    kernel_us, bounds = {}, {}
    for frame, shape in (("sony", SONY), ("imx686", IMX686)):
        H, W, C = shape
        xf, yf = _to_dev(_structured(shape, 2), dev)
        runs = {r: [] for r in K.ROUTES}
        for route in ("hopper", "generic", "generic", "hopper"):
            runs[route].append(1e3 * _loop_ms(_launcher(K, xf, yf, C, route),
                                              warmup=5, iters=100))
        kernel_us[frame] = {r: statistics.mean(v) for r, v in runs.items()}
        kernel_us[frame]["runs"] = runs
        # the same through the allocating wrapper, host overhead included
        kernel_us[frame]["wrapper"] = {r: 1e3 * _loop_ms(
            lambda: K._ssim_call_sum(xf, yf, C, route=r), warmup=5, iters=100)
            for r in K.ROUTES}
        bytes_moved = 2 * xf.numel() * 4 + 8
        ops = (H - 6) * (W - 6) * C * SSIM_OPS_PER_WINDOW + xf.numel() * 3
        t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOP_PER_S * 1e3
        bounds[frame] = {"bound_ms": max(t_bytes, t_ops), "bytes": bytes_moved, "ops": ops,
                         "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        if frame == "sony":
            plain_ms = _loop_ms(lambda: K.ssim_flat_plain(xf, yf, C), warmup=2, iters=10)
        print(f"ssim at {frame} {list(shape)}: us by route {kernel_us[frame]} "
              f"(bound {bounds[frame]['bound_ms'] * 1e3:.1f} us)", flush=True)
    sony = bounds["sony"]
    rows = {route: {
        "ms": kernel_us["sony"][route] / 1e3, "plain_ms": plain_ms,
        "bound_ms": sony["bound_ms"], "bound_by": sony["bound_by"],
        "bound_share": sony["bound_ms"] / (kernel_us["sony"][route] / 1e3),
        # no single PyTorch call computes SSIM
        "library_ms": None,
    } for route in K.ROUTES}
    timings = {
        "frame": [1, h, w, 4], "mpix_per_frame": mpix,
        "eval_step_ms": step_ms,
        "eval_mpix_s": {k: mpix / (v / 1e3) for k, v in step_ms.items()},
        "ssim_us_by_route": kernel_us, "ssim_bounds": bounds,
        "eval_step_profile": profiles,
    }
    return rows, timings


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    import pnnp_tpu_torch  # noqa: F401  (fails here outside a checkout)

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    phase_build()
    max_err = phase_kernel_checks(dev)
    launches, main_err = phase_main_path(dev)
    rows, timings = phase_timings(dev)

    # one row per SSIM route: the main path's (hopper) and the first version
    kernels = [dict(
        name=name, route="cuda", source="pnnp_tpu_torch/csrc/ssim.cu",
        replaces="pnnp_tpu/kernels/ssim.py:39", launches=launches["by_route"][route],
        max_abs_err=max(max_err[route], main_err if route == "hopper" else 0.0),
        **rows[route]) for name, route in (("ssim", "hopper"), ("ssim_generic", "generic"))]
    print(json.dumps({"timings": timings}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
