"""Measured accuracy of the W8A8 int8 serving path on a trained checkpoint
(counterpart of ``tools/validate_int8.py``).

Trains a UNetSeeInDark (nf=32) on physics-synth noise (the SID ``prq``
recipe on procedural scenes, bf16 train step), then reports the
int8-vs-bf16 PSNR delta on held-out frames over the SID ratio sweep
{100, 250, 300} (the IMX686 dgain ladder with ``--camera IMX686``), beside
the f32 and the input PSNR. Calibration: disjoint traffic (one frame per
ratio, separate scenes and noise) by default, or with ``--cal-from-eval``
the first ``--cal-frames`` eval frames, the first frame of each ratio in
turn (the tool's recipe; the Trainer's ``--int8`` takes the first N frames
of its sweep, which are those of its first ratio). ``--pct`` is one or more
comma-separated |x| percentiles mapped to 127; ``--cal-combine`` max or mean.

Usage (from the repository root; on the card unless ``--cpu``):

    python -m pnnp_tpu_torch.tools.validate_int8 [--steps 2000] [--pct 99.95]
    python -m pnnp_tpu_torch.tools.validate_int8 --skip-train   # reuse --ckpt

Prints one row per (pct, ratio) and, last, one JSON line:
``{"metric": "int8_psnr_delta", "value": <mean dB delta vs bf16>, ...}``.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def train(a, dev):
    import numpy as np
    import torch

    from pnnp_tpu_torch.models import UNetSeeInDark, params_to_jax
    from pnnp_tpu_torch.tools.demo_train import synthetic_scenes
    from pnnp_tpu_torch.train import (
        build_lr_schedule,
        make_adam,
        make_raw_synth,
        make_train_step,
        save_checkpoint,
    )

    rng = np.random.default_rng(1997)
    net = UNetSeeInDark(nf=32, generator=torch.Generator().manual_seed(0)).to(dev)
    opt = make_adam(net.parameters())
    sched = build_lr_schedule({"lr_scheduler": "WarmupCosine", "learning_rate": 2e-4,
                               "stop_epoch": a.steps, "last_epoch": 0, "step_size": 10,
                               "T": 1})
    if a.camera == "IMX686":
        # the trainer_LRID.py:399-418 law: point ISO-6400 calibration with
        # only K jittered, linear ratio ~ U(1, 16)
        synth = make_raw_synth("IMX686", "prq", ori=False, clip=False, iso=6400, lrid=True)
    else:
        synth = make_raw_synth("SonyA7S2", "prq", ori=False, clip=False)
    step = make_train_step(sched, synth, clip_mode=2, bf16=dev.type == "cuda")
    # a pool of clean scene batches made once (host scene synthesis is
    # slow); the noise is drawn anew every step
    pool = [torch.from_numpy(synthetic_scenes(rng, a.batch, a.patch)).permute(0, 3, 1, 2)
            .contiguous().to(dev) for _ in range(a.pool)]
    gen = torch.Generator(device=dev).manual_seed(1)
    t0 = time.time()
    for it in range(1, a.steps + 1):
        m = step(net, opt, {"hr": pool[(it - 1) % len(pool)]}, gen, it)
        if it % 500 == 0 or it == 1:
            print(f"step {it:5d}: loss={float(m['loss']):.4f} "
                  f"[{(time.time() - t0) / it * 1e3:.1f} ms/step]", flush=True)
    save_checkpoint(a.ckpt, params_to_jax(net.state_dict()), meta={"steps": a.steps})
    print(f"saved {a.ckpt}", flush=True)


def validate(a, dev) -> dict:
    import numpy as np
    import torch

    from pnnp_tpu_torch.models import UNetSeeInDark, params_from_jax
    from pnnp_tpu_torch.models.unet_s2d import (
        d2s,
        s2d,
        transform_params_hybrid,
        unet_hybrid_forward_packed,
    )
    from pnnp_tpu_torch.models.unet_s2d_int8 import (
        calibrate_act_scales,
        quantize_params_int8,
        unet_hybrid_forward_packed_int8,
    )
    from pnnp_tpu_torch.ops.metrics import psnr
    from pnnp_tpu_torch.physics.noise import generate_noisy
    from pnnp_tpu_torch.physics.sampling import sample_params_max
    from pnnp_tpu_torch.tools.demo_train import synthetic_scenes
    from pnnp_tpu_torch.train import load_checkpoint

    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False  # the f32 reference is f32
        torch.backends.cuda.matmul.allow_tf32 = False
    net = UNetSeeInDark(nf=32)
    net.load_state_dict(params_from_jax(load_checkpoint(a.ckpt)["params"]), strict=True)
    net = net.to(dev)
    with torch.no_grad():
        tp16 = transform_params_hybrid(net, torch.bfloat16)
        tp32 = transform_params_hybrid(net, torch.float32)
    ratios = (1, 2, 4, 8, 16) if a.camera == "IMX686" else (100, 250, 300)

    def noisy(seed, hr, ratio):
        gen = torch.Generator(device=dev).manual_seed(seed)
        if a.camera == "IMX686":
            p = sample_params_max(gen, "IMX686", n=hr.shape[0], ratio=float(ratio), iso=6400,
                                  jitter_sigmas=False)
        else:
            p = sample_params_max(gen, "SonyA7S2", n=hr.shape[0], ratio=float(ratio))
        return generate_noisy(gen, hr, p, "prq").clamp_max(1.0)

    def scene(rng):
        return torch.from_numpy(synthetic_scenes(rng, 1, a.eval_size)).permute(0, 3, 1, 2).to(dev)

    # held-out frames (seed disjoint from training's 1997 and calibration's 7)
    ev_rng = np.random.default_rng(42)
    eval_frames = {}
    for ratio in ratios:
        eval_frames[ratio] = []
        for i in range(a.eval_frames):
            hr = scene(ev_rng)
            eval_frames[ratio].append((hr, noisy(1000 + 31 * i + ratio, hr, ratio)))

    if a.cal_from_eval:
        n = max(a.cal_frames, 1)
        cal = [s2d(eval_frames[ratios[i % len(ratios)]][i // len(ratios)][1]) for i in range(n)]
    else:
        cal_rng = np.random.default_rng(7)
        cal_ratios = (1, 4, 16) if a.camera == "IMX686" else ratios
        cal = [s2d(noisy(500 + i, scene(cal_rng), ratio)) for i, ratio in enumerate(cal_ratios)]
        if a.cal_frames > 0:
            cal = cal[:a.cal_frames]

    pcts = [float(p) for p in str(a.pct).split(",")]
    qparams = {pct: quantize_params_int8(tp16, calibrate_act_scales(
        tp16, cal, pct=pct, combine=a.cal_combine)) for pct in pcts}

    def score(dn, hr):
        return float(psnr(dn.clamp(0, 1) * 255.0, hr * 255.0))

    rows = {pct: [] for pct in pcts}
    with torch.no_grad():
        for ratio in ratios:
            p32 = p16 = pin = 0.0
            p8 = dict.fromkeys(pcts, 0.0)
            for hr, lr in eval_frames[ratio]:
                g = s2d(lr)
                p32 += score(d2s(unet_hybrid_forward_packed(tp32, g, dtype=torch.float32)), hr)
                p16 += score(d2s(unet_hybrid_forward_packed(tp16, g)).float(), hr)
                pin += score(lr, hr)
                for pct in pcts:
                    p8[pct] += score(d2s(unet_hybrid_forward_packed_int8(
                        tp16, qparams[pct], g)).float(), hr)
            n = a.eval_frames
            for pct in pcts:
                r = {"ratio": ratio, "psnr_in": pin / n, "psnr_f32": p32 / n,
                     "psnr_bf16": p16 / n, "psnr_int8": p8[pct] / n}
                rows[pct].append(r)
                print(f"pct {pct:<6g} x{ratio:<4d} input {r['psnr_in']:6.2f}"
                      f"  f32 {r['psnr_f32']:6.2f}  bf16 {r['psnr_bf16']:6.2f}"
                      f"  int8 {r['psnr_int8']:6.2f}"
                      f"  (int8-bf16 {r['psnr_int8'] - r['psnr_bf16']:+.3f} dB)", flush=True)

    def summary(rws):
        d = [r["psnr_int8"] - r["psnr_bf16"] for r in rws]
        return float(np.mean(d)), float(np.min(d))

    best = max(pcts, key=lambda p: summary(rows[p])[0])
    delta, worst = summary(rows[best])
    out = {
        "metric": "int8_psnr_delta", "value": round(delta, 4), "unit": "dB",
        "camera": a.camera, "cal_pct": best,
        "cal_mode": ((f"from-eval x{len(cal)}" if a.cal_from_eval else f"disjoint x{len(cal)}")
                     + (f" {a.cal_combine}" if a.cal_combine != "max" else "")),
        "worst_ratio_delta": round(worst, 4),
        "bf16_vs_f32": round(float(np.mean([r["psnr_bf16"] - r["psnr_f32"]
                                            for r in rows[best]])), 4),
        "by_pct": {str(p): {"mean": round(summary(rows[p])[0], 4),
                            "worst": round(summary(rows[p])[1], 4)} for p in pcts},
        "rows": [{k: round(v, 3) if isinstance(v, float) else v for k, v in r.items()}
                 for r in rows[best]],
        "device": str(dev),
    }
    print(json.dumps(out), flush=True)
    return out


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--patch", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--pool", type=int, default=96, help="distinct scene batches, cycled")
    ap.add_argument("--eval-size", type=int, default=512)
    ap.add_argument("--eval-frames", type=int, default=4)
    ap.add_argument("--pct", default="100",
                    help="calibration |x| percentile(s) mapped to 127, comma-separated")
    ap.add_argument("--camera", default="SonyA7S2", choices=("SonyA7S2", "IMX686"))
    ap.add_argument("--ckpt", default=os.path.join("checkpoints", "validate_int8.ckpt"))
    ap.add_argument("--cal-combine", default="max", choices=("max", "mean"))
    ap.add_argument("--cal-frames", type=int, default=0,
                    help="the first N calibration frames only (0 = all)")
    ap.add_argument("--cal-from-eval", action="store_true",
                    help="calibrate from the eval frames themselves")
    ap.add_argument("--skip-train", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    a = ap.parse_args(argv)

    import torch

    from pnnp_tpu_torch.utils.device import resolve_device

    dev = torch.device("cpu") if a.cpu else resolve_device(device)
    if not a.skip_train:
        train(a, dev)
    return validate(a, dev)


if __name__ == "__main__":
    main()
