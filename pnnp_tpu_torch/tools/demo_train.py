"""Training demo on the card: physics-synth denoising from scratch
(counterpart of ``tools/demo_train.py``).

Trains UNetSeeInDark nf=32 with the port's train step
(``train/steps.py::TrainStep``, bf16 autocast over f32 master params) on
the on-device ``prq`` physics synth (SonyA7S2 regression sampling, ratio
U(100, 300)), the SGDR schedule (``WarmupCosine``: lr 2e-4, one period
over the run, step_size 10) and ``clip_mode=2``, on procedurally generated
clean scenes (:func:`synthetic_scenes`), and reports the eval PSNR gain over
the noisy input on two fixed scenes at ratio 200: the whole training loop
with no dataset. The eval serves a bf16 copy of the master weights, as the
JAX tool's bf16 fast path.

:func:`synthetic_scenes` is numpy and draws from the caller's
``np.random.Generator`` in the JAX tool's order: the same generator state
gives bit-identical scenes in both packages.

Usage (from the repository root; on the card unless ``--cpu``):

    python -m pnnp_tpu_torch.tools.demo_train [--steps 300] [--eval-every 50]
    CPU wiring: ... --cpu --steps 2 --patch 32

Prints the JAX tool's step lines and ``done``, then one JSON line (the
input's PSNR, the untrained net's, the final one and its gain over the
input, ms per step, the card); :func:`main` returns it. A net at its init
already scores above the noisy input on these dark scenes (its output sits
near 0), so a run that learned shows its final PSNR above ``psnr_init``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

NF = 32
SCENE_SEED = 1997  # the scenes' numpy generator (the JAX tool's)
MODEL_SEED, EVAL_PARAM_SEED, EVAL_NOISE_SEED, STREAM_SEED = 0, 99, 100, 1
EVAL_RATIO = 200.0


def synthetic_scenes(rng: np.random.Generator, n: int, p: int) -> np.ndarray:
    """Procedural low-light 'scenes': smooth gradients + blobs + edges,
    RGBG ``[n, p, p, 4]`` float32 in [0, 1]."""
    yy, xx = np.mgrid[0:p, 0:p].astype(np.float32) / p
    out = np.empty((n, p, p, 4), np.float32)
    for i in range(n):
        base = rng.uniform(0.002, 0.05)
        g = base + rng.uniform(0, 0.1) * (
            np.sin(xx * rng.uniform(2, 9) + rng.uniform(0, 6))
            * np.cos(yy * rng.uniform(2, 9))
            * 0.5 + 0.5
        )
        for _ in range(6):
            cx, cy, r = rng.uniform(0, 1, 3)
            blob = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (0.02 * r + 0.002)))
            g = g + rng.uniform(0, 0.15) * blob
        wb = rng.uniform(0.6, 1.0, 4).astype(np.float32)
        out[i] = np.clip(g[..., None] * wb, 0, 1)
    return out


def scenes_nchw(rng: np.random.Generator, n: int, p: int, device):
    """:func:`synthetic_scenes` as an NCHW tensor on ``device``."""
    import torch

    return torch.from_numpy(synthetic_scenes(rng, n, p)).permute(0, 3, 1, 2).contiguous().to(device)


def serve_psnr(model, lr_img, hr_img) -> float:
    """PSNR (data range 255) of a bf16 copy of the nf=32 ``model`` on the NCHW
    ``lr_img`` against ``hr_img``, the output clipped to [0, 1]."""
    import torch

    from pnnp_tpu_torch.models import UNetSeeInDark
    from pnnp_tpu_torch.ops.metrics import psnr
    from pnnp_tpu_torch.train import make_eval_step

    copy = UNetSeeInDark(nf=NF, dtype=torch.bfloat16).to(lr_img.device).eval()
    copy.load_state_dict(model.state_dict())
    dn = make_eval_step(copy)(lr_img.permute(0, 2, 3, 1)).clamp(0, 1)
    return float(psnr(dn * 255.0, hr_img.permute(0, 2, 3, 1) * 255.0))


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--eval-every", type=int, default=50)
    ap.add_argument("--patch", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--cpu", action="store_true")
    a = ap.parse_args(argv)

    import torch

    from pnnp_tpu_torch.models import UNetSeeInDark
    from pnnp_tpu_torch.ops.metrics import psnr
    from pnnp_tpu_torch.physics.calibration import HALF_CLIP
    from pnnp_tpu_torch.physics.noise import generate_noisy
    from pnnp_tpu_torch.physics.sampling import sample_params_max
    from pnnp_tpu_torch.train import build_lr_schedule, make_adam, make_raw_synth, make_train_step
    from pnnp_tpu_torch.utils.device import card_label, resolve_device

    dev = torch.device("cpu") if a.cpu else resolve_device(device)
    rng = np.random.default_rng(SCENE_SEED)
    model = UNetSeeInDark(nf=NF, generator=torch.Generator().manual_seed(MODEL_SEED)).to(dev)
    opt = make_adam(model.parameters())
    lr_schedule = build_lr_schedule(
        {"lr_scheduler": "WarmupCosine", "learning_rate": 2e-4,
         "stop_epoch": a.steps, "last_epoch": 0, "step_size": 10, "T": 1})
    synth = make_raw_synth("SonyA7S2", "prq", ori=False, clip=False)
    step = make_train_step(lr_schedule, synth, clip_mode=HALF_CLIP, bf16=True)

    # the fixed eval pair
    eval_hr = scenes_nchw(rng, 2, a.patch, dev)
    p_eval = sample_params_max(torch.Generator(device=dev).manual_seed(EVAL_PARAM_SEED),
                               "SonyA7S2", n=2, ratio=EVAL_RATIO)
    eval_lr = generate_noisy(torch.Generator(device=dev).manual_seed(EVAL_NOISE_SEED),
                             eval_hr, p_eval, "prq").clamp_max(1.0)
    psnr_in = float(psnr(eval_lr.clamp(0, 1) * 255.0, eval_hr * 255.0))

    psnr_init = serve_psnr(model, eval_lr, eval_hr)  # the untrained net's
    gen = torch.Generator(device=dev).manual_seed(STREAM_SEED)
    p_dn, train_s = psnr_init, 0.0
    t0 = time.time()
    for it in range(1, a.steps + 1):
        batch = {"hr": scenes_nchw(rng, a.batch, a.patch, dev)}
        ts = time.perf_counter()
        m = step(model, opt, batch, gen, it)
        sync(dev)
        train_s += time.perf_counter() - ts
        if it % a.eval_every == 0 or it == 1 or it == a.steps:
            p_dn = serve_psnr(model, eval_lr, eval_hr)
            print(f"step {it:4d}: loss={float(m['loss']):.4f} "
                  f"eval PSNR {p_dn:.2f} dB (input {psnr_in:.2f} dB, "
                  f"gain {p_dn - psnr_in:+.2f}) "
                  f"[{(time.time() - t0) / it * 1e3:.0f} ms/step]", flush=True)
    print("done")
    res = {"steps": a.steps, "patch": a.patch, "batch": a.batch, "psnr_in": psnr_in,
           "psnr_init": psnr_init, "psnr": p_dn, "gain_db": p_dn - psnr_in,
           "train_ms_per_step": train_s / a.steps * 1e3, "wall_s": time.time() - t0,
           "card": card_label(dev)}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
