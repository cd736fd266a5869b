"""The whole PNNP pipeline on the card, with no dataset (counterpart of
``tools/demo_pnnp_pipeline.py``).

Stage 1, the noise proxy: trains ``pw_iso_2stage`` (d=256, nf=16, nb=2) by
maximum likelihood on "real" dark frames at ISO 1600, drawn from the
physics engine with Tukey-lambda read and row noise (``pgrq``, which the
proxy does not know in closed form), through
``trainer_nf.py::make_proxy_train_step`` (Adam x 5e-4, fixed), and reports
the sampled-vs-real symmetric KLD (the reference's noise-model metric)
before and after.

Stage 2, the denoiser: the trained proxy feeds
``train/steps.py::make_proxy_synth`` (the Proxy_Dataset branch: ratio
U(100, 300), one legal ISO per batch), which trains UNetSeeInDark nf=32
(``WarmupCosine`` lr 2e-4, ``clip_mode=2``, the bf16 step), and the eval
PSNR gain over the noisy input is reported on two fixed scenes with
``pgrq`` physics noise at ratio 200: the reference's PNNP.yml flow
(trainer_SID.py:463-472) with the proxy trained here.

Usage (from the repository root; on the card unless ``--cpu``):

    python -m pnnp_tpu_torch.tools.demo_pnnp_pipeline [--proxy-steps 200] [--unet-steps 100]
    CPU wiring: ... --cpu --proxy-steps 2 --unet-steps 2 --patch 32

Prints the JAX tool's stage lines and ``done``, then one JSON line (the KLD
before and after, the PSNRs and the gain, ms per step, the card);
:func:`main` returns it.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

ISO = 1600
CAMERA = "SonyA7S2"
PROXY_LR = 5e-4
SPAN, BL, WP = 16383.0 - 512.0, 512, 16383
PROXY_SEED, UNET_SEED, STREAM_SEED = 0, 2, 7
KLD_BEFORE_SEED, KLD_AFTER_SEED, EVAL_NOISE_SEED = 1234, 4321, 100


def fixed_params(n: int, device, iso: int = ISO, ratio: float = 1.0) -> dict:
    """``generate_noisy`` params of the Sony point calibration at ``iso``
    for ``n`` frames (no jitter)."""
    import torch

    from pnnp_tpu_torch.physics import calibration as calib

    t = calib.ISO_TABLES[CAMERA]
    i = int(np.where(t["iso"] == iso)[0][0])
    rep = lambda v: torch.full((n,), float(v), device=device)
    return dict(K=rep(t["Kmax"][i]), sigTL=rep(t["sigTL"][i]), sigR=rep(t["sigR"][i]),
                sigGs=rep(t["sigGs"][i]), bias=torch.zeros((n, 4), device=device),
                lam=rep(t["lam"][i]), q=rep(t["q"]), ratio=rep(ratio), wp=rep(t["wp"]),
                bl=rep(t["bl"]))


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--proxy-steps", type=int, default=200)
    ap.add_argument("--unet-steps", type=int, default=100)
    ap.add_argument("--patch", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--cpu", action="store_true")
    a = ap.parse_args(argv)

    import torch

    from pnnp_tpu_torch.models import PixelWiseISOProxy, UNetSeeInDark
    from pnnp_tpu_torch.ops.kld import kl_div_norm_device
    from pnnp_tpu_torch.ops.metrics import psnr
    from pnnp_tpu_torch.physics.calibration import HALF_CLIP
    from pnnp_tpu_torch.physics.noise import generate_noisy
    from pnnp_tpu_torch.tools.demo_train import NF, SCENE_SEED, scenes_nchw, serve_psnr, sync
    from pnnp_tpu_torch.train import (
        build_lr_schedule,
        make_adam,
        make_proxy_synth,
        make_train_step,
    )
    from pnnp_tpu_torch.trainer_nf import make_proxy_train_step
    from pnnp_tpu_torch.utils.device import card_label, resolve_device

    dev = torch.device("cpu") if a.cpu else resolve_device(device)
    seeded = lambda s: torch.Generator(device=dev).manual_seed(s)
    t_start = time.time()

    # ---------------- stage 1: noise proxy ----------------
    proxy = PixelWiseISOProxy(d=256, nf=16, nb=2,
                              generator=torch.Generator().manual_seed(PROXY_SEED)).to(dev)
    popt = make_adam(proxy.parameters())
    pstep = make_proxy_train_step(proxy, build_lr_schedule(
        {"lr_scheduler": "fixed", "learning_rate": PROXY_LR, "stop_epoch": a.proxy_steps,
         "last_epoch": 0}))

    def dark_frames(gen, n):
        """'Real' dark noise: zeros + pgrq physics (TL read, row, quant)."""
        zeros = torch.zeros((n, 4, a.patch, a.patch), device=dev)
        return generate_noisy(gen, zeros, fixed_params(n, dev), "pgrq", ori=True)

    @torch.no_grad()
    def kld_now(seed):
        gen = seeded(seed)
        real = dark_frames(gen, 4)
        fake = proxy.sample(torch.zeros((4, 4, a.patch, a.patch), device=dev),
                            torch.full((4,), float(ISO), device=dev), gen)
        return float(kl_div_norm_device(real * SPAN, fake * SPAN, bl=BL, wp=WP)["kl_sym"])

    gen = seeded(STREAM_SEED)
    zeros = torch.zeros((a.batch, 4, a.patch, a.patch), device=dev)
    ones, isos = (torch.full((a.batch,), v, device=dev) for v in (1.0, float(ISO)))
    kld0 = kld_now(KLD_BEFORE_SEED)
    proxy_s, t0 = 0.0, time.time()
    for it in range(1, a.proxy_steps + 1):
        noise = dark_frames(gen, a.batch)
        ts = time.perf_counter()
        m = pstep(popt, noise, zeros, ones, isos, it)
        sync(dev)
        proxy_s += time.perf_counter() - ts
        if it % max(a.proxy_steps // 4, 1) == 0:
            print(f"[proxy] step {it}: nll/px={float(m['nll']):.4f} "
                  f"kld_sym={kld_now(it):.4f} "
                  f"({(time.time() - t0) / it * 1e3:.0f} ms/step)", flush=True)
    kld1 = kld_now(KLD_AFTER_SEED)
    print(f"[proxy] KLD(sym) vs real dark frames: {kld0:.4f} -> {kld1:.4f}", flush=True)

    # ---------------- stage 2: denoiser through the proxy ----------------
    proxy.eval().requires_grad_(False)

    def sample_fn(generator, clean, iso):
        with torch.autocast(clean.device.type, enabled=False):
            return proxy.sample(clean.float(), iso, generator)

    synth = make_proxy_synth(sample_fn, ori=False, ratio_range=(100.0, 300.0))
    model = UNetSeeInDark(nf=NF, generator=torch.Generator().manual_seed(UNET_SEED)).to(dev)
    opt = make_adam(model.parameters())
    lr_u = build_lr_schedule({"lr_scheduler": "WarmupCosine", "learning_rate": 2e-4,
                              "stop_epoch": a.unet_steps, "last_epoch": 0,
                              "step_size": 10, "T": 1})
    step = make_train_step(lr_u, synth, clip_mode=HALF_CLIP, bf16=True)

    rng = np.random.default_rng(SCENE_SEED)
    eval_hr = scenes_nchw(rng, 2, a.patch, dev)
    eval_lr = generate_noisy(seeded(EVAL_NOISE_SEED), eval_hr,
                             fixed_params(2, dev, ratio=200.0), "pgrq")
    psnr_in = float(psnr(eval_lr.clamp(0, 1) * 255.0, eval_hr * 255.0))
    psnr_init = serve_psnr(model, eval_lr, eval_hr)

    p_dn, unet_s, t0 = psnr_init, 0.0, time.time()
    for it in range(1, a.unet_steps + 1):
        batch = {"hr": scenes_nchw(rng, a.batch, a.patch, dev)}
        ts = time.perf_counter()
        m = step(model, opt, batch, gen, it)
        sync(dev)
        unet_s += time.perf_counter() - ts
        if it % max(a.unet_steps // 4, 1) == 0 or it == a.unet_steps:
            p_dn = serve_psnr(model, eval_lr, eval_hr)
            print(f"[unet]  step {it}: loss={float(m['loss']):.4f} "
                  f"eval PSNR {p_dn:.2f} dB (input {psnr_in:.2f}, "
                  f"gain {p_dn - psnr_in:+.2f}) "
                  f"({(time.time() - t0) / it * 1e3:.0f} ms/step)", flush=True)
    print("done")
    res = {"proxy_steps": a.proxy_steps, "unet_steps": a.unet_steps, "patch": a.patch,
           "batch": a.batch, "kld_before": kld0, "kld_after": kld1, "psnr_in": psnr_in,
           "psnr_init": psnr_init, "psnr": p_dn, "gain_db": p_dn - psnr_in,
           "proxy_ms_per_step": proxy_s / max(a.proxy_steps, 1) * 1e3,
           "unet_ms_per_step": unet_s / max(a.unet_steps, 1) * 1e3,
           "wall_s": time.time() - t_start, "card": card_label(dev)}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
