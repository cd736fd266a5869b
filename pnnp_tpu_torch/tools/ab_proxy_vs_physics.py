"""PNNP's core claim at recipe scale: proxy-trained ~= physics-trained
(counterpart of ``tools/ab_proxy_vs_physics.py``).

Trains the pw_iso_2stage proxy on physics-engine dark frames over the ISO
ladder (the ground-truth law), then trains TWO UNetSeeInDark denoisers with
identical recipes (reference runfiles/SonyA7S2/PNNP.yml: patch 512, batch 8,
WarmupCosine) differing ONLY in the noise-synthesis stage:

  * physics arm: exact point-calibration noise (the Raw_Dataset branch,
    reference trainer_SID.py:449-462);
  * proxy arm: noise from the trained proxy (the Proxy_Dataset branch,
    reference trainer_SID.py:463-472: noise = sample(clean/ratio, iso),
    lr = hr + noise*ratio).

Both arms draw ISO per batch from the proxy's ladder (+ the held-out
interpolation ISO) and ratio ~ U(100, 300), then eval on the SAME held-out
physics-noised frames at fixed (ISO, ratio) points. The paper's claim is a
PSNR gap within ~0.1 dB. ``--null`` is the control: arm B trains on the
physics law too, with its noise generator seeded apart and the same batch
index stream, so its deltas measure the harness's own scatter.

Random streams: every arm draws its batch indices from one generator and
its noise from a second, both reseeded at each chunk from the chunk's first
step (so a run resumed from ``--state-dir`` replays the stream of an
uninterrupted one, given the same ``--chunk``). The arms share the index
seed; the real A/B's arms share the noise seed too (each synth consumes it
its own way), the null arm B does not.

Usage (from the repository root; on the card unless ``--cpu``):

    python -m pnnp_tpu_torch.tools.ab_proxy_vs_physics [--null] \\
        [--proxy-steps 20000 --unet-steps 4000 --patch 512]
    CPU smoke: ... --proxy-steps 200 --unet-steps 50 --patch 64 --cpu

Prints a per-(ISO, ratio) PSNR table and one JSON line (the JAX tool's
keys); stage times go to stderr, the last stderr line a ``[timing]`` JSON.
:func:`main` returns the rows.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import time

TRAIN_ISOS = (800, 1600, 3200, 12800)
HELDOUT_ISO = 6400
AB_ISOS = TRAIN_ISOS + (HELDOUT_ISO,)
EVAL_ISOS = (800, 3200, 12800, HELDOUT_ISO)
EVAL_RATIOS = (100.0, 300.0)
CAMERA = "SonyA7S2"
TABLE_KEYS = ("Kmax", "sigTL", "sigR", "sigGs", "lam")
ARM_SEED = 11  # both arms' UNet init (the JAX tool's key(11))
STREAM_SEED = 100 + ARM_SEED  # batch-index / noise streams (its key(100 + seed))
NULL_SALT = 0x9E3779B9  # the null arm B's noise seed offset (its fold_in value)
PROXY_INIT_SEED, PROXY_STREAM_SEED = 0, 7
POOL_SEED, EVAL_SEED = 1997, 31337
PROXY_LR = 5e-4


def iso_table(isos=AB_ISOS) -> dict:
    """Per-ISO rows of the Sony point calibration, ``{name: [value per ISO]}``
    for the noise parameters in ``TABLE_KEYS``, plus the shared ``q``,
    ``wp`` and ``bl``."""
    import numpy as np

    from pnnp_tpu_torch.physics.calibration import ISO_TABLES

    t = ISO_TABLES[CAMERA]
    idx = [int(np.where(t["iso"] == v)[0][0]) for v in isos]
    out = {k: [float(t[k][i]) for i in idx] for k in TABLE_KEYS}
    out.update(q=float(t["q"]), wp=float(t["wp"]), bl=float(t["bl"]))
    return out


def table_rows(table: dict, device) -> dict:
    """:func:`iso_table`'s per-ISO rows as tensors on ``device`` (made once:
    the synths gather from them by an index on the device), with the shared
    scalars."""
    import torch

    rows = {k: torch.tensor(table[k], device=device) for k in TABLE_KEYS}
    return dict(rows, q=table["q"], wp=table["wp"], bl=table["bl"])


def noise_params(rows: dict, idx, n: int, ratio) -> dict:
    """``generate_noisy`` params of ladder row ``idx`` (an int or a 1-element
    tensor on the rows' device) of :func:`table_rows` for ``n`` frames;
    ``ratio`` a float or an ``[n]`` tensor."""
    import torch

    device = rows["Kmax"].device
    full = lambda v: torch.full((n,), float(v), device=device)
    idx = torch.as_tensor(idx, device=device).reshape(-1)
    rep = lambda v: v[idx].expand(n)
    return dict(K=rep(rows["Kmax"]), sigTL=rep(rows["sigTL"]), sigR=rep(rows["sigR"]),
                sigGs=rep(rows["sigGs"]), lam=rep(rows["lam"]),
                bias=torch.zeros((n, 4), device=device), q=full(rows["q"]),
                ratio=ratio if torch.is_tensor(ratio) else full(ratio),
                wp=full(rows["wp"]), bl=full(rows["bl"]))


def physics_synth(rows: dict):
    """The Raw_Dataset branch restricted to the A/B's ladder: one ISO of
    ``AB_ISOS`` per batch, ratio ~ U(100, 300) per example, exact point
    params, ``pgrq`` amplified (``ori=False``). No clip here: the train
    step's ``clip_mode=2`` clips both arms alike."""
    import torch

    from pnnp_tpu_torch.physics.noise import generate_noisy

    def synth(generator, batch):
        hr = batch["hr"]
        n, dev = hr.shape[0], hr.device
        idx = torch.randint(len(AB_ISOS), (1,), generator=generator, device=dev)
        ratio = torch.rand(n, generator=generator, device=dev) * 200.0 + 100.0
        lr = generate_noisy(generator, hr, noise_params(rows, idx, n, ratio),
                            "pgrq", ori=False)
        return lr, hr, ratio

    return synth


def ladder_proxy_synth(sample_fn, iso_arr):
    """Sony proxy law with the ISO draw restricted to the proxy's ladder
    ``iso_arr`` (``make_proxy_synth`` draws from the full 31-ISO legal
    ladder; the controlled A/B keeps both arms on the same support):
    ratio ~ U(100, 300) per example, one ISO per batch, ``lr = hr +
    sample_fn(generator, hr / ratio, iso) * ratio``."""
    import torch

    def synth(generator, batch):
        hr = batch["hr"]
        n, dev = hr.shape[0], hr.device
        ratio = torch.rand(n, generator=generator, device=dev) * 200.0 + 100.0
        idx = torch.randint(len(iso_arr), (1,), generator=generator, device=dev)
        rb = ratio.reshape(-1, 1, 1, 1)
        noise = sample_fn(generator, hr / rb, iso_arr[idx])
        return hr + noise * rb, hr, ratio

    return synth


def arm_generators(device, at: int, null_b: bool = False):
    """(index generator, noise generator) of the chunk starting at step
    ``at``: every arm's index stream is the same; the noise stream of the
    null control's arm B is seeded apart."""
    import torch

    seed = lambda s: torch.Generator(device=device).manual_seed(s * 1_000_003 + at)
    return seed(STREAM_SEED), seed(STREAM_SEED + 1 + (NULL_SALT if null_b else 0))


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--proxy-steps", type=int, default=20000)
    # Proxy-training crop geometry: wide rows at constant pixel budget feed
    # the row stage (the per-row-mean contamination std scales as
    # sigma_px/sqrt(W)); an under-trained row law is what the A/B is most
    # sensitive to at high ISO x ratio.
    ap.add_argument("--proxy-patch", type=int, default=8)
    ap.add_argument("--proxy-patch-w", type=int, default=128)
    ap.add_argument("--unet-steps", type=int, default=4000)
    ap.add_argument("--patch", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--nf", type=int, default=32)
    ap.add_argument("--d", type=int, default=256)
    ap.add_argument("--chunk", type=int, default=500)
    ap.add_argument("--eval-frames", type=int, default=8)
    ap.add_argument("--proxy-ckpt", default="",
                    help="load/save the trained proxy params here (the JAX "
                    "param tree as numpy: either package's file loads)")
    ap.add_argument("--state-dir", default="",
                    help="snapshot each arm's train state after every chunk "
                    "and resume from the snapshot on restart (same --chunk)")
    ap.add_argument("--pool", type=int, default=64,
                    help="clean-scene pool size, put on the device once; each "
                    "step gathers a batch by index")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--smooth-iso", type=float, default=0.0,
                    help="ISO-curvature smoothness weight for the proxy "
                         "(models/proxy.py smooth_iso_w)")
    ap.add_argument("--null", action="store_true",
                    help="physics-vs-physics control: arm B = same law, its "
                    "noise seeded apart; measures the harness's own delta "
                    "scatter (no proxy is trained)")
    a = ap.parse_args(argv)

    import numpy as np
    import torch

    from pnnp_tpu_torch.models import (
        PixelWiseISOProxy,
        UNetSeeInDark,
        params_from_jax,
        params_to_jax,
    )
    from pnnp_tpu_torch.ops.metrics import psnr
    from pnnp_tpu_torch.physics.calibration import HALF_CLIP
    from pnnp_tpu_torch.physics.noise import generate_noisy
    from pnnp_tpu_torch.tools.demo_train import synthetic_scenes
    from pnnp_tpu_torch.train import (
        apply_scaled_updates,
        build_lr_schedule,
        make_adam,
        make_eval_step,
        make_train_step,
    )
    from pnnp_tpu_torch.utils.device import resolve_device

    dev = torch.device("cpu") if a.cpu else resolve_device(device)
    t_start = time.time()
    timing = {}
    rows_dev = table_rows(iso_table(AB_ISOS), dev)
    iso_arr = torch.tensor(AB_ISOS, dtype=torch.float32, device=dev)

    # ------------- stage 1: proxy on the ISO ladder (trained ISOs only) ----
    proxy = PixelWiseISOProxy(d=a.d, nf=16, nb=2, smooth_iso_w=a.smooth_iso,
                              generator=torch.Generator().manual_seed(PROXY_INIT_SEED))
    loaded = a.null  # no proxy in the control; arm B is physics reseeded
    if a.proxy_ckpt and not a.null:
        try:
            with open(a.proxy_ckpt, "rb") as f:
                proxy.load_state_dict(params_from_jax(pickle.load(f)), strict=True)
            loaded = True
            print(f"[proxy] loaded {a.proxy_ckpt}", file=sys.stderr)
        except FileNotFoundError:
            pass
    proxy.to(dev)
    if not loaded:
        opt = make_adam(proxy.parameters())
        gen = torch.Generator(device=dev).manual_seed(PROXY_STREAM_SEED)
        n_tr, nb = len(TRAIN_ISOS), 8
        zeros = torch.zeros((nb, 4, a.proxy_patch, a.proxy_patch_w), device=dev)
        t0 = time.time()
        for step in range(a.proxy_steps):
            idx = torch.randint(n_tr, (1,), generator=gen, device=dev)
            noise = generate_noisy(gen, zeros, noise_params(rows_dev, idx, nb, 1.0),
                                   "pgrq", ori=True)
            opt.zero_grad(set_to_none=True)
            loss, _ = proxy.loss(noise, iso_arr[idx].expand(nb))
            loss.backward()
            nll = loss.detach()
            apply_scaled_updates(opt, PROXY_LR)
            if (step + 1) % a.chunk == 0 or step + 1 == a.proxy_steps:
                print(f"[proxy] step {step + 1}: nll={float(nll):.4f}", file=sys.stderr)
        took = time.time() - t0
        timing["proxy"] = {"steps": a.proxy_steps, "s": took,
                           "ms_per_step": took / max(a.proxy_steps, 1) * 1e3}
        print(f"[proxy] trained {a.proxy_steps} steps in {took:.0f}s", file=sys.stderr)
        if a.proxy_ckpt:
            with open(a.proxy_ckpt, "wb") as f:
                pickle.dump(params_to_jax(proxy.state_dict()), f)
        del opt
    proxy.eval().requires_grad_(False)

    # ------------- stage 2: two denoisers, one recipe -----------------------
    def proxy_sample(generator, clean, iso):
        with torch.autocast(clean.device.type, enabled=False):
            return proxy.sample(clean.float(), iso, generator)

    hyper = {"lr_scheduler": "WarmupCosine", "learning_rate": 1e-4,
             "stop_epoch": max(a.unet_steps, 2), "last_epoch": 0,
             "step_size": 10, "T": 2}
    # ONE clean-scene pool on the device, shared by both arms (same pool,
    # same index stream: the same scenes in the same order)
    pool = torch.from_numpy(synthetic_scenes(np.random.default_rng(POOL_SEED), a.pool,
                                             a.patch)).permute(0, 3, 1, 2).contiguous().to(dev)

    def train_arm(name, synth, null_b=False):
        model = UNetSeeInDark(nf=a.nf, generator=torch.Generator().manual_seed(ARM_SEED)).to(dev)
        opt = make_adam(model.parameters())
        step = make_train_step(build_lr_schedule(hyper), synth, clip_mode=HALF_CLIP, bf16=True)
        snap = os.path.join(a.state_dir, f"arm_{name}.pt") if a.state_dir else None
        done = 0
        if snap and os.path.exists(snap):
            rec = torch.load(snap, map_location=dev, weights_only=False)
            model.load_state_dict(params_from_jax(rec["params"]))
            opt.load_state_dict(rec["opt_state"])
            done = rec["done"]
            print(f"[{name}] resumed at step {done} from {snap}", file=sys.stderr)
        t0, at = time.time(), 0
        while at < a.unet_steps:  # chunk-boundary walker: resume needs the same --chunk
            n = min(a.chunk, a.unet_steps - at)
            if at < done:  # already in the snapshot
                at += n
                continue
            idx_gen, noise_gen = arm_generators(dev, at, null_b)
            for it in range(n):
                idx = torch.randint(a.pool, (a.batch,), generator=idx_gen, device=dev)
                # the schedule is step-granular here: global step = "epoch"
                m = step(model, opt, {"hr": pool[idx]}, noise_gen, at + it)
            loss = float(m["loss"])
            at += n
            if snap:
                os.makedirs(a.state_dir, exist_ok=True)
                torch.save({"done": at, "params": params_to_jax(model.state_dict()),
                            "opt_state": opt.state_dict()}, snap + ".tmp")
                os.replace(snap + ".tmp", snap)
            print(f"[{name}] step {at}/{a.unet_steps}: loss={loss:.4f} "
                  f"({(time.time() - t0) / max(at - done, 1) * 1e3:.0f} ms/step)",
                  file=sys.stderr)
        took, trained = time.time() - t0, a.unet_steps - done
        timing[name] = {"steps": trained, "s": took,
                        "ms_per_step": took / max(trained, 1) * 1e3}
        return model

    if a.null:
        arm_b_name, arm_b_synth = "physics2", physics_synth(rows_dev)
    else:
        arm_b_name, arm_b_synth = "proxy", ladder_proxy_synth(proxy_sample, iso_arr)
    model_p = train_arm("physics", physics_synth(rows_dev))
    model_x = train_arm(arm_b_name, arm_b_synth, null_b=a.null)

    # ------------- held-out A/B eval ----------------------------------------
    t0 = time.time()
    p_eval = min(a.patch, 256)
    eval_hr = torch.from_numpy(synthetic_scenes(np.random.default_rng(EVAL_SEED),
                                                a.eval_frames, p_eval)).to(dev)  # NHWC

    def server(master):
        # each arm served by a bf16 copy of its master weights
        copy = UNetSeeInDark(nf=a.nf, dtype=torch.bfloat16).to(dev).eval()
        copy.load_state_dict(master.state_dict())
        return make_eval_step(copy)

    es_p, es_x = server(model_p), server(model_x)
    hr255 = eval_hr.clamp(0, 1) * 255.0

    def arm_psnr(es, lr_img):
        return float(psnr(es(lr_img).clamp(0, 1) * 255.0, hr255))

    rows = []
    for iso_v in EVAL_ISOS:
        for ratio_v in EVAL_RATIOS:
            # amplified (ori=False) inputs, like training; HALF_CLIP like
            # the eval loop's input contract
            gen = torch.Generator(device=dev).manual_seed(int(iso_v * 7 + ratio_v))
            n = a.eval_frames
            lr_nchw = generate_noisy(
                gen, eval_hr.permute(0, 3, 1, 2),
                noise_params(rows_dev, AB_ISOS.index(iso_v), n, ratio_v), "pgrq",
                ori=False)
            lr_img = lr_nchw.clamp_max(1.0).permute(0, 2, 3, 1)
            p_phys = arm_psnr(es_p, lr_img)
            p_prox = arm_psnr(es_x, lr_img)
            p_in = float(psnr(lr_img.clamp(0, 1) * 255.0, hr255))
            rows.append({"iso": iso_v, "ratio": int(ratio_v),
                         "input_psnr": round(p_in, 3),
                         "physics_psnr": round(p_phys, 3),
                         "proxy_psnr": round(p_prox, 3),
                         "delta": round(p_prox - p_phys, 3),
                         "heldout_iso": iso_v == HELDOUT_ISO})
    timing["eval_s"] = time.time() - t0

    deltas = [r["delta"] for r in rows]
    arm_b = ("physics2 (null control)" if a.null
             else f"proxy ({a.proxy_steps} steps, d={a.d})")
    print(f"\nA/B at recipe patch={a.patch} batch={a.batch} "
          f"steps={a.unet_steps}; arm B = {arm_b}")
    print(f"{'ISO':>7} {'ratio':>6} | {'physics':>8} {'arm B':>8} {'delta':>7}")
    for r in rows:
        note = " (held-out ISO)" if r["heldout_iso"] else ""
        print(f"{r['iso']:>7} {r['ratio']:>6} | {r['physics_psnr']:>8.3f} "
              f"{r['proxy_psnr']:>8.3f} {r['delta']:>+7.3f}{note}")
    mean_d = float(np.mean(deltas))
    worst_d = float(np.min(deltas))
    print(f"mean delta {mean_d:+.3f} dB, worst {worst_d:+.3f} dB")
    print(json.dumps({"metric": ("ab_null_control" if a.null
                                 else "ab_proxy_vs_physics"),
                      "mean_delta_db": round(mean_d, 3),
                      "worst_delta_db": round(worst_d, 3),
                      "ok": bool(worst_d > -0.15), "rows": rows}), flush=True)
    timing["wall_s"] = time.time() - t_start
    print("[timing] " + json.dumps(dict(timing, device=str(dev))), file=sys.stderr)
    return rows


if __name__ == "__main__":
    main()
