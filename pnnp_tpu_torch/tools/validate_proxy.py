"""Proxy acceptance across the ISO ladder (counterpart of
``tools/validate_proxy.py``).

Trains ONE ``pw_iso_2stage`` proxy on physics-engine (``pgrq``) dark frames
spanning ISOs 800/1600/3200/12800, then reports per ISO:

  * the sampled-vs-real symmetric KLD of the full noise histogram (the
    reference's noise-model metric, trainer_NF_SID.py:163-180 /
    utils/kld_div.py:163), beside the real-vs-real floor;
  * the ROW-MARGINAL KLD: per-(row, channel) means of real vs sampled
    noise, the 2nd stage's banding on its own, beside the learned row law's
    own standard deviation and support width (ADU): a row head whose
    log-scale sits at its lower clamp shows a support of 2 e^-2 = 0.27;
  * the same at ISO 6400, held out of training (interpolation probe).

Usage (from the repository root; on the card unless ``--cpu``):

    python -m pnnp_tpu_torch.tools.validate_proxy [--steps 1200] [--d 256] [--cpu]

Prints a table and, last, one JSON line (also :func:`main`'s return value).
:func:`main` also takes ``seed`` (added to every generator seed: the init,
the training stream and the scoring draws) and ``init`` (a params tree in
the JAX layout to start from, e.g. the JAX tool's ``--steps 0 --save``
pickle); ``pnnp_tpu_torch/tools/ladder_spread.py`` uses both.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

TRAIN_ISOS = (800, 1600, 3200, 12800)
HELDOUT_ISO = 6400  # interpolation probe: inside the trained range


def main(argv=None, device=None, seed: int = 0, init=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--d", type=int, default=256)
    ap.add_argument("--patch", type=int, default=32)
    # training-crop WIDTH (defaults to --patch): wider rows give the row
    # stage cleaner observations for the same pixel budget
    ap.add_argument("--patch-w", type=int, default=0)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--eval-frames", type=int, default=16)
    ap.add_argument("--cpu", action="store_true")
    # '+anchor' was measured worse held-out (see the JAX models/proxy.py)
    ap.add_argument("--mode", type=str, default="2stage+iso")
    # cosine lr decay 5e-4 -> 2e-5, off by default (measured worse held-out
    # in the JAX tool: the constant-lr jitter regularizes the conditioning)
    ap.add_argument("--lr-decay", action="store_true")
    ap.add_argument("--s0", type=float, default=0.3,
                    help="pixel-stage likelihood smoothing (ADU); 0 = the raw "
                         "cliff-gradient NLL (A/B control)")
    ap.add_argument("--save", default="",
                    help="pickle the trained proxy params (JAX tree layout) here")
    ap.add_argument("--smooth-iso", type=float, default=0.0,
                    help="ISO-curvature smoothness weight (models/proxy.py "
                         "smooth_iso_w)")
    a = ap.parse_args(argv)
    pw = a.patch_w or a.patch

    import numpy as np
    import torch

    from pnnp_tpu_torch.models import (
        PixelWiseISOProxy,
        QuantileHead,
        params_from_jax,
        params_to_jax,
    )
    from pnnp_tpu_torch.ops.kld import kl_div_norm_device
    from pnnp_tpu_torch.physics import calibration as calib
    from pnnp_tpu_torch.physics.noise import generate_noisy
    from pnnp_tpu_torch.train import apply_scaled_updates, make_adam
    from pnnp_tpu_torch.utils.device import resolve_device

    dev = torch.device("cpu") if a.cpu else resolve_device(device)
    t = calib.ISO_TABLES["SonyA7S2"]
    span = float(t["wp"] - t["bl"])
    names = ("Kmax", "sigTL", "sigR", "sigGs", "lam")

    def rows_of(isos):
        idx = [int(np.where(t["iso"] == iso)[0][0]) for iso in isos]
        return {k: torch.tensor([float(t[k][i]) for i in idx], device=dev) for k in names}

    def params(rows, idx, n):
        """Noise params of ladder row ``idx`` (a tensor) for ``n`` frames."""
        rep = lambda v: v[idx].reshape(-1).expand(n)
        full = lambda v: torch.full((n,), float(v), device=dev)
        return dict(K=rep(rows["Kmax"]), sigTL=rep(rows["sigTL"]), sigR=rep(rows["sigR"]),
                    sigGs=rep(rows["sigGs"]), lam=rep(rows["lam"]),
                    bias=torch.zeros((n, 4), device=dev), q=full(t["q"]),
                    ratio=full(1.0), wp=full(t["wp"]), bl=full(t["bl"]))

    def dark_frames(gen, rows, idx, n, h, w):
        return generate_noisy(gen, torch.zeros((n, 4, h, w), device=dev),
                              params(rows, idx, n), "pgrq", ori=True)

    proxy = PixelWiseISOProxy(d=a.d, nf=16, nb=2, mode=a.mode, smooth_s0=a.s0,
                              smooth_iso_w=a.smooth_iso,
                              generator=torch.Generator().manual_seed(seed))
    if init is not None:
        proxy.load_state_dict(params_from_jax(init), strict=True)
    proxy.to(dev)
    opt = make_adam(proxy.parameters())
    train_rows = rows_of(TRAIN_ISOS)
    iso_arr = torch.tensor(TRAIN_ISOS, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7 + seed)

    t0 = time.time()
    nll = torch.tensor(float("nan"))
    chunk = min(50 if dev.type == "cpu" else 500, max(a.steps, 1))
    for step in range(a.steps):
        # the ISO draw stays on the device: no host round trip per step
        idx = torch.randint(len(TRAIN_ISOS), (1,), generator=gen, device=dev)
        noise = dark_frames(gen, train_rows, idx, a.batch, a.patch, pw)
        opt.zero_grad(set_to_none=True)
        loss, _ = proxy.loss(noise, iso_arr[idx].expand(a.batch))
        loss.backward()
        nll = loss.detach()
        if a.lr_decay:
            frac = min(step / max(a.steps, 1), 1.0)
            lr = 2e-5 + (5e-4 - 2e-5) * 0.5 * (1.0 + math.cos(math.pi * frac))
        else:
            lr = 5e-4
        apply_scaled_updates(opt, lr)
        if (step + 1) % chunk == 0 or step + 1 == a.steps:
            print(f"  step {step + 1}: nll/dim={float(nll):.4f}", file=sys.stderr)
    nll = float(nll)
    train_s = time.time() - t0

    if a.save:
        import pickle

        with open(a.save, "wb") as f:
            pickle.dump(params_to_jax(proxy.state_dict()), f)
        print(f"saved params -> {a.save}", file=sys.stderr)

    @torch.no_grad()
    def score(iso, draw_seed):
        g = torch.Generator(device=dev).manual_seed(draw_seed)
        n, p = a.eval_frames, 64  # fixed eval geometry for cross-run tables
        rows, idx = rows_of((iso,)), torch.zeros(1, dtype=torch.long, device=dev)
        real = dark_frames(g, rows, idx, n, p, p)
        fake = proxy.sample(torch.zeros((n, 4, p, p), device=dev),
                            torch.full((n,), float(iso), device=dev), g)
        real2 = dark_frames(g, rows, idx, n, p, p)  # second real draw: the floor
        # NaN params/samples must not pass as KLD 0 (the histogram of an
        # all-NaN tensor is empty, which scores as a match)
        if not bool(torch.isfinite(fake).all()):
            return float("nan"), 0.0, float("nan"), 0.0
        kl = lambda x, y: float(kl_div_norm_device(x * span, y * span, bl=float(t["bl"]),
                                                   wp=int(t["wp"]))["kl_sym"])
        # row-marginal: per-(row, channel) means isolate the 2nd stage (n*p*4
        # samples: the real-vs-real floor is the honest zero point)
        rmean = lambda v: v.mean(dim=3)
        return (kl(real, fake), kl(real, real2),
                kl(rmean(real), rmean(fake)), kl(rmean(real), rmean(real2)))

    @torch.no_grad()
    def row_law(iso):
        """(std, support width) of the row head's law at ``iso``, ADU."""
        _, _, hp = proxy.heads(torch.tensor([float(iso)], device=dev), 1)
        return (float(QuantileHead.variance(hp).sqrt()),
                float(hp.knots[0, -1] - hp.knots[0, 0]))

    rows = []
    for iso in TRAIN_ISOS + (HELDOUT_ISO,):
        kf, kf0, kr, kr0 = score(iso, 1000 + iso + seed)
        law_std, law_support = row_law(iso)
        rows.append({"iso": iso, "kld": round(kf, 4), "kld_floor": round(kf0, 4),
                     "row_kld": round(kr, 4), "row_floor": round(kr0, 4),
                     "row_law_std": round(law_std, 4), "row_law_support": round(law_support, 4),
                     "heldout": iso == HELDOUT_ISO})

    print(f"\npw_iso_2stage (d={a.d}) trained {a.steps} steps on ISOs {TRAIN_ISOS} "
          f"on {dev} ({train_s:.0f}s); final nll/dim={nll:.4f}")
    print(f"{'ISO':>7} | {'KLD(sym)':>9} {'floor':>7} | {'row KLD':>8} {'floor':>7} | "
          f"{'row law std':>11} {'support':>7} | note")
    for r in rows:
        note = "held-out (interpolation)" if r["heldout"] else ""
        print(f"{r['iso']:>7} | {r['kld']:>9.4f} {r['kld_floor']:>7.4f} | "
              f"{r['row_kld']:>8.4f} {r['row_floor']:>7.4f} | {r['row_law_std']:>11.4f} "
              f"{r['row_law_support']:>7.4f} | {note}")
    ok = (math.isfinite(nll)
          and all(math.isfinite(r["kld"]) and r["kld"] <= 0.1
                  for r in rows if not r["heldout"]))
    result = {"metric": "proxy_iso_ladder", "ok": ok, "rows": rows, "nll": round(nll, 4),
              "train_s": train_s, "device": str(dev)}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
