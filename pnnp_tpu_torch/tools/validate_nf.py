"""NoiseFlow convergence and KLD across the ISO ladder (counterpart of
``tools/validate_nf.py``).

Trains the full production arch string
(``sdn|unc|unc|unc|unc|giso|unc|unc|unc|unc``, runfiles/SonyA7S2/
NoiseFlow.yml) on physics-engine (``pgrq``) noise residuals conditioned on
(clean, iso), as the NF trainer consumes real pairs (``noise = (lr - hr) /
ratio, clean = hr / ratio``; reference trainer_NF_SID.py:117-123), then
reports per ISO:

  * the sampled-vs-real symmetric KLD at integer-ADU binning (the
    reference's noise-model metric, trainer_NF_SID.py:163-180 /
    utils/kld_div.py:163) beside the real-vs-real floor;
  * the same at ISO 6400, held out of training: NoiseFlow's per-ISO tables
    do not interpolate (tests/test_nf_kld_parity.py pins this);
  * the KLD trajectory on a fixed held-out batch per training chunk, and
    the chunk of its minimum (the NF trainer's best-checkpoint contract).

Usage (from the repository root; on the card unless ``--cpu``):

    python -m pnnp_tpu_torch.tools.validate_nf [--steps 10000] [--cpu]

Prints a table and, last, one JSON line; :func:`main` returns the rows.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

TRAIN_ISOS = (800, 1600, 3200, 12800)
HELDOUT_ISO = 6400


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10000)
    ap.add_argument("--patch", type=int, default=32)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--eval-frames", type=int, default=16)
    ap.add_argument("--chunk", type=int, default=500)
    ap.add_argument("--cpu", action="store_true")
    a = ap.parse_args(argv)

    import numpy as np
    import torch

    from pnnp_tpu_torch.models import NoiseFlow
    from pnnp_tpu_torch.ops.kld import kl_div_norm_device
    from pnnp_tpu_torch.physics import calibration as calib
    from pnnp_tpu_torch.physics.noise import generate_noisy
    from pnnp_tpu_torch.train import make_adam
    from pnnp_tpu_torch.trainer_nf import make_nf_train_step
    from pnnp_tpu_torch.utils.device import resolve_device

    dev = torch.device("cpu") if a.cpu else resolve_device(device)
    t = calib.ISO_TABLES["SonyA7S2"]
    span = float(t["wp"] - t["bl"])
    names = ("Kmax", "sigTL", "sigR", "sigGs", "lam")

    def rows_of(isos):
        idx = [int(np.where(t["iso"] == iso)[0][0]) for iso in isos]
        return {k: torch.tensor([float(t[k][i]) for i in idx], device=dev) for k in names}

    def params(rows, idx, n):
        rep = lambda v: v[idx].reshape(-1).expand(n)
        full = lambda v: torch.full((n,), float(v), device=dev)
        return dict(K=rep(rows["Kmax"]), sigTL=rep(rows["sigTL"]), sigR=rep(rows["sigR"]),
                    sigGs=rep(rows["sigGs"]), lam=rep(rows["lam"]),
                    bias=torch.zeros((n, 4), device=dev), q=full(t["q"]), ratio=full(1.0),
                    wp=full(t["wp"]), bl=full(t["bl"]))

    def clean_batch(gen, n, p):
        # dark-scene clean signal in [0, 0.25]: the shot-noise (sdn) stage
        # must see clean-level variety to fit beta1 * clean / gain + beta2
        return torch.rand((n, 4, p, p), generator=gen, device=dev) * 0.25

    def noise_given(gen, clean, rows, idx):
        return generate_noisy(gen, clean, params(rows, idx, clean.shape[0]), "pgrq",
                              ori=True) - clean

    nf = NoiseFlow(generator=torch.Generator().manual_seed(0)).to(dev)
    opt = make_adam(nf.parameters())
    # the tool's NLL step is the NF trainer's at ratio 1: noise = lr - hr
    step = make_nf_train_step(nf, lambda epoch: a.lr)
    train_rows = rows_of(TRAIN_ISOS)
    iso_arr = torch.tensor(TRAIN_ISOS, dtype=torch.float32, device=dev)
    ones = torch.ones(a.batch, device=dev)

    # the fixed held-out scoring batch: one clean set, one real noise draw
    fix = torch.Generator(device=dev).manual_seed(99)
    p_eval = a.patch * 2
    fix_iso, zero = 3200, torch.zeros(1, dtype=torch.long, device=dev)
    fix_clean = clean_batch(fix, a.eval_frames, p_eval)
    fix_real = noise_given(fix, fix_clean, rows_of((fix_iso,)), zero)

    def kl(x, y):
        return float(kl_div_norm_device(x * span, y * span, bl=float(t["bl"]),
                                        wp=int(t["wp"]))["kl_sym"])

    @torch.no_grad()
    def kld_fixed(gen):
        fake = nf.sample(fix_clean, torch.full((a.eval_frames,), float(fix_iso), device=dev), gen)
        return kl(fix_real, fake) if bool(torch.isfinite(fake).all()) else float("nan")

    gen = torch.Generator(device=dev).manual_seed(7)
    score_gen = torch.Generator(device=dev).manual_seed(8)
    t0 = time.time()
    nll, done, traj = float("nan"), 0, []
    while done < a.steps:
        n = min(a.chunk, a.steps - done)
        for _ in range(n):
            idx = torch.randint(len(TRAIN_ISOS), (1,), generator=gen, device=dev)
            clean = clean_batch(gen, a.batch, a.patch)
            noise = noise_given(gen, clean, train_rows, idx)
            m = step(opt, clean + noise, clean, ones, iso_arr[idx].expand(a.batch), 1)
        nll = float(m["nll"])
        done += n
        traj.append(round(kld_fixed(score_gen), 4))
        print(f"  step {done}: nll/dim={nll:.4f} fixed-batch KLD={traj[-1]:.4f}",
              file=sys.stderr)
    train_s = time.time() - t0

    @torch.no_grad()
    def score(iso):
        g = torch.Generator(device=dev).manual_seed(2000 + iso)
        n = a.eval_frames
        rows = rows_of((iso,))
        clean = clean_batch(g, n, p_eval)
        real = noise_given(g, clean, rows, zero)
        fake = nf.sample(clean, torch.full((n,), float(iso), device=dev), g)
        real2 = noise_given(g, clean, rows, zero)  # second real draw: the floor
        if not bool(torch.isfinite(fake).all()):
            return float("nan"), 0.0
        return kl(real, fake), kl(real, real2)

    rows = []
    for iso in TRAIN_ISOS + (HELDOUT_ISO,):
        kf, kf0 = score(iso)
        rows.append({"iso": iso, "kld": round(kf, 4), "kld_floor": round(kf0, 4),
                     "heldout": iso == HELDOUT_ISO})

    # best == min-KLD should be (near) the last chunk: monotone-ish descent
    best_chunk = int(np.nanargmin(traj)) if not all(map(math.isnan, traj)) else 0
    print(f"\nNoiseFlow '{nf.arch}' trained {a.steps} steps on ISOs {TRAIN_ISOS} on {dev} "
          f"({train_s:.0f}s); final nll/dim={nll:.4f}")
    print(f"fixed-batch KLD trajectory (per {a.chunk}-step chunk): {traj}")
    print(f"{'ISO':>7} | {'KLD(sym)':>9} {'floor':>7} | note")
    for r in rows:
        note = "held-out (interpolation)" if r["heldout"] else ""
        print(f"{r['iso']:>7} | {r['kld']:>9.4f} {r['kld_floor']:>7.4f} | {note}")
    ok = (math.isfinite(nll)
          and all(math.isfinite(r["kld"]) and r["kld"] <= 0.1 for r in rows if not r["heldout"])
          and best_chunk >= len(traj) - max(2, len(traj) // 4))
    print(json.dumps({"metric": "nf_kld_parity", "ok": bool(ok), "rows": rows,
                      "nll": round(nll, 4), "kld_traj": traj, "best_chunk": best_chunk,
                      "n_chunks": len(traj), "train_s": train_s, "device": str(dev)}))
    return rows


if __name__ == "__main__":
    main()
