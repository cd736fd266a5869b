"""Pixel-stage KLD oracle: is the trained proxy's KLD plateau the PWL +
Laplace family's floor, or a trainable gap? (counterpart of
``tools/oracle_proxy_family.py``)

It fits ONE ``HeadParams`` mixture (the exact family ``models/proxy.py``
samples from: d equal-probability PWL quantile core + Laplace tail, same
clips, ``QuantileHead.from_raw``) per ISO and per stage, by direct maximum
likelihood on unlimited fresh physics samples, with no MLP conditioning, no
row-mean deconvolution and no finite data:

  * pixel stage target: TukeyLambda(lam, sigTL) + U(-q*scale/2, +q*scale/2)
    (the 'g' + 'q' components of the 'pgrq' law; shot is zero on dark
    frames);
  * row stage target: N(0, sigR) per (row, channel).

The fitted family is convolved with N(0, s0) in the likelihood
(``log_prob_conv_gaussian``; ``--s0 0``: the raw family's ``log_prob``),
and sampling adds the matching N(0, s0). The oracle then composes samples
like ``PixelWiseISOProxy._sample`` (pixel draw + broadcast row draw) and is
scored with ``validate_proxy``'s integer-ADU symmetric KLD and eval
geometry (64^2 dark frames): full noise and row means, each beside its
real-vs-real floor, at ``--eval-frames`` and ``--big-eval-frames``.

The fit is Adam under optax's ``cosine_decay_schedule(lr, steps, 1e-3)``
(``oracle_row_deconv.fit_raw``).

Usage (on the card unless ``--cpu``):
    python -m pnnp_tpu_torch.tools.oracle_proxy_family [--d 256] [--steps 1500] [--cpu]
Prints a table and one JSON line; the wall time on stderr.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

FAMILY_ALPHA = 1e-3  # the JAX tool's cosine_decay_schedule alpha
EVAL_PATCH = 64


def warm_start(samples: np.ndarray, d: int) -> np.ndarray:
    """The empirical-quantile construction: knots at the core quantiles,
    the tail's mass and scale from the tail (2% to start)."""
    from pnnp_tpu_torch.models.proxy import QuantileHead

    x = np.sort(np.asarray(samples, np.float64))
    n = x.size
    pi0 = 0.02
    s = float(np.abs(x[int(n * (1 - pi0 / 2)) - 1]))
    s = float(np.clip(s, np.exp(-2.0) * 1.01, np.exp(6.0) * 0.99))
    core = x[np.abs(x) <= s]
    qs = np.quantile(core, np.linspace(0.0, 1.0, d + 1))
    cum = np.clip((qs / s + 1.0) / 2.0, 0.0, 1.0)
    cum[0], cum[-1] = 0.0, 1.0
    heights = np.maximum(np.diff(cum), 1e-8)
    heights /= heights.sum()
    raw = np.zeros(d + 3, np.float32)
    raw[:d] = np.log(heights)
    raw[d] = np.log(s) - QuantileHead.LOG_SCALE_INIT
    raw[d + 1] = np.log(pi0 / (1 - pi0)) - QuantileHead.TAIL_LOGIT_INIT
    b0 = (max(float(np.mean(np.abs(x[np.abs(x) > s]))), 1e-2)
          if np.any(np.abs(x) > s) else s)
    raw[d + 2] = np.log(b0) - QuantileHead.LOG_SCALE_INIT
    return raw


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--d", type=int, default=256)
    ap.add_argument("--steps", type=int, default=1500,
                    help="Adam steps per oracle fit (fresh samples each)")
    ap.add_argument("--fit-batch", type=int, default=1 << 18, help="samples per ML step")
    ap.add_argument("--eval-frames", type=int, default=16)
    ap.add_argument("--big-eval-frames", type=int, default=512,
                    help="large-N eval isolating family error from eval noise")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--s0", type=float, default=0.3,
                    help="Gaussian smoothing (ADU) of the fitted family; 0: the raw family")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--isos", type=int, nargs="*", default=[800, 1600, 3200, 12800, 6400])
    a = ap.parse_args(argv)

    import torch

    from pnnp_tpu_torch.models.proxy import HeadParams, QuantileHead
    from pnnp_tpu_torch.ops.kld import kl_div_norm_device
    from pnnp_tpu_torch.ops.tukey import tukeylambda_sample
    from pnnp_tpu_torch.physics import calibration as calib
    from pnnp_tpu_torch.physics.noise import generate_noisy
    from pnnp_tpu_torch.tools.oracle_row_deconv import fit_raw
    from pnnp_tpu_torch.utils.device import resolve_device

    dev = torch.device("cpu") if a.cpu else resolve_device(device)
    t = calib.ISO_TABLES["SonyA7S2"]
    span = float(t["wp"] - t["bl"])
    q_adu = float(t["q"]) * span
    d = a.d
    s0 = torch.tensor(a.s0, dtype=torch.float32, device=dev)

    def seeded(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def rand(g, shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=g, device=dev) * (hi - lo) + lo

    def nll(hp, x):
        if a.s0 > 0:
            return -QuantileHead.log_prob_conv_gaussian(hp, x[None, :], s0).mean()
        return -QuantileHead.log_prob(hp, x[None, :]).mean()

    def fit(sampler, seed, label):
        raw0 = torch.from_numpy(warm_start(sampler(seeded(123), 1 << 20).cpu().numpy(), d))
        if a.steps == 0:  # score the quantile construction alone
            return QuantileHead.from_raw(raw0.to(dev)[None]), float("nan")
        return fit_raw(raw0.to(dev), lambda g: sampler(g, a.fit_batch), nll,
                       a.steps, a.lr, FAMILY_ALPHA, seeded(seed), label)

    def params_at(iso, n):
        i = int(np.where(t["iso"] == iso)[0][0])
        rep = lambda v: torch.full((n,), float(v), device=dev)
        return dict(K=rep(t["Kmax"][i]), sigTL=rep(t["sigTL"][i]), sigR=rep(t["sigR"][i]),
                    sigGs=rep(t["sigGs"][i]), bias=torch.zeros((n, 4), device=dev),
                    lam=rep(t["lam"][i]), q=rep(t["q"]), ratio=rep(1.0),
                    wp=rep(t["wp"]), bl=rep(t["bl"]))

    def dark_frames(g, iso, n, p):
        return generate_noisy(g, torch.zeros((n, 4, p, p), device=dev), params_at(iso, n),
                              "pgrq", ori=True)

    def oracle_sample(g, hp_px, hp_row, n, p):
        """Pixel + broadcast row draws, as ``PixelWiseISOProxy._sample`` on
        dark frames (shot 0), normalized; each draw adds the N(0, s0) the
        likelihood convolved in."""
        tile = lambda hp: HeadParams(*[v.expand(n, -1) for v in hp])
        px = QuantileHead.quantile(tile(hp_px), rand(g, (n, 4, p, p), 1e-6, 1 - 1e-6),
                                   rand(g, (n, 4, p, p)))
        row = QuantileHead.quantile(tile(hp_row), rand(g, (n, 4, p, 1), 1e-6, 1 - 1e-6),
                                    rand(g, (n, 4, p, 1)))
        if a.s0 > 0:
            px = px + a.s0 * torch.randn(px.shape, generator=g, device=dev)
            row = row + a.s0 * torch.randn(row.shape, generator=g, device=dev)
        return (px + row) / span

    def kl(x, y):
        return float(kl_div_norm_device(x * span, y * span, bl=float(t["bl"]),
                                        wp=int(t["wp"]))["kl_sym"])

    def score(iso, hp_px, hp_row, n_frames, seed):
        g = seeded(seed)
        real = dark_frames(g, iso, n_frames, EVAL_PATCH)
        fake = oracle_sample(g, hp_px, hp_row, n_frames, EVAL_PATCH)
        real2 = dark_frames(g, iso, n_frames, EVAL_PATCH)
        rmean = lambda v: v.mean(dim=3)
        return (kl(real, fake), kl(real, real2),
                kl(rmean(real), rmean(fake)), kl(rmean(real), rmean(real2)))

    t0 = time.time()
    rows = []
    for iso in a.isos:
        i = int(np.where(t["iso"] == iso)[0][0])
        lam, sigTL, sigR = float(t["lam"][i]), float(t["sigTL"][i]), float(t["sigR"][i])
        print(f"ISO {iso}: fitting pixel oracle (TL lam={lam:.4f} sigTL={sigTL:.3f} "
              f"+ quant) ...", file=sys.stderr)

        def px_sampler(g, m):
            return tukeylambda_sample(g, lam, sigTL, (m,)) + (rand(g, (m,)) - 0.5) * q_adu

        def row_sampler(g, m):
            return torch.randn(m, generator=g, device=dev) * sigR

        hp_px, nll_px = fit(px_sampler, iso, f"px@{iso}")
        hp_row, _ = fit(row_sampler, iso + 1, f"row@{iso}")
        with torch.no_grad():
            kf, kf0, kr, kr0 = score(iso, hp_px, hp_row, a.eval_frames, 1000 + iso)
            bkf, bkf0, _, _ = score(iso, hp_px, hp_row, a.big_eval_frames, 2000 + iso)
        rows.append({"iso": iso, "kld": round(kf, 4), "kld_floor": round(kf0, 4),
                     "row_kld": round(kr, 4), "row_floor": round(kr0, 4),
                     "kld_bigN": round(bkf, 4), "floor_bigN": round(bkf0, 4),
                     "nll_px": round(nll_px, 4)})

    wall = time.time() - t0
    print(f"\nFAMILY ORACLE (d={d}, {a.steps} ML steps x {a.fit_batch} fresh "
          f"samples/stage; {wall:.0f}s on {dev}). Eval = validate_proxy "
          f"geometry; bigN = {a.big_eval_frames} frames.")
    print(f"{'ISO':>7} | {'oracle KLD':>10} {'floor':>7} | {'row KLD':>8} "
          f"{'floor':>7} | {'KLD bigN':>9} {'floor':>7}")
    for r in rows:
        print(f"{r['iso']:>7} | {r['kld']:>10.4f} {r['kld_floor']:>7.4f} | "
              f"{r['row_kld']:>8.4f} {r['row_floor']:>7.4f} | "
              f"{r['kld_bigN']:>9.4f} {r['floor_bigN']:>7.4f}")
    print(f"[timing] oracle_proxy_family {wall:.1f} s on {dev}", file=sys.stderr)
    print(json.dumps({"metric": "proxy_family_oracle", "d": d, "rows": rows}), flush=True)
    return rows


if __name__ == "__main__":
    main()
