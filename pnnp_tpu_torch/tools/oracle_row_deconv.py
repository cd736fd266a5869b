"""Is the row-stage deconvolution objective itself biased? (counterpart of
``tools/oracle_row_deconv.py``)

Fits ONE row-stage ``HeadParams`` by direct ML on unlimited true-physics row
observations through exactly the production row objective
(``models/proxy.py::PixelWiseISOProxy._loss``): the observed per-row mean
m = r + mean_W(pixel noise), scored under (row mixture conv N(0, s_contam))
with s_contam^2 = var_px / W. No MLP, no pixel-head coupling (var_px is the
true pixel variance), no finite data: anything wrong in the result is the
objective's own bias. The other endpoint is the same fit with no
deconvolution (s_contam = 0.3 ADU, the smoothing floor).

The fit is Adam (``torch.optim.Adam``) under optax's
``cosine_decay_schedule(lr, steps, alpha)`` as a ``LambdaLR``: step t runs
at ``lr * ((1 - alpha) * (1 + cos(pi t / steps)) / 2 + alpha)``, step 0 at
``lr``.

Prints, per (ISO, W, mode): the fitted row law's std / sigR, the direct
KLD of its draws against N(0, sigR), its tail, and the last step's NLL;
then one JSON line of the rows, and the wall time on stderr.

Usage (on the card unless ``--cpu``):
    python -m pnnp_tpu_torch.tools.oracle_row_deconv [--cpu] [--w 32 128] [--isos 12800]
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np

ROW_ALPHA = 1e-2  # the JAX tool's cosine_decay_schedule alpha


def cosine_factor(step: int, steps: int, alpha: float) -> float:
    """optax ``cosine_decay_schedule``'s value at ``step`` over its initial
    value."""
    frac = min(step, steps) / max(steps, 1)
    return (1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * frac)) + alpha


def fit_raw(raw0, sample, nll, steps: int, lr: float, alpha: float, gen, label: str = ""):
    """Direct ML fit of one raw head vector [d+3]: ``steps`` Adam steps under
    the cosine schedule, each on fresh ``sample(gen)`` observations scored
    by ``nll(HeadParams, x)``. Returns (HeadParams, the last step's NLL)."""
    import torch

    from pnnp_tpu_torch.models.proxy import QuantileHead

    raw = raw0.clone().requires_grad_(True)
    opt = torch.optim.Adam([raw], lr=lr)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda t: cosine_factor(t, steps, alpha))
    loss = torch.tensor(float("nan"))
    for i in range(steps):
        x = sample(gen)
        loss = nll(QuantileHead.from_raw(raw[None]), x)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        sched.step()
        if label and (i + 1) % max(steps // 4, 1) == 0:
            print(f"    [{label}] step {i + 1}: nll={float(loss.detach()):.5f}", file=sys.stderr)
    with torch.no_grad():
        return QuantileHead.from_raw(raw.detach()[None]), float(loss.detach())


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--d", type=int, default=256)
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--fit-batch", type=int, default=16384,
                    help="row observations per ML step")
    ap.add_argument("--w", type=int, nargs="*", default=[32, 128])
    ap.add_argument("--isos", type=int, nargs="*", default=[3200, 12800])
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--cpu", action="store_true")
    a = ap.parse_args(argv)

    import torch

    from pnnp_tpu_torch.models.proxy import QuantileHead
    from pnnp_tpu_torch.ops.kld import kl_div_norm_device
    from pnnp_tpu_torch.ops.tukey import tukeylambda_sample
    from pnnp_tpu_torch.physics import calibration as calib
    from pnnp_tpu_torch.utils.device import resolve_device

    dev = torch.device("cpu") if a.cpu else resolve_device(device)
    t = calib.ISO_TABLES["SonyA7S2"]
    q_adu = float(t["q"]) * float(t["wp"] - t["bl"])
    d = a.d
    t0 = time.time()

    def rand(gen, shape):
        return torch.rand(shape, generator=gen, device=dev)

    rows = []
    for iso in a.isos:
        i = int(np.where(t["iso"] == iso)[0][0])
        lam, sigTL, sigR = float(t["lam"][i]), float(t["sigTL"][i]), float(t["sigR"][i])
        # the true pixel-noise variance (TL + quant), estimated once at high N
        gv = torch.Generator(device=dev).manual_seed(97)
        big = (tukeylambda_sample(gv, lam, sigTL, (1 << 22,))
               + (rand(gv, (1 << 22,)) - 0.5) * q_adu)
        var_px = float(big.var(unbiased=False))

        for W in a.w:
            def obs_sampler(gen, m, _W=W):
                px = tukeylambda_sample(gen, lam, sigTL, (m, _W))
                qn = (rand(gen, (m, _W)) - 0.5) * q_adu
                r = torch.randn(m, generator=gen, device=dev) * sigR
                return r + (px + qn).mean(dim=1)

            for s_mode in ("deconv", "contaminated"):
                s_c = math.sqrt(var_px / W) if s_mode == "deconv" else 0.3
                # warm start: quantiles of the observations themselves
                x0 = np.sort(obs_sampler(torch.Generator(device=dev).manual_seed(5),
                                         1 << 18).cpu().numpy())
                s_sup = float(np.abs(x0[int(x0.size * 0.99)]))
                core = x0[np.abs(x0) <= s_sup]
                qs = np.quantile(core, np.linspace(0, 1, d + 1))
                cum = np.clip((qs / s_sup + 1) / 2, 0, 1)
                cum[0], cum[-1] = 0, 1
                h = np.maximum(np.diff(cum), 1e-8)
                h /= h.sum()
                raw0 = np.zeros(d + 3, np.float32)
                raw0[:d] = np.log(h)
                raw0[d] = np.log(max(s_sup, 0.2)) - QuantileHead.LOG_SCALE_INIT
                # a small tail near the observation scale: the default init
                # (7.6% mass, b = e^2 ADU) would dominate the sampled std
                raw0[d + 1] = -1.5
                raw0[d + 2] = np.log(max(s_sup / 2, 0.1)) - QuantileHead.LOG_SCALE_INIT

                s_t = torch.tensor(s_c, dtype=torch.float32, device=dev)
                hp, nll = fit_raw(
                    torch.from_numpy(raw0).to(dev),
                    lambda g: obs_sampler(g, a.fit_batch),
                    lambda hp, x: -QuantileHead.log_prob_conv_gaussian(hp, x[None, :], s_t).mean(),
                    a.steps, a.lr, ROW_ALPHA,
                    torch.Generator(device=dev).manual_seed(iso * 7 + W))

                g = torch.Generator(device=dev).manual_seed(iso + W)
                M = 1 << 20
                with torch.no_grad():
                    u = rand(g, (1, M)) * (1 - 2e-6) + 1e-6
                    c = rand(g, (1, M))
                    draw = QuantileHead.quantile(hp, u, c)[0]
                    core_draw = QuantileHead.quantile(hp, u, None)[0]  # tail off
                    std = float(draw.std(unbiased=False))
                    ref = torch.randn(M, generator=g, device=dev) * sigR
                    kld = float(kl_div_norm_device(ref, draw, bl=float(t["bl"]),
                                                   wp=int(t["wp"]))["kl_sym"])
                rows.append({"iso": iso, "W": W, "mode": s_mode,
                             "s_contam": round(s_c, 3),
                             "row_std": round(std, 4),
                             "core_std": round(float(core_draw.std(unbiased=False)), 4),
                             "sigR": round(sigR, 4),
                             "ratio": round(std / sigR, 4),
                             "kld_vs_gauss": round(kld, 4),
                             "tail_pi": round(float(hp.tail_pi[0, 0]), 4),
                             "tail_b": round(float(hp.tail_b[0, 0]), 3),
                             "nll": round(nll, 4)})
                r = rows[-1]
                print(f"ISO {iso} W={W:>4} {s_mode:>12}: s_contam="
                      f"{r['s_contam']:>6} fitted std {r['row_std']:.3f} "
                      f"core {r['core_std']:.3f} (sigR {sigR:.3f}, ratio "
                      f"{r['ratio']:.3f}) KLD vs N(0,sigR) "
                      f"{r['kld_vs_gauss']:.4f} tail=({r['tail_pi']:.3f},"
                      f"{r['tail_b']:.2f})", flush=True)

    print(f"[timing] oracle_row_deconv {time.time() - t0:.1f} s on {dev}", file=sys.stderr)
    print(json.dumps({"metric": "oracle_row_deconv", "rows": rows}), flush=True)
    return rows


if __name__ == "__main__":
    main()
