"""Post-hoc inspection of a trained pw_iso_2stage fit (counterpart of
``tools/diagnose_proxy_fit.py``): is the row head's learned law right?

The params pickle is the JAX-layout tree that ``validate_proxy --save``
writes (either package's); it loads through ``models/convert.py``.
Prints, per ISO:
  * pixel head: the closed-form model variance (+ s0^2 the sampler adds)
    against the empirical variance of 2^20 true residual draws (TL +
    quant), the ``var_px`` the row deconvolution divides by W;
  * row head: the std of 2^20 direct head draws against the calibrated
    sigR, and the symmetric KLD of head draws against N(0, sigR) at the
    validate binning (the row stage judged on its own law);
  * the heads' tail_pi / tail_b and means, and the 3/5/10 sigma tail
    masses of the pixel law (s0 included) against the physics.

Usage (on the card unless ``--cpu``):
       python -m pnnp_tpu_torch.tools.validate_proxy ... --save /tmp/p.pkl
       python -m pnnp_tpu_torch.tools.diagnose_proxy_fit /tmp/p.pkl [--d 256] [--cpu]

The last line is one JSON object of every column per ISO; :func:`main`
returns its rows.
"""

from __future__ import annotations

import argparse
import json
import pickle

M = 1 << 20
ISOS = (800, 1600, 3200, 12800, 6400)


def load_proxy(path: str, d: int, mode: str, s0: float, dev):
    """A ``PixelWiseISOProxy`` holding the JAX-layout params of ``path``."""
    from pnnp_tpu_torch.models.convert import params_from_jax
    from pnnp_tpu_torch.models.proxy import PixelWiseISOProxy

    with open(path, "rb") as f:
        params = pickle.load(f)
    proxy = PixelWiseISOProxy(d=d, nf=16, nb=2, mode=mode, smooth_s0=s0)
    proxy.load_state_dict(params_from_jax(params), strict=True)
    return proxy.to(dev).eval()


def diagnose(proxy, iso: int, s0: float, zero_mean: bool = True) -> dict:
    """Every column of the JAX tool's rows at one ISO, as floats; the draws
    from a generator seeded with the ISO, as the JAX tool keys them."""
    import numpy as np
    import torch

    from pnnp_tpu_torch.models.proxy import QuantileHead
    from pnnp_tpu_torch.ops.kld import kl_div_norm_device
    from pnnp_tpu_torch.ops.tukey import tukeylambda_sample
    from pnnp_tpu_torch.physics import calibration as calib

    dev = proxy.pixel_stage.bins.weight.device
    t = calib.ISO_TABLES["SonyA7S2"]
    q_adu = float(t["q"]) * float(t["wp"] - t["bl"])
    i = int(np.where(t["iso"] == iso)[0][0])
    lam, sigTL, sigR = float(t["lam"][i]), float(t["sigTL"][i]), float(t["sigR"][i])
    feat = proxy._iso_feat(float(iso))
    hp_px, hp_row = proxy.pixel_stage(feat), proxy.row_stage(feat)
    if zero_mean:
        hp_px, hp_row = QuantileHead.center(hp_px), QuantileHead.center(hp_row)

    gen = torch.Generator(device=dev).manual_seed(iso)

    def uniform(shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    v_model = float(QuantileHead.variance(hp_px)[0, 0]) + s0 ** 2
    true = tukeylambda_sample(gen, lam, sigTL, (M,)) + (uniform((M,)) - 0.5) * q_adu
    v_true = float(true.var(unbiased=False))
    u, c = uniform((1, M), 1e-6, 1 - 1e-6), uniform((1, M))
    row_draw = QuantileHead.quantile(hp_row, u, c)[0]
    row_ref = torch.randn(M, generator=gen, device=dev) * sigR
    kld = float(kl_div_norm_device(row_ref, row_draw, bl=float(t["bl"]), wp=int(t["wp"]))["kl_sym"])
    um, cm = uniform((1, M), 1e-6, 1 - 1e-6), uniform((1, M))
    px_draw = QuantileHead.quantile(hp_px, um, cm)[0] + s0 * torch.randn(M, generator=gen,
                                                                          device=dev)
    sig = max(v_true, 1e-9) ** 0.5
    tails = {str(k): [float((px_draw.abs() > k * sig).float().mean()),
                      float((true.abs() > k * sig).float().mean())] for k in (3, 5, 10)}
    return {"iso": iso, "px_var_model": v_model, "px_var_true": v_true,
            "row_std": float(row_draw.std(unbiased=False)), "sigR": sigR, "row_kld": kld,
            "px_tail_pi": float(hp_px.tail_pi[0, 0]), "px_tail_b": float(hp_px.tail_b[0, 0]),
            "row_tail_pi": float(hp_row.tail_pi[0, 0]), "row_tail_b": float(hp_row.tail_b[0, 0]),
            "mean_px": float(QuantileHead.mean(hp_px)[0, 0]),
            "mean_row": float(QuantileHead.mean(hp_row)[0, 0]),
            "row_log_scale": float(hp_row.log_scale[0, 0]), "tails": tails}


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("params")
    ap.add_argument("--d", type=int, default=256)
    ap.add_argument("--mode", default="2stage+iso")
    ap.add_argument("--s0", type=float, default=0.3)
    ap.add_argument("--no-zero-mean", action="store_true",
                    help="do NOT center the heads (pre-fix fits; production "
                         "default centers: models/proxy.py zero_mean)")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--isos", type=int, nargs="*", default=list(ISOS))
    a = ap.parse_args(argv)

    import torch

    from pnnp_tpu_torch.utils.device import resolve_device

    dev = torch.device("cpu") if a.cpu else resolve_device(device)
    proxy = load_proxy(a.params, a.d, a.mode, a.s0, dev)
    print(f"{'ISO':>7} | {'px var model':>12} {'px var true':>11} {'ratio':>6}"
          f" | {'row std model':>13} {'sigR':>6} {'ratio':>6} {'row KLD':>8}"
          f" | px(pi,b)    row(pi,b)")
    rows = []
    with torch.no_grad():
        for iso in a.isos:
            r = diagnose(proxy, iso, a.s0, zero_mean=not a.no_zero_mean)
            rows.append(r)
            print(f"{iso:>7} | {r['px_var_model']:12.2f} {r['px_var_true']:11.2f} "
                  f"{r['px_var_model'] / max(r['px_var_true'], 1e-9):6.3f} | "
                  f"{r['row_std']:13.3f} {r['sigR']:6.3f} {r['row_std'] / r['sigR']:6.3f} "
                  f"{r['row_kld']:8.4f} | ({r['px_tail_pi']:.3f},{r['px_tail_b']:.1f}) "
                  f"({r['row_tail_pi']:.3f},{r['row_tail_b']:.1f}) | "
                  f"mean px {r['mean_px']:+.4f} row {r['mean_row']:+.4f} ADU")
            tails = [f"P>|{k}s|: model {m:.2e} true {t:.2e}" for k, (m, t) in r["tails"].items()]
            print(f"{'':>7}   tail   " + "   ".join(tails), flush=True)
    print(json.dumps({"device": str(dev), "rows": rows}), flush=True)
    return rows


if __name__ == "__main__":
    main()
