"""The port's Poisson sampler against scipy, its random stream against the
next draw's, and ``validate_noise_model``'s IMX686 ISO 100 row split by
noise code.

Three tables, each on the device (the card unless ``--cpu``):

- ``sampler``: ``n`` draws of ``ops/poisson.py::poisson_sample`` at each
  lam of ``LAMS``: mean and variance against lam (scipy's), and the
  forward KLD of the count histogram against ``scipy.stats.poisson.pmf``
  beside its sampling floor ``(bins - 1) / (2 n)``.
- ``stream``: the Pearson correlation of each Poisson draw with the
  uniform that the generator's next call (``torch.rand``) gives the same
  element, for the port's sampler and for bare ``torch.poisson``. Two
  independent draws read 0 within ``1 / sqrt(n)``.
- ``split``: ``validate_noise_model.row_kld`` at IMX686 ISO 100, ratio 1,
  for each noise code of ``SPLIT_CODES`` over ``--seeds``. ``p`` alone is
  Poisson shot plus Gaussian read; ``g``, ``r`` and ``q`` alone take the
  Gaussian stand-in for shot noise (no Poisson draw). With ``--raw`` the
  split runs a second time with bare ``torch.poisson`` in the synth.

Usage (from the repository root):

    python -m pnnp_tpu_torch.tools.check_poisson [--cpu] [--n 4194304]
        [--samples 400000] [--seeds 0-7] [--raw]

Prints each table's rows and, last, one JSON line of all three;
:func:`main` returns that dict.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
from scipy import stats

LAMS = (1.0, 4.0, 16.0, 23.0, 64.0, 100.0)
SPLIT_ROW = ("IMX686", 100, 1.0)
SPLIT_CODES = ("p", "g", "r", "q", "pgrq")


def bare_poisson(generator, lam):
    """``torch.poisson`` as it is, without the port's stream reserve."""
    import torch

    return torch.poisson(lam, generator=generator)


def sampler_rows(dev, lams=LAMS, n: int = 1 << 22, seed: int = 0, draw=None) -> list:
    """Moments and pmf KLD of ``n`` draws of ``draw`` (the port's
    ``poisson_sample``) at each lam."""
    import torch

    from pnnp_tpu_torch.ops.poisson import poisson_sample

    draw = draw or poisson_sample
    rows = []
    for lam in lams:
        gen = torch.Generator(device=dev).manual_seed(seed)
        k = draw(gen, torch.full((n,), lam, device=dev)).double()
        mean, var = float(k.mean()), float(k.var())
        counts = torch.bincount(k.long()).cpu().numpy().astype(np.float64)
        emp = counts / n
        pmf = stats.poisson.pmf(np.arange(len(counts)), lam)
        pmf[-1] += stats.poisson.sf(len(counts) - 1, lam)  # the tail in the last bin
        nz = emp > 0
        rows.append({"lam": lam, "n": n, "mean": mean, "var": var,
                     "mean_rel": mean / lam - 1.0, "var_rel": var / lam - 1.0,
                     "kl": float(np.sum(emp[nz] * np.log(emp[nz] / pmf[nz]))),
                     "kl_floor": float((nz.sum() - 1) / (2.0 * n))})
    return rows


def stream_rows(dev, lams=LAMS, n: int = 1 << 20, seed: int = 0) -> list:
    """Correlation of each Poisson draw with the next call's uniform at the
    same element, for the port's sampler and for bare ``torch.poisson``."""
    import torch

    from pnnp_tpu_torch.ops.poisson import poisson_sample

    rows = []
    for lam in lams:
        row = {"lam": lam, "n": n}
        for name, draw in (("port", poisson_sample), ("bare", bare_poisson)):
            gen = torch.Generator(device=dev).manual_seed(seed)
            k = draw(gen, torch.full((n,), lam, device=dev)).double()
            u = torch.rand(n, generator=gen, device=dev).double()
            kc, uc = k - k.mean(), u - u.mean()
            row[f"corr_{name}"] = float((kc * uc).sum() / (kc.norm() * uc.norm()))
        rows.append(row)
    return rows


def split_rows(dev, seeds, samples: int = 400_000, codes=SPLIT_CODES, bare: bool = False) -> list:
    """``kl_sym`` of the IMX686 ISO 100 row for each code over ``seeds``;
    ``bare`` swaps bare ``torch.poisson`` into the synth for the run."""
    from pnnp_tpu_torch.physics import noise
    from pnnp_tpu_torch.tools.validate_noise_model import row_kld

    camera, iso, ratio = SPLIT_ROW
    saved = noise.poisson_sample
    if bare:
        noise.poisson_sample = bare_poisson
    try:
        rows = []
        for code in codes:
            kls = [row_kld(dev, camera, iso, code, ratio, samples, seed=s)["kl_sym"]
                   for s in seeds]
            rows.append({"code": code, "sampler": "bare" if bare else "port",
                         "kl_sym": kls, "median": float(np.median(kls)), "max": float(max(kls))})
        return rows
    finally:
        noise.poisson_sample = saved


def parse_seeds(text: str) -> list:
    """``"0-7"`` or ``"0,3,5"`` -> a list of ints."""
    if "-" in text:
        lo, hi = text.split("-")
        return list(range(int(lo), int(hi) + 1))
    return [int(s) for s in text.split(",")]


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 22, help="draws per lam (sampler table)")
    ap.add_argument("--samples", type=int, default=400_000, help="samples per split row")
    ap.add_argument("--seeds", default="0-7")
    ap.add_argument("--raw", action="store_true",
                    help="also run the split with bare torch.poisson in the synth")
    ap.add_argument("--cpu", action="store_true")
    a = ap.parse_args(argv)

    import torch

    from pnnp_tpu_torch.utils.device import resolve_device

    dev = torch.device("cpu") if a.cpu else resolve_device(device)
    out = {"device": str(dev)}
    out["sampler"] = sampler_rows(dev, n=a.n)
    for r in out["sampler"]:
        print(f"sampler lam {r['lam']:6.1f} mean {r['mean_rel']:+.5f} var {r['var_rel']:+.5f} "
              f"kl {r['kl']:.3e} (floor {r['kl_floor']:.3e})", flush=True)
    out["stream"] = stream_rows(dev, n=min(a.n, 1 << 20))
    for r in out["stream"]:
        print(f"stream  lam {r['lam']:6.1f} corr port {r['corr_port']:+.5f} "
              f"bare {r['corr_bare']:+.5f}", flush=True)
    seeds = parse_seeds(a.seeds)
    out["split"] = split_rows(dev, seeds, a.samples)
    if a.raw:
        out["split"] += split_rows(dev, seeds, a.samples, bare=True)
    for r in out["split"]:
        print(f"split {r['sampler']:4s} {r['code']:>5s} median kl_sym {r['median']:.3e} "
              f"max {r['max']:.3e}", flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
