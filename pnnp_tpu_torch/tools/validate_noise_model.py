"""Noise-engine statistical validation: the device sampler against a
NumPy/scipy oracle (counterpart of ``tools/validate_noise_model.py``).

For each (camera, ISO, noise_code, ratio) row, draws noise from the port's
``physics/noise.py::generate_noisy`` on the device and from an independent
NumPy/scipy implementation of the same physics (Poisson shot,
Tukey-lambda/Gaussian read, row, quantization), and reports the histogram
KL divergences at integer-ADU binning (the reference's noise-model quality
metric, utils/kld_div.py:163). A KLD of about 1e-3 or below at 2M samples
means the two laws are indistinguishable at that sample size. The oracle is
the JAX tool's, bit for bit: the same ``default_rng(1)`` gives the same
draws.

Usage (from the repository root; on the card unless ``--cpu``):

    python -m pnnp_tpu_torch.tools.validate_noise_model [--samples 2000000] [--cpu]

Prints the JAX tool's table and, last, one JSON line of the rows;
:func:`main` returns the rows.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
from scipy import stats

# (camera, ISO, noise code, ratio): the JAX tool's rows
ROWS = (
    ("SonyA7S2", 1600, "pgrq", 100.0),
    ("SonyA7S2", 1600, "pr", 250.0),
    ("SonyA7S2", 6400, "p", 300.0),
    ("IMX686", 6400, "prq", 16.0),
    ("IMX686", 100, "pgrq", 1.0),
)
DEVICE_SEED, ORACLE_SEED = 0, 1


def oracle(rng, y, p, code, ratio):
    scale = p["wp"] - p["bl"]
    y_adu = y * scale / ratio
    if "p" in code:
        z = rng.poisson(np.maximum(y_adu / p["K"], 0)).astype(np.float64) * p["K"]
    else:  # the port's Gaussian stand-in for shot noise: variance y*K
        std = np.sqrt(np.maximum(y_adu / p["K"], 1e-10)) * p["K"]
        z = y_adu + rng.normal(0, 1, y.shape) * std
    if "b" not in code:
        if "g" in code:
            z += stats.tukeylambda.rvs(p["lam"], scale=p["sigTL"], size=y.shape,
                                       random_state=rng)
        else:
            z += rng.normal(0, p["sigGs"], y.shape)
        if "r" in code:
            z += rng.normal(0, p["sigR"], y.shape[:-2] + (1, y.shape[-1]))
        if "q" in code:
            z += (rng.uniform(size=y.shape) - 0.5) * p["q"] * scale
    z = np.clip(z / scale, -p["bl"] / p["wp"], 1) * ratio
    return z


def row_params(camera: str, iso: int) -> dict:
    """The calibration row of ``camera`` at ``iso`` as python floats, ``K``
    the row's ``Kmax`` (the JAX tool's dict)."""
    from pnnp_tpu_torch.physics import calibration as calib

    t = calib.ISO_TABLES[camera]
    i = int(np.where(t["iso"] == iso)[0][0])
    p = {k: float(np.asarray(t[k])[i] if np.ndim(t[k]) else t[k])
         for k in ("Kmax", "lam", "sigGs", "sigTL", "sigR", "q", "wp", "bl")}
    p["K"] = p.pop("Kmax")
    return p


def row_kld(dev, camera: str, iso: int, code: str, ratio: float, samples: int,
            signal: float = 0.002, seed: int = DEVICE_SEED) -> dict:
    """One row: ``samples`` draws of ``generate_noisy`` on ``dev`` from
    ``seed`` against the oracle's from ``ORACLE_SEED``, at a flat signal;
    returns the integer-ADU ``kl_fwd``/``kl_inv``/``kl_sym``."""
    import torch

    from pnnp_tpu_torch.ops.kld import kl_div_norm
    from pnnp_tpu_torch.physics.noise import generate_noisy

    n = int(np.sqrt(samples / 4))
    p = row_params(camera, iso)
    full = lambda v: torch.full((1,), float(v), device=dev)
    params = {"K": full(p["K"]), "sigTL": full(p["sigTL"]), "sigR": full(p["sigR"]),
              "sigGs": full(p["sigGs"]), "bias": torch.zeros((1, 4), device=dev),
              "lam": full(p["lam"]), "q": full(p["q"]), "ratio": full(ratio),
              "wp": full(p["wp"]), "bl": full(p["bl"])}
    y = torch.full((1, 4, n, n), signal, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    z_dev = generate_noisy(gen, y, params, code).cpu().numpy()
    rng = np.random.default_rng(ORACLE_SEED)
    z_ref = oracle(rng, np.full((1, n, n, 4), signal), p, code, ratio)
    span = p["wp"] - p["bl"]
    res = kl_div_norm(z_dev / ratio * span, z_ref / ratio * span,
                      bl=p["bl"], wp=int(p["wp"]))
    return {k: float(res[k]) for k in ("kl_fwd", "kl_inv", "kl_sym")}


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=2_000_000)
    ap.add_argument("--signal", type=float, default=0.002)
    ap.add_argument("--cpu", action="store_true")
    a = ap.parse_args(argv)

    import torch

    from pnnp_tpu_torch.utils.device import resolve_device

    dev = torch.device("cpu") if a.cpu else resolve_device(device)
    n = int(np.sqrt(a.samples / 4))
    print(f"{'camera':10s} {'iso':>6s} {'code':>6s} {'ratio':>6s} "
          f"{'kl_fwd':>9s} {'kl_inv':>9s} {'kl_sym':>9s}")
    rows = []
    for camera, iso, code, ratio in ROWS:
        res = row_kld(dev, camera, iso, code, ratio, a.samples, a.signal)
        print(f"{camera:10s} {iso:6d} {code:>6s} {ratio:6.0f} "
              f"{res['kl_fwd']:9.5f} {res['kl_inv']:9.5f} {res['kl_sym']:9.5f}", flush=True)
        rows.append({"camera": camera, "iso": iso, "code": code, "ratio": ratio, **res})
    print(json.dumps({"samples": 4 * n * n, "device": str(dev), "rows": rows}), flush=True)
    return rows


if __name__ == "__main__":
    main()
