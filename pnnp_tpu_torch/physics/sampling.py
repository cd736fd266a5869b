"""Noise-parameter samplers, batched, on the generator's device
(counterpart of ``pnnp_tpu/physics/sampling.py``).

Re-expresses the reference's per-crop Python sampling loops
(reference: data_process/process.py:311-412) as batched torch draws: one
call produces the parameters of a whole crop batch, and every draw comes
from the ``torch.Generator`` passed in (never the global RNG), on that
generator's device.

The parameter dict ("params") holds float32 tensors of leading shape ``[n]``
(``bias`` is ``[n, 4]``): K, sigTL, sigR, sigGs, bias, lam, q, ratio, wp, bl.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pnnp_tpu_torch.physics import calibration as calib


def _regression_consts(camera_type: str) -> dict:
    p = calib.CAMERA_REGRESSION[camera_type]
    return {k: float(np.float32(v)) for k, v in p.items()}


def _uniform(g: torch.Generator, n, lo: float, hi: float) -> torch.Tensor:
    return torch.rand(n, generator=g, device=g.device) * (hi - lo) + lo


def _normal(g: torch.Generator, n) -> torch.Tensor:
    return torch.randn(n, generator=g, device=g.device)


def _select(g: torch.Generator, camera_type: str, n: int, default=float("nan")):
    """``sel(name)`` -> per-example [n] tensor of the camera's regression
    constant; dual-ISO cameras pick the low or high branch per example by a
    fair coin. Also returns the constants of one branch (to test for keys)."""
    dev = g.device
    if camera_type in calib.DUAL_ISO_CAMERAS:
        lo = _regression_consts(camera_type + "_lowISO")
        hi = _regression_consts(camera_type + "_highISO")
        pick_hi = torch.rand(n, generator=g, device=dev) < 0.5

        def sel(name, d=default):
            return torch.where(pick_hi,
                               torch.tensor(hi.get(name, d), device=dev),
                               torch.tensor(lo.get(name, d), device=dev))
        return sel, lo
    p = _regression_consts(camera_type)
    return (lambda name, d=default: torch.full((n,), p.get(name, d), device=dev)), p


def sample_params_max(
    generator: torch.Generator,
    camera_type: str = "NikonD850",
    n: int = 1,
    ratio=None,
    iso=None,
    jitter_sigmas: bool = True,
    table: Optional[dict] = None,
) -> dict:
    """Batched ``sample_params_max`` (reference: process.py:311-351).

    * ``iso`` given and calibrated -> point-calibration branch: gather the ISO
      row and perturb (K jitter +-1%, gaussian jitter on sigGs/sigTL/sigR).
      ``iso`` may be a scalar ISO or an int tensor of per-example table
      *indices* (see :func:`calibration.iso_index`).
    * ``iso`` None -> regression branch: per-example dual-ISO coin flip for
      SonyA7S2, K-jittered log-linear sigma models.
    * ``ratio`` None -> U(100, 300) for Sony-family, exp(U(0, 2.08)) otherwise.
    * ``jitter_sigmas=False`` (point branch only): sigGs/sigTL/sigR at their
      calibrated means, K jittered only (the trainer_LRID.py:404-408 law).
    * ``table`` (point branch only): an ``ISO_TABLES``-shaped dict overriding
      the baked calibration (:func:`calibration.table_with_noiseparam`).
    """
    g, dev = generator, generator.device
    if iso is not None and table is None and camera_type not in calib.ISO_TABLES:
        raise ValueError(
            f"explicit iso given but {camera_type!r} has no per-ISO "
            "calibration table; only regression sampling (iso=None) exists "
            "for this camera")
    if iso is not None:
        if table is None:
            table = calib.ISO_TABLES[camera_type]
        if isinstance(iso, (int, float, str, np.integer, np.floating)):
            idx = torch.full((n,), calib.iso_index(camera_type, iso), dtype=torch.long,
                             device=dev)
        else:
            idx = torch.as_tensor(iso, dtype=torch.long, device=dev)

        def gather(name):
            return torch.as_tensor(np.asarray(table[name], np.float32), device=dev)[idx]

        K = gather("Kmax") * (1.0 + _uniform(g, n, -0.01, 0.01))
        if jitter_sigmas:
            sigGs = gather("sigGs") + _normal(g, n) * gather("sigGssig")
            sigTL = gather("sigTL") + _normal(g, n) * gather("sigTLsig")
            sigR = gather("sigR") + _normal(g, n) * gather("sigRsig")
        else:
            sigGs, sigTL, sigR = gather("sigGs"), gather("sigTL"), gather("sigR")
        bias = gather("bias")
        lam = gather("lam")
        wp, bl, q = (torch.full((n,), float(np.float32(table[k])), device=dev)
                     for k in ("wp", "bl", "q"))
    else:
        sel, _ = _select(g, camera_type, n)
        log_K = sel("Kmax") + _uniform(g, n, -0.01, 0.01)
        K = torch.exp(log_K)
        sigTL = torch.exp(sel("sigTLk") * log_K + sel("sigTLb"))
        sigR = torch.exp(sel("sigRk") * log_K + sel("sigRb"))
        sigGs = torch.exp(sel("sigGsk") * log_K + sel("sigGsb")
                          + _normal(g, n) * sel("sigGssig"))
        bias = torch.zeros((n, 4), device=dev)
        lam, wp, bl, q = sel("lam"), sel("wp"), sel("bl"), sel("q")

    if ratio is None:
        if "SonyA7S2" in camera_type:
            ratio = _uniform(g, n, 100.0, 300.0)
        else:
            ratio = torch.exp(_uniform(g, n, 0.0, 2.08))
    else:
        ratio = torch.as_tensor(ratio, dtype=torch.float32, device=dev).expand(n)

    return dict(K=K, sigTL=sigTL, sigR=sigR, sigGs=sigGs, bias=bias,
                lam=lam, q=q, ratio=ratio, wp=wp, bl=bl)


def sample_params(
    generator: torch.Generator,
    camera_type: str = "NikonD850",
    n: int = 1,
    ln_ratio: bool = False,
) -> dict:
    """Batched ``sample_params`` (reference: process.py:354-412).

    Full-regression sampling: log-K uniform over the camera's calibrated K
    range, gaussian jitter on every log-sigma, exp-bias for cameras with a
    calibrated read-bias model (SonyA7S2).
    """
    g = generator
    sel, consts = _select(g, camera_type, n, default=0.0)
    log_K = _uniform(g, n, 0.0, 1.0) * (sel("Kmax") - sel("Kmin")) + sel("Kmin")
    K = torch.exp(log_K)
    sigTL = torch.exp(sel("sigTLk") * log_K + sel("sigTLb") + _normal(g, n) * sel("sigTLsig"))
    sigR = torch.exp(sel("sigRk") * log_K + sel("sigRb") + _normal(g, n) * sel("sigRsig"))
    sigGs = torch.exp(sel("sigGsk") * log_K + sel("sigGsb") + _normal(g, n) * sel("sigGssig"))
    if "uReadk" in consts:
        bias_s = torch.exp(sel("uReadk") * log_K + sel("uReadb")
                           + _normal(g, n) * sel("uReadsig"))
    else:
        # Reference quirk preserved: log_bias = 0 -> bias = exp(0) = 1.
        bias_s = torch.ones((n,), device=g.device)
    bias = bias_s[:, None].expand(n, 4)

    if ln_ratio:
        high = 1.0 if "CRVD" in camera_type else 5.0
        ratio = torch.exp(_uniform(g, n, -0.01, high))
    else:
        ratio = _uniform(g, n, 100.0, 300.0)

    return dict(K=K, sigTL=sigTL, sigR=sigR, sigGs=sigGs, bias=bias,
                lam=sel("lam"), q=sel("q"), ratio=ratio, wp=sel("wp"), bl=sel("bl"))


def sony_k_from_iso(generator: torch.Generator, iso: torch.Tensor) -> torch.Tensor:
    """SonyA7S2 system gain from ISO with the +-1% calibration jitter:
    ``K = 0.0009546 * iso - 0.00193`` (reference: process.py:455)."""
    a, b = calib.SONY_ISO2K
    iso = torch.as_tensor(iso, dtype=torch.float32, device=generator.device)
    return a * iso * (1.0 + _uniform(generator, iso.shape, -0.01, 0.01)) + b


def params_at_iso_regression(generator: torch.Generator, camera_type: str,
                             iso: torch.Tensor) -> dict:
    """SNA/WB-aug helper: K(iso) + regression sigGs for ISOs outside the table
    (reference: process.py:505-517, :563-571). ``iso`` is a float tensor
    [n]; the low/high branch follows iso <= 1600."""
    assert camera_type == "SonyA7S2"
    dev = generator.device
    iso = torch.as_tensor(iso, dtype=torch.float32, device=dev)
    lo = _regression_consts("SonyA7S2_lowISO")
    hi = _regression_consts("SonyA7S2_highISO")
    use_hi = iso > 1600

    def sel(name):
        return torch.where(use_hi, torch.tensor(hi[name], device=dev),
                           torch.tensor(lo[name], device=dev))

    K = sony_k_from_iso(generator, iso)
    sigGs = torch.exp(sel("sigGsk") * torch.log(K) + sel("sigGsb")
                      + _normal(generator, iso.shape) * sel("sigGssig"))
    return dict(K=K, sigGs=sigGs, wp=sel("wp"), bl=sel("bl"), lam=sel("lam"), q=sel("q"))
