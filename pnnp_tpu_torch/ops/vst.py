"""Generalized Anscombe variance-stabilizing transform (counterpart of
``pnnp_tpu/ops/vst.py``; reference: utils/isp_algos.py:4-18)."""

from __future__ import annotations

import torch


def vst(x, sigma, mu=0.0, gain=1.0, wp=1.0):
    """Forward VST: stabilizes Poisson-Gaussian noise to ~unit variance.

    Keeps the reference's quirk of dividing by ``wp`` while the polynomial
    uses the *unscaled* ``x``, for parity."""
    y = gain * x + (gain**2) * 3.0 / 8.0 + sigma**2 - gain * mu
    y = torch.sqrt(torch.clamp(torch.as_tensor(y), min=0.0))
    return (2.0 / gain) * (y / wp)


def inverse_vst(x, sigma, gain=1.0, wp=1.0):
    """Algebraic (exact-mean) inverse of :func:`vst` at ``wp=1``. For
    ``wp != 1`` the reference's forward never scales ``x`` into the wp
    domain while the inverse does (isp_algos.py:13-18 vs :4-11), so the
    round trip is off by 1/wp; both reference variants use only wp=1."""
    x = x * wp
    y = (x / 2.0) ** 2 - 3.0 / 8.0 - sigma**2 / gain**2
    return y * gain / wp


def inverse_vst_batch(x, kmax, sig_gs, wp=1.0):
    """Batched :func:`inverse_vst` with per-image ``kmax`` / ``sig_gs`` of
    shape ``[N]`` over ``x`` ``[N, ...]`` (the reference's per-sample loop,
    data_process/process.py:28-38)."""
    x = x * wp
    kmax = kmax.reshape((-1,) + (1,) * (x.dim() - 1))
    sig_gs = sig_gs.reshape((-1,) + (1,) * (x.dim() - 1))
    y = (x / 2.0) ** 2 - 3.0 / 8.0 - sig_gs**2 / kmax**2
    return y * kmax / wp
