"""Noise-model quality metrics: histogram KL divergences + CDF tools
(counterpart of ``pnnp_tpu/ops/kld.py``; reference: utils/kld_div.py).

``kl_div_norm`` is the per-epoch sanity metric of noise-model training
(reference: trainer_NF_SID.py:163-180): integer-quantized noise histograms
over the full ADU range, forward / inverse / symmetric KLD. The NumPy
functions are copies of the JAX package's host versions;
:func:`kl_div_norm_device` is the same quantization as one ``bincount`` per
input on the tensors' device.
"""

from __future__ import annotations

import numpy as np
import torch


# ----------------------------------------------------------------- NumPy path
def _norm_np(data, bl, wp, clip=False):
    data = data.astype(np.float32)
    if clip and wp is not None:
        data = data.clip(-bl, wp)
    bl = data.min() if bl is None else bl
    wp = data.max() if wp is None else wp
    return (data - bl) / (wp - bl)


def get_histogram(data, bin_edges=None, left_edge=0.0, right_edge=1.0, n_bins=1000):
    rng = right_edge - left_edge
    width = rng / n_bins
    if bin_edges is None:
        bin_edges = np.arange(left_edge, right_edge + width, width)
    centers = bin_edges[:-1] + width / 2.0
    hist, _ = np.histogram(data, bin_edges)
    return hist / np.prod(data.shape), centers


def kl_div_forward(p, q):
    idx = ~(np.isnan(p) | np.isinf(p) | np.isnan(q) | np.isinf(q))
    p, q = p[idx], q[idx]
    idx = (p > 0) & (q > 0)
    p, q = p[idx], q[idx]
    return np.sum(p * np.log(p / q))


def kl_div_inverse(p, q):
    return kl_div_forward(q, p)


def kl_div_sym(p, q):
    return 0.5 * (kl_div_forward(p, q) + kl_div_inverse(p, q))


def kl_div_3(p, q):
    f, i = kl_div_forward(p, q), kl_div_inverse(p, q)
    return f, i, 0.5 * (f + i)


def kl_div_3_data(p_data, q_data, bin_edges=None, left_edge=0.0, right_edge=1.0,
                  n_bins=1000):
    if bin_edges is None:
        width = (right_edge - left_edge) / n_bins
        bin_edges = np.arange(left_edge, right_edge + width, width)
    p, _ = get_histogram(p_data, bin_edges, left_edge, right_edge, n_bins)
    q, _ = get_histogram(q_data, bin_edges, left_edge, right_edge, n_bins)
    return kl_div_3(p, q)


def kl_div_norm(p_data, q_data, bl=512, wp=16383):
    """Integer-ADU histogram KLD (reference: kld_div.py:163-200).

    Inputs are noise samples in ADU (or normalized with negatives); they are
    shifted by ``bl`` when negative, rounded to integers, normalized to
    [0, 1] over ``wp`` bins, and compared where both histograms have mass.
    """
    p_data = np.asarray(p_data, np.float32).copy()
    q_data = np.asarray(q_data, np.float32).copy()
    if bl is None:
        n_bins = wp
        left, right = (
            min(p_data.min(), q_data.min()),
            max(p_data.max(), q_data.max()),
        )
    else:
        if p_data.min() < 0:
            p_data += bl
            q_data += bl
        p_data = np.round(p_data)
        q_data = np.round(q_data)
        p_data = _norm_np(p_data, 0, wp, clip=True)
        q_data = _norm_np(q_data, 0, wp, clip=True)
        n_bins = wp
        left, right = 0.0, 1.0
    width = (right - left) / n_bins
    bin_edges = np.arange(left, right + width, width)
    y_p, _ = get_histogram(p_data, bin_edges, left, right, n_bins)
    y_q, _ = get_histogram(q_data, bin_edges, left, right, n_bins)
    kl_fwd, kl_inv, kl_sym = kl_div_3(y_p, y_q)
    # hist axes rescale by wp even in the bl=None branch (where edges are
    # already in data units) — reference-exact quirk (kld_div.py:199).
    return {
        "kl_fwd": kl_fwd,
        "kl_inv": kl_inv,
        "kl_sym": kl_sym,
        "hist_p": (y_p, bin_edges * wp - (bl or 0)),
        "hist_q": (y_q, bin_edges * wp - (bl or 0)),
    }


# -------------------------------------------------------------- device path
def kl_div_norm_device(p_data: torch.Tensor, q_data: torch.Tensor,
                       bl: float = 512.0, wp: int = 16383) -> dict:
    """Integer-histogram KLD on the tensors' device: one ``bincount`` per
    input, the quantization of :func:`kl_div_norm` (shift by ``bl`` when
    ``p_data`` has negatives, round half to even, clip to ``[0, wp]``, and
    the integers ``wp - 1`` and ``wp`` share the last bin, as
    ``np.histogram`` puts them). Returns 0-dim float32 tensors."""
    wp = int(wp)
    shift = p_data.min() < 0

    def hist(x):
        x = torch.where(shift, x + bl, x).round()
        x = x.clamp(0, wp).clamp_max(wp - 1).long().reshape(-1)
        return torch.bincount(x, minlength=wp) / x.numel()

    hp, hq = hist(p_data), hist(q_data)
    mask = (hp > 0) & (hq > 0)
    logp = torch.log(torch.where(mask, hp, 1.0))
    logq = torch.log(torch.where(mask, hq, 1.0))
    kl_fwd = torch.where(mask, hp * (logp - logq), 0.0).sum()
    kl_inv = torch.where(mask, hq * (logq - logp), 0.0).sum()
    return {"kl_fwd": kl_fwd, "kl_inv": kl_inv, "kl_sym": 0.5 * (kl_fwd + kl_inv)}


# --------------------------------------------------- CDF/quantile loss tools
def cdf_interp(sorted_data: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Empirical CDF with linear interpolation (reference CDFPPF.get_cdf)."""
    n = sorted_data.shape[0]
    x = torch.clamp(x, sorted_data[0], sorted_data[-1])
    idx = torch.searchsorted(sorted_data, x).clamp(1, n - 1)
    lo = sorted_data[idx - 1]
    hi = sorted_data[idx]
    frac = torch.where(hi > lo, (x - lo) / (hi - lo).clamp_min(1e-12), 0.0)
    return (idx - 1 + frac) / (n - 1)


def quantile_loss(output: torch.Tensor, gt: torch.Tensor, x_quant: torch.Tensor):
    """L1 between matched quantiles (reference kld_div.py:49-53)."""
    qo = torch.quantile(output.reshape(-1), x_quant)
    qg = torch.quantile(gt.reshape(-1), x_quant)
    return torch.mean(torch.abs(qo - qg))


def cdf_loss(output: torch.Tensor, gt: torch.Tensor, x_cdf: torch.Tensor):
    """L1 between empirical CDFs at probe points (reference kld_div.py:56-60)."""
    co = cdf_interp(torch.sort(output.reshape(-1)).values, x_cdf)
    cg = cdf_interp(torch.sort(gt.reshape(-1)).values, x_cdf)
    return torch.mean(torch.abs(co - cg))
