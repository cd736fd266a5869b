"""ISP support filters (counterpart of ``pnnp_tpu/ops/filters.py``;
reference: utils/isp_algos.py:21-99): stdfilt, the (fast) guided filter and
the bilateral row-mean FPN remover of dark-shading calibration, as box-filter
compositions over ``[..., H, W]`` tensors on any device."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _box(img: torch.Tensor, k: int) -> torch.Tensor:
    """Mean filter with edge-replicate padding over the last two dims of
    ``[..., H, W]``; the asymmetric pad keeps the size for even ``k`` too."""
    pl, pr = k // 2, (k - 1) // 2
    lead, (H, W) = img.shape[:-2], img.shape[-2:]
    x = F.pad(img.reshape(-1, 1, H, W), (pl, pr, pl, pr), mode="replicate")[:, 0]
    x = (x / k).unfold(-1, k, 1).sum(-1)  # separable: rows, then columns
    x = (x / k).unfold(-2, k, 1).sum(-1)
    return x.reshape(*lead, H, W)


def stdfilt(img: torch.Tensor, k: int = 5) -> torch.Tensor:
    """Local standard deviation (reference: isp_algos.py:21-30)."""
    mu = _box(img, k)
    mu2 = _box(img * img, k)
    return torch.sqrt(torch.clamp(mu2 - mu * mu, min=0.0))


def guided_filter(I: torch.Tensor, p: torch.Tensor, k: int = 5, eps: float = 0.01):
    """He et al. guided filter (reference: isp_algos.py:61-82)."""
    mean_I = _box(I, k)
    mean_p = _box(p, k)
    var_I = _box(I * I, k) - mean_I * mean_I
    cov_Ip = _box(I * p, k) - mean_I * mean_p
    a = cov_Ip / (var_I + eps)
    b = mean_p - a * mean_I
    return _box(a, k) * I + _box(b, k)


def fast_guided_filter(p: torch.Tensor, k: int = 5, eps: float = 0.01):
    """Self-guided variant (reference: isp_algos.py:42-59)."""
    return guided_filter(p, p, k, eps)


def row_denoise(raw: torch.Tensor, sigma_s: float = 7.0, sigma_r: float = 0.5):
    """Bilateral smoothing of per-row means: the row FPN estimate of
    dark-shading calibration (reference: isp_algos.py:84-99, which ran
    cv2.bilateralFilter on the row-mean profile). ``raw`` is a mosaic
    ``[H, W]``; row means are taken per Bayer row plane. Returns the raw
    with the row noise removed."""
    H, W = raw.shape
    rows = raw.reshape(H // 2, 2, W).permute(1, 0, 2)  # [2, H/2, W]
    row_mean = rows.mean(dim=-1)  # [2, H/2]
    n = row_mean.shape[1]
    radius = int(3 * sigma_s)
    offsets = torch.arange(-radius, radius + 1, device=raw.device)
    spatial_w = torch.exp(-0.5 * (offsets / sigma_s) ** 2)
    idx = (torch.arange(n, device=raw.device)[:, None] + offsets[None, :]).clamp(0, n - 1)
    neigh = row_mean[:, idx]  # [2, n, 2r+1]
    range_w = torch.exp(-0.5 * ((neigh - row_mean[..., None]) / sigma_r) ** 2)
    w = spatial_w * range_w
    smooth = (w * neigh).sum(-1) / w.sum(-1)
    corrected = rows - (row_mean - smooth)[..., None]
    return corrected.permute(1, 0, 2).reshape(H, W)
