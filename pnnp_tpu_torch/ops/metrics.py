"""Image quality metrics in plain torch: PSNR and skimage-compatible SSIM.

Counterparts of ``pnnp_tpu/ops/metrics.py`` (``psnr`` :16, ``ssim`` :42,
``ssim_sum`` :84). These are the CPU path of the eval step and the plain
version that the CUDA SSIM kernel (``pnnp_tpu_torch/kernels/ssim.py``) is
held against on the card. They run on any device.

:func:`quality_assess` and :func:`rgb_quality` (:99-124 there) score with
the kernel on a CUDA tensor and with :func:`ssim` on a CPU tensor.
"""

from __future__ import annotations

import torch


def psnr(x: torch.Tensor, y: torch.Tensor, data_range: float = 255.0) -> torch.Tensor:
    """Peak signal-to-noise ratio; ``x`` is the estimate, ``y`` the target."""
    mse = torch.mean((x.float() - y.float()) ** 2)
    return 10.0 * torch.log10(data_range**2 / mse)


def _window_mean(img: torch.Tensor, win: int) -> torch.Tensor:
    """Valid-mode uniform-window mean over the leading two axes of
    [H, W, C]: an H pass then a W pass of ``win``-tap sums."""
    s = img.unfold(0, win, 1).sum(-1)
    s = s.unfold(1, win, 1).sum(-1)
    return s / (win * win)


def ssim(
    x: torch.Tensor,
    y: torch.Tensor,
    data_range: float = 255.0,
    win_size: int = 7,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """Mean SSIM over an ``[H, W, C]`` image pair, channels averaged.

    Matches ``skimage.metrics.structural_similarity(..., channel_axis=-1)``
    defaults: 7x7 uniform filter, sample covariance (N/(N-1)), and the
    (win_size-1)/2 border crop, which valid-mode windows give for free.
    """
    x = x.float()
    y = y.float()
    n = win_size * win_size
    cov_norm = n / (n - 1.0)

    stacked = torch.cat([x, y, x * x, y * y, x * y], dim=-1)
    ux, uy, uxx, uyy, uxy = torch.chunk(_window_mean(stacked, win_size), 5, dim=-1)

    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    a1 = 2.0 * ux * uy + c1
    a2 = 2.0 * vxy + c2
    b1 = ux * ux + uy * uy + c1
    b2 = vx + vy + c2
    return torch.mean((a1 * a2) / (b1 * b2))


def ssim_sum(
    x: torch.Tensor,
    y: torch.Tensor,
    data_range: float = 255.0,
    win_size: int = 7,
) -> torch.Tensor:
    """SUM of the valid-window SSIM map of an ``[H, W, C]`` pair (all
    channels): ``ssim(x, y) * (H-6) * (W-6) * C``."""
    n = (x.shape[0] - win_size + 1) * (x.shape[1] - win_size + 1) * x.shape[2]
    return ssim(x, y, data_range=data_range, win_size=win_size) * n


def _ssim_on_device(x: torch.Tensor, y: torch.Tensor, data_range: float) -> torch.Tensor:
    """Mean SSIM of an ``[H, W, C]`` pair: the CUDA kernel on the card, the
    plain version on the CPU (the kernel module imports this one, so it is
    imported here at call time)."""
    from pnnp_tpu_torch.kernels.ssim import ssim_kernel

    return ssim_kernel(x, y, data_range=data_range)


def quality_assess(x: torch.Tensor, y: torch.Tensor, data_range: float = 255.0) -> dict:
    """PSNR + SSIM dict for an HWC pair; ``x`` the estimate, ``y`` the
    reference (reference: utils/visualization.py:26-33)."""
    return {"PSNR": psnr(x, y, data_range), "SSIM": _ssim_on_device(x, y, data_range)}


def rgb_quality(out4c: torch.Tensor, tgt4c: torch.Tensor, wb=None, ccm=None):
    """sRGB-domain PSNR/SSIM of a packed-RGBG pair ``[h, w, 4]`` in [0, 1].

    Both images go through :func:`pnnp_tpu_torch.ops.isp.fast_isp` (WB ->
    demosaic -> CCM -> gamma, the device analog of the reference's
    ``raw2rgb_rawpy``), are floored to uint8 levels like the reference's
    scale_up (visualization.py:6-7) and scored at data_range 255: the
    reference's disabled "RGB metrics" eval option (trainer_SID.py:272 +
    visualization.py:57-63). Returns (psnr, ssim) as 0-d tensors on the
    input's device; the SSIM of the ``[2h, 2w, 3]`` pair is the kernel's
    ``generic`` route on the card.
    """
    from pnnp_tpu_torch.ops.isp import fast_isp

    a = torch.floor(fast_isp(out4c, wb=wb, ccm=ccm).clamp(0, 1) * 255.0)
    b = torch.floor(fast_isp(tgt4c, wb=wb, ccm=ccm).clamp(0, 1) * 255.0)
    return psnr(a, b), _ssim_on_device(a, b, 255.0)
