"""Image scores of the PNNP evaluation, in float64.

* PSNR at data range 255 (the SID/ELD logs' convention).
* SSIM as ``skimage.metrics.structural_similarity(x, y, data_range=255,
  channel_axis=-1)``: a 7x7 uniform window, K1 = 0.01, K2 = 0.03, the
  sample covariance (49/48) and only the windows that lie inside the image,
  averaged over windows and channels.
* The ELD illuminance correction (ELD, Wei et al., CVPR 2020, the
  evaluation's ``IlluminanceCorrect``): the least-squares scale that fits
  the clipped prediction to the ground truth, saturated ground-truth pixels
  left out; a degenerate fit leaves the prediction as it is.

Frames are ``[H, W, C]`` tensors (C last), any float dtype; the scores come
back as Python floats. ``dtype`` is the precision the score is computed in
(float64 unless the control asks for less).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

WIN = 7
K1, K2 = 0.01, 0.03


def psnr(x: torch.Tensor, y: torch.Tensor, data_range: float = 255.0,
         dtype=torch.float64) -> float:
    mse = torch.mean((x.to(dtype) - y.to(dtype)) ** 2).double()
    return float(10.0 * torch.log10(data_range**2 / mse.clamp_min(1e-30)))


def ssim(x: torch.Tensor, y: torch.Tensor, data_range: float = 255.0,
         dtype=torch.float64) -> float:
    x = x.to(dtype).permute(2, 0, 1)[None]
    y = y.to(dtype).permute(2, 0, 1)[None]
    box = lambda t: F.avg_pool2d(t, WIN, stride=1)
    ux, uy = box(x), box(y)
    norm = WIN * WIN / (WIN * WIN - 1.0)
    vx = norm * (box(x * x) - ux * ux)
    vy = norm * (box(y * y) - uy * uy)
    vxy = norm * (box(x * y) - ux * uy)
    c1, c2 = (K1 * data_range) ** 2, (K2 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)
         / ((ux * ux + uy * uy + c1) * (vx + vy + c2)))
    return float(s.double().mean())


def illuminance_correct(pred: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    pred = pred.clamp(0.0, 1.0)
    keep = src != 1.0
    num = torch.sum(torch.where(keep, pred * src, 0.0))
    den = torch.sum(torch.where(keep, pred * pred, 0.0))
    return pred * (num / den) if float(den) > 0 else pred


def score_frame(dn: torch.Tensor, hr: torch.Tensor, ratio: float, ori: bool,
                correct: bool) -> tuple:
    """The evaluation of one denoised frame ``dn`` against ``hr`` (both
    ``[H, W, 4]``, the network's output unclipped): ori scaling, clip,
    optional correction, then (dn as scored, PSNR, SSIM)."""
    if ori:
        dn = dn * ratio
    dn = dn.clamp(0.0, 1.0)
    hrc = hr.clamp(0.0, 1.0)
    if correct:
        dn = illuminance_correct(dn, hr)
    return dn, psnr(dn * 255.0, hrc * 255.0), ssim(dn * 255.0, hrc * 255.0)
