"""Training losses (counterpart of ``pnnp_tpu/train/losses.py``; reference:
losses/base_loss.py, losses/__init__.py). Plain functions of tensors; the
image ones take the port's NCHW layout where JAX's take NHWC."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def charbonnier_loss(pred: torch.Tensor, target: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """L1-Charbonnier (reference: base_loss.py:63-74)."""
    diff = pred - target
    return torch.mean(torch.sqrt(diff * diff + eps))


def unet_loss(pred: torch.Tensor, target: torch.Tensor,
              charbonnier: bool = False) -> torch.Tensor:
    """The denoiser loss: plain L1 (reference: base_loss.py:75-107)."""
    return charbonnier_loss(pred, target) if charbonnier else l1_loss(pred, target)


def pyramid_sample(x: torch.Tensor, max_scale: int = 8) -> list:
    """Average-pyramid levels ``[x/2, x/4, ..., x/max_scale]`` of an NCHW
    batch, 2x2 VALID pooling (reference: base_loss.py:38-47)."""
    outs, cur, s = [], x, 2
    while s <= max_scale:
        cur = F.avg_pool2d(cur, 2)
        outs.append(cur)
        s *= 2
    return outs


def pyramid_loss(lows, highs, rate: float = 0.5, charbonnier: bool = False):
    """Scale-weighted multi-resolution loss (reference: base_loss.py:49-61)."""
    loss, weight, total = 0.0, 1.0, 0.0
    for lo, hi in zip(lows, highs):
        loss = loss + weight * unet_loss(lo, hi, charbonnier)
        total = total + weight
        weight = weight * rate
    return loss / total


def unet_dpsv_loss(outputs, target: torch.Tensor, charbonnier: bool = False):
    """Deep-supervision loss over ``[out, out2, out4, out8]``: the
    UNWEIGHTED sum over the scales against the target's average pyramid
    (reference base_loss.py:109-121, as the JAX package)."""
    highs = [target] + pyramid_sample(target, max_scale=2 ** (len(outputs) - 1))
    return sum(unet_loss(lo, hi, charbonnier) for lo, hi in zip(outputs, highs))


def unet_dpsv_up_loss(outputs, target: torch.Tensor, charbonnier: bool = False):
    """``Unet_dpsv_Loss_up`` (base_loss.py:122-133): the finest target is
    scored twice (``outputs[0]`` and ``outputs[1]``), the pyramid reaching
    only ``2^(len-2)``; the same unweighted sum."""
    highs = [target, target] + pyramid_sample(target, max_scale=2 ** (len(outputs) - 2))
    return sum(unet_loss(lo, hi, charbonnier) for lo, hi in zip(outputs, highs))


_SOBEL_X = ((1.0, 0.0, -1.0), (2.0, 0.0, -2.0), (1.0, 0.0, -1.0))
_ROBERT_X = ((0.0, 0.0), (-1.0, 1.0))


def gradient(x: torch.Tensor, direction: str = "x", mode: str = "sobel") -> torch.Tensor:
    """Sobel/Robert image gradients of an NCHW batch, per channel, zero
    padding ``(k//2, (k-1)//2)`` on each axis (reference: base_loss.py
    Sobel/Robert ops)."""
    k = torch.tensor(_SOBEL_X if mode == "sobel" else _ROBERT_X,
                     dtype=x.dtype, device=x.device)
    if direction == "y":
        k = k.T
    kh, kw = k.shape
    c = x.shape[1]
    xpad = F.pad(x, (kw // 2, (kw - 1) // 2, kh // 2, (kh - 1) // 2))
    return F.conv2d(xpad, k.expand(c, 1, kh, kw), groups=c)


def grad_loss(pred: torch.Tensor, target: torch.Tensor, mode: str = "sobel"):
    """L1 on gradient maps (reference: base_loss.py grad_loss)."""
    gx = torch.abs(gradient(pred, "x", mode) - gradient(target, "x", mode))
    gy = torch.abs(gradient(pred, "y", mode) - gradient(target, "y", mode))
    return torch.mean(gx + gy)


def gan_loss(logits: torch.Tensor, target_is_real: bool, mode: str = "lsgan"):
    """GAN criterion (reference: base_loss.py:135-182; vanilla/lsgan)."""
    target = torch.ones_like(logits) if target_is_real else torch.zeros_like(logits)
    if mode == "lsgan":
        return torch.mean((logits - target) ** 2)
    # vanilla: BCE with logits
    return torch.mean(logits.clamp_min(0) - logits * target
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def psnr_loss(pred: torch.Tensor, target: torch.Tensor):
    """Per-image mean PSNR on [0, 1] tensors (reference: losses/__init__.py:4-15)."""
    mse = torch.mean((pred - target) ** 2, dim=(1, 2, 3))
    return torch.mean(10.0 * torch.log10(1.0 / mse.clamp_min(1e-12)))
