"""Training losses (counterpart of ``pnnp_tpu/train/losses.py:12-24``;
reference: losses/base_loss.py). Plain functions of tensors in any layout.
The deep-supervision, gradient and GAN losses wait for ROADMAP 1.13."""

from __future__ import annotations

import torch


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
