"""Optical-flow-heritage losses: EPE, census-ternary, Sobel (counterpart of
``pnnp_tpu/train/flow_losses.py``; reference: losses/flow_loss.py, which no
reference trainer uses). NCHW tensors in, per-pixel maps out (callers
reduce)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pnnp_tpu_torch.train.losses import gradient


def epe_loss(flow: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Endpoint error ``||flow - gt||_2`` over channels, masked:
    ``[N, C, H, W]`` -> ``[N, 1, H, W]`` (reference flow_loss.py:6-13)."""
    d = (flow - gt.detach()) ** 2
    return torch.sqrt(torch.sum(d, dim=1, keepdim=True) + 1e-6) * mask


def _rgb2gray(rgb: torch.Tensor) -> torch.Tensor:
    w = torch.tensor([0.2989, 0.5870, 0.1140], dtype=rgb.dtype, device=rgb.device)
    return torch.sum(rgb[:, :3] * w.reshape(1, 3, 1, 1), dim=1, keepdim=True)


def _census(img: torch.Tensor, patch: int = 7) -> torch.Tensor:
    """Ternary census signature: the normalized difference of each 7x7
    neighbour to the centre, ``[N, 1, H, W]`` -> ``[N, 49, H, W]``."""
    k = torch.eye(patch * patch, dtype=img.dtype, device=img.device)
    patches = F.conv2d(img, k.reshape(patch * patch, 1, patch, patch), padding=patch // 2)
    t = patches - img
    return t / torch.sqrt(0.81 + t * t)


def ternary_loss(img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
    """Census soft-hamming distance map of two RGB images, a 1-pixel border
    masked out: ``[N, 1, H, W]`` (reference flow_loss.py:15-50)."""
    d = (_census(_rgb2gray(img0)) - _census(_rgb2gray(img1))) ** 2
    ham = torch.mean(d / (0.1 + d), dim=1, keepdim=True)
    mask = F.pad(torch.ones_like(ham[:, :, 1:-1, 1:-1]), (1, 1, 1, 1))
    return ham * mask


def sobel_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """L1 of the Sobel-gradient difference, per pixel and channel
    (reference flow_loss.py:52-75)."""
    lx = torch.abs(gradient(pred, "x", "sobel") - gradient(gt, "x", "sobel"))
    ly = torch.abs(gradient(pred, "y", "sobel") - gradient(gt, "y", "sobel"))
    return lx + ly
