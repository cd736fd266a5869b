"""Training arithmetic of the PNNP recipes, in plain PyTorch.

* Adam (Kingma and Ba, 2015) with the recipes' (0.9, 0.999, 1e-8), bias
  correction by the step count, no weight decay.
* The learning-rate schedule ``WarmupCosine`` of the PNNP code (SGDR,
  Loshchilov and Hutter, 2017, with a warm-up after each restart and the
  rate halved each period), as a function of the epoch.
* The denoiser's step: forward on the noisy crops, mean L1 against the
  clean crops, gradients by autograd, Adam.
"""

from __future__ import annotations

import math

import torch

from . import unet

BETAS, EPS = (0.9, 0.999), 1e-8


class Adam:
    """Adam over a dict of tensors, updated in place."""

    def __init__(self, params: dict):
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict, lr: float) -> None:
        self.t += 1
        b1, b2 = BETAS
        c1, c2 = 1.0 - b1**self.t, 1.0 - b2**self.t
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1.0 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            p.sub_(lr * (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2) + EPS))


def warmup_cosine(epoch: int, hyper: dict) -> float:
    """The recipes' rate at ``epoch``: ``hyper`` holds learning_rate,
    stop_epoch, last_epoch, step_size (the warm-up) and T (the periods)."""
    lr = float(hyper["learning_rate"])
    periods = max(int(hyper.get("T", 1)), 1)
    period = max((hyper["stop_epoch"] - hyper.get("last_epoch", 0)) // periods, 1)
    peak = max(int(hyper.get("step_size", 10)), 1)
    T = epoch // period
    s = epoch - T * period
    cos = 0.8 * (math.cos((s - peak) / max(period - peak, 1) * math.pi) * 0.5 + 0.5) + 0.2
    mul = s / peak if (s <= peak and T > 0) else cos
    return lr * mul / 2.0**T


def unet_step(params: dict, opt: Adam, lr_img: torch.Tensor, hr_img: torch.Tensor,
              rate: float, quant=None) -> tuple:
    """One step on NCHW crops: returns (loss, gradients); ``params`` move."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = torch.mean(torch.abs(unet.forward(leaves, lr_img, quant) - hr_img))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    grads = dict(zip(leaves, grads))
    opt.step(params, grads, rate)
    return float(loss.detach()), grads
