"""Small bijectors: ActNorm, Squeeze, Logit, UniformDequantization,
NoiseExtraction (counterpart of ``pnnp_tpu/models/flows/basic.py``;
reference archs/flow_layers/{actnorm,squeeze,logit,uniform_dequantization,
noise_extraction}.py).

NCHW, where the JAX package is NHWC: a per-channel parameter broadcasts
over dim 1, and the log-det's ``H*W`` is ``shape[-2] * shape[-1]``.
ActNorm's data-dependent init is the functional :func:`actnorm_data_init`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from pnnp_tpu_torch.models.flows.base import Bijector


def _per_channel(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``[C]`` as a view that broadcasts over dim 1 of ``x``."""
    return p.reshape((1, -1) + (1,) * (x.dim() - 2))


class ActNorm(Bijector):
    """Per-channel affine ``z = exp(log_scale) * x + shift``, ldj =
    ``H*W*sum(log_scale)`` (1 for a ``[n, C]`` input)."""

    def __init__(self, features: int = 4):
        super().__init__()
        self.features = features
        self.log_scale = nn.Parameter(torch.zeros(features))
        self.shift = nn.Parameter(torch.zeros(features))

    def forward_ldj(self, x, clean=None, iso=None, train: bool = False):
        z = torch.exp(_per_channel(self.log_scale, x)) * x + _per_channel(self.shift, x)
        hw = x.shape[-2] * x.shape[-1] if x.dim() == 4 else 1
        ldj = hw * torch.sum(self.log_scale)
        return z, torch.broadcast_to(ldj, (x.shape[0],))

    def inverse(self, z, clean=None, iso=None):
        return (z - _per_channel(self.shift, z)) * torch.exp(-_per_channel(self.log_scale, z))


def actnorm_data_init(x: torch.Tensor) -> dict:
    """Data-dependent ActNorm init from a representative batch (channels on
    dim 1): ``{'log_scale', 'shift'}`` that put the post-norm activations at
    N(0, 1) (reference actnorm.py:80-95). The std (``ddof=1``) is floored
    at 1e-6: a constant channel (a clipped black-level plane) would give an
    infinite log-scale otherwise."""
    flat = x.movedim(1, -1).reshape(-1, x.shape[1])  # [-1, C] rows
    std = torch.clamp_min(torch.std(flat, dim=0, correction=1), 1e-6)
    mu = torch.mean(flat / std, dim=0)
    return {"log_scale": -torch.log(std), "shift": -mu}


class Squeeze(Bijector):
    """Space-to-depth by ``factor`` (volume-preserving, ldj = 0). The
    output channel of input channel ``c`` at offset ``(fy, fx)`` is
    ``c*f*f + fy*f + fx``: JAX's order, which ``pixel_unshuffle`` gives."""

    def __init__(self, factor: int = 2):
        super().__init__()
        self.factor = factor

    def forward_ldj(self, x, clean=None, iso=None, train: bool = False):
        return F.pixel_unshuffle(x, self.factor), x.new_zeros(x.shape[0])

    def inverse(self, z, clean=None, iso=None):
        return F.pixel_shuffle(z, self.factor)


class Logit(Bijector):
    """``x`` in (0, 1) -> logits; the ldj by the softplus identity
    (reference logit.py)."""

    def __init__(self, temperature: float = 1.0, eps: float = 1e-6):
        super().__init__()
        self.temperature, self.eps = temperature, eps

    def forward_ldj(self, x, clean=None, iso=None, train: bool = False):
        t = torch.tensor(self.temperature, dtype=torch.float32, device=x.device)
        xc = torch.clamp(x, self.eps, 1.0 - self.eps)
        z = (1.0 / t) * (torch.log(xc) - torch.log1p(-xc))
        softplus = lambda v: torch.logaddexp(v, torch.zeros_like(v))
        per = -(torch.log(t) - softplus(-t * z) - softplus(t * z))
        return z, torch.sum(per.reshape(x.shape[0], -1), dim=1)

    def inverse(self, z, clean=None, iso=None):
        return torch.sigmoid(self.temperature * z)


class UniformDequantization(Bijector):
    """Integer pixels + U[0, 1) -> continuous [0, 1); ldj = ``-bits*log 2``
    per dimension. The uniform comes from the caller's ``generator`` (JAX:
    the ``sample`` rng stream)."""

    def __init__(self, num_bits: int = 8):
        super().__init__()
        self.num_bits = num_bits

    def forward_ldj(self, x, clean=None, iso=None, train: bool = False,
                    generator: Optional[torch.Generator] = None):
        bins = 2**self.num_bits
        u = torch.rand(x.shape, generator=generator, device=x.device, dtype=x.dtype)
        n_dims = math.prod(x.shape[1:])
        ldj = torch.full((x.shape[0],), -self.num_bits * math.log(2.0) * n_dims,
                         device=x.device)
        return (x + u) / bins, ldj

    def inverse(self, z, clean=None, iso=None):
        bins = 2**self.num_bits
        return torch.clamp(torch.floor(bins * z), 0, bins - 1)


class NoiseExtraction(Bijector):
    """``z = x - clean`` (zero ldj)."""

    def forward_ldj(self, x, clean=None, iso=None, train: bool = False):
        return x - clean, x.new_zeros(x.shape[0])

    def inverse(self, z, clean=None, iso=None):
        return z + clean
