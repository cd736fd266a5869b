"""Bijector framework for the noise-model flows (counterpart of
``pnnp_tpu/models/flows/base.py``).

Each bijector is an ``nn.Module`` with

    ``forward_ldj(x, clean=None, iso=None, train=False) -> (z, ldj)``  (x -> latent)
    ``inverse(z, clean=None, iso=None) -> x``                          (latent -> noise)

where ``ldj`` is the per-example log |det dz/dx| ``[n]``. Images are NCHW;
``iso`` is a scalar or a per-example ``[n]`` tensor. The chain sums the
log-dets (reference: archs/noise_flow.py:113-131).
"""

from __future__ import annotations

import torch
import torch.nn as nn


def sum_except_batch(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).sum(dim=1)


class Bijector(nn.Module):
    """Base class; subclasses implement ``forward_ldj`` and ``inverse``."""

    def forward_ldj(self, x, clean=None, iso=None, train: bool = False):  # pragma: no cover
        raise NotImplementedError

    def inverse(self, z, clean=None, iso=None):  # pragma: no cover - interface
        raise NotImplementedError
