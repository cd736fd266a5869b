"""NoiseFlow: a normalizing-flow camera noise model (counterpart of
``pnnp_tpu/models/noise_flow.py``; reference archs/noise_flow.py:24-221).

The arch string DSL is the JAX module's:
``'sdn|unc|unc|unc|unc|giso|unc|unc|unc|unc'``, where ``unc`` is
InvertibleConv1x1 plus AffineCoupling (the coupling alone unless
``flow_permutation == 1``), ``sdn`` SignalDependantISO and ``giso``/``gain``
GainISO. The prior is a standard diagonal Gaussian. Images are NCHW.

API:
  * ``loss(noise, clean, iso, train=False)`` -> (nll_per_dim, sd_z)
  * ``sample(clean, iso, generator, eps_std=None)`` -> noise draw
  * ``forward(noise, clean, iso, train=False)`` -> (z, log_det)
  * ``inverse(z, clean, iso)`` -> noise

The layers carry the JAX module names (``conv1x1_{i}``, ``unc_{i}``,
``sdn_{i}``, ``giso_{i}``), so ``models/convert.py::flow_params_from_jax``
loads a JAX checkpoint, params and ``batch_stats``, as it is. ``train=True``
normalizes the couplings by batch statistics and moves their running
averages; ``inverse`` and ``sample`` use the running ones. The flow computes
in float32 (no TF32 on the card).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from pnnp_tpu_torch.models.flows import (
    AffineCoupling,
    GainISO,
    InvertibleConv1x1,
    SignalDependantISO,
)

ARCH = "sdn|unc|unc|unc|unc|giso|unc|unc|unc|unc"


def _exact_f32(x: torch.Tensor) -> None:
    # the flow's f32 convolutions and channel mixes in full f32, as JAX
    # computes them: cuDNN would otherwise run them in TF32
    if x.is_cuda:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


class NoiseFlow(nn.Module):
    def __init__(self, arch: str = ARCH, flow_permutation: int = 1, num_channels: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.arch, self.flow_permutation = arch, int(flow_permutation)
        c = num_channels
        names = []
        for i, lyr in enumerate(arch.split("|")):
            if lyr == "unc":
                if self.flow_permutation == 1:
                    # any other value means no permutation layer, the
                    # reference's fall-through (noise_flow.py:53-66)
                    names.append((f"conv1x1_{i}", InvertibleConv1x1(c, generator)))
                names.append((f"unc_{i}", AffineCoupling(c, generator=generator)))
            elif lyr == "sdn":
                names.append((f"sdn_{i}", SignalDependantISO()))
            elif lyr in ("giso", "gain"):
                names.append((f"giso_{i}", GainISO()))
            else:
                raise ValueError(f"unknown flow layer '{lyr}'")
        for name, layer in names:
            self.add_module(name, layer)
        self.order = tuple(name for name, _ in names)

    def bijectors(self):
        return [getattr(self, name) for name in self.order]

    def forward(self, noise, clean=None, iso=None, train: bool = False):
        """noise -> (z, per-example log-det [n])."""
        _exact_f32(noise)
        z = noise
        objective = torch.zeros(noise.shape[0], device=noise.device)
        for bij in self.bijectors():
            z, ldj = bij.forward_ldj(z, clean=clean, iso=iso, train=train)
            objective = objective + ldj
        return z, objective

    def inverse(self, z, clean=None, iso=None):
        _exact_f32(z)
        x = z
        for bij in reversed(self.bijectors()):
            x = bij.inverse(x, clean=clean, iso=iso)
        return x

    def loss(self, noise, clean=None, iso=None, train: bool = False):
        """Per-dim NLL under the standard-normal prior, and the mean
        per-example std of the input (the reference's ``sd_z``;
        noise_flow.py:133-165)."""
        z, objective = self.forward(noise, clean=clean, iso=iso, train=train)
        n = z.shape[0]
        logp = -0.5 * torch.sum((math.log(2 * math.pi) + z ** 2).reshape(n, -1), dim=1)
        nll = -(objective + logp)
        nll_dim = torch.mean(nll) / (noise.shape[1] * noise.shape[2] * noise.shape[3])
        var_z = torch.var(noise.reshape(n, -1), dim=1, unbiased=False)
        return nll_dim, torch.mean(torch.sqrt(var_z))

    def sample(self, clean, iso, generator: torch.Generator, eps_std=None):
        """Draw noise: z ~ N(0, 1) from ``generator`` -> the inverse chain
        (reference: noise_flow.py:173-188)."""
        eps = torch.randn(clean.shape, generator=generator, device=generator.device)
        if eps_std is not None:
            eps = eps * torch.as_tensor(eps_std, device=eps.device).reshape(-1, 1, 1, 1)
        return self.inverse(eps, clean=clean, iso=iso)
