"""RealNVP affine coupling with the NoiseFlow CNN conditioner (counterpart
of ``pnnp_tpu/models/flows/coupling.py``; reference
archs/flow_layers/affine_coupling.py:19-53, 245-295).

The conditioner (:class:`ShiftAndLogScale`): 3x3 conv -> BN -> ReLU -> 1x1
conv -> BN -> ReLU, then the border-flag trick: zero-pad H and W by 1, add
one channel that is 1 exactly on the padded ring, and a zero-init VALID 3x3
conv, so the network can tell the zero border apart. The output is scaled
by ``exp(3 * logs)`` and the log-scale bounded by ``scale * tanh(.)``.

The BatchNorm is flax's (:class:`FlaxBatchNorm`), not torch's: flax keeps
its running averages with momentum 0.99 and updates the running variance
with the *biased* batch variance, where ``nn.BatchNorm2d`` uses the
unbiased one; the stats would drift from JAX's within a few steps.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from pnnp_tpu_torch.models.flows.base import Bijector, sum_except_batch


class FlaxBatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channels of NCHW input: epsilon 1e-5;
    in train mode it normalizes by the batch mean and the biased batch
    variance and moves the running averages by ``momentum * running + (1 -
    momentum) * batch`` (the biased variance too); otherwise it uses the
    running averages. ``weight`` is flax's ``scale``. The normalization is
    torch's fused batch norm, which computes flax's biased variance in two
    passes where flax takes ``E[x^2] - E[x]^2``: the same statistic, with
    fewer digits lost.

    ``data_mean``, set by the data-parallel noise step
    (:func:`~pnnp_tpu_torch.parallel.bind_data_group`), maps this rank's
    moments to the data group's mean, with gradient: the train-mode moments
    are then the global batch's, as flax's under SPMD jit, taken as flax
    takes them (``E[x]`` and ``E[x^2]``, the variance ``E[x^2] - E[x]^2``),
    and the running averages move alike on every rank."""

    data_mean = None

    def __init__(self, num_features: int, momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x, train: bool = False):
        if train and self.data_mean is not None:
            return self._forward_group(x)
        if train:
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
                self._update_running(mean, var)
            return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, self.eps)

    @torch.no_grad()
    def _update_running(self, mean, var):
        m = self.momentum
        self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1 - m) * var)

    def _forward_group(self, x):
        mean, mean2 = self.data_mean(torch.stack([x.mean(dim=(0, 2, 3)),
                                                  (x * x).mean(dim=(0, 2, 3))]))
        var = (mean2 - mean * mean).clamp_min(0.0)
        self._update_running(mean.detach(), var.detach())
        view = lambda t: t.reshape(1, -1, 1, 1)
        return (x - view(mean)) * view(torch.rsqrt(var + self.eps) * self.weight) + view(self.bias)


class ShiftAndLogScale(nn.Module):
    def __init__(self, num_in: int, num_out: int, width: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_out = num_out
        self.conv2d_1 = nn.Conv2d(num_in, width, 3, padding=1)
        self.bn1 = FlaxBatchNorm(width)
        self.conv2d_2 = nn.Conv2d(width, width, 1)
        self.bn2 = FlaxBatchNorm(width)
        self.conv2d_3 = nn.Conv2d(width + 1, num_out, 3, padding=0)
        # flax's shape (1, 1, 1, num_out), kept for checkpoints: NHWC channels last
        self.logs = nn.Parameter(torch.zeros(1, 1, 1, num_out))
        self.scale = nn.Parameter(torch.full((1,), 1e-4))
        with torch.no_grad():
            std = width / 512 * 0.05  # flax normal(stddev) on the first two kernels
            for conv in (self.conv2d_1, self.conv2d_2):
                conv.weight.normal_(0.0, std, generator=generator)
            for conv in (self.conv2d_1, self.conv2d_2, self.conv2d_3):
                nn.init.zeros_(conv.bias)
            nn.init.zeros_(self.conv2d_3.weight)

    def forward(self, x, train: bool = False):
        h = F.relu(self.bn1(self.conv2d_1(x), train))
        h = F.relu(self.bn2(self.conv2d_2(h), train))
        n, _, H, W = h.shape
        ring = torch.ones((H + 2, W + 2), dtype=h.dtype, device=h.device)
        ring[1:-1, 1:-1] = 0.0
        h = torch.cat([F.pad(h, (1, 1, 1, 1)), ring.expand(n, 1, H + 2, W + 2)], dim=1)
        h = self.conv2d_3(h) * torch.exp(self.logs.reshape(1, -1, 1, 1) * 3.0)
        half = self.num_out // 2
        return h[:, :half], self.scale * torch.tanh(h[:, half:])


class AffineCoupling(Bijector):
    """Split the channels in half; affine-transform the second half from
    the first. The conditioner's BatchNorm uses batch statistics in train
    mode (and updates its running averages); ``inverse`` uses the running
    ones."""

    def __init__(self, num_channels: int = 4, width: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = self.num_channels = num_channels
        self.net = ShiftAndLogScale(c // 2, 2 * (c - c // 2), width, generator)

    def forward_ldj(self, x, clean=None, iso=None, train: bool = False):
        c = self.num_channels
        x0, x1 = x[:, :c // 2], x[:, c // 2:]
        shift, log_scale = self.net(x0, train)
        z1 = x1 * torch.exp(log_scale) + shift
        return torch.cat([x0, z1], dim=1), sum_except_batch(log_scale)

    def inverse(self, z, clean=None, iso=None):
        c = self.num_channels
        z0, z1 = z[:, :c // 2], z[:, c // 2:]
        shift, log_scale = self.net(z0, False)
        return torch.cat([z0, (z1 - shift) * torch.exp(-log_scale)], dim=1)
