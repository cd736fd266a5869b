"""Reusable blocks beyond the UNet family (counterpart of
``pnnp_tpu/models/blocks.py``; reference: archs/modules.py): BN
convolutions, CBAM channel and spatial attention, pixel shuffle and
unshuffle, the pixel-shuffle upsampler, the padded concat and residual
stacks, as NCHW modules. torch needs the input width that flax infers, so
each module takes ``in_ch`` first; the initializers are flax's (N(0, 0.02)
kernels, zero biases)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pnnp_tpu_torch.models.flows.coupling import FlaxBatchNorm
from pnnp_tpu_torch.models.unet import ResidualBlock, SameConv2d, _lrelu, init_conv_params


def _flax_init(module: nn.Module) -> nn.Module:
    """flax ``kernel_init=normal(0.02)`` with the default zero bias."""
    init_conv_params(module)
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)) and m.bias is not None:
            nn.init.zeros_(m.bias)
    return module


class ConvWithBN(nn.Module):
    """conv (SAME, no bias) (+ flax BatchNorm) (+ ReLU) (reference:
    modules.py:141-154)."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3, stride: int = 1,
                 use_bn: bool = True, activate: bool = True):
        super().__init__()
        self.activate = activate
        self.conv = SameConv2d(in_ch, features, kernel, stride=stride, bias=False)
        self.bn = FlaxBatchNorm(features) if use_bn else None
        _flax_init(self)

    def forward(self, x, train: bool = False):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x, train)
        return F.relu(x) if self.activate else x


class DoubleConvBlock(nn.Module):
    """Two bias-free conv3x3 + ReLU (reference: modules.py:156-166)."""

    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.conv_a = ConvWithBN(in_ch, features, use_bn=False)
        self.conv_b = ConvWithBN(features, features, use_bn=False)

    def forward(self, x, train: bool = False):
        return self.conv_b(self.conv_a(x, train), train)


class ChannelAttention(nn.Module):
    """CBAM channel attention: a shared bias-free MLP over the average- and
    max-pooled descriptors (reference: modules.py:199-219)."""

    def __init__(self, channels: int, ratio: int = 16):
        super().__init__()
        hidden = max(channels // ratio, 1)
        self.fc1 = nn.Linear(channels, hidden, bias=False)
        self.fc2 = nn.Linear(hidden, channels, bias=False)
        _flax_init(self)

    def forward(self, x):
        mlp = lambda t: self.fc2(F.relu(self.fc1(t)))
        scale = torch.sigmoid(mlp(x.mean(dim=(2, 3))) + mlp(x.amax(dim=(2, 3))))
        return x * scale[:, :, None, None]


class SpatialAttention(nn.Module):
    """CBAM spatial attention: a bias-free 7x7 convolution over the
    channel-mean and channel-max maps (reference: modules.py:221-243)."""

    def __init__(self, kernel: int = 7):
        super().__init__()
        self.conv = SameConv2d(2, 1, kernel, bias=False)
        _flax_init(self)

    def forward(self, x):
        att = self.conv(torch.cat([x.mean(dim=1, keepdim=True),
                                   x.amax(dim=1, keepdim=True)], dim=1))
        return x * torch.sigmoid(att)


class CBAM(nn.Module):
    """Channel then spatial attention."""

    def __init__(self, channels: int, ratio: int = 16):
        super().__init__()
        self.channel = ChannelAttention(channels, ratio)
        self.spatial = SpatialAttention()

    def forward(self, x):
        return self.spatial(self.channel(x))


def pixel_shuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Depth-to-space ``[N, C*r^2, H, W]`` -> ``[N, C, rH, rW]`` in torch's
    channel order (``c*r^2 + i*r + j`` lands at offset ``(i, j)``), the
    order the JAX module keeps."""
    return F.pixel_shuffle(x, factor)


def pixel_unshuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Space-to-depth ``[N, C, rH, rW]`` -> ``[N, C*r^2, H, W]``, torch's
    channel order (reference: modules.py:277-304)."""
    return F.pixel_unshuffle(x, factor)


class UpsampleBlock(nn.Module):
    """conv3x3 -> pixel shuffle x2 -> LeakyReLU 0.2 (reference:
    modules.py:257-266)."""

    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, features * 4, 3, padding=1)
        _flax_init(self)

    def forward(self, x):
        return _lrelu(pixel_shuffle(self.conv(x), 2))


def concat_pad(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Channel concat of two NCHW maps, the smaller zero-padded (centred) to
    the larger's height and width (reference: modules.py:306-326)."""
    dh, dw = b.shape[2] - a.shape[2], b.shape[3] - a.shape[3]

    def pad(t, h, w):
        h, w = max(h, 0), max(w, 0)
        return F.pad(t, (w // 2, w - w // 2, h // 2, h - h // 2))

    return torch.cat([pad(a, dh, dw), pad(b, -dh, -dw)], dim=1)


class ResBlockStack(nn.Module):
    """``n_layers`` chained :class:`ResidualBlock` s named ``block{i}``
    (reference: modules.py:168-174)."""

    def __init__(self, in_ch: int, features: int, n_layers: int = 2):
        super().__init__()
        for i in range(n_layers):
            self.add_module(f"block{i}", ResidualBlock(in_ch if i == 0 else features,
                                                       features))
        init_conv_params(self)

    def forward(self, x):
        for block in self.children():
            x = block(x)
        return x
