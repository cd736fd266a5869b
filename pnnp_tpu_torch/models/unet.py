"""The UNet denoiser family as NCHW ``nn.Module``s (counterpart of
``pnnp_tpu/models/unet.py``): ``UNetSeeInDark`` :37 (reference:
archs/Unet.py:4-99), ``DeepUNet`` :100 (archs/Unet.py:102-211),
``ResidualBlock`` :170, ``ResUNet`` :197 and ``DeepResUNet`` :245
(archs/ResUnet.py).

Layer names are the reference's (``conv1_1`` ... ``conv10_1``, ``upv6`` ...
``upv9``, ``out2``/``out4``/``out8``, ``conv_in``, ``pool1`` ...), so a
reference ``.pth`` ``state_dict`` loads with ``strict=True`` and
:func:`pnnp_tpu_torch.models.convert.params_from_jax` maps a JAX parameter
tree onto each by name. Convolutions stay on cuDNN (``nn.Conv2d`` /
``nn.ConvTranspose2d``), as the JAX package leaves them to XLA.

``dtype`` is the parameter and compute precision (``torch.bfloat16`` for
serving, ``torch.float32`` for the exact path); the forward always returns
float32, like the flax module's ``out.astype(float32)``. The deep-supervised
archs return ``(out, out2, out4, out8)`` from ``forward(x, train=True)``.

flax's ``padding="SAME"`` is symmetric for the stride-1 convolutions, as
torch's ``padding=k//2``; for ResUNet's stride-2 downsampling convolutions
it is not: on an even input XLA pads ``(0, 1)`` (total 1, low 0), so those
convolutions pad explicitly (:func:`same_pad`) and convolve with no padding
of their own.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

_INIT_STD = 0.02  # reference weight init N(0, 0.02) (archs/__init__.py:12-19)


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


def same_pad(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """Zero-pad an NCHW ``x`` as XLA's ``padding="SAME"`` pads for a
    ``k x k`` window at ``stride``: ``ceil(n / stride)`` outputs, the total
    pad ``max((out - 1) * stride + k - n, 0)`` split low ``total // 2``,
    high the rest."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):  # F.pad order: W, then H
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class SameConv2d(nn.Conv2d):
    """``nn.Conv2d`` with flax's ``padding="SAME"`` at any stride."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int = 1, bias: bool = True):
        super().__init__(in_ch, out_ch, k, stride=stride, bias=bias)

    def forward(self, x):
        return super().forward(same_pad(x, self.kernel_size[0], self.stride[0]))


@torch.no_grad()
def init_conv_params(module: nn.Module, generator: Optional[torch.Generator] = None):
    """The family's init (reference archs/__init__.py:12-19, as the flax
    modules'): N(0, 0.02) convolution and dense weights and convolution
    biases; ConvTranspose biases zero (flax ``ConvTranspose``'s default)."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            nn.init.normal_(m.weight, 0.0, _INIT_STD, generator=generator)
            if m.bias is not None:
                if isinstance(m, nn.ConvTranspose2d):
                    nn.init.zeros_(m.bias)
                else:
                    nn.init.normal_(m.bias, 0.0, _INIT_STD, generator=generator)


class UNetSeeInDark(nn.Module):
    """5-level encoder-decoder, 2x(conv3x3+LeakyReLU 0.2) per level, nf=32..512."""

    def __init__(self, in_nc: int = 4, out_nc: int = 4, nf: int = 32,
                 res: bool = False, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._build(in_nc, out_nc, nf, res, dtype)
        self.reset_parameters(generator)
        self.to(dtype)

    def _build(self, in_nc, out_nc, nf, res, dtype):
        self.in_nc, self.out_nc, self.nf, self.res = in_nc, out_nc, nf, res
        self.dtype = dtype
        conv = lambda i, o, k=3: nn.Conv2d(i, o, k, padding=k // 2)
        up = lambda i, o: nn.ConvTranspose2d(i, o, 2, stride=2)
        self.conv1_1, self.conv1_2 = conv(in_nc, nf), conv(nf, nf)
        self.conv2_1, self.conv2_2 = conv(nf, nf * 2), conv(nf * 2, nf * 2)
        self.conv3_1, self.conv3_2 = conv(nf * 2, nf * 4), conv(nf * 4, nf * 4)
        self.conv4_1, self.conv4_2 = conv(nf * 4, nf * 8), conv(nf * 8, nf * 8)
        self.conv5_1, self.conv5_2 = conv(nf * 8, nf * 16), conv(nf * 16, nf * 16)
        self.upv6 = up(nf * 16, nf * 8)
        self.conv6_1, self.conv6_2 = conv(nf * 16, nf * 8), conv(nf * 8, nf * 8)
        self.upv7 = up(nf * 8, nf * 4)
        self.conv7_1, self.conv7_2 = conv(nf * 8, nf * 4), conv(nf * 4, nf * 4)
        self.upv8 = up(nf * 4, nf * 2)
        self.conv8_1, self.conv8_2 = conv(nf * 4, nf * 2), conv(nf * 2, nf * 2)
        self.upv9 = up(nf * 2, nf)
        self.conv9_1, self.conv9_2 = conv(nf * 2, nf), conv(nf, nf)
        self.conv10_1 = conv(nf, out_nc, 1)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """N(0, 0.02) conv weights and biases; ConvTranspose weights N(0, 0.02)
        with zero bias (flax ``ConvTranspose``'s default bias init)."""
        init_conv_params(self, generator)

    def _decoder_levels(self, x):
        c1 = _lrelu(self.conv1_2(_lrelu(self.conv1_1(x))))
        c2 = _lrelu(self.conv2_2(_lrelu(self.conv2_1(F.max_pool2d(c1, 2)))))
        c3 = _lrelu(self.conv3_2(_lrelu(self.conv3_1(F.max_pool2d(c2, 2)))))
        c4 = _lrelu(self.conv4_2(_lrelu(self.conv4_1(F.max_pool2d(c3, 2)))))
        c5 = _lrelu(self.conv5_2(_lrelu(self.conv5_1(F.max_pool2d(c4, 2)))))

        def dec(h, skip, upv, ca, cb):
            h = torch.cat([upv(h), skip], dim=1)
            return _lrelu(cb(_lrelu(ca(h))))

        c6 = dec(c5, c4, self.upv6, self.conv6_1, self.conv6_2)
        c7 = dec(c6, c3, self.upv7, self.conv7_1, self.conv7_2)
        c8 = dec(c7, c2, self.upv8, self.conv8_1, self.conv8_2)
        return c6, c7, c8, dec(c8, c1, self.upv9, self.conv9_1, self.conv9_2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` [N, in_nc, H, W] with H, W divisible by 16 -> float32
        [N, out_nc, H, W]."""
        x = x.to(self.dtype)
        out = self.conv10_1(self._decoder_levels(x)[-1])
        if self.res:
            out = out + x
        return out.float()


def _avg2(x):
    return F.avg_pool2d(x, 2)


def _heads(module, out, x, c6, c7, c8, train):
    """The deep-supervision tail shared by DeepUNet and DeepResUNet: in
    train mode ``(out, out2, out4, out8)`` from the 1x1 heads on the
    decoder levels (with ``res``, each plus the input pooled to its scale);
    else ``out`` (plus ``x`` with ``res``). float32."""
    if train:
        outs = [out, module.out2(c8), module.out4(c7), module.out8(c6)]
        if module.res:
            xs = [x]
            for _ in range(3):
                xs.append(_avg2(xs[-1]))
            outs = [o + xi for o, xi in zip(outs, xs)]
        return tuple(o.float() for o in outs)
    if module.res:
        out = out + x
    return out.float()


class DeepUNet(UNetSeeInDark):
    """UNetSeeInDark with the deep-supervision heads ``out2``/``out4``/
    ``out8`` (1x1 convolutions on ``conv8``/``conv7``/``conv6``) in train
    mode (reference archs/Unet.py:102-211; the reference never defines the
    activation, the family's LeakyReLU(0.2) is used, as in JAX)."""

    def __init__(self, in_nc: int = 4, out_nc: int = 4, nf: int = 32,
                 res: bool = False, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        nn.Module.__init__(self)
        self._build(in_nc, out_nc, nf, res, dtype)
        self.out8 = nn.Conv2d(nf * 8, out_nc, 1)
        self.out4 = nn.Conv2d(nf * 4, out_nc, 1)
        self.out2 = nn.Conv2d(nf * 2, out_nc, 1)
        init_conv_params(self, generator)
        self.to(dtype)

    def forward(self, x: torch.Tensor, train: bool = False):
        x = x.to(self.dtype)
        c6, c7, c8, c9 = self._decoder_levels(x)
        return _heads(self, self.conv10_1(c9), x, c6, c7, c8, train)


class ResidualBlock(nn.Module):
    """conv3x3 -> ReLU -> conv3x3 (-> LeakyReLU 0.2 with ``activate``) plus
    the input, through a 1x1 projection ``short_cut`` when the widths
    differ; no biases (reference archs/modules.py:176-197 with
    ``is_activate=False``, as ResUnet uses it)."""

    def __init__(self, in_ch: int, features: int, activate: bool = False):
        super().__init__()
        self.activate = activate
        self.conv1 = nn.Conv2d(in_ch, features, 3, padding=1, bias=False)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1, bias=False)
        self.short_cut = (nn.Conv2d(in_ch, features, 1, bias=False)
                          if in_ch != features else None)

    def forward(self, x):
        y = self.conv2(F.relu(self.conv1(x)))
        if self.activate:
            y = _lrelu(y)
        return y + (self.short_cut(x) if self.short_cut is not None else x)


class ResUNet(nn.Module):
    """Residual-block UNet with stride-2 convolutional downsampling
    (reference archs/ResUnet.py:3-88): ``conv_in``, the residual blocks
    ``conv1`` ... ``conv9``, the 3x3 stride-2 ``pool1`` ... ``pool4`` (XLA's
    SAME padding, :class:`SameConv2d`), ``upv6`` ... ``upv9`` and the 1x1
    ``conv10``."""

    def __init__(self, in_nc: int = 4, out_nc: int = 4, nf: int = 32,
                 res: bool = False, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._build(in_nc, out_nc, nf, res, dtype)
        init_conv_params(self, generator)
        self.to(dtype)

    def _build(self, in_nc, out_nc, nf, res, dtype):
        self.in_nc, self.out_nc, self.nf, self.res = in_nc, out_nc, nf, res
        self.dtype = dtype
        self.conv_in = nn.Conv2d(in_nc, nf, 3, padding=1)
        self.conv1 = ResidualBlock(nf, nf)
        widths = [nf, nf * 2, nf * 4, nf * 8, nf * 16]
        for lvl in range(1, 5):
            setattr(self, f"pool{lvl}", SameConv2d(widths[lvl - 1], widths[lvl], 3, stride=2))
            setattr(self, f"conv{lvl + 1}", ResidualBlock(widths[lvl], widths[lvl]))
        for lvl, (w_in, w_out) in zip(range(6, 10), zip(widths[:0:-1], widths[-2::-1])):
            setattr(self, f"upv{lvl}", nn.ConvTranspose2d(w_in, w_out, 2, stride=2))
            setattr(self, f"conv{lvl}", ResidualBlock(w_out * 2, w_out))
        self.conv10 = nn.Conv2d(nf, out_nc, 1)

    def _decoder_levels(self, x):
        c = [self.conv1(F.relu(self.conv_in(x)))]
        for lvl in range(1, 5):
            pool = getattr(self, f"pool{lvl}")
            c.append(getattr(self, f"conv{lvl + 1}")(F.relu(pool(c[-1]))))
        h, levels = c[4], []
        for lvl, skip in zip(range(6, 10), c[3::-1]):
            h = torch.cat([getattr(self, f"upv{lvl}")(h), skip], dim=1)
            h = getattr(self, f"conv{lvl}")(h)
            levels.append(h)
        return levels  # conv6, conv7, conv8, conv9

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` [N, in_nc, H, W] with H, W divisible by 16 -> float32
        [N, out_nc, H, W]."""
        x = x.to(self.dtype)
        out = self.conv10(self._decoder_levels(x)[-1])
        if self.res:
            out = out + x
        return out.float()


class DeepResUNet(ResUNet):
    """ResUNet with the deep-supervision heads ``out2``/``out4``/``out8``
    in train mode (reference archs/ResUnet.py:90-192)."""

    def __init__(self, in_nc: int = 4, out_nc: int = 4, nf: int = 32,
                 res: bool = False, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        nn.Module.__init__(self)
        self._build(in_nc, out_nc, nf, res, dtype)
        self.out8 = nn.Conv2d(nf * 8, out_nc, 1)
        self.out4 = nn.Conv2d(nf * 4, out_nc, 1)
        self.out2 = nn.Conv2d(nf * 2, out_nc, 1)
        init_conv_params(self, generator)
        self.to(dtype)

    def forward(self, x: torch.Tensor, train: bool = False):
        x = x.to(self.dtype)
        c6, c7, c8, c9 = self._decoder_levels(x)
        return _heads(self, self.conv10(c9), x, c6, c7, c8, train)
