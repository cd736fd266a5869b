"""UNetSeeInDark as an NCHW ``nn.Module`` (counterpart of
``pnnp_tpu/models/unet.py:37-97``; reference: archs/Unet.py:4-99).

Layer names are the reference's (``conv1_1`` ... ``conv10_1``, ``upv6`` ...
``upv9``), so a reference ``.pth`` ``state_dict`` loads with ``strict=True``
and :func:`pnnp_tpu_torch.models.convert.params_from_jax` maps a JAX
parameter tree onto it by name. Convolutions stay on cuDNN
(``nn.Conv2d`` / ``nn.ConvTranspose2d``), as the JAX package leaves them to
XLA.

``dtype`` is the parameter and compute precision (``torch.bfloat16`` for
serving, ``torch.float32`` for the exact path); the forward always returns
float32, like the flax module's ``out.astype(float32)``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

_INIT_STD = 0.02  # reference weight init N(0, 0.02) (archs/__init__.py:12-19)


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


class UNetSeeInDark(nn.Module):
    """5-level encoder-decoder, 2x(conv3x3+LeakyReLU 0.2) per level, nf=32..512."""

    def __init__(self, in_nc: int = 4, out_nc: int = 4, nf: int = 32,
                 res: bool = False, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
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
        self.reset_parameters(generator)
        self.to(dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """N(0, 0.02) conv weights and biases; ConvTranspose weights N(0, 0.02)
        with zero bias (flax ``ConvTranspose``'s default bias init)."""
        for m in self.modules():
            if isinstance(m, nn.ConvTranspose2d):
                nn.init.normal_(m.weight, 0.0, _INIT_STD, generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.Conv2d):
                nn.init.normal_(m.weight, 0.0, _INIT_STD, generator=generator)
                nn.init.normal_(m.bias, 0.0, _INIT_STD, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` [N, in_nc, H, W] with H, W divisible by 16 -> float32
        [N, out_nc, H, W]."""
        x = x.to(self.dtype)
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
        c9 = dec(c8, c1, self.upv9, self.conv9_1, self.conv9_2)
        out = self.conv10_1(c9)
        if self.res:
            out = out + x
        return out.float()
