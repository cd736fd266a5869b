"""UNetSeeInDark, the SID denoiser (Chen et al., "Learning to See in the
Dark", CVPR 2018; the PNNP runfiles' ``arch: UNetSeeInDark``), in plain
PyTorch on a dict of parameters.

Five levels of two 3x3 convolutions with LeakyReLU(0.2), 2x2 max-pool down,
2x2 stride-2 transposed convolution up with the skip concatenated after the
upsampled map, and a 1x1 head. Departures from the published network: the
leaky slope is 0.2 as in the SID code (the paper says LReLU), and full
frames are reflect-padded to a multiple of 16 and cropped back, as the
PNNP evaluation does (it pads 4 per side, which is the same at both camera
frames). Layouts are PyTorch's: NCHW maps, OIHW kernels, ``[I, O, 2, 2]``
transposed kernels.

``quant`` (optional) maps every convolution's input and weight before the
convolution: the lower-precision control uses it to round both to fp8.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

SLOPE = 0.2


def layer_shapes(nf: int = 32, in_nc: int = 4, out_nc: int = 4) -> dict:
    """``name -> (kind, c_in, c_out, k)`` in the network's order; kind
    ``conv`` or ``up`` (the 2x2 stride-2 transposed convolution)."""
    c = [nf * 2**k for k in range(5)]
    shapes = {"conv1_1": ("conv", in_nc, c[0], 3), "conv1_2": ("conv", c[0], c[0], 3)}
    for k in range(1, 5):
        shapes[f"conv{k + 1}_1"] = ("conv", c[k - 1], c[k], 3)
        shapes[f"conv{k + 1}_2"] = ("conv", c[k], c[k], 3)
    for lvl, k in zip(range(6, 10), range(3, -1, -1)):
        shapes[f"upv{lvl}"] = ("up", c[k + 1], c[k], 2)
        shapes[f"conv{lvl}_1"] = ("conv", 2 * c[k], c[k], 3)
        shapes[f"conv{lvl}_2"] = ("conv", c[k], c[k], 3)
    shapes["conv10_1"] = ("conv", c[0], out_nc, 1)
    return shapes


def param_shapes(nf: int = 32, in_nc: int = 4, out_nc: int = 4) -> dict:
    """``"<layer>.weight" / "<layer>.bias" -> shape`` (PyTorch layouts)."""
    out = {}
    for name, (kind, ci, co, k) in layer_shapes(nf, in_nc, out_nc).items():
        out[name + ".weight"] = (ci, co, k, k) if kind == "up" else (co, ci, k, k)
        out[name + ".bias"] = (co,)
    return out


def forward(params: dict, x: torch.Tensor, quant=None) -> torch.Tensor:
    """``x`` [N, 4, H, W] (H, W multiples of 16) -> [N, out_nc, H, W]."""
    q = quant or (lambda t: t)

    def conv(h, name):
        w = params[name + ".weight"]
        return F.conv2d(q(h), q(w), params[name + ".bias"], padding=w.shape[-1] // 2)

    def up(h, name):
        return F.conv_transpose2d(q(h), q(params[name + ".weight"]),
                                  params[name + ".bias"], stride=2)

    act = lambda t: F.leaky_relu(t, SLOPE)
    skips = []
    h = x
    for lvl in range(1, 6):
        if lvl > 1:
            h = F.max_pool2d(h, 2)
        h = act(conv(act(conv(h, f"conv{lvl}_1")), f"conv{lvl}_2"))
        skips.append(h)
    h = skips.pop()
    for lvl in range(6, 10):
        h = torch.cat([up(h, f"upv{lvl}"), skips.pop()], dim=1)
        h = act(conv(act(conv(h, f"conv{lvl}_1")), f"conv{lvl}_2"))
    return conv(h, "conv10_1")


def pad16(n: int) -> tuple:
    """(before, after) reflect padding of a side of ``n`` to a multiple of 16,
    split evenly with the odd pixel after."""
    p = (-n) % 16
    return p // 2, p - p // 2


def forward_frame(params: dict, x: torch.Tensor, quant=None) -> torch.Tensor:
    """Full-frame forward: reflect pad to a multiple of 16, network, crop."""
    H, W = x.shape[-2:]
    (t, b), (l, r) = pad16(H), pad16(W)
    y = forward(params, F.pad(x, (l, r, t, b), mode="reflect"), quant)
    return y[..., t:t + H, l:l + W]
