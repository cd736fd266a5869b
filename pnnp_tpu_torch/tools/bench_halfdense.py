"""The card's A/B of the half-dense s2d conv against the dense hybrid
(counterpart of ``tools/bench_halfdense.py``).

The packed hybrid forward runs its level-1 convs (conv1_1, conv1_2, conv9_1
with upv9 folded in, conv9_2) as dense-s2d 3x3 convs with 4x the FLOPs of
the full-resolution conv. The half-dense form keeps the rows in exact 2-tap
block form and the columns dense: a [2, 3]-tap conv with 2.67x the FLOPs,
the per-group selection reduced to two row-shifted masked adds
(:func:`halfdense_conv`). On the TPU the JAX tool found it exact but slower
than the dense hybrid (the TPU reading: 23.75 against 21.53 ms on v5e).
This asks the same question of cuDNN on the card.

It prints the half-dense forward's max error against the dense hybrid
(``unet_hybrid_forward_packed``) in bf16, each bf16 form's max error
against the dense hybrid in f32 (TF32 off), then ms/frame of the dense
hybrid, the half-dense form and the ``channels_last`` forward that serves
(``profile_prefix.full_fn``). Weights: the seeded nf=32 UNetSeeInDark;
input: one N(0, 0.1) packed Sony frame ``[1, 16, 712, 1064]`` (``--small``:
32x32). Timing: ``profile_prefix.calls_ms`` (``--iters`` calls between
two CUDA events, the median of ``--repeats``).

Usage (from the repository root; on the card unless ``--cpu``):

    python -m pnnp_tpu_torch.tools.bench_halfdense [--iters 16] [--small] [--cpu]

:func:`main` returns ``{"halfdense_vs_hybrid", "err_vs_f32": {"hybrid",
"halfdense"}, "ms": {"hybrid", "halfdense", "channels_last"}}``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
import torch.nn.functional as F

from pnnp_tpu_torch.models.unet_s2d import (
    _group_max,
    _head,
    _lrelu,
    _mid_levels,
    _up_weight_1x1,
    _with_ones,
    transform_params_hybrid,
    unet_hybrid_forward_packed,
)
from pnnp_tpu_torch.tools.profile_prefix import calls_ms, full_fn, make_input, make_net
from pnnp_tpu_torch.utils.device import card_label, resolve_device

HD_LAYERS = ("conv1_1", "conv1_2", "conv9_2")


def transform_conv3_halfdense(k3):
    """HWIO ``[3, 3, C, D]`` -> ``[2, 3, 4C, 4D]`` (numpy): rows in exact
    2-tap block form (dy = 2*(o+t-1)+a-o), columns dense (dx = 2*p + a - o,
    |dx| <= 1). The JAX tool's function, copied."""
    k3 = np.asarray(k3, np.float32)
    C, D = k3.shape[2], k3.shape[3]
    out = np.zeros((2, 3, 4 * C, 4 * D), np.float32)
    for t_h in (0, 1):
        for p_w in (-1, 0, 1):
            for a_h in (0, 1):
                for a_w in (0, 1):
                    for o_h in (0, 1):
                        for o_w in (0, 1):
                            dy = 2 * (o_h + t_h - 1) + a_h - o_h
                            dx = 2 * p_w + a_w - o_w
                            if abs(dy) <= 1 and abs(dx) <= 1:
                                gi, go = 2 * a_h + a_w, 2 * o_h + o_w
                                out[t_h, p_w + 1,
                                    gi * C:(gi + 1) * C,
                                    go * D:(go + 1) * D] = k3[dy + 1, dx + 1]
    return out


def halfdense_conv(g, kh):
    """3x3 SAME conv in full-resolution semantics over the s2d tensor ``g``
    ``[n, 4C, h, w]`` with a half-dense kernel (OIHW ``[4D, 4C, 2, 3]``): one
    row of zeros above and below, the [2, 3] conv (column padding 1) to
    ``h + 1`` rows, then the output groups with o_h = 0 from rows ``0..h-1``
    and those with o_h = 1 from rows ``1..h``, as two masked adds."""
    h = g.shape[-2]
    d4 = kh.shape[0]
    o = F.conv2d(F.pad(g, (0, 0, 1, 1)), kh, padding=(0, 1))
    m_top = (torch.arange(d4, device=g.device) < d4 // 2).to(o.dtype)[:, None, None]
    return o[:, :, :h] * m_top + o[:, :, 1:h + 1] * (1.0 - m_top)


def halfdense_params(net, dtype) -> dict:
    """The half-dense kernels (OIHW, ``channels_last``) of conv1_1, conv1_2,
    conv9_2, and of conv9_1 with upv9 folded in as in the hybrid transform
    (the ones channel carries upv9's bias): ``k91f`` over ``[c8 | ones]``,
    ``k91s`` over the skip ``c1g``."""
    hwio = lambda name: getattr(net, name).weight.detach().permute(2, 3, 1, 0).cpu().numpy()
    dev = net.conv1_1.weight.device
    oihw = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(3, 2, 0, 1))).to(
        dev, dtype).contiguous(memory_format=torch.channels_last)
    hd = {name: oihw(transform_conv3_halfdense(hwio(name))) for name in HD_LAYERS}
    k91, nf = hwio("conv9_1"), net.conv9_1.out_channels  # [3, 3, 2nf, nf]
    w1 = _up_weight_1x1(net.upv9.weight.detach())[:, :, 0, 0].T.cpu().numpy()  # [2nf, 4nf]
    w1e = np.concatenate([w1, np.tile(net.upv9.bias.detach().cpu().numpy(), 4)[None]])
    hd_up = transform_conv3_halfdense(k91[:, :, :nf])
    hd["k91f"] = oihw(np.einsum("cd,tpde->tpce", w1e, hd_up))
    hd["k91s"] = oihw(transform_conv3_halfdense(k91[:, :, nf:]))
    return hd


def forward_halfdense(tp: dict, hd: dict, g1, dtype=torch.bfloat16):
    """The hybrid forward with its level-1 convs in half-dense form: conv1_1,
    conv1_2, the folded conv9_1 and conv9_2; ``_mid_levels`` (levels 2-8)
    and the head as the dense hybrid runs them."""
    b = lambda name: tp[name]["bias"][:, None, None]
    conv = lambda t, k, name: _lrelu(halfdense_conv(t, k) + b(name))
    c1g = conv(conv(g1.to(dtype), hd["conv1_1"], "conv1_1"), hd["conv1_2"], "conv1_2")
    c8 = _mid_levels(tp, _group_max(c1g))
    h9 = _lrelu(halfdense_conv(_with_ones(c8), hd["k91f"]) + halfdense_conv(c1g, hd["k91s"])
                + b("conv9_1"))
    c9g = conv(h9, hd["conv9_2"], "conv9_2")
    return _head(c9g, tp["conv10_1"]["kernel"], tp["conv10_1"]["bias"])


@torch.no_grad()
def main(argv=None, device=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--small", action="store_true", help="32x32 packed frame (wiring)")
    ap.add_argument("--cpu", action="store_true")
    a = ap.parse_args(argv)

    dev = torch.device("cpu") if a.cpu else resolve_device(device)
    print(f"devices: {dev} ({card_label(dev)})", file=sys.stderr)
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False  # the f32 reference is f32
        torch.backends.cuda.matmul.allow_tf32 = False
    net = make_net(dev)
    g1 = make_input("packed", dev, a.small)
    tp16, tp32 = (transform_params_hybrid(net, dt) for dt in (torch.bfloat16, torch.float32))
    hd16 = halfdense_params(net, torch.bfloat16)
    ref32 = unet_hybrid_forward_packed(tp32, g1, dtype=torch.float32)
    dense = unet_hybrid_forward_packed(tp16, g1).float()
    half = forward_halfdense(tp16, hd16, g1).float()
    err = float((half - dense).abs().max())
    err32 = {"hybrid": float((dense - ref32).abs().max()),
             "halfdense": float((half - ref32).abs().max())}
    print(f"halfdense vs hybrid max err: {err:.3e}; against the f32 hybrid: "
          f"hybrid {err32['hybrid']:.3e}, half-dense {err32['halfdense']:.3e}", flush=True)
    mpix = g1.numel() / 1e6
    x = make_input("channels_last", dev, a.small)
    serving = full_fn("channels_last", net)
    time = lambda call: calls_ms(call, a.iters, a.repeats, dev)
    ms = {"hybrid": time(lambda: unet_hybrid_forward_packed(tp16, g1)),
          "halfdense": time(lambda: forward_halfdense(tp16, hd16, g1)),
          "channels_last": time(lambda: serving(x))}
    for name, label in (("hybrid", "hybrid (dense L1/L9):"), ("halfdense", "half-dense L1/L9:"),
                        ("channels_last", "channels_last UNet:")):
        print(f"{label:22s} {ms[name]:6.2f} ms ({mpix / (ms[name] / 1e3):5.1f} Mpix/s)",
              flush=True)
    return {"halfdense_vs_hybrid": err, "err_vs_f32": err32, "ms": ms}


if __name__ == "__main__":
    main()
