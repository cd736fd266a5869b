"""Composed-prefix cost profile of the bf16 UNet forward (counterpart of
``tools/profile_prefix.py``).

Times successively longer PREFIXES of the forward; the difference between
consecutive prefixes is the marginal cost of the band it adds inside the
real composed program. The bands are the JAX tool's seven (``NAMES``):
head, c2, c3, c4+c5, c6+c7, c8, tail. The last line times the whole
forward in one piece, as the anchor the full prefix is held to.

``--form`` picks the forward:

* ``channels_last`` (the default): the form that serves on the card,
  ``UNetSeeInDark`` (``models/unet.py``) on f32 master params in
  ``channels_last`` memory under ``torch.autocast`` in bf16, as the trainer
  and the fused eval step run it, cut into the bands of its
  ``_decoder_levels``: the head is conv1_1, conv1_2 and the level-1 2x2
  max-pool (JAX's ``gmax``), the tail upv9, conv9_* and conv10_1;
* ``packed``: the JAX tools' own subject, the port's
  ``unet_hybrid_forward_packed`` on ``transform_params_hybrid`` weights.

Weights are the nf=32 UNetSeeInDark at its seeded init (seed 0); the input
is one N(0, 0.1) Sony frame, ``[1, 4, 1424, 2128]`` or packed ``[1, 16, 712,
1064]`` (``--small``: a 64x64 mosaic). Timing: ``--iters`` calls issued
back to back between two CUDA events, each output summed into one
accumulator read back once, the median of ``--repeats``
(``bench_int8.median_ms``; the host clock with ``--cpu``).

Usage (from the repository root; on the card unless ``--cpu``):

    python -m pnnp_tpu_torch.tools.profile_prefix [--form channels_last|packed] [--iters 16] [--small] [--cpu]

Prints one line per prefix and the anchor last; :func:`main` returns
``{"form", "rows": [(name, ms)], "anchor_ms"}``.
"""

from __future__ import annotations

import argparse
import sys

import torch
import torch.nn.functional as F

from pnnp_tpu_torch.models import UNetSeeInDark
from pnnp_tpu_torch.models.unet_s2d import (
    _conv_same,
    _dec_conv,
    _group_max,
    _lrelu,
    _pool,
    _tail,
    _upconv,
    transform_params_hybrid,
    unet_hybrid_forward_packed,
)
from pnnp_tpu_torch.tools.bench_int8 import median_ms
from pnnp_tpu_torch.utils.device import card_label, resolve_device

NAMES = (
    "head (c1_1+c1_2+gmax)",
    "+ c2 (conv2_1/2_2)",
    "+ c3 (pool+conv3_1/3_2)",
    "+ c4+c5 (bottleneck)",
    "+ c6+c7 (up deep)",
    "+ c8 (upv8+conv8_1/8_2)",
    "+ tail (upv9+c9+head)",
)
FORMS = ("channels_last", "packed")
# the Sony 2848x4256 mosaic: packed RGBG [1, 4, 1424, 2128], s2d [1, 16, 712, 1064]
FRAME = {"channels_last": (1, 4, 1424, 2128), "packed": (1, 16, 712, 1064)}
SMALL_FRAME = {"channels_last": (1, 4, 64, 64), "packed": (1, 16, 32, 32)}
MODEL_SEED, INPUT_SEED = 0, 1


def make_net(dev):
    """The seeded nf=32 UNetSeeInDark, f32 master params, on ``dev`` in
    ``channels_last`` memory (the bf16 steps' ``BF16_MEMORY_FORMAT``)."""
    net = UNetSeeInDark(nf=32, generator=torch.Generator().manual_seed(MODEL_SEED))
    return net.to(dev, memory_format=torch.channels_last)


def subject(form: str, net, dtype=None):
    """The forward's parameters: the module itself (``channels_last``), or
    its ``transform_params_hybrid`` fold in ``dtype`` (``packed``)."""
    if form == "channels_last":
        return net
    with torch.no_grad():
        return transform_params_hybrid(net, dtype or torch.bfloat16)


def make_input(form: str, dev, small: bool = False):
    """One N(0, 0.1) frame of ``form``'s layout, in ``channels_last`` memory."""
    shape = (SMALL_FRAME if small else FRAME)[form]
    g = torch.Generator(device=dev).manual_seed(INPUT_SEED)
    x = torch.randn(shape, generator=g, device=dev) * 0.1
    return x.contiguous(memory_format=torch.channels_last)


def autocast(x, dtype):
    """bf16 autocast on ``x``'s device for a bf16 ``dtype``, else off. A
    forward casts each weight once, so the cast cache would save nothing;
    off, a CUDA graph can capture the forward."""
    return torch.autocast(x.device.type, dtype=torch.bfloat16,
                          enabled=dtype == torch.bfloat16, cache_enabled=False)


def _cl_prefix(net, x, n):
    """``UNetSeeInDark._decoder_levels`` through band ``n`` (6: the forward)."""
    conv = lambda t, m: _lrelu(m(t))

    def dec(h, skip, upv, ca, cb):
        return conv(conv(torch.cat([upv(h), skip], dim=1), ca), cb)

    c1 = conv(conv(x, net.conv1_1), net.conv1_2)
    p1 = F.max_pool2d(c1, 2)
    if n == 0:
        return p1
    c2 = conv(conv(p1, net.conv2_1), net.conv2_2)
    if n == 1:
        return c2
    c3 = conv(conv(F.max_pool2d(c2, 2), net.conv3_1), net.conv3_2)
    if n == 2:
        return c3
    c4 = conv(conv(F.max_pool2d(c3, 2), net.conv4_1), net.conv4_2)
    c5 = conv(conv(F.max_pool2d(c4, 2), net.conv5_1), net.conv5_2)
    if n == 3:
        return c5
    c6 = dec(c5, c4, net.upv6, net.conv6_1, net.conv6_2)
    c7 = dec(c6, c3, net.upv7, net.conv7_1, net.conv7_2)
    if n == 4:
        return c7
    c8 = dec(c7, c2, net.upv8, net.conv8_1, net.conv8_2)
    if n == 5:
        return c8
    out = net.conv10_1(dec(c8, c1, net.upv9, net.conv9_1, net.conv9_2))
    return out + x if net.res else out


def _packed_prefix(tp, g1, n, dtype):
    """``unet_hybrid_forward_packed`` through band ``n`` (6: the forward)."""
    k = lambda name: tp[name]["kernel"]
    b = lambda name: tp[name]["bias"]
    conv = lambda t, name: _lrelu(_conv_same(t, k(name), b(name)))

    def dec(h, skip, level):
        u = _upconv(h, k(f"upv{level}"), b(f"upv{level}"))
        return conv(_dec_conv(tp, u, skip, f"conv{level}_1"), f"conv{level}_2")

    c1g = conv(conv(g1.to(dtype), "conv1_1"), "conv1_2")
    p1 = _group_max(c1g)
    if n == 0:
        return p1
    c2 = conv(conv(p1, "conv2_1"), "conv2_2")
    if n == 1:
        return c2
    c3 = conv(conv(_pool(c2), "conv3_1"), "conv3_2")
    if n == 2:
        return c3
    c4 = conv(conv(_pool(c3), "conv4_1"), "conv4_2")
    c5 = conv(conv(_pool(c4), "conv5_1"), "conv5_2")
    if n == 3:
        return c5
    c7 = dec(dec(c5, c4, 6), c3, 7)
    if n == 4:
        return c7
    c8 = dec(c7, c2, 8)
    if n == 5:
        return c8
    return _tail(tp, c8, c1g)


def prefix_fn(form: str, params, n: int, dtype=None):
    """The forward of ``form`` through band ``n`` as a function of its input
    (``params`` from :func:`subject`); ``dtype`` bf16 (default) or f32."""
    dtype = dtype or torch.bfloat16
    if form == "channels_last":
        def fn(x):
            with autocast(x, dtype):
                return _cl_prefix(params, x, n)
        return fn
    return lambda g1: _packed_prefix(params, g1, n, dtype)


def full_fn(form: str, params, dtype=None):
    """The production forward of ``form``: the module's ``forward`` under
    autocast, or ``unet_hybrid_forward_packed``."""
    dtype = dtype or torch.bfloat16
    if form == "channels_last":
        def fn(x):
            with autocast(x, dtype):
                return params(x)
        return fn
    return lambda g1: unet_hybrid_forward_packed(params, g1, dtype=dtype)


def calls_ms(call, iters: int, repeats: int, dev) -> float:
    """Median ms per call of ``call()``: ``iters`` calls issued back to back
    between two CUDA events, each output cast to f32 and summed into one
    accumulator read back once; the median of ``repeats`` such runs after a
    warm-up run (``bench_int8.median_ms``; the host clock on the CPU)."""
    def run():
        acc = torch.zeros((), device=dev)
        for _ in range(iters):
            acc = acc + call().float().sum()
        return acc

    return median_ms(run, iters, repeats, dev)


def parse(argv, iters: int, doc: str):
    """The forward tools' common flags."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--form", choices=FORMS, default="channels_last")
    ap.add_argument("--iters", type=int, default=iters)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--small", action="store_true", help="64x64 mosaic (wiring)")
    ap.add_argument("--cpu", action="store_true")
    return ap.parse_args(argv)


def setup(a, device=None):
    """(device, the form's params in bf16 from the seeded net, the input
    frame)."""
    dev = torch.device("cpu") if a.cpu else resolve_device(device)
    print(f"devices: {dev} ({card_label(dev)}); form {a.form}", file=sys.stderr)
    return dev, subject(a.form, make_net(dev)), make_input(a.form, dev, a.small)


@torch.no_grad()
def main(argv=None, device=None):
    a = parse(argv, 16, __doc__)
    dev, params, x = setup(a, device)
    time = lambda fn: calls_ms(lambda: fn(x), a.iters, a.repeats, dev)
    rows, prev = [], 0.0
    for n, name in enumerate(NAMES):
        ms = time(prefix_fn(a.form, params, n))
        print(f"prefix {n} {name:26s}: {ms:6.2f} ms  (marginal {ms - prev:+6.2f} ms)",
              flush=True)
        rows.append((name, ms))
        prev = ms
    anchor = time(full_fn(a.form, params))
    print(f"full forward (anchor) {a.form}: {anchor:6.2f} ms", flush=True)
    return {"form": a.form, "rows": rows, "anchor_ms": anchor}


if __name__ == "__main__":
    main()
