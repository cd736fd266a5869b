"""Marginal per-layer cost of the bf16 UNet forward, by ablation
(counterpart of ``tools/profile_ablate.py``).

The marginal cost of a layer group is time(full) - time(full with the
group replaced by a shape-preserving no-op). The groups (``GROUPS``) are
the JAX tool's: upv6, upv7, upv8, conv9_1, head, gmax, pools and the two
combined groups.

* ``--form packed``: :func:`forward` is the JAX tool's ``forward``
  (``tools/profile_ablate.py:28-114``) no-op for no-op, over
  ``transform_params_hybrid`` weights: a skipped conv adds its bias to its
  input (channels tiled or cut to its width), a skipped transpose
  zero-pads its input's first channels to twice the size, a skipped pool
  takes every second pixel, ``gmax`` keeps the first group, ``conv9_1``
  (upv9 folded in) duplicates c8's channels, ``head`` keeps c9's first 16.
* ``--form channels_last`` (the default): :func:`forward_channels_last`
  applies the same groups to the unpacked ``UNetSeeInDark`` under bf16
  autocast. ``gmax`` exists only in the packed form (``GROUPS`` drops it
  there); ``pools`` skips all four max-pools, the level-1 one included;
  ``conv9_1`` skips upv9 and conv9_1, which the packed form folds into one.

Timing (``profile_prefix.calls_ms``): ``--iters`` calls between two CUDA
events, each output summed into one accumulator read back once, the
median of ``--repeats``.

Usage (from the repository root; on the card unless ``--cpu``):

    python -m pnnp_tpu_torch.tools.profile_ablate [--form channels_last|packed] [--iters 24] [--small] [--cpu]

:func:`main` returns ``{"form", "base_ms", "rows": [{"group", "ms",
"marginal_ms"}]}``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pnnp_tpu_torch.models.unet_s2d import (
    _conv9_1,
    _conv_same,
    _dec_conv,
    _group_max,
    _head,
    _lrelu,
    _pool,
    _upconv,
)
from pnnp_tpu_torch.tools.profile_prefix import autocast, calls_ms, parse, setup

_PACKED_GROUPS = (
    ("upv6",), ("upv7",), ("upv8",), ("conv9_1",),
    ("head",), ("gmax",), ("pools",),
    ("upv6", "upv7", "upv8"),
    ("head", "gmax", "conv9_1", "pools"),
)
GROUPS = {
    "packed": _PACKED_GROUPS,
    "channels_last": tuple(tuple(n for n in g if n != "gmax")
                           for g in _PACKED_GROUPS if g != ("gmax",)),
}


def _bias_act(t, b):
    return _lrelu(t + b[:, None, None])


def _noop_conv(t, co, b):
    """A skipped conv: its input's channels tiled or cut to ``co``, plus the
    bias, through the activation."""
    ci = t.shape[1]
    if co != ci:
        t = torch.cat([t] * -(-co // ci), dim=1)[:, :co]
    return _bias_act(t, b)


def _noop_up(t, co):
    """A skipped 2x2 stride-2 transpose: the first ``co`` channels,
    zero-padded to twice the height and width."""
    h, w = t.shape[-2:]
    return F.pad(t[:, :co], (0, w, 0, h))


def forward(tparams: dict, g1, skip=(), dtype=torch.bfloat16):
    """``unet_hybrid_forward_packed`` with the named layers ablated to
    no-ops (the JAX tool's ``forward``)."""
    k = lambda name: tparams[name]["kernel"]
    b = lambda name: tparams[name]["bias"]

    def conv(t, name):
        if name in skip:
            return _noop_conv(t, k(name).shape[0], b(name))
        return _lrelu(_conv_same(t, k(name), b(name)))

    def up(t, name):
        if name in skip:
            return _noop_up(t, k(name).shape[1])  # ConvTranspose [I, O, 2, 2]
        return _upconv(t, k(name), b(name))

    def pool(t):
        return t[:, :, ::2, ::2] if "pools" in skip else _pool(t)

    def dec_conv(up_t, skip_t, name):
        if name in skip:
            return _bias_act(up_t[:, :k(name).shape[0]], b(name))
        return _dec_conv(tparams, up_t, skip_t, name)

    c1g = conv(conv(g1.to(dtype), "conv1_1"), "conv1_2")
    p1 = c1g[:, :c1g.shape[1] // 4] if "gmax" in skip else _group_max(c1g)
    c2 = conv(conv(p1, "conv2_1"), "conv2_2")
    c3 = conv(conv(pool(c2), "conv3_1"), "conv3_2")
    c4 = conv(conv(pool(c3), "conv4_1"), "conv4_2")
    c5 = conv(conv(pool(c4), "conv5_1"), "conv5_2")
    c6 = conv(dec_conv(up(c5, "upv6"), c4, "conv6_1"), "conv6_2")
    c7 = conv(dec_conv(up(c6, "upv7"), c3, "conv7_1"), "conv7_2")
    c8 = conv(dec_conv(up(c7, "upv8"), c2, "conv8_1"), "conv8_2")
    if "conv9_1" in skip:
        h9 = _bias_act(torch.cat([c8, c8], dim=1), b("conv9_1"))
    else:
        h9 = _conv9_1(tparams, c8, c1g)  # the production form: upv9 folded in
    c9g = conv(h9, "conv9_2")
    if "head" in skip:
        return c9g[:, :16]
    return _head(c9g, k("conv10_1"), b("conv10_1"))


def forward_channels_last(net, x, skip=(), dtype=torch.bfloat16):
    """``UNetSeeInDark``'s forward under bf16 autocast (f32 with ``dtype``
    float32) with the named groups ablated to no-ops."""

    def conv(t, name):
        m = getattr(net, name)
        return _noop_conv(t, m.out_channels, m.bias) if name in skip else _lrelu(m(t))

    def up(t, name):
        m = getattr(net, name)
        return _noop_up(t, m.out_channels) if name in skip else m(t)

    def pool(t):
        return t[:, :, ::2, ::2] if "pools" in skip else F.max_pool2d(t, 2)

    def dec(h, skip_t, level):
        u, ca = up(h, f"upv{level}"), getattr(net, f"conv{level}_1")
        if f"conv{level}_1" in skip:
            h = _bias_act(u[:, :ca.out_channels], ca.bias)
        else:
            h = _lrelu(ca(torch.cat([u, skip_t], dim=1)))
        return conv(h, f"conv{level}_2")

    with autocast(x, dtype):
        c1 = conv(conv(x, "conv1_1"), "conv1_2")
        c2 = conv(conv(pool(c1), "conv2_1"), "conv2_2")
        c3 = conv(conv(pool(c2), "conv3_1"), "conv3_2")
        c4 = conv(conv(pool(c3), "conv4_1"), "conv4_2")
        c5 = conv(conv(pool(c4), "conv5_1"), "conv5_2")
        c8 = dec(dec(dec(c5, c4, 6), c3, 7), c2, 8)
        if "conv9_1" in skip:  # with upv9, which the packed form folds into it
            m = net.conv9_1
            c9 = conv(_bias_act(_noop_up(c8, m.out_channels), m.bias), "conv9_2")
        else:
            c9 = dec(c8, c1, 9)
        out = c9[:, :net.out_nc] if "head" in skip else net.conv10_1(c9)
    return out.float()


@torch.no_grad()
def main(argv=None, device=None):
    a = parse(argv, 24, __doc__)
    dev, params, x = setup(a, device)
    fwd = forward if a.form == "packed" else forward_channels_last
    time = lambda g: calls_ms(lambda: fwd(params, x, skip=g), a.iters, a.repeats, dev)
    base = time(())
    mpix = x.numel() / 1e6
    print(f"base frame: {base:.2f} ms ({mpix / (base / 1e3):.1f} Mpix/s)\n", flush=True)
    rows = []
    for g in GROUPS[a.form]:
        ms = time(g)
        print(f"ablate {'+'.join(g):28s}: {ms:7.2f} ms  (marginal {base - ms:6.2f} ms)",
              flush=True)
        rows.append({"group": "+".join(g), "ms": ms, "marginal_ms": base - ms})
    return {"form": a.form, "base_ms": base, "rows": rows}


if __name__ == "__main__":
    main()
