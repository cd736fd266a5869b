"""Per-layer cost profile of the bf16 UNet forward (counterpart of
``tools/profile_layers.py``).

Times each conv shape of the forward alone, chained: a conv whose input and
output channels agree feeds itself; one whose channels differ chains as a
Cin -> Cout -> Cin round trip and reports half the pair. Then the
transposed convs as round trips (the 2x2 stride-2 transpose and a 2x2
stride-2 conv back), ``gmax+1x1`` (the packed form's level-1 group max
and a 1x1 projection, counted twice), the sum of parts, and the full
forward chained on itself as the anchor. Each conv prints ms and TFLOP/s.
The JAX tool found isolated chains mislead by 2.4x against the composed
forward: the sum of parts is printed beside the anchor, not held to it.

``LAYERS[form]`` holds, for each conv entry, (name, spatial shape, Cin,
Cout, count in the frame) at the Sony frame (:func:`layers` at any frame):

* ``packed``: the JAX tool's table (``tools/profile_layers.py:62-75``)
  with two corrections that the jaxpr of ``unet_hybrid_forward_packed``
  shows: level 5 runs at 89x133 (the table's W/8 + 1 = 134 is one column
  too wide), and conv9_1's up-path kernel (upv9 folded into it) takes
  c8 and the ones channel, 65 -> 128, where the table counts it as a third
  128 -> 128 conv beside conv9_1's skip half and conv9_2;
* ``channels_last``: the unpacked UNetSeeInDark's 3x3 convs at their own
  shapes (the decoder's first conv of each level over the concat), and
  four transposed convs (upv9 is not folded).

Convolutions go to cuDNN through ``F.conv2d`` in bf16 ``channels_last``:
this measures what serves. Timing: ``--iters`` chained calls between two
CUDA events, the last output read back once, the median of ``--repeats``
(``bench_int8.median_ms``; the host clock with ``--cpu``).

Usage (from the repository root; on the card unless ``--cpu``):

    python -m pnnp_tpu_torch.tools.profile_layers [--form channels_last|packed] [--iters 30] [--small] [--cpu]

:func:`main` returns ``{"form", "rows", "sum_ms", "anchor_ms"}``; each row
``{"name", "shape", "ms", "tflops", "count"}`` (``tflops`` None where the
JAX tool prints none).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pnnp_tpu_torch.models.unet_s2d import _group_max
from pnnp_tpu_torch.tools.bench_int8 import _chain, median_ms
from pnnp_tpu_torch.tools.profile_prefix import FORMS, FRAME, full_fn, parse, setup


def layers(form: str, h: int, w: int) -> list:
    """The conv table of ``form`` for a frame whose packed RGBG planes are
    ``h`` x ``w`` (the Sony frame: 1424 x 2128)."""
    s = [(1, h >> k, w >> k) for k in range(5)]  # levels 1-5 at full resolution
    if form == "packed":
        S1, S3, S4, S5 = s[1], s[2], s[3], s[4]  # level 1 in s2d form at level 2's size
        return [
            ("conv1_1 d-s2d", S1, 16, 128, 1),
            ("conv1_2 d-s2d", S1, 128, 128, 1),
            ("conv2_1", S1, 32, 64, 1),
            ("conv2_2", S1, 64, 64, 1),
            ("conv3_1", S3, 64, 128, 1),
            ("conv3_2/7_1s/7_2", S3, 128, 128, 4),
            ("conv4_1", S4, 128, 256, 1),
            ("conv4_2/6_1s/6_2", S4, 256, 256, 4),
            ("conv5_1", S5, 256, 512, 1),
            ("conv5_2", S5, 512, 512, 1),
            ("conv8_1s/8_2", S1, 64, 64, 3),
            ("conv9_1u d-s2d", S1, 65, 128, 1),
            ("conv9_1s d-s2d/9_2", S1, 128, 128, 2),
        ]
    return [
        ("conv1_1", s[0], 4, 32, 1),
        ("conv1_2/9_2", s[0], 32, 32, 2),
        ("conv9_1", s[0], 64, 32, 1),
        ("conv2_1", s[1], 32, 64, 1),
        ("conv2_2/8_2", s[1], 64, 64, 2),
        ("conv8_1", s[1], 128, 64, 1),
        ("conv3_1", s[2], 64, 128, 1),
        ("conv3_2/7_2", s[2], 128, 128, 2),
        ("conv7_1", s[2], 256, 128, 1),
        ("conv4_1", s[3], 128, 256, 1),
        ("conv4_2/6_2", s[3], 256, 256, 2),
        ("conv6_1", s[3], 512, 256, 1),
        ("conv5_1", s[4], 256, 512, 1),
        ("conv5_2", s[4], 512, 512, 1),
    ]


def up_layers(form: str, h: int, w: int) -> list:
    """The transposed convs: (name, input spatial shape, Cin, Cout)."""
    s = [(1, h >> k, w >> k) for k in range(5)]
    ups = [("upv6", s[4], 512, 256), ("upv7", s[3], 256, 128), ("upv8", s[2], 128, 64)]
    return ups if form == "packed" else ups + [("upv9", s[1], 64, 32)]


LAYERS = {form: layers(form, *FRAME["channels_last"][2:]) for form in FORMS}


def flops(sp, ci, co) -> int:
    """Multiply-adds x 2 of one 3x3 conv."""
    return 2 * 9 * ci * co * sp[1] * sp[2]


def carried_ms(step, x, iters: int, repeats: int) -> float:
    """Median ms per call of ``step`` chained on its own output ``iters``
    times (``bench_int8.median_ms``)."""
    return median_ms(_chain(step, x, iters), iters, repeats, x.device)


@torch.no_grad()
def main(argv=None, device=None):
    a = parse(argv, 30, __doc__)
    dev, params, x = setup(a, device)
    h, w = x.shape[-2:] if a.form == "channels_last" else (2 * x.shape[-2], 2 * x.shape[-1])
    gen = torch.Generator(device=dev).manual_seed(0)
    cl = torch.channels_last

    def randn(*shape, scale=1.0):
        t = torch.randn(shape, generator=gen, device=dev) * scale
        return t.to(torch.bfloat16, memory_format=cl if t.dim() == 4 else torch.contiguous_format)

    rows, total = [], 0.0
    print(f"{'layer':22s} {'shape':24s} {'ms':>8s} {'TFLOP/s':>8s} {'xN':>3s} {'tot ms':>7s}")
    for name, sp, ci, co, count in layers(a.form, h, w):
        xi = randn(1, ci, sp[1], sp[2])
        k1 = randn(co, ci, 3, 3, scale=1 / (3 * ci ** 0.5))
        if ci == co:
            ms = carried_ms(lambda c: F.conv2d(c, k1, padding=1), xi, a.iters, a.repeats)
        else:
            k2 = randn(ci, co, 3, 3, scale=1 / (3 * co ** 0.5))
            ms = carried_ms(lambda c: F.conv2d(F.conv2d(c, k1, padding=1), k2, padding=1),
                            xi, a.iters, a.repeats) / 2
        tflops = flops(sp, ci, co) / ms / 1e9
        total += ms * count
        rows.append({"name": name, "shape": [sp[1], sp[2], ci, co], "ms": ms,
                     "tflops": tflops, "count": count})
        print(f"{name:22s} {str((*sp, ci)) + '->' + str(co):24s} "
              f"{ms:8.3f} {tflops:8.1f} x{count} {ms * count:7.2f}", flush=True)

    for name, sp, ci, co in up_layers(a.form, h, w):
        xi = randn(1, ci, sp[1], sp[2])
        ku = randn(ci, co, 2, 2, scale=1 / (2 * ci ** 0.5))
        kd = randn(ci, co, 2, 2, scale=1 / (2 * co ** 0.5))
        ms = carried_ms(lambda c: F.conv2d(F.conv_transpose2d(c, ku, stride=2), kd, stride=2),
                        xi, a.iters, a.repeats) / 2
        total += ms
        rows.append({"name": name + " convT", "shape": [sp[1], sp[2], ci, co], "ms": ms,
                     "tflops": None, "count": 1})
        print(f"{name + ' convT (~half pair)':22s} {str((*sp, ci)) + '->' + str(co):24s} "
              f"{ms:8.3f} {'':>8s} x1  {ms:7.2f}", flush=True)

    if a.form == "packed":
        x1 = randn(1, 128, h // 2, w // 2)
        p = randn(128, 32, 1, 1, scale=1 / 32 ** 0.5)
        ms = carried_ms(lambda c: F.conv2d(_group_max(c), p), x1, a.iters, a.repeats)
        total += ms * 2  # the group max and a projection, on the p1 and the tail paths
        rows.append({"name": "gmax+1x1", "shape": [h // 2, w // 2, 128, 128], "ms": ms,
                     "tflops": None, "count": 2})
        print(f"{'gmax+1x1 (x2)':22s} {'':24s} {ms:8.3f} {'':>8s} x2  {ms * 2:7.2f}")

    print(f"\nsum of parts: {total:.2f} ms")
    fwd = full_fn(a.form, params)
    anchor = carried_ms(lambda c: fwd(c).float(), x, a.iters, a.repeats)
    print(f"full {a.form} forward: {anchor:.2f} ms/frame "
          f"({h * w * 4 / 1e6 / (anchor / 1e3):.1f} Mpix/s)", flush=True)
    return {"form": a.form, "rows": rows, "sum_ms": total, "anchor_ms": anchor}


if __name__ == "__main__":
    main()
