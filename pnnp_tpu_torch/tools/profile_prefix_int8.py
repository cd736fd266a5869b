"""Composed-prefix cost profile of the W8A8 packed serving forward
(counterpart of ``tools/profile_prefix_int8.py``).

Successively longer prefixes of the real forward,
``models/unet_s2d_int8.py::_walk(..., stop=i)`` with the default
``QUANT_LAYERS`` quantized: the marginal column says which band of the
int8 forward holds the frame's milliseconds. The full prefix (stop = 6) is
the forward that ``--int8`` serves (``unet_hybrid_forward_packed_int8``).
The bands are the JAX tool's seven (``BANDS``): head, c2, c3, c4+c5, c6+c7,
c8, tail.

Weights are ``ablate_int8_quantset.make_tparams``'s; the input is one
N(0, 0.1) Sony frame ``[1, 16, 712, 1064]`` (``--small`` 64x64), which
also calibrates the scales (pct 99.95), as in the JAX tool. Timing: ``--iters``
chained calls of the prefix between two CUDA events, each output summed
into one accumulator read back once, the median of ``--repeats``
(``bench_int8.median_ms``).

Usage (from the repository root; on the card unless ``--cpu``):

    python -m pnnp_tpu_torch.tools.profile_prefix_int8 [--iters 16] [--small] [--cpu]

Prints one line per prefix; :func:`main` returns ``[(name, seconds)]``.
"""

from __future__ import annotations

import argparse
import sys

NAMES = (
    "head (c1_1 bf16 + c1_2 q + gmax)",
    "+ c2 (q conv2_1/2_2)",
    "+ c3 (pool + q)",
    "+ c4+c5 (bottleneck q)",
    "+ c6+c7 (up bf16 + dec q)",
    "+ c8 (upv8 + dec q)",
    "+ tail (q conv9 + head einsum)",
)


def prefix_fn(tparams: dict, qparams: dict, n: int):
    """The int8 forward's prefix through band ``n`` (``_walk``'s ``stop``)."""
    import torch

    from pnnp_tpu_torch.models.unet_s2d_int8 import _walk

    return lambda g: _walk(tparams, g, torch.bfloat16, qparams=qparams, stop=n)


def prefix_ms(tparams: dict, qparams: dict, g1, iters: int, repeats: int) -> list:
    """Median ms per call of each prefix, in band order."""
    import torch

    from pnnp_tpu_torch.tools.bench_int8 import median_ms

    out = []
    for n in range(len(NAMES)):
        fn = prefix_fn(tparams, qparams, n)

        def run(fn=fn):
            acc = torch.zeros((), device=g1.device)
            s = 1.0
            for _ in range(iters):
                acc = acc + fn(g1 * s).float().sum()
                s *= 1.0001
            return acc

        with torch.no_grad():
            out.append(median_ms(run, iters, repeats, g1.device))
    return out


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--small", action="store_true", help="64x64 packed input (wiring)")
    ap.add_argument("--cpu", action="store_true")
    a = ap.parse_args(argv)

    import torch

    from pnnp_tpu_torch.models.unet_s2d_int8 import calibrate_act_scales, quantize_params_int8
    from pnnp_tpu_torch.tools.ablate_int8_quantset import FRAME, SMALL_FRAME, make_tparams
    from pnnp_tpu_torch.utils.device import card_label, resolve_device

    dev = torch.device("cpu") if a.cpu else resolve_device(device)
    print(f"devices: {dev} ({card_label(dev)})", file=sys.stderr)
    tparams = make_tparams(dev)
    g1 = torch.randn(SMALL_FRAME if a.small else FRAME,
                     generator=torch.Generator(device=dev).manual_seed(1), device=dev) * 0.1
    qparams = quantize_params_int8(tparams, calibrate_act_scales(tparams, [g1], pct=99.95))
    rows, prev = [], 0.0
    for name, ms in zip(NAMES, prefix_ms(tparams, qparams, g1, a.iters, a.repeats)):
        t = ms / 1e3
        print(f"prefix {len(rows)} {name:34s}: {t * 1e3:6.2f} ms  "
              f"(marginal {1e3 * (t - prev):+6.2f} ms)", flush=True)
        rows.append((name, t))
        prev = t
    return rows


if __name__ == "__main__":
    main()
