"""Composed A/B of W8A8 quant-layer subsets on the serving forward
(counterpart of ``tools/ablate_int8_quantset.py``).

``bench_int8`` measures isolated layer rates; which layers pay for
quantization is a question of the composed forward. This times the packed
serving forward at the Sony frame (``[1, 16, 712, 1064]``, the packed
2848x4256 mosaic) for each quant subset of ``SUBSETS``, built from
``QUANT_LAYERS``/``OPTIONAL_QUANT`` through ``calibrate_act_scales`` (pct
99.95 on one U(0, 0.3) frame) and ``quantize_params_int8``; ``bf16`` is
the unquantized skeleton. UNetSeeInDark nf=32 from a seeded init.

Timing: K frames chained on the stream between two CUDA events (each
frame's output cast to f32 and summed into one accumulator, read back
once), the median of ``--repeats`` after one warm-up run
(``bench_int8.median_ms``).

Usage (from the repository root; on the card unless ``--cpu``):

    python -m pnnp_tpu_torch.tools.ablate_int8_quantset [SUBSET ...] [--frames 24] [--small] [--cpu]

Prints the device on stderr and one JSON line per subset with the JAX
tool's keys; :func:`main` returns the rows.
"""

from __future__ import annotations

import argparse
import json
import sys

from pnnp_tpu_torch.models.unet_s2d_int8 import QUANT_LAYERS

L64 = ("conv2_1", "conv2_2", "conv8_1u", "conv8_1s", "conv8_2")
L1 = ("conv1_2", "conv9_1u", "conv9_1s", "conv9_2")

SUBSETS = {
    "bf16": (),
    "all": QUANT_LAYERS,
    # without the 64-channel layers
    "no64ch": tuple(n for n in QUANT_LAYERS if n not in L64),
    # only the level-1 128-channel convs at 712x1064
    "L1only": L1,
    # the interior pyramid without level 1
    "deep_only": tuple(n for n in QUANT_LAYERS if n not in L64 + L1),
    # OPTIONAL_QUANT probes (speed only): the head conv, the 2x2 transposes
    "all+c11": QUANT_LAYERS + ("conv1_1",),
    "all+upv": QUANT_LAYERS + ("upv6", "upv7", "upv8"),
    "all+c11+upv": QUANT_LAYERS + ("conv1_1", "upv6", "upv7", "upv8"),
}
FRAME = (1, 16, 712, 1064)  # the Sony frame, packed NCHW-logical
SMALL_FRAME = (1, 16, 64, 64)
MODEL_SEED, CAL_SEED = 0, 3


def make_tparams(dev):
    """Hybrid bf16 params of a seeded nf=32 UNetSeeInDark on ``dev``."""
    import torch

    from pnnp_tpu_torch.models import UNetSeeInDark
    from pnnp_tpu_torch.models.unet_s2d import transform_params_hybrid

    net = UNetSeeInDark(nf=32, generator=torch.Generator().manual_seed(MODEL_SEED)).to(dev)
    with torch.no_grad():
        return transform_params_hybrid(net, torch.bfloat16)


def setup(dev, small: bool = False):
    """(:func:`make_tparams`, the activation scales at pct 99.95 on one
    U(0, 0.3) frame, the frame shape)."""
    import torch

    from pnnp_tpu_torch.models.unet_s2d_int8 import calibrate_act_scales

    shape = SMALL_FRAME if small else FRAME
    tparams = make_tparams(dev)
    cal = torch.rand(shape, generator=torch.Generator(device=dev).manual_seed(CAL_SEED),
                     device=dev) * 0.3
    return tparams, calibrate_act_scales(tparams, [cal], pct=99.95), shape


def subset_forward(tparams: dict, scales: dict, subset, dtype=None):
    """The serving forward with ``subset`` quantized (the unquantized
    skeleton for an empty one): ``g1 [n, 16, h, w] -> [n, 16, h, w]``."""
    import torch

    from pnnp_tpu_torch.models.unet_s2d_int8 import (
        quantize_params_int8,
        unet_hybrid_forward_packed_int8,
        unet_hybrid_forward_packed_ref,
    )

    dtype = dtype or torch.bfloat16
    if not subset:
        return lambda g: unet_hybrid_forward_packed_ref(tparams, g, dtype)
    qp = quantize_params_int8(tparams, scales, quant=subset)
    return lambda g: unet_hybrid_forward_packed_int8(tparams, qp, g, dtype)


def frames_ms(fwd, frames, dev, repeats: int) -> float:
    """Median ms per frame of ``fwd`` over the chained ``frames``."""
    import torch

    from pnnp_tpu_torch.tools.bench_int8 import median_ms

    def run():
        acc = torch.zeros((), device=dev)
        for g in frames:
            acc = acc + fwd(g).float().sum()
        return acc

    with torch.no_grad():
        return median_ms(run, len(frames), repeats, dev)


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("only", nargs="*", help="subset names to run (default: all)")
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--repeats", type=int, default=6)
    ap.add_argument("--small", action="store_true", help="64x64 packed frames (wiring)")
    ap.add_argument("--cpu", action="store_true")
    a = ap.parse_args(argv)

    import torch

    from pnnp_tpu_torch.utils.device import card_label, resolve_device

    dev = torch.device("cpu") if a.cpu else resolve_device(device)
    print(f"devices: {dev} ({card_label(dev)})", file=sys.stderr)
    tparams, scales, shape = setup(dev, a.small)
    frames = torch.zeros((a.frames,) + shape, device=dev)
    mpix = shape[2] * shape[3] * 16 / 1e6  # the mosaic's pixels
    rows = []
    for name, subset in SUBSETS.items():
        if a.only and name not in a.only:
            continue
        ms = frames_ms(subset_forward(tparams, scales, subset), frames, dev, a.repeats)
        row = {"subset": name, "n_quant": len(subset), "ms_frame": round(ms, 2),
               "mpix_s": round(mpix / ms * 1e3, 1)}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
