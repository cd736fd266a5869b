"""Band-by-band roofline of the W8A8 serving forward (counterpart of
``tools/int8_roofline.py``).

For every band of the composed prefix profile (``profile_prefix_int8``)
this takes the band's FLOP inventory from the layer shapes that
``models/unet_s2d_int8.py::_walk`` records (:func:`layer_shapes`), holds it
equal to the JAX tool's table
(:func:`reference_bands`, the port's copy), and reports the band's
effective TOP/s (dense FLOPs / the composed marginal ms) beside the time
the band would take at each op's isolated rate, as ``bench_int8`` measures
it in this run for the op's shape class:

    wide-s8      conv3x3 128->128 int8 at 712x1064 (int8 rate)
    narrow-bf16  conv3x3 16->128 bf16 at 712x1064 (bf16 rate)
    64ch-s8      conv3x3 64->64 int8 at 356x532 (int8 rate); narrow-s8 too
    bf16-upT     matmul 378k x 128 x 128 bf16 (the 2x2 transposes are one
                 GEMM each); the 1x1 head einsum (tiny) too

(``--small``: the small conv case for every conv class, the small matmul
for the rest.) A band at or under its isolated-rate time (+5%) is CLOSED:
the composed forward already runs that math at the measured rate.

The card's dense peaks, for scale: 989 TFLOP/s bf16 and 1979 TOP/s int8
(H100 SXM). ``--probe-int4``: PyTorch reaches no s4 GEMM on sm_90
(``torch._int_mm`` takes int8 only), so the probe reports that in the
tool's JSON form and times nothing in its place.

Usage (from the repository root; on the card unless ``--cpu``):

    python -m pnnp_tpu_torch.tools.int8_roofline [--iters 16] [--probe-int4] [--small] [--cpu]

Prints the table and, last, one JSON line; :func:`main` returns the bands.
"""

from __future__ import annotations

import argparse
import json

from pnnp_tpu_torch.models.unet_s2d_int8 import BANDS, OPTIONAL_QUANT, QUANT_LAYERS

# every layer input of the walk, by band
BAND_LAYERS = {
    "head": ("conv1_1", "conv1_2"),
    "c2": ("conv2_1", "conv2_2"),
    "c3": ("conv3_1", "conv3_2"),
    "c4+c5": ("conv4_1", "conv4_2", "conv5_1", "conv5_2"),
    "c6+c7": ("upv6", "conv6_1u", "conv6_1s", "conv6_2",
              "upv7", "conv7_1u", "conv7_1s", "conv7_2"),
    "c8": ("upv8", "conv8_1u", "conv8_1s", "conv8_2"),
    "tail": ("conv9_1u", "conv9_1s", "conv9_2", "conv10_1"),
}
NO_INT4 = ("no s4 GEMM reachable from PyTorch on sm_90: torch._int_mm takes int8 "
           "operands only")


def reference_bands(H2: int, W2: int) -> list:
    """The JAX tool's FLOP table (tools/int8_roofline.py:64-88) at packed
    level-1 size ``H2 x W2``: ``[(band, [(label, FLOPs, class)])]``."""
    px1 = H2 * W2
    px2, px3, px4 = px1 // 4, px1 // 16, px1 // 64
    conv = lambda px, cin, cout: px * 9 * cin * cout * 2
    upT = lambda px_out, cin, cout: px_out * cin * cout * 2
    return [
        ("head", [("conv1_1 bf16 16->128", conv(px1, 16, 128), "narrow-bf16"),
                  ("conv1_2 s8 128->128", conv(px1, 128, 128), "wide-s8")]),
        ("c2", [("conv2_1 s8 32->64", conv(px1, 32, 64), "narrow-s8"),
                ("conv2_2 s8 64->64", conv(px1, 64, 64), "64ch-s8")]),
        ("c3", [("conv3_1 s8 64->128", conv(px2, 64, 128), "64ch-s8"),
                ("conv3_2 s8 128->128", conv(px2, 128, 128), "wide-s8")]),
        ("c4+c5", [("conv4_1 s8 128->256", conv(px3, 128, 256), "wide-s8"),
                   ("conv4_2 s8 256->256", conv(px3, 256, 256), "wide-s8"),
                   ("conv5_1 s8 256->512", conv(px4, 256, 512), "wide-s8"),
                   ("conv5_2 s8 512->512", conv(px4, 512, 512), "wide-s8")]),
        ("c6+c7", [("upv6 bf16 512->256", upT(px3, 512, 256), "bf16-upT"),
                   ("conv6_1u/s s8 256", 2 * conv(px3, 256, 256), "wide-s8"),
                   ("conv6_2 s8 256", conv(px3, 256, 256), "wide-s8"),
                   ("upv7 bf16 256->128", upT(px2, 256, 128), "bf16-upT"),
                   ("conv7_1u/s s8 128", 2 * conv(px2, 128, 128), "wide-s8"),
                   ("conv7_2 s8 128", conv(px2, 128, 128), "wide-s8")]),
        ("c8", [("upv8 bf16 128->64", upT(px1, 128, 64), "bf16-upT"),
                ("conv8_1u/s s8 64", 2 * conv(px1, 64, 64), "64ch-s8"),
                ("conv8_2 s8 64", conv(px1, 64, 64), "64ch-s8")]),
        ("tail", [("conv9_1u s8 65->128", conv(px1, 65, 128), "wide-s8"),
                  ("conv9_1s s8 128->128", conv(px1, 128, 128), "wide-s8"),
                  ("conv9_2 s8 128->128", conv(px1, 128, 128), "wide-s8"),
                  ("head einsum 32x4", px1 * 4 * 32 * 4 * 2, "tiny")]),
    ]


def _out_channels(tparams: dict, name: str) -> int:
    if name.startswith("conv9_1"):
        return tparams["conv9_1"]["kernel_up"].shape[0]
    if name.startswith("upv"):
        return tparams[name]["kernel"].shape[1]  # [Cin, Cout, 2, 2]
    if name[-1] in ("u", "s") and name[:-1] in tparams:
        return tparams[name[:-1]]["kernel"].shape[0]
    return tparams[name]["kernel"].shape[0]


def _op(tparams: dict, name: str, shape) -> tuple:
    """(FLOPs, shape class) of one layer from its recorded input shape."""
    n, cin, h, w = shape
    cout = _out_channels(tparams, name)
    if name == "conv10_1":  # the 1x1 head, block-diagonal over 4 groups
        return n * h * w * cin * cout * 2, "tiny"
    if name.startswith("upv"):  # 2x2 stride 2: 4 output pixels per input
        return n * h * w * 4 * cin * cout * 2, "bf16-upT"
    flops = n * h * w * 9 * cin * cout * 2
    if name not in QUANT_LAYERS:
        return flops, "narrow-bf16"
    return flops, ("narrow-s8" if cin <= 32 else "64ch-s8" if cin == 64 else "wide-s8")


def layer_shapes(tparams: dict, g1) -> dict:
    """The input shape of every layer of the walk on the packed frame
    ``g1``, by layer input name. The walk runs with every layer quantized
    (``QUANT_LAYERS`` and ``OPTIONAL_QUANT``), and its ``trace`` hook records
    each layer's input codes, which have the input's shape (its ``record``
    hook keeps one scalar per input, no shape). The 1x1 head reads
    conv9_2's output at conv9_2's size."""
    import torch

    from pnnp_tpu_torch.models.unet_s2d_int8 import (
        _walk,
        calibrate_act_scales,
        quantize_params_int8,
    )

    qparams = quantize_params_int8(tparams, calibrate_act_scales(tparams, [g1]),
                                   QUANT_LAYERS + OPTIONAL_QUANT)
    trace: list = []
    with torch.no_grad():
        _walk(tparams, g1, torch.bfloat16, qparams=qparams, trace=trace)
    shapes = {name: tuple(codes.shape) for name, codes in trace}
    n, _, h, w = shapes["conv9_2"]
    shapes["conv10_1"] = (n, _out_channels(tparams, "conv9_2"), h, w)
    return shapes


def inventory(tparams: dict, g1) -> list:
    """``[(band, {class: FLOPs})]`` from :func:`layer_shapes` on the packed
    frame ``g1``."""
    shapes = layer_shapes(tparams, g1)
    out = []
    for band in BANDS:
        per: dict = {}
        for name in BAND_LAYERS[band]:
            flops, cls = _op(tparams, name, shapes[name])
            per[cls] = per.get(cls, 0) + flops
        out.append((band, per))
    return out


def by_class(bands: list) -> list:
    """:func:`reference_bands`' table summed per band and class, in
    :func:`inventory`'s form."""
    out = []
    for band, ops in bands:
        per: dict = {}
        for _, flops, cls in ops:
            per[cls] = per.get(cls, 0) + flops
        out.append((band, per))
    return out


def class_rates(small: bool, dev) -> dict:
    """Isolated TOP/s per shape class, measured now by ``bench_int8``."""
    from pnnp_tpu_torch.tools.bench_int8 import CASES, SMALL_CASES, measure

    m = measure(SMALL_CASES if small else CASES, dev)
    rate = lambda case, i: m[case][2] / m[case][i] / 1e9  # FLOPs / ms -> TOP/s
    if small:
        conv, mm = SMALL_CASES[0][0], SMALL_CASES[1][0]
        wide = narrow_bf16 = ch64 = conv
    else:
        wide, narrow_bf16, ch64, mm = CASES[0][0], CASES[1][0], CASES[2][0], CASES[3][0]
    return {"wide-s8": rate(wide, 1), "narrow-bf16": rate(narrow_bf16, 0),
            "64ch-s8": rate(ch64, 1), "narrow-s8": rate(ch64, 1),
            "bf16-upT": rate(mm, 0), "tiny": rate(mm, 0)}


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--probe-int4", action="store_true")
    a = ap.parse_args(argv)

    import torch

    from pnnp_tpu_torch.tools.ablate_int8_quantset import FRAME, SMALL_FRAME, make_tparams
    from pnnp_tpu_torch.tools.profile_prefix_int8 import main as prefix_main
    from pnnp_tpu_torch.utils.device import resolve_device

    dev = torch.device("cpu") if a.cpu else resolve_device(device)
    shape = SMALL_FRAME if a.small else FRAME
    H2, W2 = shape[2], shape[3]
    derived = inventory(make_tparams(dev), torch.zeros(shape, device=dev))
    if derived != by_class(reference_bands(H2, W2)):
        raise RuntimeError(f"the walk's FLOP inventory differs from the JAX tool's table: "
                           f"{derived}")

    rows = prefix_main(["--iters", str(a.iters)] + (["--small"] if a.small else [])
                       + (["--cpu"] if a.cpu else []), device=device)
    marginals, prev = [], 0.0
    for _, t in rows:
        marginals.append(t - prev)
        prev = t
    rates = class_rates(a.small, dev)

    print(f"\nBand roofline at {H2}x{W2} packed (effective = dense FLOPs / "
          f"composed marginal; iso = what the band would cost at each op's "
          f"isolated measured rate):")
    print(f"{'band':>7} | {'TFLOP':>7} | {'measured ms':>11} | "
          f"{'eff TOP/s':>9} | {'iso ms':>7} | verdict")
    out = []
    for (name, per), meas in zip(derived, marginals):
        tflop = sum(per.values()) / 1e12
        iso_ms = sum(f / 1e12 / rates[cls] * 1e3 for cls, f in per.items())
        eff = tflop / max(meas, 1e-9)
        verdict = ("CLOSED (>= isolated rate)" if meas * 1e3 <= iso_ms * 1.05
                   else f"{meas * 1e3 / iso_ms:.2f}x isolated-rate cost")
        print(f"{name:>7} | {tflop:7.4f} | {meas * 1e3:11.2f} | {eff:9.1f} | "
              f"{iso_ms:7.2f} | {verdict}")
        out.append({"band": name, "tflop": round(tflop, 4), "measured_ms": round(meas * 1e3, 2),
                    "eff_tops": round(eff, 1), "iso_ms": round(iso_ms, 2)})

    int4 = None
    if a.probe_int4:
        int4 = {"error": NO_INT4}
        print(f"\nint4 probe: {NO_INT4}")
    print(json.dumps({"metric": "int8_roofline", "bands": out, "int4": int4}), flush=True)
    return out


if __name__ == "__main__":
    main()
