"""The card's A/B of the serving loop's structure (counterpart of
``tools/bench_serving_variants.py``).

The JAX tool asks whether unrolling k independent frames in one scan body
recovers the ``lax.map`` loop's per-frame floor on the TPU. On the card
the question is whether issuing frames in bigger units cuts the host's
launch overhead: K frames go through the forward

* ``loop`` (the baseline): one eager forward per frame, as ``lax.map``;
* ``sequential x2`` / ``x4``: k frames issued per call, their outputs
  stacked;
* ``graph x1`` / ``x2`` / ``x4``: one, two or four forwards captured in one
  ``torch.cuda.CUDAGraph`` over a static input, each call a copy in and a
  replay (the card only: a capture that fails fails the run; no eager
  fallback);
* ``int8``: the W8A8 forward per frame (``models/unet_s2d_int8.py``, on the
  s2d-packed frame; calibrated at pct 99.95 on the first frame).

Every variant serves the same K frames; :func:`main` holds each one's
frames against the loop's: equal bit for bit, except ``int8``, which
differs by its quantization (its relative L2 error against the loop is
returned).

``--form`` picks the forward (``profile_prefix``): the ``channels_last``
UNetSeeInDark under bf16 autocast that serves on the card (the default), or
the packed hybrid. Weights: the seeded nf=32 UNetSeeInDark; frames: K = 24
N(0, 0.1) Sony frames (``--small``: 4 64x64 mosaics). Timing: the K frames
issued back to back between two CUDA events, each output summed into one
accumulator read back once, the median of ``--repeats`` runs after one
warm-up run, over K (``bench_int8.median_ms``; the host clock with
``--cpu``).

Usage (from the repository root; on the card unless ``--cpu``):

    python -m pnnp_tpu_torch.tools.bench_serving_variants [--form channels_last|packed] [--small] [--cpu]

Prints one JSON line per variant, ``{"variant": ..., "ms_per_frame": ...}``;
:func:`main` returns the rows with ``max_abs_diff`` (and ``rel_err``)
against the loop's frames.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from pnnp_tpu_torch.models.unet_s2d import d2s, s2d, transform_params_hybrid
from pnnp_tpu_torch.models.unet_s2d_int8 import (
    calibrate_act_scales,
    quantize_params_int8,
    unet_hybrid_forward_packed_int8,
)
from pnnp_tpu_torch.tools.bench_int8 import median_ms
from pnnp_tpu_torch.tools.profile_prefix import (
    FORMS,
    FRAME,
    SMALL_FRAME,
    full_fn,
    make_net,
    subject,
)
from pnnp_tpu_torch.utils.device import card_label, resolve_device

K_FRAMES, SMALL_K_FRAMES = 24, 4
UNROLL = (2, 4)
INT8_PCT = 99.95


def make_frames(form: str, dev, k: int, small: bool = False) -> torch.Tensor:
    """``k`` N(0, 0.1) frames ``[k, 1, C, H, W]``, each in ``channels_last``."""
    shape = (SMALL_FRAME if small else FRAME)[form]
    g = torch.Generator(device=dev).manual_seed(1)
    fr = torch.randn((k,) + shape, generator=g, device=dev) * 0.1
    return fr.permute(0, 1, 3, 4, 2).contiguous().permute(0, 1, 4, 2, 3)


def sequential(fwd, k: int):
    """k frames issued per call: ``frames [k, ...] -> outputs [k, ...]``."""
    return lambda chunk: torch.stack([fwd(chunk[i]) for i in range(k)])


def graphed(fn, example: torch.Tensor):
    """``fn`` captured in one CUDA graph over a static input shaped like
    ``example``: each call copies its input in and replays. The output is
    the graph's static buffer, valid until the next call."""
    static_in = example.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture (cuDNN plans)
        for _ in range(2):
            fn(static_in)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_out = fn(static_in)

    def call(x):
        static_in.copy_(x)
        graph.replay()
        return static_out

    return call


def serve(call, frames: torch.Tensor, k: int, each):
    """``call`` over ``frames`` in chunks of ``k`` (k = 1: one frame, no
    chunk axis); ``each(output)`` sees every frame's output in turn."""
    for j in range(0, frames.shape[0], k):
        out = call(frames[j] if k == 1 else frames[j:j + k])
        for i in range(k):
            each(out if k == 1 else out[i])


def variants(form: str, net, frames: torch.Tensor) -> dict:
    """``{name: (call, k)}``: the loop, sequential, graph (frames on the
    card) and int8 variants over ``frames``."""
    fwd = full_fn(form, subject(form, net))
    out = {"loop": (fwd, 1)}
    out.update({f"sequential x{k}": (sequential(fwd, k), k) for k in UNROLL})
    if frames.is_cuda:
        out["graph x1"] = (graphed(fwd, frames[0]), 1)
        out.update({f"graph x{k}": (graphed(sequential(fwd, k), frames[:k]), k)
                    for k in UNROLL})
    tp = transform_params_hybrid(net, torch.bfloat16)
    pack = (lambda x: x) if form == "packed" else s2d
    unpack = (lambda x: x) if form == "packed" else d2s
    qp = quantize_params_int8(tp, calibrate_act_scales(tp, [pack(frames[0])], pct=INT8_PCT))
    out["int8"] = (lambda x: unpack(unet_hybrid_forward_packed_int8(tp, qp, pack(x))), 1)
    return out


@torch.no_grad()
def main(argv=None, device=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--form", choices=FORMS, default="channels_last")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--small", action="store_true", help="64x64 mosaics (wiring)")
    ap.add_argument("--cpu", action="store_true")
    a = ap.parse_args(argv)

    dev = torch.device("cpu") if a.cpu else resolve_device(device)
    print(f"devices: {dev} ({card_label(dev)}); form {a.form}", file=sys.stderr)
    net = make_net(dev)
    frames = make_frames(a.form, dev, SMALL_K_FRAMES if a.small else K_FRAMES, a.small)
    rows, loop = [], []
    with torch.no_grad():
        for name, (call, k) in variants(a.form, net, frames).items():
            outs = []
            serve(call, frames, k, lambda o: outs.append(o.float().clone()))
            if name == "loop":
                loop = outs
            diff = max(float((o - r).abs().max()) for o, r in zip(outs, loop))
            rel = float(torch.stack([(o - r).norm() for o, r in zip(outs, loop)]).norm()
                        / torch.stack([r.norm() for r in loop]).norm())
            del outs

            def run(call=call, k=k):
                acc = torch.zeros((), device=dev)

                def add(o):
                    nonlocal acc
                    acc = acc + o.float().sum()

                serve(call, frames, k, add)
                return acc

            ms = median_ms(run, frames.shape[0], a.repeats, dev)
            print(json.dumps({"variant": name, "ms_per_frame": round(ms, 3)}), flush=True)
            print(f"{name}: max |frame - loop frame| {diff:.3e}, relative L2 {rel:.3e}",
                  file=sys.stderr)
            rows.append({"variant": name, "ms_per_frame": ms, "max_abs_diff": diff,
                         "rel_err": rel})
    return rows


if __name__ == "__main__":
    main()
