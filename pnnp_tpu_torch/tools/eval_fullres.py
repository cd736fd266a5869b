"""Full-resolution eval on the card: the production fused eval step at both
camera frames (counterpart of ``tools/eval_fullres.py``).

Times ``train/steps.py::make_eval_metrics_step`` (pad to 16, UNetSeeInDark
nf=32 forward, crop, clip, illuminance correction, PSNR and the CUDA SSIM
kernel) at the SonyA7S2 2848x4256 and IMX686 3472x4624 mosaics (reference
full-frame semantics trainer_SID.py:221-228; the IMX686 packed frame is
%16-misaligned and takes the pad/crop path). The weights are a seeded
N(0, 0.02) init served in bf16, as the Trainer serves.

Modes:
  default   the unpacked frame ``[1, h, w, 4]``, the step pads it and runs
            the module forward (bf16, ``channels_last``): the Trainer's path
  --packed  frames packed on the host (``models/unet_s2d.py::pack_frame_np``:
            %16 reflect pad + s2d), the step's host-packed branch
  --int8    the W8A8 packed forward (``models/unet_s2d_int8.py``), calibrated
            at maxabs on one U(0, 0.3) packed frame ``[1, 16, 712, 1064]``,
            as JAX's ``[1, 712, 1064, 16]``; metrics stay f32

Timing: K frames queued back to back on the stream between two CUDA
events, one readback after them (the JAX tool chains K frames in one
``lax.map`` with one readback), best of 4 repeats after a first call. The
JAX tool pads frames to 16 before its step; this one hands the step the
frame as the Trainer does, so the pad is inside the time.

Usage (from the repository root; on the card unless ``--cpu``):

    python -m pnnp_tpu_torch.tools.eval_fullres [--frames 4] [--packed | --int8] [--cpu]

Prints one JSON line per shape with the JAX tool's keys (``compile_s`` is
the first chained run's seconds: cuDNN's autotuning, no compile), plus
``card`` (name and power limit), ``frames`` and ``metric_sum`` (the first
run's sum of PSNR + SSIM over the frames); :func:`main` returns them.
"""

from __future__ import annotations

import argparse
import json
import time

SHAPES = (("SonyA7S2", 2848, 4256), ("IMX686", 3472, 4624))
CAL_SHAPE = (1, 16, 712, 1064)  # the int8 calibration frame, packed NCHW-logical
REPEATS = 4
MODEL_SEED, FRAME_SEED, HR_SEED, CAL_SEED = 0, 1, 2, 3


def build_step(model, mode: str, generator=None):
    """The fused eval step of ``model`` for ``mode``; ``int8`` calibrates on
    one U(0, 0.3) frame drawn from ``generator`` (on the model's device)."""
    import torch

    from pnnp_tpu_torch.train.steps import make_eval_metrics_step

    if mode != "int8":
        return make_eval_metrics_step(model)
    from pnnp_tpu_torch.models.unet_s2d import transform_params_hybrid
    from pnnp_tpu_torch.models.unet_s2d_int8 import calibrate_act_scales, quantize_params_int8

    dev = next(model.parameters()).device
    cal = torch.rand(CAL_SHAPE, generator=generator, device=dev) * 0.3
    with torch.no_grad():
        tp = transform_params_hybrid(model, model.dtype)
        qparams = quantize_params_int8(tp, calibrate_act_scales(tp, [cal], model.dtype))
    return make_eval_metrics_step(model, qparams=qparams)


def make_frames(h: int, w: int, K: int, mode: str, device):
    """K lr frames U(0, 0.3) ``[1, h, w, 4]`` (host-packed for ``packed``:
    ``[1, h'/2, w'/2, 16]``) and one hr U(0, 1), on ``device``, seeded."""
    import torch

    from pnnp_tpu_torch.models.unet_s2d import pack_frame_np

    gen = torch.Generator(device=device).manual_seed(FRAME_SEED)
    frames = [torch.rand((1, h, w, 4), generator=gen, device=device) * 0.3 for _ in range(K)]
    if mode == "packed":
        frames = [torch.from_numpy(pack_frame_np(f.cpu().numpy())).to(device) for f in frames]
    hr_gen = torch.Generator(device=device).manual_seed(HR_SEED)
    hr = torch.rand((1, h, w, 4), generator=hr_gen, device=device)
    return frames, hr


def run_frames(step, frames, hr) -> list:
    """The step over every frame against ``hr`` (ratio 1, corrected, as the
    JAX tool); the per-frame metrics, left on the device."""
    return [step(lr, hr, 1.0, ori=False, correct=True, with_inputs=False)[1] for lr in frames]


def time_frames(step, frames, hr, device, repeats: int = REPEATS):
    """(best ms per frame over ``repeats`` chained runs of the frames, the
    first run's seconds, the readback sum). The frames are queued back to
    back between two CUDA events and read back once (perf_counter and a
    plain readback on the host)."""
    import torch

    def chained():
        ms = run_frames(step, frames, hr)
        return torch.stack([m["psnr"] + m["ssim"] for m in ms]).sum()

    t0 = time.perf_counter()
    total = float(chained())
    first_s = time.perf_counter() - t0
    best = float("inf")
    for _ in range(repeats):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            s = chained()
            end.record()
            float(s)
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            float(chained())
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms / len(frames))
    return best, first_s, total


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--packed", action="store_true",
                    help="feed host pre-packed frames (pack_frame_np) to the step's "
                         "host-packed branch")
    ap.add_argument("--int8", action="store_true",
                    help="W8A8 packed serving path (unet_s2d_int8); metrics stay f32")
    ap.add_argument("--cpu", action="store_true")
    a = ap.parse_args(argv)

    import torch

    from pnnp_tpu_torch.models import UNetSeeInDark
    from pnnp_tpu_torch.utils.device import card_label, resolve_device

    dev = torch.device("cpu") if a.cpu else resolve_device(device)
    mode = "int8" if a.int8 else ("packed" if a.packed else "default")
    model = UNetSeeInDark(nf=32, dtype=torch.bfloat16,
                          generator=torch.Generator().manual_seed(MODEL_SEED)).to(dev).eval()
    step = build_step(model, mode, torch.Generator(device=dev).manual_seed(CAL_SEED))
    card = card_label(dev)
    out = []
    for cam, H, W in SHAPES:
        frames, hr = make_frames(H // 2, W // 2, a.frames, mode, dev)
        best, first_s, total = time_frames(step, frames, hr, dev)
        row = {
            "camera": cam,
            "mosaic": f"{H}x{W}",
            "path": ("fused" + ("-packed-in" if mode == "packed" else "")
                     + ("-int8" if mode == "int8" else "")),
            "ms_per_frame": best,
            "mpix_s": H * W / 1e6 / (best / 1e3),
            "compile_s": first_s,
            "includes": ("fused unet+clip+illum+psnr+ssim, host-packed input"
                         if mode == "packed" else
                         "fused pad16+unet+clip+illum+psnr+ssim (production step)"),
            "frames": a.frames,
            "metric_sum": total,
            "card": card,
        }
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


if __name__ == "__main__":
    main()
