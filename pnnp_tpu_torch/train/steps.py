"""Eval steps: padded full-frame forward, fused with the eval metrics.

Counterpart of the eval half of ``pnnp_tpu/train/steps.py``
(``pad_split`` :354, ``pad_to_multiple`` :364, ``make_eval_metrics_step``
:376-486, ``make_eval_step`` :489). The public layouts are the JAX
package's: NHWC frames, or channel-interleaved flat ``[1, H, W*4]``; the
steps convert to NCHW only around the model. The train steps (synth, loss,
Adam) are still to be ported (ROADMAP 1.3-1.4).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pnnp_tpu_torch.kernels.ssim import ssim_flat
from pnnp_tpu_torch.ops.correct import illuminance_correct


def pad_split(n: int, mult: int = 16):
    """(lo, hi) symmetric split of the pad needed to reach %mult — the
    general form of the reference's fixed ``F.pad(p2d=(4,4,4,4))``
    (trainer_SID.py:221-226 / trainer_LRID.py:224-229: both camera shapes
    have residue 8, i.e. 4 per side)."""
    p = (-n) % mult
    return p // 2, p - p // 2


def _pad_nchw(x: torch.Tensor, mult: int):
    H, W = x.shape[-2], x.shape[-1]
    (pt, pb), (pl, pr) = pad_split(H, mult), pad_split(W, mult)
    if pt or pb or pl or pr:
        x = F.pad(x, (pl, pr, pt, pb), mode="reflect")
    return x, (pt, pl, H, W)


def pad_to_multiple(x: torch.Tensor, mult: int = 16):
    """Symmetric reflect-pad an NHWC ``[N, H, W, C]`` frame to a multiple of
    ``mult`` (reference pads 4 per side before the UNet and center-crops
    after, trainer_SID.py:221-226). Returns (padded, (oy, ox, H, W)); crop
    the output with ``pred[:, oy:oy+H, ox:ox+W, :]``."""
    xp, geom = _pad_nchw(x.permute(0, 3, 1, 2), mult)
    return xp.permute(0, 2, 3, 1), geom


def _exact_f32(model) -> None:
    # An f32 model on the card must compute in full f32, as the JAX f32
    # path does: cuDNN would otherwise run f32 convolutions in TF32 (about
    # three decimal digits). Matmuls are f32 by default; set both anyway.
    if model.dtype == torch.float32 and next(model.parameters()).is_cuda:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def _forward_cropped(model, x_nchw: torch.Tensor) -> torch.Tensor:
    """%16 reflect pad -> model -> center crop, NCHW float32."""
    xp, (oy, ox, H, W) = _pad_nchw(x_nchw.float(), 16)
    return model(xp)[:, :, oy:oy + H, ox:ox + W]


def make_eval_metrics_step(model):
    """Fused full-frame eval: forward + clip + illuminance correction +
    PSNR + SSIM (the CUDA kernel on the card) in one call.

    step(lr, hr, ratio, *, ori=False, correct=True, with_inputs=False) ->
    (dn_flat [1, H, W*4] corrected+clipped, metrics with psnr/ssim
    [/psnr_in/ssim_in]) and, with ``with_inputs``, the (ori-scaled, clipped)
    input panel ``lr_panel`` [1, H, W*4] as a third element. ``lr``/``hr``
    are flat ``[1, H, W*4]`` or ``[1, H, W, 4]`` tensors on the model's
    device. Reference eval semantics (trainer_SID.py:221-248): ori
    amplification, clip, correct dn against hr, score at data_range 255.
    The model runs in its own dtype (bf16 serving, or f32) and hands back
    float32.
    """
    _exact_f32(model)
    in_nc = getattr(model, "in_nc", 4)

    @torch.no_grad()
    def step(lr, hr, ratio, *, ori=False, correct=True, with_inputs=False):
        if lr.dim() == 3:  # flat [1, H, W*4] -> logical 4-channel view
            lr = lr.reshape(1, lr.shape[1], -1, 4)
        if hr.dim() == 3:
            hr = hr.reshape(1, hr.shape[1], -1, 4)
        if lr.shape[-1] == 16 and in_nc == 4:
            raise NotImplementedError(
                "host pre-packed 16-channel eval input is not ported yet "
                "(ROADMAP 1.10 packed forms)")
        dn = _forward_cropped(model, lr.permute(0, 3, 1, 2))
        H = dn.shape[-2]
        dnf = dn[0].permute(1, 2, 0).reshape(H, -1)  # [H, W*4] dense copy
        if with_inputs:
            lrf = lr[0].float().reshape(H, -1)
        if ori:
            r = torch.as_tensor(ratio, dtype=torch.float32,
                                device=dnf.device).reshape(())
            dnf = dnf * r
            if with_inputs:
                lrf = lrf * r
        dnf = dnf.clamp(0.0, 1.0)
        if with_inputs:
            lrf = lrf.clamp(0.0, 1.0)
        hrf = hr[0].float().reshape(H, -1)
        hrc = hrf.clamp(0.0, 1.0)
        if correct:
            dnf = illuminance_correct(dnf.reshape(H, -1, 4),
                                      hrf.reshape(H, -1, 4)).reshape(H, -1)

        def psnr_of(a, b):
            mse = torch.mean((a * 255.0 - b * 255.0) ** 2)
            return 10.0 * torch.log10(255.0**2 / mse.clamp_min(1e-12))

        metrics = {
            "psnr": psnr_of(dnf, hrc),
            "ssim": ssim_flat(dnf * 255.0, hrc * 255.0),
        }
        if with_inputs:  # the save_plot meters (trainer_SID.py:291-297)
            metrics["psnr_in"] = psnr_of(lrf, hrc)
            metrics["ssim_in"] = ssim_flat(lrf * 255.0, hrc * 255.0)
            return dnf[None], metrics, lrf[None]
        return dnf[None], metrics

    return step


def make_eval_step(model):
    """eval_step(lr_img [N, H, W, C]) -> denoised [N, H, W, out_nc] float32,
    with %16 reflect padding (the plain forward ``dump`` mode uses)."""
    _exact_f32(model)

    @torch.no_grad()
    def step(lr_img):
        return _forward_cropped(model, lr_img.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    return step
