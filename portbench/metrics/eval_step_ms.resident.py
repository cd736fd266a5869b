"""eval_step_ms.resident: CUDA events from the call of the fused eval step to
the readback of its PSNR and SSIM, the mean over the traced window's units
(ms)."""


def read(rec):
    return rec.span_mean("eval_step")
