"""eval_ms_per_frame: the window's length over the frames whose PSNR and SSIM
reached the host in it."""


def read(rec):
    return rec.window_s * 1e3 / rec.units if rec.unit == "frame" and rec.units else None
