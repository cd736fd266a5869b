"""resident_frame_p95_ms: the 95th percentile of the frames' times, each from
when the loop asks for the frame to when its PSNR and SSIM are floats on the
host (a wait on the loader counts)."""

import statistics


def read(rec):
    if rec.unit != "frame" or len(rec.unit_s) < 20:
        return None
    return statistics.quantiles(rec.unit_s, n=20)[18] * 1e3
