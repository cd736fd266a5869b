"""h2d_ms.eval: CUDA events around the two pageable host-to-device copies of a
frame, the mean over the traced window's units (ms)."""


def read(rec):
    return rec.span_mean("h2d")
