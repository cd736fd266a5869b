"""nll_fwd_bwd_ms.proxy: CUDA events around the proxy step's loss and backward,
the mean over the traced window's units (ms)."""


def read(rec):
    return rec.span_mean("nll_fwd_bwd")
