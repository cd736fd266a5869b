"""fwd_bwd_ms.train: CUDA events around TrainStep.forward_backward, the mean
over the traced window's units (ms)."""


def read(rec):
    return rec.span_mean("fwd_bwd")
