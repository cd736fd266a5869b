"""adam_ms.train: CUDA events around TrainStep.update (Adam), the mean over the
traced window's units (ms)."""


def read(rec):
    return rec.span_mean("adam")
