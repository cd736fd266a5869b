"""synth_ms.train: CUDA events around TrainStep.make_pair (the proxy synth and
the clip), the mean over the traced window's units (ms)."""


def read(rec):
    return rec.span_mean("synth")
