"""nll_fwd_ms.proxy: CUDA events around the proxy's masked NLL (``loss_fn``:
the chunked Gaussian-convolved density), the program's ``proxy.forward``
device spans in ``NoiseStep.forward_backward``, the mean over the traced
pass's steps (ms)."""

from portbench import program_spans


def read(rec):
    return program_spans.mean_device_ms("proxy.forward")
