"""nll_bwd_ms.proxy: CUDA events around the proxy NLL's backward (each
checkpointed chunk recomputed, then its gradients), the program's
``proxy.backward`` device spans in ``NoiseStep.forward_backward``, the mean
over the traced pass's steps (ms)."""

from portbench import program_spans


def read(rec):
    return program_spans.mean_device_ms("proxy.backward")
