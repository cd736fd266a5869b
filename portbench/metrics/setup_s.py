"""setup_s: seconds from the start of the process to the start of the window:
imports, the CUDA context, inputs and weights made from the seed, the first
build of a kernel, warm-up of every shape the cell uses."""


def read(rec):
    return rec.setup_s
