"""loader_wait_ms.eval: the host time a frame waits on the loader (DataLoader
over ELDDataset), the mean over the traced window's units (ms)."""


def read(rec):
    return rec.span_mean("loader_wait")
