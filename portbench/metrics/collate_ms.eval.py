"""collate_ms.eval: the mean host time of the program's ``loader.collate``
spans, one a batch inside the loader's fetch: the items stacked into the
batch (``data/loader.py::collate``, which copies each frame), over the
traced pass (ms)."""

from portbench import program_spans


def read(rec):
    return program_spans.mean_wall_ms("loader.collate")
