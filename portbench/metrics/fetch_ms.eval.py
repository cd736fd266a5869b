"""fetch_ms.eval: the mean host time of the program's ``loader.fetch`` spans,
a loader worker building one frame's batch (dataset item and collate), over
the traced pass (ms)."""

from portbench import program_spans


def read(rec):
    return program_spans.mean_wall_ms("loader.fetch")
