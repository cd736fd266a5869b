"""busy_workers.eval: the host time of the program's ``loader.fetch`` spans,
summed, over the interval from the first one's start to the last one's end
in the traced pass: the mean number of loader workers building a batch
(workers)."""

from portbench import program_spans


def read(rec):
    v = program_spans.spans("loader.fetch")
    if not v:
        return None
    span_ns = max(s["t1_ns"] for s in v) - min(s["t0_ns"] for s in v)
    return sum(s["t1_ns"] - s["t0_ns"] for s in v) / span_ns if span_ns > 0 else None
