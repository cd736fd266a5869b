"""h2d_gbps.eval: the bytes ``Trainer._to_device`` copied to the card a frame
(the program's ``h2d.bytes`` counter over the traced pass's frames) over the
CUDA-event time of the two copies (``h2d_ms.eval``'s span), in GB/s."""

from portbench import program_spans


def read(rec):
    n = program_spans.counter("h2d.bytes")
    ms = rec.span_mean("h2d")
    if not n or not ms or not rec.trace or not rec.trace.get("units"):
        return None
    return n / rec.trace["units"] / (ms * 1e-3) * 1e-9
