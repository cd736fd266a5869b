"""scale_clip_ms.eval: the mean host time of the program's ``eld.scale_clip``
spans, one a frame inside ``ELDDataset.__getitem__``: the ratio multiply,
the clip and the contiguous copies, over the traced pass (ms)."""

from portbench import program_spans


def read(rec):
    return program_spans.mean_wall_ms("eld.scale_clip")
