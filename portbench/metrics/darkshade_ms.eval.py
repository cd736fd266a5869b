"""darkshade_ms.eval: the mean host time of the program's ``eld.darkshade``
spans, one a frame inside ``ELDDataset.__getitem__``: the dark shading of
the short exposure (``correct_lr``), over the traced pass (ms)."""

from portbench import program_spans


def read(rec):
    return program_spans.mean_wall_ms("eld.darkshade")
