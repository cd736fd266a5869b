"""pack_ms.eval: the mean host time of the program's ``eld.pack`` spans, one a
frame inside ``ELDDataset.__getitem__``: the two packs of the mosaics
(native or NumPy), over the traced pass (ms)."""

from portbench import program_spans


def read(rec):
    return program_spans.mean_wall_ms("eld.pack")
