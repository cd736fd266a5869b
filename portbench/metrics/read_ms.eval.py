"""read_ms.eval: the mean host time of the program's ``eld.read`` spans, one a
frame inside ``ELDDataset.__getitem__``: the two raw mosaics read from disk
(``data/io.py::dataload``), over the traced pass (ms)."""

from portbench import program_spans


def read(rec):
    return program_spans.mean_wall_ms("eld.read")
