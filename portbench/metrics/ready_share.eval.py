"""ready_share.eval: the share of the program's ``loader.wait`` spans whose
batch was built when the sweep asked for it (attribute ``ready``), over the
traced pass (%)."""

from portbench import program_spans


def read(rec):
    v = program_spans.spans("loader.wait")
    return 100.0 * sum(bool(s["attrs"].get("ready")) for s in v) / len(v) if v else None
