"""graph_share.proxy: the proxy NLL steps of the traced pass that replayed
the step's CUDA graphs, over those steps and the steps that ran eagerly
(the program's ``proxy.graph_replays`` and ``proxy.graph_eager``
counters), in percent. ``None`` where the program counts neither."""

from portbench import program_spans


def read(rec):
    replays = program_spans.counter("proxy.graph_replays") or 0
    eager = program_spans.counter("proxy.graph_eager") or 0
    if replays + eager == 0:
        return None
    return 100.0 * replays / (replays + eager)
