"""core_walked_share.proxy: the (value, bin) pairs the proxy NLL's kernel
pair walked in the traced pass, over the pairs of their full grids (the
program's ``proxy.core_pairs_walked`` and ``proxy.core_pairs`` counters), in
percent. ``None`` where the program counts neither."""

from portbench import program_spans


def read(rec):
    pairs = program_spans.counter("proxy.core_pairs")
    walked = program_spans.counter("proxy.core_pairs_walked")
    if not pairs or walked is None:
        return None
    return 100.0 * walked / pairs
