"""fetch_cpu_share.eval: the thread CPU time of the program's ``loader.fetch``
spans over their host time, summed over the traced pass (%): the rest is the
workers' wait for the interpreter lock, the disk or the scheduler."""

from portbench import program_spans


def read(rec):
    v = program_spans.spans("loader.fetch")
    wall = sum(program_spans.wall_ms(s) for s in v)
    return 100.0 * sum(s["cpu_ns"] for s in v) * 1e-6 / wall if wall > 0 else None
