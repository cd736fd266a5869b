"""mfu.proxy: the proxy NLL step's operations over the profiled window's time
per unit, as a share of the float32 peak (portbench/counts.py), in percent."""

from portbench import counts


def read(rec):
    t = rec.trace
    ops = rec.counts.get("ops_per_unit")
    if not t or not ops or not t["units"]:
        return None
    return 100.0 * ops / (t["window_s"] / t["units"]) / counts.PEAK_FP32
