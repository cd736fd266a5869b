"""mfu.resident: the UNet forward's FLOPs at the padded frame over the profiled
window's time per unit, as a share of the bf16 peak (portbench/counts.py),
in percent."""

from portbench import counts


def read(rec):
    t = rec.trace
    ops = rec.counts.get("flops_per_unit")
    if not t or not ops or not t["units"]:
        return None
    return 100.0 * ops / (t["window_s"] / t["units"]) / counts.PEAK_BF16
