"""idle_share.resident: 1 - the union of the device's kernel, copy and set
intervals over the profiled window, in percent."""


def read(rec):
    t = rec.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
