"""ssim_roofline.eval: the SSIM kernel's least time at the eval frame
(portbench/counts.py, bound by bytes) over its device time per launch in the
profiled window, in percent. A launch is one SSIM call of the eval step (one
per frame): the device time of every kernel of the SSIM library in the
window, over the frames."""


def read(rec):
    t = rec.trace
    bound = rec.counts.get("ssim_bound_s")
    if not t or not bound or not t["units"]:
        return None
    busy = sum(s for name, times in t["ops"].items() if "ssim" in name.lower() for s in times)
    if busy <= 0:
        return None
    return 100.0 * bound / (busy / t["units"])
