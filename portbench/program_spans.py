"""What the per-layer readers of ``source: program_span`` take from the
program's own tracer (``pnnp_tpu_torch.utils.profiling``): the spans and
counters it recorded, which it does only while a profiler records, so only
in a run's traced pass. Each reader averages over the spans recorded there,
not over the window's units: the loader's workers may have begun a few
fetches before the profiler started. A program without the tracer, or a run
without a traced pass, gives nothing, and each reader then returns ``None``.
"""

from __future__ import annotations

import statistics


def snapshot():
    """The tracer's spans and counters, or ``None`` without the tracer."""
    try:
        from pnnp_tpu_torch.utils import profiling

        return profiling.snapshot()
    except (ImportError, AttributeError):
        return None


def spans(name: str) -> list:
    """The recorded spans named ``name``."""
    snap = snapshot()
    return [s for s in snap["spans"] if s["name"] == name] if snap else []


def counter(name: str):
    snap = snapshot()
    return snap["counters"].get(name) if snap else None


def wall_ms(s: dict) -> float:
    return (s["t1_ns"] - s["t0_ns"]) * 1e-6


def mean_wall_ms(name: str):
    """The mean host time of the spans named ``name`` (ms), or ``None``."""
    v = spans(name)
    return statistics.fmean(wall_ms(s) for s in v) if v else None


def mean_device_ms(name: str):
    """The mean device time of the device spans named ``name`` (ms), or
    ``None``."""
    v = [s["device_ms"] for s in spans(name) if s["device_ms"] is not None]
    return statistics.fmean(v) if v else None
