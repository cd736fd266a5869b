"""Profiling instruments (counterpart of ``pnnp_tpu/utils/profiling.py``):
``fn_timer`` and device-trace hooks.

Replaces the reference's hand-rolled accumulating decorator (reference:
utils/utils.py:56-71). :func:`device_trace` is a ``torch.profiler`` trace
of the host and, where there is one, the card (CUPTI), written to ``logdir``
as a Chrome/TensorBoard trace; :func:`annotate` names a region in it
(``torch.profiler.record_function``, plus an NVTX range on the card: the
counterpart of ``jax.profiler.TraceAnnotation``).
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from collections import defaultdict

_TOTALS: dict = defaultdict(float)
_TOTALS_LOCK = threading.Lock()
_COUNTS: dict = defaultdict(int)


def fn_timer(fn):
    """Accumulate total wall time per function; report with print_fn_timers."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            dt = time.perf_counter() - t0
            with _TOTALS_LOCK:  # loader worker threads share these
                _TOTALS[fn.__qualname__] += dt
                _COUNTS[fn.__qualname__] += 1

    return wrapper


def print_fn_timers():
    for name in sorted(_TOTALS, key=_TOTALS.get, reverse=True):
        print(f"{name}: total {_TOTALS[name]:.3f}s over {_COUNTS[name]} calls")


def reset_fn_timers():
    _TOTALS.clear()
    _COUNTS.clear()


@contextlib.contextmanager
def device_trace(logdir: str = "traces/pnnp_trace"):
    """Trace the block with ``torch.profiler`` (CPU, and CUDA when a card is
    present) and write it to ``logdir`` (``*.pt.trace.json``, for
    TensorBoard's profiler plugin or chrome://tracing). Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


@contextlib.contextmanager
def annotate(name: str):
    """Named region in device traces: a ``record_function`` range, and an
    NVTX range when a card is present."""
    import torch

    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()
