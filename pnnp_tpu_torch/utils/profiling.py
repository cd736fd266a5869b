"""The program's tracer and the device trace (counterpart of
``pnnp_tpu/utils/profiling.py``).

:func:`span` names a region of the program's work and :func:`count` adds to
a named counter; :func:`count_device` adds a count that only the device
knows yet (a 0-dim integer tensor), read when :func:`snapshot` is. All three
record only while tracing is on: while :func:`enable`
is in force, or while a ``torch.profiler`` profile records. The second reads
``torch.autograd.profiler._is_profiler_enabled``, one module attribute that
every thread sees, the data loader's workers included. Off, a span costs that
read and returns a shared no-op context: it reads no clock, allocates no
record and opens no profiler range.

A recorded span holds its name, thread, start and end on
``time.perf_counter_ns``, the thread CPU time it spent, its parent (the
innermost span open on the same thread when it opened) and its attributes.
Records go to a bounded in-memory buffer (:data:`CAPACITY` entries, the
oldest dropped and counted); :func:`snapshot` reads it with the counters and
:func:`reset` clears both. A span opened with ``device=True`` also records
two CUDA events on the current stream, read only by :func:`snapshot` (after
the caller's sync); without a CUDA context it keeps the host times.

While a profiler records, a span on the profiler's thread also opens a
``record_function`` range of the same name (and an NVTX range on the card),
so it sits in the Chrome trace beside the device's kernels and copies, on
the profiler's clock. The profiler does not record ranges opened in other
threads, so :func:`device_trace` appends those threads' spans to the file it
writes, converted to the profiler's clock through an anchor span recorded in
both, and puts each device idle gap of its window down to the spans open in
it.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import socket
import threading
import time
from collections import deque

import torch
from torch.autograd import profiler as _autograd_profiler

CAPACITY = 65536
ANCHOR = "pnnp.trace_anchor"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")

_LOCK = threading.Lock()
_RECORDS: deque = deque(maxlen=CAPACITY)
_COUNTERS: dict = {}
_PENDING: list = []  # (counter, 0-dim device tensor) of count_device, unread
_DROPPED = [0]
_FORCED = [0]
_IDS = itertools.count(1)
_TLS = threading.local()
# the thread whose record_function ranges the profiler records
_PROFILER_THREAD = [threading.main_thread().ident]
_NULL = contextlib.nullcontext()


def tracing() -> bool:
    """True while spans and counters record."""
    return bool(_FORCED[0] or _autograd_profiler._is_profiler_enabled)


@contextlib.contextmanager
def enable():
    """Record spans and counters inside the block, profiler or not."""
    with _LOCK:
        _FORCED[0] += 1
    try:
        yield
    finally:
        with _LOCK:
            _FORCED[0] -= 1


class _Span:
    __slots__ = ("name", "attrs", "device", "id", "parent", "tid", "thread", "t0", "t1",
                 "cpu_ns", "events", "device_ms", "_rf", "_nvtx", "_cpu0")

    def __init__(self, name: str, device: bool, attrs: dict):
        self.name, self.device, self.attrs = name, device, attrs
        self.events = self.device_ms = self._rf = None
        self._nvtx = False

    def __enter__(self):
        stack = getattr(_TLS, "stack", None)
        if stack is None:
            stack = _TLS.stack = []
        self.id = next(_IDS)
        self.parent = stack[-1] if stack else None
        stack.append(self.id)
        self.tid = threading.get_native_id()
        self.thread = threading.current_thread().name
        # the host interval encloses the profiler's range: the range takes its
        # start early in its (at first slow) entry
        self._cpu0 = time.thread_time_ns()
        self.t0 = time.perf_counter_ns()
        if (_autograd_profiler._is_profiler_enabled
                and threading.get_ident() == _PROFILER_THREAD[0]):
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        if torch.cuda.is_initialized():
            torch.cuda.nvtx.range_push(self.name)
            self._nvtx = True
            if self.device:
                self.events = (torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True))
                self.events[0].record()
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record()
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        self.t1 = time.perf_counter_ns()
        self.cpu_ns = time.thread_time_ns() - self._cpu0
        _TLS.stack.pop()
        with _LOCK:
            if len(_RECORDS) == CAPACITY:
                _DROPPED[0] += 1
            _RECORDS.append(self)
        return False

    def record(self) -> dict:
        if self.device_ms is None and self.device:
            if self.events is None:  # no CUDA context: the host times
                self.device_ms = (self.t1 - self.t0) * 1e-6
            else:
                self.events[1].synchronize()
                self.device_ms = self.events[0].elapsed_time(self.events[1])
                self.events = None
        return {"name": self.name, "id": self.id, "parent": self.parent, "tid": self.tid,
                "thread": self.thread, "t0_ns": self.t0, "t1_ns": self.t1,
                "cpu_ns": self.cpu_ns, "device_ms": self.device_ms, "attrs": self.attrs}


def span(name: str, device: bool = False, **attrs):
    """A context manager that records the block as span ``name`` with
    ``attrs`` while tracing is on (``device``: also by CUDA events)."""
    if not (_FORCED[0] or _autograd_profiler._is_profiler_enabled):
        return _NULL
    return _Span(name, device, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while tracing is on."""
    if not (_FORCED[0] or _autograd_profiler._is_profiler_enabled):
        return
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def count_device(name: str, t: torch.Tensor) -> None:
    """Add the value of the 0-dim integer tensor ``t`` to counter ``name``
    while tracing is on. Nothing syncs here: :func:`snapshot` reads ``t``,
    so the caller must not write it again."""
    if not (_FORCED[0] or _autograd_profiler._is_profiler_enabled):
        return
    with _LOCK:
        _PENDING.append((name, t))


def snapshot() -> dict:
    """The recorded spans, oldest first (each a dict: ``name``, ``id``,
    ``parent``, ``tid``, ``thread``, ``t0_ns``, ``t1_ns``, ``cpu_ns``,
    ``device_ms`` for a device span, ``attrs``), the counters and the
    number of spans dropped. Device spans' events and :func:`count_device`'s
    tensors are read here: call it after the work has been synchronised."""
    with _LOCK:
        pending = list(_PENDING)
        _PENDING.clear()
    counts = [(name, int(t)) for name, t in pending]
    with _LOCK:
        for name, k in counts:
            _COUNTERS[name] = _COUNTERS.get(name, 0) + k
        records = list(_RECORDS)
        counters = dict(_COUNTERS)
        dropped = _DROPPED[0]
    return {"spans": [r.record() for r in records], "counters": counters, "dropped": dropped}


def reset() -> None:
    """Clear the recorded spans, the counters and the dropped count."""
    with _LOCK:
        _RECORDS.clear()
        _COUNTERS.clear()
        _PENDING.clear()
        _DROPPED[0] = 0


class DeviceTrace:
    """What :func:`device_trace` yields: ``prof``, the profiler; on exit,
    ``path`` (the Chrome trace), ``skew_us`` (the anchor's duration on the
    profiler's clock less on the host's), ``window_s``, ``idle_gaps`` (each
    device idle gap of the window: ``ts`` and ``dur`` in µs on the
    profiler's clock, ``span``, the innermost program span open at its
    middle on the profiler's thread or ``None``, and ``workers``, the
    innermost span open then on each other thread) and ``idle_by_span``
    (idle seconds by ``span``, largest first)."""

    def __init__(self):
        self.prof = self.path = self.skew_us = self.window_s = None
        self.idle_gaps, self.idle_by_span = [], []


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(spans, t_ns):
    """The innermost of ``spans`` (one thread's) open at ``t_ns``."""
    open_ = [s for s in spans if s["t0_ns"] <= t_ns <= s["t1_ns"]]
    return max(open_, key=lambda s: s["t0_ns"])["name"] if open_ else None


def _annotate_trace(tr: DeviceTrace, anchor: dict, spans: list) -> None:
    """Append the other threads' spans to the Chrome trace at
    ``tr.path`` and attribute the window's device idle gaps."""
    with open(tr.path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    mark = next(e for e in events if e.get("ph") == "X" and e.get("name") == ANCHOR)
    w0, w1 = mark["ts"], mark["ts"] + mark["dur"]
    # profiler µs less host µs, the mean of the anchor's two ends
    offset = 0.5 * (w0 + w1 - (anchor["t0_ns"] + anchor["t1_ns"]) * 1e-3)
    tr.skew_us = mark["dur"] - (anchor["t1_ns"] - anchor["t0_ns"]) * 1e-3
    tr.window_s = mark["dur"] * 1e-6
    inside = [s for s in spans if s["id"] != anchor["id"]
              and s["t1_ns"] >= anchor["t0_ns"] and s["t0_ns"] <= anchor["t1_ns"]]
    main = [s for s in inside if s["tid"] == anchor["tid"]]
    by_thread: dict = {}
    for s in inside:
        if s["tid"] != anchor["tid"]:
            by_thread.setdefault(s["tid"], []).append(s)
    for tid, rows in by_thread.items():
        events.append({"ph": "M", "name": "thread_name", "pid": mark["pid"], "tid": tid,
                       "args": {"name": rows[0]["thread"]}})
        for s in rows:
            events.append({"ph": "X", "cat": "pnnp_span", "name": s["name"],
                           "pid": mark["pid"], "tid": tid, "ts": s["t0_ns"] * 1e-3 + offset,
                           "dur": (s["t1_ns"] - s["t0_ns"]) * 1e-3,
                           "args": {**{k: str(v) for k, v in s["attrs"].items()},
                                    "id": s["id"], "parent": s["parent"],
                                    "cpu_ms": s["cpu_ns"] * 1e-6}})
    with open(tr.path, "w") as f:
        json.dump(trace, f)
    busy = _union([(max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in events
                   if e.get("ph") == "X" and e.get("cat") in DEVICE_KINDS
                   and e["ts"] < w1 and e["ts"] + e["dur"] > w0])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    by_span: dict = {}
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid_ns = (0.5 * (a + b) - offset) * 1e3
        name = _innermost(main, mid_ns)
        workers = [n for n in (_innermost(rows, mid_ns) for rows in by_thread.values()) if n]
        tr.idle_gaps.append({"ts": a, "dur": b - a, "span": name, "workers": workers})
        by_span[name] = by_span.get(name, 0.0) + (b - a) * 1e-6
    tr.idle_by_span = sorted(by_span.items(), key=lambda kv: -kv[1])


@contextlib.contextmanager
def device_trace(logdir: str = "traces/pnnp_trace"):
    """Trace the block with ``torch.profiler`` (CPU, and CUDA when a card is
    present) and write it to ``logdir`` as ``*.pt.trace.json`` (TensorBoard's
    profiler plugin or chrome://tracing), the program's spans of other
    threads added on their own rows. Yields a :class:`DeviceTrace`, filled in
    on exit, and logs the window's idle time by span."""
    from torch.profiler import ProfilerActivity, profile

    from pnnp_tpu_torch.utils.logging import log

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    tr = DeviceTrace()
    prev, _PROFILER_THREAD[0] = _PROFILER_THREAD[0], threading.get_ident()
    try:
        with profile(activities=activities) as prof:
            tr.prof = prof
            with _Span(ANCHOR, False, {}) as anchor:
                yield tr
                if torch.cuda.is_initialized():
                    torch.cuda.synchronize()
    finally:
        _PROFILER_THREAD[0] = prev
    os.makedirs(logdir, exist_ok=True)
    tr.path = os.path.join(
        logdir, f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(tr.path)
    _annotate_trace(tr, anchor.record(), snapshot()["spans"])
    idle = sum(s for _, s in tr.idle_by_span)
    log(f"device_trace {tr.path}: device idle {idle:.4f} of {tr.window_s:.4f} s; "
        + ", ".join(f"{n or 'outside spans'} {s:.4f} s" for n, s in tr.idle_by_span[:6]))
