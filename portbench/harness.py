"""The window loop, the traced pass and the result line of one benchmark run.

Everything that belongs to one configuration, traffic mix or metric lives
in a file of its own, found by name: ``BENCHMARK.json`` names the cell's
configuration file and traffic mix, the mix ``traffic/<name>.json`` names
its driver ``drivers/<driver>.py``, the cell's limits are
``limits/<cell>.json`` and each metric is read by ``metrics/<metric>.py``.
Adding any of them edits no file that is there.

A driver is a class ``Driver(cfg, traffic, limits, seed, device, workdir)``
with ``unit`` ("frame" or "step"), ``setup()`` (build, warm up every shape,
run the checked first steps), ``step(spans)`` (one unit of the timed path,
complete on the host when it returns, as the program's own loop has it),
``sync()``, ``release()`` (drop the program's state once the window has
closed), ``check() -> [(name, value, limit)]`` (the comparison with the
plain reference; a value passes at or under its limit), ``counts()`` (the
operation and byte counts the metric readers use) and ``close()``. A
driver may time the parts of its set-up in a ``setup_split`` dict (seconds
by part), which the result line carries beside the harness's own part.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import statistics
import sys
import tempfile
import threading
import time
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BANNED = ("jax", "jaxlib", "flax", "pnnp_tpu")
PROFILE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module from a file whose name need not be an identifier."""
    spec = importlib.util.spec_from_file_location(f"portbench_{name}".replace(".", "_"), path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def banned_modules() -> list:
    """Loaded modules whose top-level name is one of :data:`BANNED`."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


class Cell:
    """One entry of ``workloads`` with everything found by its names."""

    def __init__(self, bench_file: Path, name: str, root: Path = ROOT):
        bench_file = Path(bench_file)
        self.bench = load_json(bench_file)
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in {bench_file}; known: {sorted(cells)}")
        self.spec = cells[name]
        self.name = name
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.cfg = load_json(bench_file.parent / configs[self.spec["config"]]["file"])
        self.traffic = load_json(root / "traffic" / f"{self.spec['traffic']}.json")
        self.limits = load_json(root / "limits" / f"{name}.json")
        self.driver_cls = load_module(root / "drivers" / f"{self.traffic['driver']}.py",
                                      self.traffic["driver"]).Driver
        self.root = root

    def _applies(self, metric: dict) -> bool:
        return self.name in metric.get("workloads", [self.name])

    def metrics(self, trace: bool) -> list:
        """The cell's end-to-end metrics, or with ``trace`` its per-layer ones."""
        if not trace:
            return [m for m in self.bench["end_to_end"] if self._applies(m)]
        e2e = {m["name"] for m in self.metrics(False)}
        return [m for m in self.bench["per_layer"]
                if self._applies(m) and m["moves"] in e2e]

    def reader(self, name: str):
        return load_module(self.root / "metrics" / f"{name}.py", name).read


class Spans:
    """Timings of the harness's own spans around the calls into each layer:
    ``host`` spans by the host clock, ``dev`` spans by CUDA events (read
    once the window has closed). Each span is also a profiler range named
    ``portbench.<name>``. Disabled, every span is a no-op."""

    def __init__(self, enabled: bool, cuda: bool):
        self.enabled, self.cuda = enabled, cuda
        self.host_ms: dict = {}
        self._events: dict = {}

    @contextmanager
    def host(self, name: str):
        if not self.enabled:
            yield
            return
        from torch.profiler import record_function

        t = time.perf_counter()
        with record_function(f"portbench.{name}"):
            yield
        self.host_ms.setdefault(name, []).append((time.perf_counter() - t) * 1e3)

    @contextmanager
    def dev(self, name: str):
        if not self.enabled:
            yield
            return
        if not self.cuda:
            with self.host(name):
                yield
            return
        import torch
        from torch.profiler import record_function

        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with record_function(f"portbench.{name}"):
            a.record()
            yield
            b.record()
        self._events.setdefault(name, []).append((a, b))

    def ms(self) -> dict:
        """Every span's times, ms per unit, once the device is synchronised."""
        out = {k: list(v) for k, v in self.host_ms.items()}
        for name, pairs in self._events.items():
            out[name] = [a.elapsed_time(b) for a, b in pairs]
        return out


OFF = Spans(False, False)


class Phases:
    """Seconds of the parts of a driver's set-up, each ended by ``sync``."""

    def __init__(self, sync):
        self.sync, self.t, self.split = sync, time.perf_counter(), {}

    def mark(self, name: str) -> None:
        self.sync()
        now = time.perf_counter()
        self.split[name] = now - self.t
        self.t = now


class Record:
    """What the metric readers read: the window, its units, the spans, the
    traced pass and the driver's counts."""

    def __init__(self, unit, setup_s, window_s, unit_s, spans, trace, counts):
        self.unit, self.setup_s, self.window_s, self.unit_s = unit, setup_s, window_s, unit_s
        self.units = len(unit_s)
        self.spans, self.trace, self.counts = spans, trace, counts

    def span_mean(self, name):
        v = self.spans.get(name)
        return statistics.fmean(v) if v else None


def window(driver, seconds: float, spans: Spans):
    """Units until ``seconds`` have passed, then a device sync: (window
    seconds, per-unit host seconds)."""
    unit_s = []
    t0 = time.perf_counter()
    end = t0 + seconds
    t = t0
    while t < end:
        driver.step(spans)
        now = time.perf_counter()
        unit_s.append(now - t)
        t = now
    driver.sync()
    return time.perf_counter() - t0, unit_s


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read_trace(path: str) -> dict:
    """Device busy time (the union of kernel, copy and set intervals), the
    window, the device operations by time and the idle gaps by the host span
    they fall in, from a Chrome trace of the profiled pass (times in s)."""
    events = load_json(path)
    events = events.get("traceEvents", events) if isinstance(events, dict) else events
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    marks = [e for e in spans if e.get("cat") == "user_annotation"]
    win = [e for e in marks if e.get("name") == "portbench.window"]
    if not win:
        raise RuntimeError("the trace has no portbench.window range")
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    dev = [e for e in spans if e.get("cat") in PROFILE_KINDS]
    ivals = _union([(max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in dev
                    if e["ts"] < w1 and e["ts"] + e["dur"] > w0])
    busy = sum(b - a for a, b in ivals)
    by_op: dict = {}
    for e in dev:
        by_op.setdefault(e["name"][:160], []).append(e["dur"] * 1e-6)
    host = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in marks
                   if e.get("name", "").startswith("portbench.")
                   and e["name"] != "portbench.window"), key=lambda r: r[1] - r[0])
    gaps: dict = {}
    edges = [w0] + [x for iv in ivals for x in iv] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        # the innermost harness span the gap's middle falls in
        name = next((n[len("portbench."):] for s, t, n in host if s <= mid <= t), "outside spans")
        gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-6
    return {"busy_s": busy * 1e-6, "window_s": (w1 - w0) * 1e-6, "ops": by_op,
            "device_ops": sorted(([k, sum(v)] for k, v in by_op.items()),
                                 key=lambda r: -r[1])[:10],
            "idle_gaps": sorted(([k, v] for k, v in gaps.items()), key=lambda r: -r[1])[:10]}


def profile(driver, units: int, workdir: str) -> dict:
    """A bounded traced pass of ``units`` units after the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

    driver.sync()
    spans = Spans(True, True)
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("portbench.window"):
            for _ in range(units):
                driver.step(spans)
            driver.sync()
    path = os.path.join(workdir, "trace.json")
    prof.export_chrome_trace(path)
    try:
        trace = read_trace(path)
    finally:
        os.remove(path)
    trace["units"] = units
    return trace


def device_info(torch, dev) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1}


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reads it, or "unknown"."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "unknown"


def _join_threads(before, timeout=30.0):
    """Wait for threads the run started (the loaders' workers)."""
    end = time.perf_counter() + timeout
    for t in threading.enumerate():
        if t not in before and t is not threading.current_thread():
            t.join(max(0.0, end - time.perf_counter()))


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        control: bool = False) -> tuple:
    """One run of ``cell``: (result line as a dict, checks)."""
    import torch

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    threads = set(threading.enumerate())
    workdir = tempfile.mkdtemp(prefix="portbench-")
    if cuda:  # the context, apart from the driver's set-up
        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)
    t_driver = time.perf_counter()
    driver = cell.driver_cls(cell.cfg, cell.traffic, cell.limits, seed, dev, workdir)
    try:
        if control:
            driver.use_control()
        driver.setup()
        driver.sync()
        setup_s = time.perf_counter() - t_start
        split = {"imports_context_s": t_driver - t_start,
                 **getattr(driver, "setup_split", {})}
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        spans = Spans(trace, cuda)
        window_s, unit_s = window(driver, seconds, spans)
        span_ms = spans.ms()
        traced = profile(driver, int(cell.traffic["profile_units"]), workdir) \
            if trace and cuda else None
        mem = torch.cuda.max_memory_allocated(dev) if cuda else 0
        found = banned_modules()
        if found:
            raise RuntimeError(f"modules loaded in the run: {', '.join(found)}")
        counts = driver.counts()
        counters = driver.counters() if hasattr(driver, "counters") else {}
        driver.release()
        checks = driver.check()
    finally:
        driver.close()
        _join_threads(threads)
        import shutil

        shutil.rmtree(workdir, ignore_errors=True)
    rec = Record(driver.unit, setup_s, window_s, unit_s, span_ms, traced, counts)
    metrics = {}
    for m in cell.metrics(trace):
        value = cell.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = device_info(torch, dev)
    device["memory_peak_bytes"] = int(mem)
    device["power_limit"] = power_limit() if cuda else "none"
    line = {"correct": all(math.isfinite(v) and v <= lim for _, v, lim in checks),
            "attempted": len(unit_s), "failed": 0, "metrics": metrics, "device": device}
    if traced is not None:
        device["busy_s"] = traced["busy_s"]
        device["window_s"] = traced["window_s"]
        line["breakdown"] = {"device_ops": traced["device_ops"],
                             "idle_gaps": traced["idle_gaps"]}
    line["setup_split"] = split
    if counters:
        line["counters"] = counters
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return line, checks


def setup_env(checkout: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout, before
    torch is imported."""
    cache = checkout / ".portbench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
