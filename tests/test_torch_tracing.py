"""The port's tracer (``pnnp_tpu_torch/utils/profiling.py``) on the CPU:
spans and counters off and on (by ``enable`` and by a ``torch.profiler``
profile, from any thread), parents, thread CPU time and the bounded buffer;
the loader's ``loader.fetch`` / ``loader.wait`` pairs; the ELD dataset's
stage spans inside the fetch and the pack counters; ``device_trace``'s
worker rows and idle-gap attribution; the proxy step's forward and backward
spans; the copy's byte counters."""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pnnp_tpu_torch.data import DataLoader, build_dataset
from pnnp_tpu_torch.models import PixelWiseISOProxy
from pnnp_tpu_torch.train import make_adam
from pnnp_tpu_torch.trainer import Trainer
from pnnp_tpu_torch.trainer_nf import make_proxy_train_step
from pnnp_tpu_torch.utils import profiling as tprof


@pytest.fixture(autouse=True)
def _clean():
    tprof.reset()
    yield
    tprof.reset()


def _by_name(snap, name):
    return [s for s in snap["spans"] if s["name"] == name]


def test_off_records_nothing():
    assert not tprof.tracing()
    assert tprof.span("x", a=1) is tprof.span("y")  # the shared no-op
    with tprof.span("x", device=True):
        tprof.count("c", 3)
    snap = tprof.snapshot()
    assert snap == {"spans": [], "counters": {}, "dropped": 0}


def _nested_work(out):
    with tprof.span("outer", k=1):
        with tprof.span("inner"):
            sum(i * i for i in range(200_000))  # CPU time on this thread
        tprof.count("c")
    out.append(threading.get_native_id())


@pytest.mark.parametrize("how", ["enable", "profiler"])
def test_on_from_a_second_thread(how):
    tids = []
    cm = tprof.enable() if how == "enable" else profile(activities=[ProfilerActivity.CPU])
    with cm:
        assert tprof.tracing()
        t = threading.Thread(target=_nested_work, args=(tids,))
        t.start()
        t.join(30)
        assert not t.is_alive()
    assert not tprof.tracing()
    snap = tprof.snapshot()
    (outer,), (inner,) = _by_name(snap, "outer"), _by_name(snap, "inner")
    assert outer["tid"] == inner["tid"] == tids[0] != threading.get_native_id()
    assert inner["parent"] == outer["id"] and outer["parent"] is None
    assert outer["attrs"] == {"k": 1} and snap["counters"] == {"c": 1}
    assert outer["t0_ns"] <= inner["t0_ns"] < inner["t1_ns"] <= outer["t1_ns"]
    assert 0 < inner["cpu_ns"] <= outer["cpu_ns"]
    assert inner["cpu_ns"] <= (inner["t1_ns"] - inner["t0_ns"]) * 1.05 + 1e6
    assert outer["device_ms"] is None


def test_buffer_is_bounded_and_counts_what_it_drops():
    with tprof.enable():
        for i in range(tprof.CAPACITY + 3):
            with tprof.span("s", i=i):
                pass
    snap = tprof.snapshot()
    assert len(snap["spans"]) == tprof.CAPACITY and snap["dropped"] == 3
    assert snap["spans"][0]["attrs"] == {"i": 3}  # the oldest went first
    tprof.reset()
    assert tprof.snapshot() == {"spans": [], "counters": {}, "dropped": 0}


def test_counters_and_spans_lose_no_update_across_threads():
    n_threads, n = 32, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n):
                with tprof.span("w"):
                    tprof.count("hits")
                    tprof.count("bytes", 7)

        with tprof.enable():
            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    snap = tprof.snapshot()
    assert snap["counters"] == {"hits": n_threads * n, "bytes": 7 * n_threads * n}
    spans = _by_name(snap, "w")
    assert len(spans) == n_threads * n and all(s["parent"] is None for s in spans)
    assert len({s["id"] for s in spans}) == len(spans)


class _Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        time.sleep(0.002)
        return {"x": np.full((1, 4, 4, 4), i, np.float32), "name": f"f{i}"}


@pytest.mark.parametrize("workers", [2, 0])
def test_loader_pairs_each_fetch_with_its_wait(workers):
    loader = DataLoader(_Items(7), batch_size=1, shuffle=False, num_workers=workers)
    with tprof.enable():
        for _ in range(2):  # two passes
            got = []
            for b in loader:
                got.append(int(b["x"][0, 0, 0, 0]))
                if len(got) == 1:
                    time.sleep(0.3)  # the workers build ahead of the next ask
            assert got == list(range(7))
    snap = tprof.snapshot()
    fetch, wait = _by_name(snap, "loader.fetch"), _by_name(snap, "loader.wait")
    key = lambda s: (s["attrs"]["pass"], s["attrs"]["bi"])
    assert sorted(map(key, fetch)) == sorted(map(key, wait))
    assert len(fetch) == 14 and len({s["attrs"]["pass"] for s in fetch}) == 2
    for w in wait:
        assert w["attrs"]["first"] == (w["attrs"]["bi"] == 0)
        assert w["tid"] == threading.get_native_id()
    if workers:
        assert {f["attrs"]["worker"] for f in fetch} == {0, 1}
        assert all(f["tid"] != threading.get_native_id() for f in fetch)
        assert all(f["attrs"]["worker"] == f["attrs"]["bi"] % 2 for f in fetch)
        after_sleep = [w for w in wait if w["attrs"]["bi"] == 1]
        assert all(w["attrs"]["ready"] and w["attrs"]["built"] >= 1 for w in after_sleep)
    else:
        by_id = {w["id"]: w for w in wait}
        assert all(key(by_id[f["parent"]]) == key(f) for f in fetch)
        assert not any(w["attrs"]["ready"] for w in wait)


def _eld_dataset(tmp_path):
    from portbench import data

    cfg = json.load(open(os.path.join(os.path.dirname(__file__), "..", "portbench",
                                      "configs", "sony_pnnp_unet32.json")))
    dst = dict(cfg["dst_eval"], H=64, W=96)
    tree = data.eld_tree(str(tmp_path / "eld"), 1, 64, 96, dst["iso_list"], dst["ratio_list"],
                         float(dst["wp"]), float(dst["bl"]), data.generator(5, "cpu", 1),
                         torch.device("cpu"), 0.00095, 0.125)
    return build_dataset(dict(dst, root_dir=tree["root"], ds_dir=tree["ds_dir"],
                              infos_dir=tree["infos_dir"], bias_dir=None), seed=5)


STAGES = ("eld.read", "eld.darkshade", "eld.pack", "eld.scale_clip", "loader.collate")


def test_eld_stages_and_collate_nest_inside_the_fetch(tmp_path):
    ds = _eld_dataset(tmp_path)
    with tprof.enable():
        frames = list(DataLoader(ds, batch_size=1, shuffle=False, num_workers=2))
    snap = tprof.snapshot()
    n = len(ds)
    assert len(frames) == n == 6
    fetch = {s["id"]: s for s in _by_name(snap, "loader.fetch")}
    assert len(fetch) == n
    for name in STAGES:
        stages = _by_name(snap, name)
        assert len(stages) == n, name
        for s in stages:
            f = fetch[s["parent"]]
            assert s["tid"] == f["tid"] and f["t0_ns"] <= s["t0_ns"] <= s["t1_ns"] <= f["t1_ns"]
    assert {s["attrs"]["iso"] for s in _by_name(snap, "eld.darkshade")} == {800, 1600, 3200}
    c = snap["counters"]
    assert c.get("pack.native", 0) + c.get("pack.numpy", 0) == 2 * n


def _main_work(tmp_path):
    def worker():
        with tprof.span("test.worker", job=1):
            time.sleep(0.03)

    with tprof.span("test.main"):
        t = threading.Thread(target=worker, name="test-worker")
        t.start()
        t.join(30)
        assert not t.is_alive()
        (torch.ones(64) * 2).sum()


def test_device_trace_adds_worker_rows_and_attributes_idle(tmp_path):
    logdir = tmp_path / "trace"
    with tprof.device_trace(str(logdir)) as tr:
        _main_work(tmp_path)
    files = [f for f in os.listdir(logdir) if f.endswith(".pt.trace.json")]
    assert [os.path.join(logdir, f) for f in files] == [tr.path]
    with open(tr.path) as f:
        events = json.load(f)["traceEvents"]
    anchor = next(e for e in events if e.get("name") == tprof.ANCHOR and e.get("ph") == "X")
    main = next(e for e in events if e.get("name") == "test.main" and e.get("ph") == "X")
    (work,) = [e for e in events if e.get("name") == "test.worker"]
    assert main["tid"] == anchor["tid"] != work["tid"] and work["pid"] == anchor["pid"]
    assert work["cat"] == "pnnp_span" and work["args"]["job"] == "1"
    assert {"ph": "M", "name": "thread_name", "pid": anchor["pid"], "tid": work["tid"],
            "args": {"name": "test-worker"}} in events
    # on the profiler's clock, inside the anchor and the main thread's span
    slack = abs(tr.skew_us) + 50.0
    assert anchor["ts"] - slack <= main["ts"] <= work["ts"]
    assert work["ts"] + work["dur"] <= main["ts"] + main["dur"] + slack
    assert main["ts"] + main["dur"] <= anchor["ts"] + anchor["dur"] + slack
    assert 25e3 <= work["dur"] <= main["dur"] + slack
    # no device here: the window is one idle gap, put down to the open spans
    assert tr.window_s == pytest.approx(anchor["dur"] * 1e-6)
    assert [g["span"] for g in tr.idle_gaps] == ["test.main"]
    assert tr.idle_gaps[0]["workers"] == ["test.worker"]
    assert tr.idle_by_span[0][0] == "test.main"


def test_proxy_step_records_forward_and_backward():
    proxy = PixelWiseISOProxy(d=16, nf=4, nb=2, generator=torch.Generator().manual_seed(3))
    step = make_proxy_train_step(proxy, lambda e: 1e-3)
    opt = make_adam(proxy.parameters())
    g = torch.Generator().manual_seed(0)
    lr = torch.randn((1, 4, 16, 16), generator=g) * 3 / 15871.0
    args = (lr, torch.zeros_like(lr), torch.ones(1), torch.full((1,), 800.0))
    step(opt, *args, 0)
    assert tprof.snapshot()["spans"] == []
    with tprof.enable():
        for e in range(2):
            step(opt, *args, e)
    snap = tprof.snapshot()
    fwd, bwd = _by_name(snap, "proxy.forward"), _by_name(snap, "proxy.backward")
    assert len(fwd) == len(bwd) == 2
    for f, b in zip(fwd, bwd):  # the host times stand in for the events here
        assert f["t1_ns"] <= b["t0_ns"] and f["parent"] is None and b["parent"] is None
        assert f["device_ms"] == pytest.approx((f["t1_ns"] - f["t0_ns"]) * 1e-6)
        assert b["device_ms"] > 0
    assert snap["counters"]["proxy.chunks"] >= 2


def test_to_device_counts_pageable_bytes():
    owner = Trainer.__new__(Trainer)
    owner.device = torch.device("cpu")
    a = np.ones((1, 8, 8, 4), np.float32)
    owner._to_device(a)
    assert tprof.snapshot()["counters"] == {}
    with tprof.enable():
        t = owner._to_device(a)
        owner._to_device(a[..., :2])  # a strided view: its contiguous copy's bytes
    assert torch.equal(t, torch.ones(1, 8, 8, 4))
    assert tprof.snapshot()["counters"] == {"h2d.bytes": 1536, "h2d.pageable_bytes": 1536}
