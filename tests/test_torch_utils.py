"""The port's small utilities against the JAX package, on the CPU:
``utils/video.py`` (index windows exact, gathers to atol 1e-6),
``utils/debugger.py`` (the default algorithm's output to atol 1e-6, the
contact sheets written) and ``utils/profiling.py`` (a torch.profiler trace
written to its logdir, a span named in it; the tracer's own tests are in
tests/test_torch_tracing.py)."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnnp_tpu.utils import debugger as jdbg
from pnnp_tpu.utils import video as jvideo
from pnnp_tpu_torch.utils import debugger as tdbg
from pnnp_tpu_torch.utils import profiling as tprof
from pnnp_tpu_torch.utils import video as tvideo


@pytest.mark.parametrize("nframes,pad,reflect,total", [
    (1, True, True, 7), (3, True, True, 7), (5, True, False, 7), (3, False, True, 7),
    (7, True, True, 3), (5, False, False, 9)])
def test_frame_index_splitor_matches_jax(nframes, pad, reflect, total):
    np.testing.assert_array_equal(
        tvideo.frame_index_splitor(nframes, pad, reflect, total),
        jvideo.frame_index_splitor(nframes, pad, reflect, total))


@pytest.mark.parametrize("gt,keepdims", [(False, False), (True, False), (True, True)])
def test_multi_frame_gather_matches_jax(gt, keepdims):
    clip = np.random.default_rng(0).uniform(0, 1, (2, 7, 4, 5, 3)).astype(np.float32)
    index = jvideo.frame_index_splitor(3, True, True, 7)
    got = tvideo.multi_frame_gather(torch.from_numpy(clip), index, gt=gt, keepdims=keepdims)
    ref = jvideo.multi_frame_gather(jnp.asarray(clip), index, gt=gt, keepdims=keepdims)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


@pytest.mark.parametrize("d,eps", [(5, 0.01), (9, 1e-3)])
def test_debugger_default_algo_matches_jax(d, eps):
    p = np.random.default_rng(1).uniform(0, 1, (12, 14, 3)).astype(np.float32)
    np.testing.assert_allclose(tdbg._default_algo(p, d, eps), jdbg._default_algo(p, d, eps),
                               rtol=0, atol=1e-6)


def test_debugger_writes_contact_sheets(tmp_path):
    img = np.random.default_rng(2).uniform(0, 1, (16, 16, 3)).astype(np.float32)
    dbg = tdbg.AlgoDebugger()
    paths = dbg.debug([img], out_dir=str(tmp_path / "t"), steps=3)
    ref = jdbg.AlgoDebugger().debug([img], out_dir=str(tmp_path / "j"), steps=3)
    assert [os.path.basename(p) for p in paths] == [os.path.basename(p) for p in ref] \
        == ["Show_d.jpg", "Show_eps.jpg"]
    assert all(os.path.getsize(p) > 0 for p in paths)
    # a custom algo on a torch image, the schema's 'func' applied
    seen = []
    dbg = tdbg.AlgoDebugger({"algo": lambda x, k: seen.append(k) or x * 0 + k / 10,
                             "trackbar": {"k": {"default": 1, "max_num": 8,
                                                "func": lambda v: v + 1}}})
    dbg.debug([torch.from_numpy(img)], out_dir=str(tmp_path / "c"), steps=3)
    assert seen == [1, 5, 9]


def test_device_trace_writes_annotated_trace(tmp_path):
    logdir = tmp_path / "trace"
    with tprof.device_trace(str(logdir)):
        with tprof.span("pnnp_region"):
            (torch.ones(64) * 2).sum()
    files = [f for f in os.listdir(logdir) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    with open(logdir / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "pnnp_region" for e in events)
