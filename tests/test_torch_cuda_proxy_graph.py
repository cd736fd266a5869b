"""The proxy NLL step replayed as CUDA graphs, against the eager step.

These tests need an NVIDIA GPU (``cuda`` marker) and skip on a host without
one: a CUDA graph has no CPU mode. This file imports no JAX, so it also
runs on a machine without it:

    python -m pytest tests/test_torch_cuda_proxy_graph.py -m cuda --noconftest -q

``make_proxy_train_step`` at the recipe's shape (one packed 512^2 dark
frame, d = 1024) for 8 steps at ISO 800 / 1600 / 3200 / 12800 in turn from
the same weights, once with its graphs and once eagerly: every step's
metrics and gradients, the parameters and Adam's moments after it are
bit-identical, with and without the gradient clip (which scales the
graph's gradients in place); the counters read 1 capture, 7 replays and 2
launches of each kernel a step. A second input shape captures anew; the
metrics of a step are not overwritten by the next; the profiler sees the
kernels the graphs replay.
"""

import pytest
import torch

from pnnp_tpu_torch.utils import profiling

ISOS = (800.0, 1600.0, 3200.0, 12800.0)
D, SPAN = 1024, 16383.0 - 512.0
HYPER = {"lr_scheduler": "WarmupCosine", "learning_rate": 1e-3, "stop_epoch": 1200,
         "step_size": 10, "T": 2}


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _weights():
    from pnnp_tpu_torch.models import build_proxy

    base = build_proxy({"name": "pw_iso_2stage", "d": D, "nf": 16, "nb": 2},
                       generator=torch.Generator().manual_seed(0))
    return base.state_dict()


def _frames(dev, sizes):
    """Dark frames [1, 4, h, h] of Gaussian read and row noise, a few ADU."""
    g = torch.Generator().manual_seed(1)
    out = []
    for k, h in enumerate(sizes):
        sd = (2.0, 4.0, 3.0, 9.0)[k % 4]
        x = (torch.randn(1, 4, h, h, generator=g) * sd
             + torch.randn(1, 4, h, 1, generator=g) * sd / 4)
        out.append((torch.round(x) / SPAN).to(dev))
    return out


def _run(dev, graphed, frames, clip_norm=None):
    """The steps over ``frames``: per step (metrics, grads, params, Adam
    moments) and the counters."""
    from pnnp_tpu_torch.models import build_proxy
    from pnnp_tpu_torch.train import build_lr_schedule, make_adam
    from pnnp_tpu_torch.trainer_nf import make_proxy_train_step

    proxy = build_proxy({"name": "pw_iso_2stage", "d": D, "nf": 16, "nb": 2}).to(dev)
    proxy.load_state_dict(_weights())
    step = make_proxy_train_step(proxy, build_lr_schedule(HYPER), clip_norm=clip_norm)
    step.capturable = graphed
    opt = make_adam(proxy.parameters())
    ratio = torch.ones(1, device=dev)
    rows = []
    profiling.reset()
    with profiling.enable():
        for k, lr in enumerate(frames):
            iso = torch.full((1,), ISOS[k % len(ISOS)], device=dev)
            m = step(opt, lr, torch.zeros_like(lr), ratio, iso, 1)
            named = list(proxy.named_parameters())
            rows.append((
                {k: v.clone() for k, v in m.items() if k != "lr"},
                {n: p.grad.clone() for n, p in named},
                {n: p.detach().clone() for n, p in named},
                {n: (opt.state[p]["exp_avg"].clone(), opt.state[p]["exp_avg_sq"].clone())
                 for n, p in named}))
    torch.cuda.synchronize(dev)
    counters = profiling.snapshot()["counters"]
    profiling.reset()
    return rows, counters, step


def _identical(rows_a, rows_b):
    assert len(rows_a) == len(rows_b)
    for k, (a, b) in enumerate(zip(rows_a, rows_b)):
        for part in range(3):
            assert a[part].keys() == b[part].keys()
            for n in a[part]:
                assert torch.equal(a[part][n], b[part][n]), (k, part, n)
        for n in a[3]:
            assert torch.equal(a[3][n][0], b[3][n][0]) and torch.equal(a[3][n][1], b[3][n][1]), \
                (k, n)


@pytest.mark.cuda
@pytest.mark.parametrize("clip_norm", [None, 1.0])
def test_graphed_steps_equal_the_eager_steps_bit_for_bit(card, clip_norm):
    frames = _frames(card, [512] * 8)
    graphed, counters, _ = _run(card, True, frames, clip_norm)
    eager, counters_e, _ = _run(card, False, frames, clip_norm)
    _identical(graphed, eager)
    assert counters["proxy.graph_captures"] == 1 and counters["proxy.graph_replays"] == 7
    assert counters["proxy.graph_eager"] == 1
    assert counters["proxy.core_fwd"] == counters["proxy.core_bwd"] == 2 * 8
    assert counters_e["proxy.graph_eager"] == 8 and "proxy.graph_captures" not in counters_e
    assert counters_e["proxy.core_fwd"] == counters_e["proxy.core_bwd"] == 2 * 8
    assert "proxy.chunks" not in counters
    # the replays count the pairs their kernels walked as the eager steps do
    assert counters["proxy.core_pairs"] == counters_e["proxy.core_pairs"]
    assert counters["proxy.core_pairs_walked"] == counters_e["proxy.core_pairs_walked"]
    assert 0 < counters["proxy.core_pairs_walked"] <= counters["proxy.core_pairs"]


@pytest.mark.cuda
def test_a_second_shape_captures_anew(card):
    frames = _frames(card, [512, 512, 256, 256, 256, 512])
    graphed, counters, step = _run(card, True, frames)
    eager, _, _ = _run(card, False, frames)
    _identical(graphed, eager)
    assert counters["proxy.graph_captures"] == 2 and counters["proxy.graph_replays"] == 4
    assert counters["proxy.graph_eager"] == 2
    assert counters["proxy.core_fwd"] == counters["proxy.core_bwd"] == 2 * 6
    assert sorted(k[0][0][0][2] for k, g in step._graphs.items() if g is not None) == [256, 512]


@pytest.mark.cuda
def test_metrics_of_a_step_outlive_the_next(card):
    from pnnp_tpu_torch.models import build_proxy
    from pnnp_tpu_torch.train import build_lr_schedule, make_adam
    from pnnp_tpu_torch.trainer_nf import make_proxy_train_step

    proxy = build_proxy({"name": "pw_iso_2stage", "d": D, "nf": 16, "nb": 2}).to(card)
    proxy.load_state_dict(_weights())
    step = make_proxy_train_step(proxy, build_lr_schedule(HYPER))
    opt = make_adam(proxy.parameters())
    frames = _frames(card, [512] * 5)
    kept = []
    for k, lr in enumerate(frames):
        iso = torch.full((1,), ISOS[k % 4], device=card)
        m = step(opt, lr, torch.zeros_like(lr), torch.ones(1, device=card), iso, 1)
        kept.append((m, {k: float(v) for k, v in m.items() if k != "lr"}))
    graphs = next(g for g in step._graphs.values() if g is not None)
    for m, values in kept:
        assert {k: float(v) for k, v in m.items() if k != "lr"} == values
        assert all(m[k].data_ptr() != graphs.out[k].data_ptr() for k in values)
    assert len({v["nll"] for _, v in kept}) == len(kept)


@pytest.mark.cuda
def test_the_profiler_sees_the_replayed_kernels(card):
    """The benchmark's traced pass reads the device from the profiler: the
    kernels a replay runs reach it as the eager launches do."""
    from torch.profiler import ProfilerActivity, profile

    from pnnp_tpu_torch.models import build_proxy
    from pnnp_tpu_torch.train import build_lr_schedule, make_adam
    from pnnp_tpu_torch.trainer_nf import make_proxy_train_step

    proxy = build_proxy({"name": "pw_iso_2stage", "d": D, "nf": 16, "nb": 2}).to(card)
    step = make_proxy_train_step(proxy, build_lr_schedule(HYPER))
    opt = make_adam(proxy.parameters())
    lr = _frames(card, [512])[0]
    args = (lr, torch.zeros_like(lr), torch.ones(1, device=card),
            torch.full((1,), 3200.0, device=card))
    for _ in range(2):  # the warm-up and the capture
        step(opt, *args, 1)
    torch.cuda.synchronize(card)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            step(opt, *args, 1)
        torch.cuda.synchronize(card)
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    fwd = [e for e in events if "proxy_core_fwd_kernel" in e.name]
    bwd = [e for e in events if "proxy_core_bwd_kernel" in e.name]
    assert len(fwd) == len(bwd) == 2 * 2, sorted({e.name[:60] for e in events})
