"""The proxy NLL step's route between its CUDA graphs and the eager step,
on the CPU (``trainer_nf.py::NoiseStep``; the graphs themselves run on the
card, tests/test_torch_cuda_proxy_graph.py).

* On the CPU and in float64 the step stays eager, counts
  ``proxy.graph_eager`` and gives the eager step's numbers bit for bit.
* With the input rule forced open and the graphs replaced by a stand-in
  that runs the loss eagerly: a step of ``make_nf_train_step`` never
  captures, nor does a proxy whose masked means are a data group's
  (``data_mean``, as ``ShardedNoiseStep`` binds it); a proxy step warms up
  at the first call of an input key, captures at the second, replays after,
  and captures anew at a new key.
* A patch of ``NoiseStep.forward_backward`` on the class, as
  ``portbench/faults.py`` makes one, still replaces the whole step.
* Replays count the kernels' launches their graph holds; the benchmark's
  ``graph_share.proxy`` reads the counters.
"""

import pytest
import torch

import pnnp_tpu_torch.trainer_nf as NF
from pnnp_tpu_torch.kernels import proxy_core
from pnnp_tpu_torch.models import NoiseFlow, PixelWiseISOProxy
from pnnp_tpu_torch.models.proxy import QuantileHead
from pnnp_tpu_torch.train import apply_scaled_updates, make_adam
from pnnp_tpu_torch.trainer_nf import make_nf_train_step, make_proxy_train_step
from pnnp_tpu_torch.utils import profiling

SPAN = 16383.0 - 512.0
NF_ARCH = "sdn|unc|unc|unc|unc|giso|unc|unc|unc|unc"


@pytest.fixture(autouse=True)
def _clean_tracer():
    profiling.reset()
    yield
    profiling.reset()


def _proxy(dtype=torch.float32, **kw):
    return PixelWiseISOProxy(d=16, nf=4, nb=2, generator=torch.Generator().manual_seed(3),
                             **kw).to(dtype)


def _batch(seed, h=16, w=16, dtype=torch.float32, iso=800.0):
    g = torch.Generator().manual_seed(seed)
    lr = (torch.randn((1, 4, h, w), generator=g, dtype=torch.float64) * 3 / SPAN).to(dtype)
    return (lr, torch.zeros_like(lr), torch.ones(1, dtype=dtype),
            torch.full((1,), iso, dtype=dtype))


def _eager_step(step, opt, batch, epoch):
    """The step as the eager code runs it: loss, backward, Adam."""
    opt.zero_grad(set_to_none=True)
    loss, metrics = step.loss_fn(*batch)
    loss.backward()
    apply_scaled_updates(opt, float(step.lr_schedule(epoch)), step.clip_norm)
    return {k: v.detach() for k, v in metrics.items()}


def _graph_counters() -> dict:
    return {k: v for k, v in profiling.snapshot()["counters"].items()
            if ".graph_" in k}


def _same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


class _StandIn:
    """The graphs' stand-in on the CPU: records each capture's input shapes
    and runs the loss eagerly at each replay."""

    built: list = []

    def __init__(self, model, loss_fn, inputs):
        self.loss_fn = loss_fn
        _StandIn.built.append(tuple(tuple(t.shape) for t in inputs))

    def forward(self, inputs):
        self.loss, self.out = self.loss_fn(*inputs)

    def backward(self):
        self.loss.backward()

    def metrics(self):
        return {k: v.detach().clone() for k, v in self.out.items()}


@pytest.fixture()
def graphs_open(monkeypatch):
    """Every input passes the graphs' rule; the graphs are the stand-in."""
    monkeypatch.setattr(NF, "_graph_inputs", lambda inputs: True)
    monkeypatch.setattr(NF, "_StepGraphs", _StandIn)
    _StandIn.built = []
    return _StandIn


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_and_float64_steps_stay_eager(dtype):
    """Three steps from the same weights: the step's metrics, gradients,
    parameters and Adam moments equal the eager code's bit for bit, and
    every step counts as eager."""
    sides = {}
    for side in ("step", "eager"):
        proxy = _proxy(dtype)
        step = make_proxy_train_step(proxy, lambda e: 1e-3)
        opt = make_adam(proxy.parameters())
        assert step.capturable
        out = []
        with profiling.enable():
            for k in range(3):
                b = _batch(k, dtype=dtype, iso=(800.0, 3200.0, 12800.0)[k])
                m = step(opt, *b, 1) if side == "step" else _eager_step(step, opt, b, 1)
                out.append(({k: v for k, v in m.items() if k != "lr"},
                            {n: p.grad.clone() for n, p in proxy.named_parameters()}))
        state = {n: (p.detach().clone(), opt.state[p]["exp_avg"].clone(),
                     opt.state[p]["exp_avg_sq"].clone()) for n, p in proxy.named_parameters()}
        sides[side] = out, state, profiling.snapshot()["counters"]
        profiling.reset()
    (out_s, state_s, counters), (out_e, state_e, _) = sides["step"], sides["eager"]
    for (m_s, g_s), (m_e, g_e) in zip(out_s, out_e):
        _same(m_s, m_e)
        _same(g_s, g_e)
    for n in state_e:
        assert all(torch.equal(a, b) for a, b in zip(state_s[n], state_e[n])), n
    assert counters["proxy.graph_eager"] == 3
    assert "proxy.graph_captures" not in counters and "proxy.graph_replays" not in counters


def test_a_number_s_and_a_tensor_s_give_the_same_bits():
    """``log_prob_conv_gaussian`` makes a numeric ``s`` on the device by a
    fill: the same law as the tensor of that number."""
    proxy = _proxy()
    _, hp, _ = proxy.heads(torch.full((1,), 1600.0), 1)
    x = torch.randn((1, 4, 8, 8), generator=torch.Generator().manual_seed(1)) * 3
    a = QuantileHead.log_prob_conv_gaussian(hp, x, 0.3)
    b = QuantileHead.log_prob_conv_gaussian(hp, x, torch.tensor(0.3))
    assert torch.equal(a, b)


def test_nf_step_never_captures(graphs_open):
    nf = NoiseFlow(NF_ARCH, generator=torch.Generator().manual_seed(4))
    step = make_nf_train_step(nf, lambda e: 1e-4)
    opt = make_adam(nf.parameters())
    assert not step.capturable
    g = torch.Generator().manual_seed(0)
    hr = torch.rand((1, 4, 8, 8), generator=g) * 0.01
    lr = hr + torch.randn((1, 4, 8, 8), generator=g) * 1e-3
    with profiling.enable():
        for _ in range(3):
            m = step(opt, lr, hr, torch.ones(1), torch.full((1,), 1600.0), 1)
            assert torch.isfinite(m["nll"])
    counters = profiling.snapshot()["counters"]
    assert graphs_open.built == []
    assert counters["nf.graph_eager"] == 3 and "nf.graph_captures" not in counters


def test_a_data_group_mean_forces_the_eager_step(graphs_open):
    """A ``data_mean`` bound as ``ShardedNoiseStep`` binds it (a collective
    inside the loss) keeps every step eager; unbound, the step warms up,
    captures and replays."""
    proxy = _proxy()
    step = make_proxy_train_step(proxy, lambda e: 1e-3)
    opt = make_adam(proxy.parameters())
    proxy.data_mean = lambda t: t
    with profiling.enable():
        for k in range(3):
            step(opt, *_batch(k), 1)
    assert graphs_open.built == []
    assert _graph_counters() == {"proxy.graph_eager": 3}
    profiling.reset()
    proxy.data_mean = None
    with profiling.enable():
        for k in range(3):
            step(opt, *_batch(k), 1)
    assert graphs_open.built == [((1, 4, 16, 16), (1, 4, 16, 16), (1,), (1,))]
    assert _graph_counters() == {
        "proxy.graph_eager": 1, "proxy.graph_captures": 1, "proxy.graph_replays": 2}


def test_graphs_are_cached_by_input_key(graphs_open):
    """Keys A A A B B A: a warm-up and a capture at each, replays after; the
    replayed route gives the eager step's numbers and spans."""
    sides = {}
    shapes = [16, 16, 16, 8, 8, 16]
    for side in ("graphed", "eager"):
        proxy = _proxy()
        step = make_proxy_train_step(proxy, lambda e: 1e-3)
        step.capturable = side == "graphed"
        opt = make_adam(proxy.parameters())
        with profiling.enable():
            ms = [step(opt, *_batch(k, h=h), 1) for k, h in enumerate(shapes)]
        snap = profiling.snapshot()
        snap["graph"] = _graph_counters()
        sides[side] = ms, {n: p.detach().clone() for n, p in proxy.named_parameters()}, snap
        profiling.reset()
    (ms_g, p_g, snap), (ms_e, p_e, _) = sides["graphed"], sides["eager"]
    for a, b in zip(ms_g, ms_e):
        assert a.pop("lr") == b.pop("lr")
        _same(a, b)
    _same(p_g, p_e)
    assert [s[0][2] for s in graphs_open.built] == [16, 8]
    assert snap["graph"] == {
        "proxy.graph_eager": 2, "proxy.graph_captures": 2, "proxy.graph_replays": 4}
    names = [s["name"] for s in snap["spans"]]
    assert names == ["proxy.forward", "proxy.backward"] * len(shapes)


def test_the_iso_curvature_penalty_is_not_capturable():
    """Its ISO grid is a copy from the host, which a graph cannot capture."""
    assert not make_proxy_train_step(_proxy(smooth_iso_w=0.1), lambda e: 1e-3).capturable


def test_a_class_patch_of_forward_backward_replaces_the_step(graphs_open):
    """``portbench/faults.py``'s ``half`` patches ``NoiseStep.forward_backward``
    on the class: the step's loss is then the first half of the rows', on
    the graphed route as on the eager one."""
    from portbench import faults

    proxy = _proxy()
    step = make_proxy_train_step(proxy, lambda e: 0.0)
    opt = make_adam(proxy.parameters())
    with faults.half():
        for k in range(3):
            b = _batch(k)
            with torch.no_grad():
                half, _ = step.loss_fn(b[0][:, :, :8], b[1][:, :, :8], b[2], b[3])
            m = step(opt, *b, 1)
            assert torch.equal(m["nll"], half)
    assert graphs_open.built == [((1, 4, 8, 16), (1, 4, 8, 16), (1,), (1,))]


def test_replays_count_the_launches_their_graph_holds():
    before = dict(proxy_core.launches_by_kernel), proxy_core.launches
    with proxy_core.holding() as outer:
        with proxy_core.holding() as inner:
            assert proxy_core._HELD == [outer, inner] and inner is not outer
        assert proxy_core._HELD == [outer]
    assert proxy_core._HELD == []
    with profiling.enable():
        for _ in range(3):
            proxy_core.replayed({"fwd": 2, "bwd": 0})
        proxy_core.replayed({"fwd": 0, "bwd": 2})
    assert profiling.snapshot()["counters"] == {"proxy.core_fwd": 6, "proxy.core_bwd": 2}
    assert proxy_core.launches == before[1] + 8
    assert proxy_core.launches_by_kernel == {"fwd": before[0]["fwd"] + 6,
                                             "bwd": before[0]["bwd"] + 2}


def test_graph_share_reads_the_counters():
    from portbench.harness import ROOT, load_module

    read = load_module(ROOT / "metrics" / "graph_share.proxy.py", "graph_share.proxy").read
    assert read(None) is None
    with profiling.enable():
        profiling.count("proxy.graph_replays", 3)
    assert read(None) == 100.0
    with profiling.enable():
        profiling.count("proxy.graph_eager")
    assert read(None) == 75.0
