"""The proxy NLL's fused bin-law kernels on the card, against float64.

These tests need an NVIDIA GPU (``cuda`` marker) and skip on a host without
one: a CUDA kernel has no CPU or interpret mode. This file imports no JAX,
so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda_proxy_kernel.py -m cuda --noconftest -q

The kernels' core and knot gradient (``kernels/proxy_core.py``) are held to
the plain ``QuantileHead._core_conv`` and its autograd evaluated in float64
on the card, at the recipe shape (one 512^2 packed frame, d = 1024) and at
small ``d``, across knot tiles, with values far outside the support, ``s``
of 1e-9 and 4000, all-narrow, all-wide and mixed bins, zero-width bins on
the 1e-8 floor and one ``s`` per value (the row head): the core within 1e-5
and the gradient within 5e-4 of their largest magnitudes, and neither
further from float64 than twice the plain f32 path plus 1e-6. Two launches
give the same bits; a value's core is the same bits whatever its block's
values (shuffled, or near and far neighbours: a narrow window and the full
walk); erfc and exp(-r^2) are exactly 0 in f32 from ``REACH`` on; the
counters show the kernels engaged and no chunks, and the pairs walked
(below the full grid at the recipe shape, equal to the plain-torch rule's
count, and the full grid where every value is within reach of every knot);
three ``make_proxy_train_step`` steps on the card follow the CPU's.
"""

import pytest
import torch

from pnnp_tpu_torch.kernels import proxy_core as PC
from pnnp_tpu_torch.models.proxy import HeadParams, QuantileHead
from pnnp_tpu_torch.utils import profiling

# of the largest magnitude; the plain f32 path's own knot gradient reads up
# to 2.9e-4 from float64 at the recipe shape (a wide bin's r and width terms
# cancel), the kernel's up to 1.7e-4
CORE_TOL, GRAD_TOL = 1e-5, 5e-4
RECIPE_M, RECIPE_D = 4 * 512 * 512, 1024


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the proxy core kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _knots(kind, n, d, gen, dev):
    """float64 knots [n, d+1]: 'head' (a softmax law over +-7.4 ADU, the
    recipe's at init, narrow and wide bins mixed at s0 = 0.3), 'narrow'
    (widths up to 2e-3 ADU), 'wide' (0.5-1.5 ADU), 'mixed' (1e-3 or 0.2),
    'zero' (every third bin of width 0), 'floor' (bins of 0 and 5e-9 ADU)."""
    f64 = dict(generator=gen, device=dev, dtype=torch.float64)
    if kind == "head":
        w = torch.softmax(torch.randn(n, d, **f64) * 0.5, -1) * 14.8
    elif kind == "narrow":
        w = torch.rand(n, d, **f64) * 2e-3
    elif kind == "wide":
        w = 0.5 + torch.rand(n, d, **f64)
    elif kind == "mixed":
        w = torch.where(torch.rand(n, d, **f64) < 0.5, 1e-3, 0.2) * (1 + 0.3 * torch.rand(n, d, **f64))
    elif kind == "zero":
        w = torch.where(torch.arange(d, device=dev) % 3 == 1, 0.0, torch.rand(n, d, **f64) * 0.1)
    elif kind == "floor":
        w = torch.where(torch.arange(d, device=dev) % 2 == 0, 0.0, 5e-9).expand(n, d)
    else:
        raise ValueError(kind)
    cum = torch.cat([torch.zeros(n, 1, device=dev, dtype=torch.float64), torch.cumsum(w, -1)], -1)
    return cum - 0.5 * cum[:, -1:]


# name: (knots, n, m, d, s: a number for one per example or 'per_value', x)
CASES = {
    "recipe": ("head", 1, RECIPE_M, RECIPE_D, 0.3, "normal"),
    "row_head": ("head", 1, 4 * 512, RECIPE_D, "per_value", "normal"),
    "small_d": ("head", 3, 1000, 8, 0.3, "normal"),
    "warp_edges": ("mixed", 2, 777, 125, 0.3, "normal"),
    "block_edge": ("mixed", 2, 513, 124, 0.3, "normal"),
    "knot_tiles": ("head", 1, 560_000, 1100, 0.3, "normal"),
    "bin_splits": ("head", 2, 3000, 2500, 0.3, "normal"),
    "far_outside": ("head", 2, 4000, 256, 0.3, "far"),
    "s_1e-9": ("head", 2, 4000, 256, 1e-9, "normal"),
    "s_4000": ("head", 2, 4000, 256, 4000.0, "far"),
    "all_narrow": ("narrow", 2, 4000, 512, 1.1, "normal"),
    "all_wide": ("wide", 2, 4000, 512, 0.2, "wide"),
    "mixed": ("mixed", 2, 4000, 512, 0.3, "normal"),
    "zero_width": ("zero", 2, 4000, 300, 0.3, "normal"),
    "width_floor": ("floor", 2, 4000, 300, 1e-9, "on_knots"),
    "per_value_mixed": ("mixed", 3, 5000, 300, "per_value", "normal"),
}


def _case(name, dev, seed=0):
    kind, n, m, d, s, xs = CASES[name]
    gen = torch.Generator(device=dev).manual_seed(seed)
    knots = _knots(kind, n, d, gen, dev).float()
    span = float((knots[:, -1] - knots[:, 0]).max())
    u = torch.rand(n, m, generator=gen, device=dev)
    if xs == "normal":
        x = torch.randn(n, m, generator=gen, device=dev) * 0.4 * span
    elif xs == "wide":
        x = (u - 0.5) * 1.2 * span
    elif xs == "far":  # a third inside, the rest up to 1e4 ADU outside
        x = torch.where(u < 0.5, -1.0, 1.0) * (span + 10.0 ** (1 + 3 * u))
        x = torch.where(u < 1 / 3, (6 * u - 1) * 0.5 * span, x)
    else:  # on and between the knots, within a few s
        idx = torch.randint(0, d + 1, (n, m), generator=gen, device=dev)
        x = torch.gather(knots, 1, idx) + 3e-9 * (u - 0.5)
    if s == "per_value":
        s_t = 0.05 + 20 * torch.rand(n, m, generator=gen, device=dev)
    else:
        s_t = torch.full((n, 1), float(s), device=dev)
    g = torch.rand(n, m, generator=gen, device=dev) - 0.3
    return knots, x, s_t, g


def _plain(knots, x, s, g, dtype, chunk=8192):
    """_core_conv and the knots' gradient of sum(core * g) in ``dtype``,
    chunked over the values."""
    kn = knots.to(dtype).detach().requires_grad_(True)
    xd, gd = x.to(dtype), g.to(dtype)
    sd = torch.broadcast_to(s, x.shape).to(dtype)
    cores = []
    for a in range(0, x.shape[1], chunk):
        c = QuantileHead._core_conv(kn[:, None, :], xd[:, a:a + chunk, None],
                                    sd[:, a:a + chunk, None])
        (c * gd[:, a:a + chunk]).sum().backward()
        cores.append(c.detach())
    return torch.cat(cores, 1), kn.grad


def _kernel(knots, x, s, g):
    kn = knots.detach().clone().requires_grad_(True)
    core = PC.core_conv(kn, x, s)
    (core * g).sum().backward()
    return core.detach(), kn.grad


def _err(a, ref):
    return float((a.double() - ref).abs().max() / ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_core_and_knot_grad_match_float64(card, name):
    knots, x, s, g = _case(name, card)
    core, grad = _kernel(knots, x, s, g)
    ref_core, ref_grad = _plain(knots, x, s, g, torch.float64)
    f32_core, f32_grad = _plain(knots, x, s, g, torch.float32)
    assert torch.isfinite(core).all() and torch.isfinite(grad).all()
    assert float(ref_core.abs().max()) > 0 and float(ref_grad.abs().max()) > 0
    e_core, e_grad = _err(core, ref_core), _err(grad, ref_grad)
    p_core, p_grad = _err(f32_core, ref_core), _err(f32_grad, ref_grad)
    msg = f"{name}: kernel {e_core:.2e} / {e_grad:.2e}, plain f32 {p_core:.2e} / {p_grad:.2e}"
    print(msg)
    assert e_core <= CORE_TOL and e_core <= 2 * p_core + 1e-6, msg
    assert e_grad <= GRAD_TOL and e_grad <= 2 * p_grad + 1e-6, msg


@pytest.mark.cuda
def test_cases_hold_both_kinds_of_bin(card):
    """The recipe's knots hold narrow and wide bins at s0 = 0.3; the named
    all-narrow and all-wide cases hold one kind."""
    h = {}
    for name in ("recipe", "all_narrow", "all_wide", "width_floor"):
        knots, _, s, _ = _case(name, card)
        h[name] = (knots[:, 1:] - knots[:, :-1]) / s[:, :1]
    assert (h["recipe"] < 0.05).any() and (h["recipe"] >= 0.05).any()
    assert (h["all_narrow"] < 0.05).all() and (h["all_wide"] >= 0.05).all()
    w = h["width_floor"] * 1e-9
    assert ((w > 0) & (w < 1e-8)).any() and (w == 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["recipe", "row_head"])
def test_launches_are_bit_identical(card, name):
    knots, x, s, g = _case(name, card, seed=3)
    a, b = _kernel(knots, x, s, g), _kernel(knots, x, s, g)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
def test_reach_underflows_in_f32(card):
    """The proof of REACH (csrc/proxy_core.cu's header): erfc(t) and
    exp(-t^2) are exactly 0 in f32 on the card for every t from REACH on."""
    t = torch.cat([torch.linspace(PC.REACH, 40.0, 200_001, device=card),
                   torch.logspace(1.5, 30, 10_001, device=card),
                   torch.tensor([PC.REACH, float("inf")], device=card)])
    assert t.dtype == torch.float32 and float(t.min()) == PC.REACH
    assert torch.count_nonzero(torch.special.erfc(t)) == 0
    assert torch.count_nonzero(torch.exp(-t * t)) == 0
    assert float(torch.special.erfc(torch.tensor(9.5, device=card))) > 0


def _probes_among(knots, s, probes, company):
    """The forward's core of each of ``probes`` ``[k]`` computed in an
    example of its own among 511 other values: 'near' (the probe plus up to
    1e-3 ADU, a window as narrow as its own), 'far' (1e4 ADU to both sides
    of the knots: every bin walked), or alone."""
    k = probes.shape[0]
    kn = knots[:1].expand(k, -1).contiguous()
    sk = s[:1, :1].expand(k, 1).contiguous()
    if company == "alone":
        return PC._forward(kn, probes[:, None].contiguous(), sk)[:, 0]
    j = torch.arange(1, 512, device=knots.device)
    if company == "near":
        others = probes[:, None] + 1e-3 * j / 512
    else:
        others = torch.where(j % 2 == 0, -1.0, 1.0) * (1e4 + j) + 0 * probes[:, None]
    x = torch.cat([probes[:, None], others], 1).contiguous()
    return PC._forward(kn, x, sk)[:, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("company", ["shuffled", "near_and_far"])
@pytest.mark.parametrize("name", ["recipe", "far_outside", "knot_tiles", "mixed"])
def test_a_values_core_does_not_depend_on_the_others(card, name, company):
    """The forward kernel on the values in one order and in a shuffled
    order gives the same bits for every value (each walks its knots alone);
    the backward agrees to f32 rounding (its sums run in another order).
    A value among near neighbours (its block's window as narrow as its own),
    among far ones (the full walk) and alone: the same bits."""
    knots, x, s, g = _case(name, card, seed=5)
    if company == "near_and_far":
        gen = torch.Generator(device=card).manual_seed(9)
        probes = x[0, torch.randint(0, x.shape[1], (256,), generator=gen, device=card)]
        near, far, alone = (_probes_among(knots, s, probes, c) for c in ("near", "far", "alone"))
        assert torch.equal(near, far) and torch.equal(near, alone)
        return
    gen = torch.Generator(device=card).manual_seed(9)
    order = torch.argsort(torch.rand(x.shape, generator=gen, device=card), dim=1)
    shuf = torch.gather(x, 1, order)
    a = PC._forward(knots, x, s)
    b = torch.empty_like(a).scatter_(1, order, PC._forward(knots, shuf, s))
    assert torch.equal(a, b)
    ga = PC._backward(knots, x, s, g)
    gb = PC._backward(knots, shuf, s, torch.gather(g, 1, order))
    assert float((ga - gb).abs().max()) <= 1e-5 * float(ga.abs().max())


def _head(knots):
    n = knots.shape[0]
    f = dict(device=knots.device, dtype=knots.dtype)
    return HeadParams(knots, torch.zeros(n, 1, **f), torch.full((n, 1), 0.05, **f),
                      torch.full((n, 1), 4.0, **f))


@pytest.mark.cuda
def test_counters_show_the_kernels_and_no_chunks(card):
    knots, x, _, _ = _case("recipe", card)
    kn = knots.clone().requires_grad_(True)
    before = dict(PC.launches_by_kernel)
    profiling.reset()
    with profiling.enable():
        lp = QuantileHead.log_prob_conv_gaussian(_head(kn), x.reshape(1, 4, 512, 512), 0.3)
        lp.sum().backward()
    counters = profiling.snapshot()["counters"]
    profiling.reset()
    assert counters.get("proxy.core_fwd") == 1 and counters.get("proxy.core_bwd") == 1
    assert "proxy.chunks" not in counters
    assert PC.launches_by_kernel["fwd"] == before["fwd"] + 1
    assert PC.launches_by_kernel["bwd"] == before["bwd"] + 1


def _walked(knots, x, s, g):
    profiling.reset()
    with profiling.enable():
        PC._forward(knots, x, s)
        PC._backward(knots, x, s, g)
    torch.cuda.synchronize()
    counters = profiling.snapshot()["counters"]
    profiling.reset()
    return counters["proxy.core_pairs_walked"], counters["proxy.core_pairs"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["recipe", "far_outside", "bin_splits", "all_wide"])
def test_walked_pairs_are_the_rules(card, name):
    """The kernels count the pairs the plain-torch rule (``fwd_windows``,
    ``bwd_runs``) says they walk; at these cases fewer than the full grid."""
    knots, x, s, g = _case(name, card)
    walked, pairs = _walked(knots, x, s, g)
    n, m = x.shape
    assert pairs == 2 * n * m * (knots.shape[1] - 1)
    xs, _ = PC.order_of(x, s)
    fwd, bwd = PC.walked_pairs(knots.cpu(), xs.cpu(), s.cpu())
    assert walked == fwd + bwd
    assert walked < pairs


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["recipe", "row_head"])
def test_walked_pairs_are_the_full_grid_within_reach(card, name):
    """Every value within reach of every knot (s = 4000 ADU), or one s per
    value (the row head's walk): every pair walked."""
    knots, x, s, g = _case(name, card)
    if name == "recipe":
        s = torch.full_like(s, 4000.0)
    walked, pairs = _walked(knots, x, s, g)
    assert walked == pairs == 2 * x.numel() * (knots.shape[1] - 1)


@pytest.mark.cuda
@pytest.mark.parametrize("grad_of", ["x", "s"])
def test_a_differentiated_x_or_s_takes_the_plain_path(card, grad_of):
    knots, x, _, _ = _case("small_d", card)
    s = torch.full((3, 1), 0.3, device=card)
    (x if grad_of == "x" else s).requires_grad_(True)
    launches = PC.launches
    profiling.reset()
    with profiling.enable():
        lp = QuantileHead.log_prob_conv_gaussian(_head(knots), x, s)
        lp.sum().backward()
    counters = profiling.snapshot()["counters"]
    profiling.reset()
    assert counters.get("proxy.chunks", 0) >= 1 and "proxy.core_fwd" not in counters
    assert PC.launches == launches
    assert (x if grad_of == "x" else s).grad is not None


@pytest.mark.cuda
def test_refuses_float64(card):
    knots, x, s, _ = _case("small_d", card)
    with pytest.raises(ValueError):
        PC.core_conv(knots.double(), x.double(), s.double())


@pytest.mark.cuda
def test_float64_takes_the_plain_path(card):
    """log_prob_conv_gaussian on float64 card tensors is the chunked plain
    path (the kernels take float32 only): chunks counted, no launch, and
    the same log density as the float64 plain path on the CPU."""
    knots, x, _, _ = _case("small_d", card)
    knots, x = knots.double(), x.double()
    launches = PC.launches
    profiling.reset()
    with profiling.enable():
        lp = QuantileHead.log_prob_conv_gaussian(_head(knots), x, 0.3)
    counters = profiling.snapshot()["counters"]
    profiling.reset()
    assert counters.get("proxy.chunks", 0) >= 1 and "proxy.core_fwd" not in counters
    assert PC.launches == launches
    assert lp.dtype == torch.float64
    ref = QuantileHead.log_prob_conv_gaussian(_head(knots.cpu()), x.cpu(), 0.3)
    assert float((lp.cpu() - ref).abs().max()) <= 1e-9 * float(ref.abs().max())


@pytest.mark.cuda
def test_proxy_train_steps_match_the_cpu(card):
    """Three make_proxy_train_step steps (d = 1024, pgrq-like dark frames of
    4 x 64 x 64, ISO 800 / 3200 / 12800) from the same weights on the card
    (the kernels) and on the CPU (the plain chunked path): every step's NLL
    within 1e-5 relative, every parameter after the third within 1e-4 of
    its leaf's largest magnitude."""
    from pnnp_tpu_torch.models import build_proxy
    from pnnp_tpu_torch.train import build_lr_schedule, make_adam
    from pnnp_tpu_torch.trainer_nf import make_proxy_train_step

    hyper = {"lr_scheduler": "WarmupCosine", "learning_rate": 1e-3, "stop_epoch": 1200,
             "step_size": 10, "T": 2}
    gen = torch.Generator().manual_seed(0)
    base = build_proxy({"name": "pw_iso_2stage", "d": 1024, "nf": 16, "nb": 2},
                       generator=gen)
    noises = [torch.randn(1, 4, 64, 64, generator=gen) * sd / 15871.0
              + torch.randn(1, 4, 64, 1, generator=gen) * sd / 4 / 15871.0
              for sd in (2.0, 4.0, 9.0)]
    isos = (800.0, 3200.0, 12800.0)
    out = {}
    for dev in ("cpu", card):
        proxy = build_proxy({"name": "pw_iso_2stage", "d": 1024, "nf": 16, "nb": 2}).to(dev)
        proxy.load_state_dict(base.state_dict())
        step = make_proxy_train_step(proxy, build_lr_schedule(hyper))
        opt = make_adam(proxy.parameters())
        nlls = []
        for noise, iso in zip(noises, isos):
            lr = noise.to(dev)
            m = step(opt, lr, torch.zeros_like(lr), torch.ones(1, device=dev),
                     torch.tensor([iso], device=dev), 0)
            nlls.append(float(m["nll"]))
        out[str(dev)] = (nlls, {k: v.detach().cpu() for k, v in proxy.state_dict().items()})
    (nc, pc), (nh, ph) = out[str(card)], out["cpu"]
    for a, b in zip(nc, nh):
        assert abs(a - b) <= 1e-5 * abs(b), (nc, nh)
    for k, v in ph.items():
        assert float((pc[k] - v).abs().max()) <= 1e-4 * max(float(v.abs().max()), 1e-12), k
