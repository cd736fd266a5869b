"""The proxy NLL's fused bin-law kernels, what the CPU can check of them.

The kernels (``pnnp_tpu_torch/csrc/proxy_core.cu``) run only on the card
(``tests/test_torch_cuda_proxy_kernel.py`` holds them to float64 there).
Here:

* the launcher's plan (``kernels/proxy_core.py::plan``): the forward's value
  tiles and knot tiles with their halo, the backward's warps of 31 bins with
  a halo knot and its splits of the values, cover every (value, bin) pair
  of every example exactly once and every knot where a bin needs it, or,
  with the windows and runs of sorted values, every pair inside them once,
  as many as the kernels count walked; the partials' layout gives each
  (example, side, split, bin) its own slot, which the final sum reads for
  both neighbours of every knot; the plan's constants are the source's;
* the window rule in plain torch (``fwd_windows``, ``bwd_runs``): every
  (value, bin) pair whose term in ``_core_conv``'s f32 arithmetic, or whose
  knot gradient by the backward's formulas, is nonzero lies inside its
  block's window and its warp's run, on narrow and wide bins, values
  outside the knots and ties, several examples and ragged blocks, and the
  recipe shape sampled; the forward's walk in its FOLD groups gives each
  value's sum bit for bit over its window as over every bin;
* the tracer's device counts (``count_device``) and the walked-pair
  counters of a replayed graph, and ``core_walked_share.proxy`` reading them;
* the backward's formulas, transcribed line for line (``core_grad_plain``),
  equal autograd of ``QuantileHead._core_conv``, both in float64, on
  narrow, wide and mixed bins, values on both sides of and far outside the
  support, zero-width bins and the 1e-8 width floor, one ``s`` per example
  and one per value;
* the routing rule: CPU tensors, and an ``x`` or ``s`` that requires grad,
  take the plain chunked path (``proxy.chunks`` counts, the kernels' counters
  do not, nothing is built).
"""

import re
from collections import Counter
from types import SimpleNamespace

import pytest
import torch

from pnnp_tpu_torch.kernels import proxy_core as PC
from pnnp_tpu_torch.models.proxy import HeadParams, QuantileHead
from pnnp_tpu_torch.utils import profiling

# every tile, warp and split edge at small m: one knot tile and three, a
# block's last warp with 0, 1 and 31 bins, one split and several
PLAN_SHAPES = [(1, 1, 1), (1, 5, 3), (2, 511, 30), (1, 513, 31), (3, 300, 124),
               (1, 1300, 250), (2, 300, 248), (1, 130, 1024), (2, 40, 1025),
               (1, 50, 2049), (4, 9, 1024), (8, 256, 64), (1, 3, 4100)]


def _pairs_fwd(p, windows=None):
    """(example, value, knot) triples the forward computes r and erfc for,
    and (example, value, bin) triples it sums; with ``windows``
    (``fwd_windows``) only those of each block's window."""
    knots, bins = Counter(), Counter()
    for ex in range(p.n):
        for b in range(p.fwd_blocks):
            vals = p.fwd_values(b)
            for ks in range(p.knot_splits):
                win = None if windows is None else range(*windows[ex, b, ks].tolist())
                for tile in p.knot_tiles(ks, win):
                    for v in vals:
                        for k in p.walked_knots(ks, tile):
                            knots[ex, v, k] += 1
                        for k in tile:
                            bins[ex, v, k] += 1
    return knots, bins


def _pairs_bwd(p, runs=None):
    """(example, value, bin) triples the backward sums, and the partial
    slots it writes; with ``runs`` (``bwd_runs``) only each warp's run."""
    bins, slots = Counter(), Counter()
    for ex in range(p.n):
        for split in range(p.splits):
            vals = p.split_values_of(split)
            assert len(vals) > 0 and p.split_values % PC.CHUNK == 0
            for kb in range(p.knot_blocks):
                for w in range(PC.BWD_WARPS):
                    ks = p.warp_knots(kb, w)
                    owned = p.warp_bins(kb, w)
                    run = vals if runs is None else range(*runs[ex, split, kb, w].tolist())
                    assert run.start >= vals.start and run.stop <= vals.stop or not owned
                    # each owned bin's upper knot is the next lane's knot
                    assert all(b in ks and b + 1 in ks for b in owned)
                    for b in owned:
                        for side in (0, 1):
                            slots[p.partial_index(ex, side, split, b)] += 1
                        for v in run:
                            bins[ex, v, b] += 1
    return bins, slots


def _head_values(n, m, d, seed=0):
    """f32 head knots [n, d+1] (about +-7.4 ADU), values spread past them,
    sorted, and s = 0.3 per example."""
    g = torch.Generator().manual_seed(seed)
    knots = _knots("head", n, d, seed).float()
    x = torch.randn(n, m, generator=g) * 12.0
    return knots, torch.sort(x, dim=1).values, torch.full((n, 1), 0.3)


@pytest.mark.parametrize("n,m,d", PLAN_SHAPES)
def test_plan_covers_every_pair_in_the_windows_once(n, m, d):
    """With the windows and runs of sorted values: every pair inside them
    once, no other, the knots of each walked tile once, and as many pairs
    as ``walked_pairs`` says the kernels count."""
    p = PC.plan(n, m, d)
    knots, xs, s = _head_values(n, m, d)
    win, runs = PC.fwd_windows(knots, xs, s), PC.bwd_runs(knots, xs, s)
    assert (win[..., 0] <= win[..., 1]).all()
    inside = {(ex, v, k) for ex in range(n) for b in range(p.fwd_blocks)
              for v in p.fwd_values(b) for ks in range(p.knot_splits)
              for k in range(*win[ex, b, ks].tolist())}
    assert all(p.fwd_bins(ks).start <= win[ex, b, ks, 0] and
               win[ex, b, ks, 1] <= p.fwd_bins(ks).stop
               for ex in range(n) for b in range(p.fwd_blocks) for ks in range(p.knot_splits))
    knots_seen, bins = _pairs_fwd(p, win)
    assert set(bins) == inside and set(bins.values()) <= {1}
    assert all((ex, v, k) in knots_seen for ex, v, k in inside)
    assert all((ex, v, k + 1) in knots_seen for ex, v, k in inside)
    bins_b, slots = _pairs_bwd(p, runs)
    assert set(bins_b.values()) <= {1} and sorted(slots) == list(range(p.n_partials))
    assert PC.walked_pairs(knots, xs, s) == (len(bins), len(bins_b))


@pytest.mark.parametrize("n,m,d", PLAN_SHAPES)
def test_plan_covers_every_pair_once(n, m, d):
    p = PC.plan(n, m, d)
    every_knot = {(ex, v, k) for ex in range(n) for v in range(m) for k in range(d + 1)}
    every_bin = {(ex, v, k) for ex in range(n) for v in range(m) for k in range(d)}
    knots, bins = _pairs_fwd(p)
    assert set(bins) == every_bin and set(bins.values()) == {1}
    # a knot once, and once more where it ends one tile or split and starts the next
    edges = {t.start for ks in range(p.knot_splits) for t in p.knot_tiles(ks) if t.start}
    assert set(knots) == every_knot
    assert all(c == 1 + (k in edges) for (_, _, k), c in knots.items())
    assert p.knot_splits == 1 or p.split_bins % PC.FOLD == 0
    assert p.n_fwd_partials == (n * p.knot_splits * m if p.knot_splits > 1 else 0)
    bins, slots = _pairs_bwd(p)
    assert set(bins) == every_bin and set(bins.values()) == {1}
    assert set(slots.values()) == {1}
    assert sorted(slots) == list(range(p.n_partials))
    # the final sum: knot k reads side 0 of bin k and side 1 of bin k - 1,
    # both written, for every split
    for k in range(d + 1):
        reads = [p.partial_index(0, 0, sp, k) for sp in range(p.splits) if k < d]
        reads += [p.partial_index(0, 1, sp, k - 1) for sp in range(p.splits) if k > 0]
        assert reads and all(r in slots for r in reads)


@pytest.mark.parametrize("n,m,d", [(1, 4 * 512 * 512, 1024), (1, 4 * 512, 1024),
                                   (8, 4 * 512 * 512, 1024), (1, 1 << 20, 1)])
def test_plan_at_the_callers_shapes(n, m, d):
    """The recipe's pixel and row heads, validate_proxy's batch of 8, and the
    oracle tools' [1, M]: values and bins partitioned (the grid is their
    product), the grid within CUDA's limits, the partials bounded."""
    p = PC.plan(n, m, d)
    seen = Counter(v for b in range(p.fwd_blocks) for v in p.fwd_values(b))
    assert len(seen) == m and set(seen.values()) == {1}
    fwd_bins = [b for ks in range(p.knot_splits) for t in p.knot_tiles(ks) for b in t]
    assert fwd_bins == list(range(d))
    assert p.knot_splits <= PC.MAX_GRID_YZ
    split_vals = [p.split_values_of(sp) for sp in range(p.splits)]
    assert split_vals[0].start == 0 and split_vals[-1].stop == m
    assert all(a.stop == b.start for a, b in zip(split_vals, split_vals[1:]))
    assert all(len(r) > 0 for r in split_vals)
    owned = [b for kb in range(p.knot_blocks) for w in range(PC.BWD_WARPS)
             for b in p.warp_bins(kb, w)]
    assert owned == list(range(d))
    assert p.splits <= PC.MAX_GRID_YZ and n <= PC.MAX_GRID_YZ
    assert p.n * p.knot_blocks * p.splits <= 2 * PC.TARGET_BLOCKS or p.splits == 1
    assert p.n_partials * 8 <= 64 << 20


def test_plan_constants_are_the_sources():
    """The Python mirror's constants equal the .cu's constexprs."""
    src = PC.SOURCE.read_text()
    names = ("FWD_THREADS", "FWD_VALUES", "KNOT_TILE", "FOLD", "BWD_WARPS", "WARP_BINS",
             "FINAL_THREADS", "GRAD_WARPS")
    for name in names:
        got = re.search(rf"constexpr int {name} = (\d+);", src)
        assert got and int(got.group(1)) == getattr(PC, name), name
    got = re.search(r"constexpr float REACH = ([0-9.]+)f;", src)
    assert got and float(got.group(1)) == PC.REACH
    got = re.search(r"constexpr float RSQ2 = ([0-9.]+)f;", src)
    assert got and float(got.group(1)) == PC.RSQ2
    assert re.search(r"constexpr int CHUNK = BWD_THREADS;", src)
    assert re.search(r"constexpr int BWD_THREADS = 32 \* BWD_WARPS;", src)
    assert PC.CHUNK == 32 * PC.BWD_WARPS


def test_plan_refuses_what_the_grid_does_not_take():
    for bad in ((0, 5, 3), (1, 0, 3), (1, 5, 0), (PC.MAX_GRID_YZ + 1, 5, 3)):
        with pytest.raises(ValueError):
            PC.plan(*bad)


def _knots(kind, n, d, seed):
    """float64 knots [n, d+1] of ``kind``: 'head' (a softmax law over +-7 ADU,
    the recipe's), 'narrow' (widths ~1e-3 ADU), 'wide' (~1 ADU), 'mixed'
    (half the bins 1e-3, half 0.2), 'zero' (a third of the bins of width 0)."""
    g = torch.Generator().manual_seed(seed)
    if kind == "head":
        w = torch.softmax(torch.randn(n, d, generator=g, dtype=torch.float64) * 0.5, -1) * 14.8
    elif kind == "narrow":
        w = torch.rand(n, d, generator=g, dtype=torch.float64) * 2e-3
    elif kind == "wide":
        w = 0.5 + torch.rand(n, d, generator=g, dtype=torch.float64)
    elif kind == "mixed":
        w = torch.where(torch.rand(n, d, generator=g, dtype=torch.float64) < 0.5, 1e-3, 0.2)
        w = w * (1 + 0.3 * torch.rand(n, d, generator=g, dtype=torch.float64))
    elif kind == "zero":
        w = torch.rand(n, d, generator=g, dtype=torch.float64) * 0.1
        w = torch.where(torch.arange(d) % 3 == 1, 0.0, w)
    else:
        raise ValueError(kind)
    cum = torch.cat([torch.zeros(n, 1, dtype=torch.float64), torch.cumsum(w, -1)], -1)
    return cum - 0.5 * cum[:, -1:]


# csrc/proxy_core.cu's constants
_RSQ2 = 0.707106781186547524
_SQ2 = 1.41421356237309505
_RSQPI = 0.564189583547756287
_TWO_RSQPI = 1.12837916709551257
_NARROW_BIN = 0.05
_WIDTH_FLOOR = 1e-8


def bin_grads(knots: torch.Tensor, x: torch.Tensor, s: torch.Tensor) -> tuple:
    """Each bin's share of d core / d v_k and d core / d v_{k+1} (times d),
    ``[n, m, d]`` each, by the backward kernel's formulas
    (``proxy_core_bwd_kernel``, ``wide_grad``, ``narrow_grad``), one line
    for each, in any dtype."""
    x, s = x[..., None], torch.broadcast_to(s, x.shape)[..., None]
    kn = knots[:, None, :]
    inv = (1.0 / s) * _RSQ2
    c = inv * _RSQPI
    sq2inv = _SQ2 * inv
    r = (kn - x) * inv
    ra, rb = r[..., :-1], r[..., 1:]
    w = kn[..., 1:] - kn[..., :-1]
    cw = 1.0 / (2.0 * torch.clamp_min(w, _WIDTH_FLOOR))
    iw = torch.where(w >= _WIDTH_FLOOR, 1.0 / torch.clamp_min(w, _WIDTH_FLOOR), 0.0)
    h = w * sq2inv
    hs2 = torch.square(torch.clamp_max(h, _NARROW_BIN)) / 24.0
    hcoef = (h / 12.0) * sq2inv
    # wide_grad
    e = torch.special.erfc(torch.abs(r))
    xr = torch.exp(-r * r)
    ea, eb, xa, xb = e[..., :-1], e[..., 1:], xr[..., :-1], xr[..., 1:]
    diff = ea - eb
    mass2 = torch.where(ra >= 0, diff, torch.where(rb <= 0, -diff, 2.0 - ea - eb))
    dw_wide = -(mass2 * cw) * iw
    ga_wide = -_TWO_RSQPI * xa * cw * inv - dw_wide
    gb_wide = _TWO_RSQPI * xb * cw * inv + dw_wide
    # narrow_grad
    mid = 0.5 * (ra + rb)
    m2 = mid * mid
    ec = torch.exp(-m2) * c
    poly = 1.0 + (2.0 * m2 - 1.0) * hs2
    dm = ec * (2.0 * hs2 - poly) * mid * inv
    dw_narrow = ec * (2.0 * m2 - 1.0) * hcoef
    ga_narrow, gb_narrow = dm - dw_narrow, dm + dw_narrow
    narrow = h < _NARROW_BIN
    return torch.where(narrow, ga_narrow, ga_wide), torch.where(narrow, gb_narrow, gb_wide)


def core_grad_plain(knots: torch.Tensor, x: torch.Tensor, s: torch.Tensor,
                    g: torch.Tensor) -> torch.Tensor:
    """dL/dknots ``[n, d+1]`` from ``g = dL/dcore [n, m]``, by the backward
    kernel's formulas (:func:`bin_grads`), dense over ``[n, m, d]`` bins, in
    any dtype."""
    ga, gb = bin_grads(knots, x, s)
    g = g[..., None]
    # sums over the values, then proxy_core_grad_kernel's sum of both sides
    lo = torch.sum(g * ga, dim=1)
    hi = torch.sum(g * gb, dim=1)
    d = knots.shape[-1] - 1
    grad = torch.zeros_like(knots)
    grad[:, :-1] += lo
    grad[:, 1:] += hi
    return grad / d


# (knot kind, s, x spread): s one value per example unless "per_value"
FORMULA_CASES = {
    "head_s0": ("head", 0.3, 6.0),
    "narrow": ("narrow", 1.1, 1.5),
    "wide": ("wide", 0.2, 40.0),
    "mixed": ("mixed", 0.3, 8.0),
    "zero_width": ("zero", 0.3, 3.0),
    "floor_tiny_s": ("zero", 1e-9, 3.0),
    "large_s": ("head", 4000.0, 100.0),
    "per_value": ("mixed", "per_value", 8.0),
    "far_outside": ("head", 0.3, 400.0),
}


@pytest.mark.parametrize("case", list(FORMULA_CASES))
def test_backward_formulas_equal_autograd(case):
    """core_grad_plain (the .cu's backward, line for line) against autograd
    of _core_conv, both in float64."""
    kind, s, spread = FORMULA_CASES[case]
    n, m, d = 2, 40, 33
    g = torch.Generator().manual_seed(list(FORMULA_CASES).index(case))
    knots = _knots(kind, n, d, 3)
    if kind == "zero" and s == 1e-9:  # bins of a few 1e-9 ADU: wide, on the floor
        knots = torch.cumsum(torch.full((n, d + 1), 5e-9, dtype=torch.float64), -1)
        knots[:, 1::4] = knots[:, 0::4][:, :knots[:, 1::4].shape[1]]
    x = (torch.rand(n, m, generator=g, dtype=torch.float64) - 0.5) * 2 * spread
    x[:, :4] = knots[:, :1] - torch.tensor([1e-3, 1.0, 1e3, 1e4], dtype=torch.float64)
    x[:, 4:8] = knots[:, -1:] + torch.tensor([1e-3, 1.0, 1e3, 1e4], dtype=torch.float64)
    if case == "floor_tiny_s":
        x[:, 8:] = knots[:, torch.arange(8, m) % (d + 1)] + 1e-9 * torch.rand(
            n, m - 8, generator=g, dtype=torch.float64)
    if s == "per_value":
        s_t = 0.05 + 20 * torch.rand(n, m, generator=g, dtype=torch.float64)
    else:
        s_t = torch.full((n, 1), float(s), dtype=torch.float64)
    gout = torch.rand(n, m, generator=g, dtype=torch.float64) - 0.3

    kn = knots.clone().requires_grad_(True)
    core = QuantileHead._core_conv(kn[:, None, :], x[..., None],
                                   torch.broadcast_to(s_t, x.shape)[..., None])
    (core * gout).sum().backward()
    got = core_grad_plain(knots, x, s_t, gout)
    ref = kn.grad
    assert torch.isfinite(got).all() and torch.isfinite(ref).all()
    scale = float(ref.abs().max())
    assert scale > 0
    # r = (v - x) inv here, -x inv + v inv in _core_conv: float64 rounding
    # of x inv (x up to 1e4 ADU over s of 1e-9) is what separates them
    tol = 1e-9 if case != "floor_tiny_s" else 1e-5
    torch.testing.assert_close(got, ref, rtol=0, atol=tol * scale)


def test_backward_formulas_see_both_branches():
    """The mixed case holds narrow and wide bins, at s0 = 0.3."""
    knots = _knots("mixed", 2, 33, 3)
    h = (knots[:, 1:] - knots[:, :-1]) / 0.3
    assert (h < 0.05).any() and (h >= 0.05).any()


def test_routing_rule():
    """The kernels take float32 CUDA tensors whose x and s need no gradient."""
    t = lambda cuda=True, grad=False, dtype=torch.float32: SimpleNamespace(
        is_cuda=cuda, requires_grad=grad, dtype=dtype)
    assert PC.routes(t(), t(), t())
    assert not PC.routes(t(cuda=False), t(cuda=False), t(cuda=False))
    assert not PC.routes(t(), t(grad=True), t())
    assert not PC.routes(t(), t(), t(grad=True))
    assert PC.routes(t(grad=True), t(), t())  # the knots' gradient is the kernels'
    f64 = t(dtype=torch.float64)
    assert not PC.routes(f64, f64, f64)
    assert not PC.routes(t(), f64, f64) and not PC.routes(f64, t(), t())


@pytest.mark.parametrize("grad_of", [None, "knots", "x", "s"])
def test_cpu_calls_take_the_plain_path(grad_of):
    """On the CPU every call is chunked, whatever requires grad: the chunk
    counter counts, the kernels' counters stay absent, nothing is built."""
    g = torch.Generator().manual_seed(5)
    knots = _knots("head", 2, 16, 1).float()
    x = torch.randn(2, 3, 5, 4, generator=g)
    s = torch.full((2, 1, 1, 1), 0.3)
    if grad_of == "knots":
        knots.requires_grad_(True)
    elif grad_of == "x":
        x.requires_grad_(True)
    elif grad_of == "s":
        s.requires_grad_(True)
    hp = HeadParams(knots, torch.zeros(2, 1), torch.full((2, 1), 0.05), torch.full((2, 1), 4.0))
    launches = PC.launches
    profiling.reset()
    with profiling.enable():
        lp = QuantileHead.log_prob_conv_gaussian(hp, x, s, chunk=7)
        if grad_of is not None:
            lp.sum().backward()
    counters = profiling.snapshot()["counters"]
    profiling.reset()
    assert counters["proxy.chunks"] == -(-60 // 7)
    assert "proxy.core_fwd" not in counters and "proxy.core_bwd" not in counters
    assert PC.launches == launches
    assert PC._library.cache_info().currsize == 0


# name: (knot kind, n, m, d, s, values): 'spread' N(0, 12 ADU); 'ties' whole
# ADU, a third far outside the knots, some on knots; 'recipe' N(0, 3 ADU) in
# whole ADU, the pgrq frames' steps
WINDOW_CASES = {
    "narrow": ("narrow", 2, 3000, 200, 0.6, "spread"),
    "wide": ("wide", 2, 1500, 120, 0.2, "spread"),
    "mixed": ("mixed", 1, 2000, 257, 0.3, "spread"),
    "outside_and_ties": ("head", 2, 1800, 300, 0.3, "ties"),
    "ragged_examples": ("head", 3, 1300, 100, 0.3, "spread"),
    "recipe_sampled": ("head", 1, 4 * 512 * 512, 1024, 0.3, "recipe"),
}


def _window_case(name):
    kind, n, m, d, s, values = WINDOW_CASES[name]
    g = torch.Generator().manual_seed(list(WINDOW_CASES).index(name))
    knots = _knots(kind, n, d, 7).float()
    if values == "spread":
        x = torch.randn(n, m, generator=g) * 12.0
    elif values == "recipe":
        x = torch.round(torch.randn(n, m, generator=g) * 3.0)
    else:
        x = torch.round(torch.randn(n, m, generator=g) * 4.0)
        u = torch.rand(n, m, generator=g)
        far = (knots[:, -1:] - knots[:, :1]) + 10.0 ** (1 + 3 * u)
        x = torch.where(u < 1 / 3, torch.where(u < 1 / 6, -far, far), x)
        x[:, :40] = knots[:, 5:45]
    return knots, x, torch.full((n, 1), s)


def _bin_terms(knots, x, s):
    """Each bin's term of ``_core_conv`` (before the sum), ``[n, m, d]``:
    its own arithmetic, one bin at a time."""
    pairs = torch.stack([knots[:, :-1], knots[:, 1:]], -1)[:, None]  # [n, 1, d, 2]
    return QuantileHead._core_conv(pairs, x[..., None, None],
                                   torch.broadcast_to(s[..., None, None], x.shape + (1, 1)))


@pytest.mark.parametrize("name", list(WINDOW_CASES))
def test_windows_hold_every_nonzero_term(name):
    """Every (value, bin) pair whose term in ``_core_conv``'s f32 arithmetic
    is nonzero lies in its block's window, and every one whose knot
    gradient by the backward's formulas is nonzero lies in its warp's run;
    the windows leave pairs out."""
    knots, x, s = _window_case(name)
    n, m = x.shape
    d = knots.shape[1] - 1
    p = PC.plan(n, m, d)
    xs, _ = PC.order_of(x, s)
    win, runs = PC.fwd_windows(knots, xs, s), PC.bwd_runs(knots, xs, s)
    g = torch.Generator().manual_seed(1)
    idx = torch.arange(m) if m <= 2048 else torch.cat([
        torch.randint(0, m, (1000,), generator=g),
        torch.arange(0, m, PC.FWD_THREADS * PC.FWD_VALUES), torch.tensor([m - 1])])
    xv = xs[:, idx]
    bins = torch.arange(d)
    terms = _bin_terms(knots, xv, s)
    w = win[:, idx // (PC.FWD_THREADS * PC.FWD_VALUES)][:, :, bins // p.split_bins]
    assert ((terms == 0) | ((bins >= w[..., 0]) & (bins < w[..., 1]))).all()
    ga, gb = bin_grads(knots, xv, s)
    gw = bins // PC.WARP_BINS
    r = runs[:, idx // p.split_values][:, :, gw // PC.BWD_WARPS, gw % PC.BWD_WARPS]
    v = idx[None, :, None]
    assert (((ga == 0) & (gb == 0)) | ((v >= r[..., 0]) & (v < r[..., 1]))).all()
    assert (terms != 0).any() and (ga != 0).any()
    fwd, bwd = PC.walked_pairs(knots, xs, s)
    assert fwd < n * m * d and bwd < n * m * d


@pytest.mark.parametrize("name", [k for k in WINDOW_CASES if k != "recipe_sampled"])
def test_windowed_walk_sums_every_value_bit_for_bit(name):
    """The forward's sum of each value (groups of FOLD bins by bin index,
    the groups added in order, the splits added in order) over its block's
    window, which starts and ends inside such groups, is bit for bit the
    sum over every bin: the terms left out are +-0.0 and the sum is never
    -0.0."""
    knots, x, s = _window_case(name)
    n, m = x.shape
    d = knots.shape[1] - 1
    p = PC.plan(n, m, d)
    xs, _ = PC.order_of(x, s)
    terms = _bin_terms(knots, xs, s)
    win = PC.fwd_windows(knots, xs, s)[:, torch.arange(m) // (PC.FWD_THREADS * PC.FWD_VALUES)]

    def walk(windowed):
        out = torch.zeros(n, m)
        for ks in range(p.knot_splits):
            b0 = p.fwd_bins(ks).start
            tot, acc = torch.zeros(n, m), torch.zeros(n, m)
            for b in p.fwd_bins(ks):
                on = ((b >= win[..., ks, 0]) & (b < win[..., ks, 1]) if windowed
                      else torch.ones(n, m, dtype=torch.bool))
                acc = torch.where(on, acc + terms[..., b], acc)
                if (b + 1 - b0) % PC.FOLD == 0:
                    tot = torch.where(on, tot + acc, tot)
                    acc = torch.where(on, 0.0, acc)
            out = out + (tot + acc) if p.knot_splits > 1 else tot + acc
        return out

    full, windowed = walk(False), walk(True)
    assert torch.equal(full, windowed)
    assert not (torch.signbit(full) & (full == 0)).any()  # never -0.0
    assert (win[..., 1] - win[..., 0] < torch.tensor([len(p.fwd_bins(ks)) for ks in
                                                       range(p.knot_splits)])).any()


def test_order_of_sorts_each_example_stably():
    x = torch.tensor([[3.0, 1.0, 3.0, 0.0, 1.0], [2.0, 2.0, -1.0, 5.0, 2.0]])
    xs, perm = PC.order_of(x, torch.ones(2, 1))
    assert xs.tolist() == [[0, 1, 1, 3, 3], [-1, 2, 2, 2, 5]]
    assert perm.tolist() == [[3, 1, 4, 0, 2], [2, 0, 1, 4, 3]]
    per_value = PC.order_of(x, torch.ones(2, 5))
    assert per_value[0] is x and per_value[1] is None


def test_windows_walk_every_pair_where_s_varies_per_value():
    knots, x, _ = _window_case("wide")
    s = torch.full(x.shape, 0.2)
    n, m = x.shape
    d = knots.shape[1] - 1
    assert PC.walked_pairs(knots, x, s) == (n * m * d, n * m * d)


def test_replays_count_the_pairs_their_graph_walks():
    """A replayed graph's launches count their full grids and a copy of
    its walked counter as the replay left it, only while tracing."""
    held = {"fwd": 1, "bwd": 1, "pairs": 200, "walked": torch.tensor(65)}
    profiling.reset()
    PC.replayed(held)
    assert profiling.snapshot()["counters"] == {}
    with profiling.enable():
        PC.replayed(held)
        PC.replayed(held)
    held["walked"].fill_(0)  # the next replay's value
    counters = profiling.snapshot()["counters"]
    profiling.reset()
    assert counters["proxy.core_pairs"] == 400 and counters["proxy.core_pairs_walked"] == 130
    assert counters["proxy.core_fwd"] == counters["proxy.core_bwd"] == 2


def test_core_walked_share_reads_the_counters():
    from portbench.harness import ROOT, load_module

    read = load_module(ROOT / "metrics" / "core_walked_share.proxy.py",
                       "core_walked_share.proxy").read
    profiling.reset()
    assert read(None) is None
    with profiling.enable():
        profiling.count("proxy.core_pairs", 400)
        profiling.count_device("proxy.core_pairs_walked", torch.tensor(130))
    assert read(None) == 100.0 * 130 / 400
    profiling.reset()
    with profiling.enable():
        profiling.count("proxy.core_pairs", 400)
    assert read(None) is None
    profiling.reset()
