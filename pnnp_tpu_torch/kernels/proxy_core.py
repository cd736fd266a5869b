"""The proxy NLL's Gaussian-convolved bin law, as a pair of CUDA kernels.

``QuantileHead._core_conv`` (``pnnp_tpu_torch/models/proxy.py``) is the
plain version: the piecewise-constant core density convolved with
``N(0, s^2)`` at every value, from the ``d + 1`` knots of its example. The
kernels (``pnnp_tpu_torch/csrc/proxy_core.cu``) compute the same f32 law
without its ``[n, m, d + 1]`` intermediates: the forward walks the knots for
each value (value-major), the backward sums each knot's gradient over the
values (knot-major) into one partial per (split, bin) and side, added in a
fixed order, so two launches give the same bits. They are built with
``nvcc`` at first use and bound through ``ctypes``.

Most (value, bin) terms are exact zeros: a bin whose two knots both lie
:data:`REACH` or more (in ``r = (v - x) / (s sqrt2)``) to one side of a
value adds +-0.0 to its core and to both knots' gradients, since
``erfcf(10.5)`` and ``expf(-10.5^2)`` underflow to 0 in f32 (the source's
header has the proof). Where ``s`` is one value per example (the pixel
head), :func:`order_of` sorts each example's values (``torch.sort``,
stable: device work, no host read) and the kernels take them sorted with
their places: each forward block walks only the bins that may be nonzero
for a value between its least and its largest, and each value's core is
bit for bit the full walk's whatever its neighbours (its sum's groups of
:data:`FOLD` bins stay keyed by bin index); each
backward warp walks only the run of sorted values within reach of its
knots. Where ``s`` varies per value (the row head) nothing is sorted and
every pair is walked. :func:`fwd_windows` and :func:`bwd_runs` are the
rule in plain torch, for the tests.

While tracing is on (``utils/profiling.py``), each launch counts the full
grid, ``n m d`` pairs, in ``proxy.core_pairs`` and the pairs it walked in
``proxy.core_pairs_walked``; the kernels add the second on the device (one
integer a block), and :func:`~pnnp_tpu_torch.utils.profiling.snapshot`
reads it.

:class:`ProxyCore` binds them into autograd: ``(knots [n, d+1], x [n, m],
s [n, 1] or [n, m]) -> core [n, m]``, with a gradient for the knots only.
:func:`routes` is the rule ``log_prob_conv_gaussian`` uses: the kernels take
float32 CUDA tensors whose ``x`` and ``s`` do not require grad; everything
else (the CPU, float64, a caller that differentiates ``x`` or ``s``) takes
the plain chunked path. Launches count at the launch site, or, captured
into a CUDA graph, at each of its replays (:func:`holding`,
:func:`replayed`).

:func:`plan` mirrors the kernels' grid (value tiles, knot tiles, the
backward's warps of 31 bins and one halo knot, the splits of the values,
the partials' layout); the tests hold it to covering every (value, bin)
pair once, and every pair inside the windows and runs once.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from dataclasses import dataclass

import torch
from torch.autograd.function import once_differentiable

from pnnp_tpu_torch.kernels.build import CSRC_DIR, load
from pnnp_tpu_torch.utils import profiling
from pnnp_tpu_torch.utils.profiling import count

SOURCE = CSRC_DIR / "proxy_core.cu"
KERNELS = ("fwd", "bwd")

# Launches since import (or since a caller reset them to 0), in all and by
# kernel; counted at the one launch site, _launch, and for a CUDA graph at
# each of its replays, replayed.
launches = 0
launches_by_kernel = dict.fromkeys(KERNELS, 0)
# The tallies of the graphs being captured (holding), innermost last: the
# launches by kernel, under "pairs" their full grids, and under "walked" the
# one device counter all of them add the pairs they walk to (kept for the
# graph's life, zeroed at the start of each replay).
_HELD: list = []

# The kernels' constants, mirrored from csrc/proxy_core.cu.
FWD_THREADS = 128
FWD_VALUES = 4           # values a forward thread owns
KNOT_TILE = 1024         # bins staged in shared memory at once, plus a halo knot
FOLD = 32                # bins a group of a value's f32 sum
BWD_WARPS = 4
WARP_BINS = 31           # bins a backward warp owns; lane 31 is the halo knot
CHUNK = 32 * BWD_WARPS   # values the backward stages at once
FINAL_THREADS = 256
GRAD_WARPS = 16          # warps that share a knot's sum over the splits
REACH = 10.5             # |r| past which every term is exactly 0 in f32
RSQ2 = 0.707106781186547524
# The launcher's choice of splits: the backward's values split into about
# TARGET_BLOCKS blocks (128 a SM of the H100's 132: the runs leave most
# blocks little or nothing to walk, and smaller blocks shorten the last wave,
# 2-5% faster than 64 a SM on an H100 at the sony_proxy_nll benchmark's
# inputs), no split under MIN_SPLIT values; the forward's bins split, in multiples of
# FOLD, only where its value tiles are fewer than TARGET_FWD_BLOCKS (one wave):
# the row head's 2,048 values are 4 tiles, each a serial walk of d knots.
TARGET_BLOCKS = 132 * 128
MIN_SPLIT = 256
TARGET_FWD_BLOCKS = 132 * 8
MAX_GRID_YZ = 65535


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (first use only), load and declare the C interface."""
    lib = load(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.pnnp_proxy_core_fwd.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32,
                                        ptr, ptr, ptr, ptr]
    lib.pnnp_proxy_core_fwd.restype = i32
    lib.pnnp_proxy_core_bwd.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32,
                                        i32, ptr, ptr, ptr, ptr]
    lib.pnnp_proxy_core_bwd.restype = i32
    return lib


@dataclass(frozen=True)
class Plan:
    """Both kernels' grids for ``n`` examples of ``m`` values and ``d`` bins.

    Forward: block ``(b, ks, ex)`` takes values ``fwd_values(b)`` of example
    ``ex`` and walks the knots of bin split ``ks`` (:meth:`fwd_bins`), or of
    its window there (:func:`fwd_windows`), tile by tile (:meth:`knot_tiles`,
    each tile staged with one halo knot,
    :meth:`walked_knots` the knots whose r and erfc it computes there);
    with more than one split, each writes its sums and a second kernel adds
    them in order. Backward: block ``(kb, split, ex)``; its warp ``w`` owns
    bins :meth:`warp_bins` over values :meth:`split_values_of`, or its run
    there (:func:`bwd_runs`), and writes a partial per bin and side at
    :meth:`partial_index`."""

    n: int
    m: int
    d: int
    fwd_blocks: int
    knot_splits: int
    split_bins: int
    knot_blocks: int
    splits: int
    split_values: int

    def fwd_values(self, block: int) -> list:
        base = block * FWD_THREADS * FWD_VALUES
        return [v for t in range(FWD_THREADS) for j in range(FWD_VALUES)
                if (v := base + t + j * FWD_THREADS) < self.m]

    def fwd_bins(self, ks: int) -> range:
        b0 = ks * self.split_bins
        return range(b0, min(self.d, b0 + self.split_bins))

    def knot_tiles(self, ks: int, window: range = None) -> list:
        """The bins of each staged tile of split ``ks``, or of ``window``
        within it (its knots are these and one more)."""
        bins = self.fwd_bins(ks) if window is None else window
        return [range(t0, min(t0 + KNOT_TILE, bins.stop))
                for t0 in range(bins.start, bins.stop, KNOT_TILE)]

    def walked_knots(self, ks: int, tile: range) -> range:
        """Knots a tile's walk visits, computing r and erfc at each: all of
        its knots, the halo too (a knot between two tiles or splits is
        visited by both)."""
        return range(tile.start, tile.stop + 1)

    def warp_knots(self, kb: int, warp: int) -> range:
        """Knots of lanes 0..31 of a backward warp (lanes past knot d idle)."""
        k0 = kb * WARP_BINS * BWD_WARPS + warp * WARP_BINS
        return range(k0, min(k0 + 32, self.d + 1))

    def warp_bins(self, kb: int, warp: int) -> range:
        """Bins a backward warp owns: those of lanes 0..30."""
        k0 = kb * WARP_BINS * BWD_WARPS + warp * WARP_BINS
        return range(min(k0, self.d), min(k0 + WARP_BINS, self.d))

    def split_values_of(self, split: int) -> range:
        a = split * self.split_values
        return range(a, min(self.m, a + self.split_values))

    @property
    def n_fwd_partials(self) -> int:
        """The forward's sums per (example, bin split, value), where it splits."""
        return self.n * self.knot_splits * self.m if self.knot_splits > 1 else 0

    @property
    def n_partials(self) -> int:
        return self.n * 2 * self.splits * self.d

    def partial_index(self, ex: int, side: int, split: int, b: int) -> int:
        """Side 0 holds bin b's share of knot b's gradient, side 1 of knot b+1's."""
        return ((ex * 2 + side) * self.splits + split) * self.d + b


@functools.lru_cache(maxsize=64)
def plan(n: int, m: int, d: int) -> Plan:
    """The grids of :class:`Plan`: forward blocks of ``FWD_THREADS *
    FWD_VALUES`` values over splits of the bins (multiples of :data:`FOLD`),
    as many splits as bring the forward near :data:`TARGET_FWD_BLOCKS`
    blocks; backward blocks of ``BWD_WARPS * WARP_BINS`` bins over splits of
    the values, as many as bring the backward near :data:`TARGET_BLOCKS`
    blocks, each a multiple of :data:`CHUNK` values and none under
    :data:`MIN_SPLIT` (so none is empty)."""
    if n < 1 or m < 1 or d < 1:
        raise ValueError(f"proxy core kernels need n, m, d >= 1, got {n}, {m}, {d}")
    if n > MAX_GRID_YZ:
        raise ValueError(f"proxy core kernels take at most {MAX_GRID_YZ} examples, got {n}")
    fwd_blocks = -(-m // (FWD_THREADS * FWD_VALUES))
    knot_splits = max(1, min(-(-TARGET_FWD_BLOCKS // (n * fwd_blocks)), d // FOLD,
                             MAX_GRID_YZ))
    split_bins = -(-d // knot_splits)
    split_bins = -(-split_bins // FOLD) * FOLD
    knot_splits = -(-d // split_bins)
    knot_blocks = -(-d // (WARP_BINS * BWD_WARPS))
    want = -(-TARGET_BLOCKS // (n * knot_blocks))
    splits = max(1, min(want, m // MIN_SPLIT, MAX_GRID_YZ))
    split_values = -(-m // splits)
    split_values = -(-split_values // CHUNK) * CHUNK
    splits = -(-m // split_values)
    return Plan(n, m, d, fwd_blocks, knot_splits, split_bins, knot_blocks, splits,
                split_values)


def _inv(s: torch.Tensor) -> torch.Tensor:
    """The kernels' ``1 / (s sqrt2)`` of one ``s`` per example, ``[n, 1]``
    float32."""
    return (1.0 / s[:, :1].float()) * RSQ2


def _sides(v: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, inv: torch.Tensor):
    """``knot_side``: 1 where knot ``v`` lies at r >= REACH of both ``lo``
    and ``hi``, -1 at r <= -REACH of both, else 0 (all broadcast, f32)."""
    a, b = (v - lo) * inv, (v - hi) * inv
    right = (a >= REACH) & (b >= REACH)
    left = (a <= -REACH) & (b <= -REACH)
    return right.to(torch.int8) - left.to(torch.int8)


def fwd_windows(knots: torch.Tensor, xs: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The forward kernel's windows in plain torch: ``[n, fwd_blocks,
    knot_splits, 2]``, the first and one past the last bin each block walks
    in each split, for ``xs`` in the order the kernel takes them (sorted)
    and ``s`` of :func:`_check`'s shapes. Per value ``s``: every bin."""
    n, m = xs.shape
    d = knots.shape[1] - 1
    p = plan(n, m, d)
    out = torch.empty(n, p.fwd_blocks, p.knot_splits, 2, dtype=torch.int64)
    for ks in range(p.knot_splits):
        b = p.fwd_bins(ks)
        out[:, :, ks, 0], out[:, :, ks, 1] = b.start, b.stop
    if s.shape[1] != 1:
        return out
    inf = float("inf")
    per = FWD_THREADS * FWD_VALUES
    xb = torch.nn.functional.pad(xs.float(), (0, p.fwd_blocks * per - m)).reshape(
        n, p.fwd_blocks, per)
    valid = (torch.arange(p.fwd_blocks * per) < m).reshape(p.fwd_blocks, per)
    nan = torch.isnan(xb)
    lo = torch.where(nan, -inf, xb).masked_fill(~valid, inf).amin(-1)
    hi = torch.where(nan, inf, xb).masked_fill(~valid, -inf).amax(-1)
    side = _sides(knots.float()[:, None, :], lo[..., None], hi[..., None],
                  _inv(s)[..., None])                             # [n, blocks, d+1]
    live = (side[..., :-1] == 0) | (side[..., :-1] != side[..., 1:])  # [n, blocks, d]
    for ks in range(p.knot_splits):
        b0, b1 = p.fwd_bins(ks).start, p.fwd_bins(ks).stop
        seg = live[..., b0:b1]
        idx = torch.arange(b0, b1)
        first = torch.where(seg, idx, d).amin(-1)
        last = torch.where(seg, idx, -1).amax(-1)
        none = last < first
        out[:, :, ks, 0] = torch.where(none, b0, first)
        out[:, :, ks, 1] = torch.where(none, b0, last + 1)
    return out


def bwd_runs(knots: torch.Tensor, xs: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The backward kernel's runs in plain torch: ``[n, splits, knot_blocks,
    BWD_WARPS, 2]``, the first and one past the last value each warp walks
    in each split (of ``xs``, sorted), by its two binary searches. Per value
    ``s``, or a warp with a NaN knot: the whole split."""
    n, m = xs.shape
    d = knots.shape[1] - 1
    p = plan(n, m, d)
    out = torch.empty(n, p.splits, p.knot_blocks, BWD_WARPS, 2, dtype=torch.int64)
    for sp in range(p.splits):
        v = p.split_values_of(sp)
        out[:, sp, ..., 0], out[:, sp, ..., 1] = v.start, v.stop
    if s.shape[1] != 1:
        return out
    k0 = (torch.arange(p.knot_blocks)[:, None] * BWD_WARPS + torch.arange(BWD_WARPS)) * WARP_BINS
    lanes = torch.clamp_max(k0[..., None] + torch.arange(32), d)     # [kb, w, 32]
    kw = knots.float()[:, lanes]                                      # [n, kb, w, 32]
    kmin, kmax = kw.amin(-1), kw.amax(-1)
    inv = _inv(s)[..., None, None]                                    # [n, 1, 1, 1]
    plain = torch.isnan(kw).any(-1) | ~(inv > 0)[..., 0]              # [n, kb, w]
    for sp in range(p.splits):
        v = p.split_values_of(sp)
        xv = xs.float()[:, None, None, v.start:v.stop]                # [n, 1, 1, L]
        idx = torch.arange(len(v))
        before = (kmin[..., None] - xv) * inv >= REACH
        rb = torch.where((~before).any(-1), (~before).int().argmax(-1), len(v))
        past = ((kmax[..., None] - xv) * inv <= -REACH) & (idx >= rb[..., None])
        re = torch.where(past[..., -1], past.int().argmax(-1), len(v))
        out[:, sp, ..., 0] = torch.where(plain, v.start, v.start + rb)
        out[:, sp, ..., 1] = torch.where(plain, v.stop, v.start + re)
    return out


def walked_pairs(knots: torch.Tensor, xs: torch.Tensor, s: torch.Tensor) -> tuple:
    """The pairs the forward and the backward walk, by :func:`fwd_windows`
    and :func:`bwd_runs`: what each adds to ``proxy.core_pairs_walked``."""
    n, m = xs.shape
    d = knots.shape[1] - 1
    p = plan(n, m, d)
    per = FWD_THREADS * FWD_VALUES
    n_vals = torch.clamp_max(m - torch.arange(p.fwd_blocks) * per, per)
    win = fwd_windows(knots, xs, s)
    fwd = int(((win[..., 1] - win[..., 0]).sum(-1) * n_vals).sum())
    owned = torch.tensor([[len(p.warp_bins(kb, w)) for w in range(BWD_WARPS)]
                          for kb in range(p.knot_blocks)])
    runs = bwd_runs(knots, xs, s)
    bwd = int(((runs[..., 1] - runs[..., 0]) * owned).sum())
    return fwd, bwd


def routes(knots, x, s) -> bool:
    """The kernels take the call: float32 CUDA tensors, and neither ``x``
    nor ``s`` requires grad (the kernels give the knots' gradient only).
    Any other dtype, float64 too, takes the plain path."""
    return bool(knots.is_cuda and knots.dtype == x.dtype == torch.float32
                and not (x.requires_grad or s.requires_grad))


def _check(knots: torch.Tensor, x: torch.Tensor, s: torch.Tensor) -> None:
    ts = (knots, x, s)
    if not all(t.is_cuda and t.device == knots.device for t in ts):
        raise ValueError("proxy core kernels need knots, x and s on one CUDA device, got "
                         f"{[str(t.device) for t in ts]}")
    if any(t.dtype != torch.float32 for t in ts):
        raise ValueError(f"proxy core kernels take float32, got {[t.dtype for t in ts]}")
    n, m = x.shape
    if knots.dim() != 2 or knots.shape[0] != n or knots.shape[1] < 2:
        raise ValueError(f"knots {tuple(knots.shape)} do not fit x {tuple(x.shape)}")
    if s.shape not in ((n, 1), (n, m)):
        raise ValueError(f"s {tuple(s.shape)} is neither [n, 1] nor [n, m] for x "
                         f"{tuple(x.shape)}")


def order_of(x: torch.Tensor, s: torch.Tensor):
    """``(xs, perm)``: each example's values in sorted order and each one's
    place in ``x`` (``torch.sort``, stable, along the values), where ``s``
    is one value per example; ``(x, None)`` where it varies per value, whose
    walk takes the values as they come."""
    if s.shape[1] != 1:
        return x, None
    return torch.sort(x, dim=1, stable=True)


def _walked(device) -> torch.Tensor:
    """The device counter a launch adds the pairs it walks to: a fresh one
    while tracing is on; while a graph is captured under :func:`holding`,
    the graph's one counter (zeroed by the graph as its first launch's
    does); else ``None``, and the kernels count nothing."""
    if torch.cuda.is_current_stream_capturing():
        if not _HELD:
            return None
        if _HELD[-1]["walked"] is None:
            _HELD[-1]["walked"] = torch.zeros((), dtype=torch.int64, device=device)
        return _HELD[-1]["walked"]
    if profiling.tracing():
        return torch.zeros((), dtype=torch.int64, device=device)
    return None


def _count_pairs(pairs: int, walked) -> None:
    count("proxy.core_pairs", pairs)
    if walked is not None:
        profiling.count_device("proxy.core_pairs_walked", walked)


def _launch(kernel: str, fn, args, pairs: int, walked) -> None:
    """The one launch site: runs ``fn(*args)`` (a C entry, which returns the
    CUDA error after its launches) and counts it, with the ``pairs`` of its
    full grid and the device counter ``walked`` of those it walks. A launch
    recorded into a CUDA graph under capture runs nothing: it goes to the
    capture's tally (:func:`holding`) and counts at each replay
    (:func:`replayed`)."""
    global launches
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"proxy core {kernel} launch failed: CUDA error {err}")
    if torch.cuda.is_current_stream_capturing():
        if _HELD:
            _HELD[-1][kernel] += 1
            _HELD[-1]["pairs"] += pairs
        return
    launches += 1
    launches_by_kernel[kernel] += 1
    count(f"proxy.core_{kernel}")
    _count_pairs(pairs, walked)


@contextlib.contextmanager
def holding():
    """Around a CUDA graph's capture: yields the launches the graph holds,
    by kernel, their full grids' pairs (``"pairs"``) and the counter of the
    pairs they walk (``"walked"``), which :func:`replayed` counts at each of
    its replays."""
    held = {**dict.fromkeys(KERNELS, 0), "pairs": 0, "walked": None}
    _HELD.append(held)
    try:
        yield held
    finally:
        _HELD.pop()


def replayed(held: dict) -> None:
    """Count the launches ``held`` (:func:`holding`) of a graph replayed
    once, as :func:`_launch` counts its own. While tracing, the walked
    counter is copied after the replay (the next one overwrites it): one
    small copy a replay."""
    global launches
    for kernel in KERNELS:
        k = held.get(kernel, 0)
        if k:
            launches += k
            launches_by_kernel[kernel] += k
            count(f"proxy.core_{kernel}", k)
    if held.get("pairs") and profiling.tracing():
        walked = held.get("walked")
        _count_pairs(held["pairs"], None if walked is None else walked.clone())


def _forward(knots: torch.Tensor, x: torch.Tensor, s: torch.Tensor,
             order=None) -> torch.Tensor:
    """The core ``[n, m]``; ``order`` is :func:`order_of` ``(x, s)``, made
    here if not given."""
    n, m = x.shape
    d = knots.shape[1] - 1
    p = plan(n, m, d)
    xs, perm = order_of(x, s) if order is None else order
    core = torch.empty_like(x)
    partials = torch.empty(p.n_fwd_partials, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        walked = _walked(x.device)
        _launch("fwd", _library().pnnp_proxy_core_fwd,
                (knots.data_ptr(), xs.data_ptr(), _ptr(perm), s.data_ptr(), n, m, d,
                 int(s.shape[1] != 1), p.knot_splits, p.split_bins, partials.data_ptr(),
                 core.data_ptr(), _ptr(walked), stream), n * m * d, walked)
    return core


def _backward(knots, x, s, g, order=None) -> torch.Tensor:
    """The knots' gradient ``[n, d+1]`` from ``g = dL/dcore``; ``order`` as
    for :func:`_forward`."""
    n, m = x.shape
    d = knots.shape[1] - 1
    p = plan(n, m, d)
    xs, perm = order_of(x, s) if order is None else order
    partials = torch.empty(p.n_partials, dtype=torch.float64, device=x.device)
    grad = torch.empty_like(knots)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        walked = _walked(x.device)
        _launch("bwd", _library().pnnp_proxy_core_bwd,
                (knots.data_ptr(), xs.data_ptr(), _ptr(perm), s.data_ptr(), g.data_ptr(), n,
                 m, d, int(s.shape[1] != 1), p.splits, p.split_values, partials.data_ptr(),
                 grad.data_ptr(), _ptr(walked), stream), n * m * d, walked)
    return grad


def _ptr(t):
    return None if t is None else t.data_ptr()


class ProxyCore(torch.autograd.Function):
    """``core [n, m]`` of ``knots [n, d+1]``, ``x [n, m]`` and ``s`` (``[n,
    1]``, one value per example, or ``[n, m]``), all f32 on one CUDA device:
    :meth:`QuantileHead._core_conv`'s law. The backward gives the knots'
    gradient and none for ``x`` or ``s``."""

    @staticmethod
    def forward(ctx, knots, x, s):
        knots, x, s = knots.contiguous(), x.contiguous(), s.contiguous()
        _check(knots, x, s)
        xs, perm = order_of(x, s)
        ctx.save_for_backward(knots, xs, perm, s)
        return _forward(knots, x, s, (xs, perm))

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        knots, xs, perm, s = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return None, None, None
        return _backward(knots, xs, s, g.contiguous().float(), (xs, perm)), None, None


def core_conv(knots: torch.Tensor, x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The kernels' core ``[n, m]`` (see :class:`ProxyCore`)."""
    if x.shape[1] == 0:
        return x.new_zeros(x.shape)
    return ProxyCore.apply(knots, x, s)
