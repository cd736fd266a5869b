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
pair once.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from dataclasses import dataclass

import torch
from torch.autograd.function import once_differentiable

from pnnp_tpu_torch.kernels.build import CSRC_DIR, load
from pnnp_tpu_torch.utils.profiling import count

SOURCE = CSRC_DIR / "proxy_core.cu"
KERNELS = ("fwd", "bwd")

# Launches since import (or since a caller reset them to 0), in all and by
# kernel; counted at the one launch site, _launch, and for a CUDA graph at
# each of its replays, replayed.
launches = 0
launches_by_kernel = dict.fromkeys(KERNELS, 0)
# The tallies of the graphs being captured (holding), innermost last.
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
# The launcher's choice of splits: the backward's values split into about
# TARGET_BLOCKS blocks (8 waves of 8 resident blocks on the H100's 132 SMs),
# no split under MIN_SPLIT values; the forward's bins split, in multiples of
# FOLD, only where its value tiles are fewer than TARGET_FWD_BLOCKS (one wave):
# the row head's 2,048 values are 4 tiles, each a serial walk of d knots.
TARGET_BLOCKS = 132 * 64
MIN_SPLIT = 256
TARGET_FWD_BLOCKS = 132 * 8
MAX_GRID_YZ = 65535


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (first use only), load and declare the C interface."""
    lib = load(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.pnnp_proxy_core_fwd.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr,
                                        ptr, ptr]
    lib.pnnp_proxy_core_fwd.restype = i32
    lib.pnnp_proxy_core_bwd.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32,
                                        ptr, ptr, ptr]
    lib.pnnp_proxy_core_bwd.restype = i32
    return lib


@dataclass(frozen=True)
class Plan:
    """Both kernels' grids for ``n`` examples of ``m`` values and ``d`` bins.

    Forward: block ``(b, ks, ex)`` takes values ``fwd_values(b)`` of example
    ``ex`` and walks the knots of bin split ``ks`` (:meth:`fwd_bins`) tile by
    tile (:meth:`knot_tiles`, each tile staged with one halo knot,
    :meth:`walked_knots` the knots whose r and erfc it computes there);
    with more than one split, each writes its sums and a second kernel adds
    them in order. Backward: block ``(kb, split, ex)``; its warp ``w`` owns
    bins :meth:`warp_bins` over values :meth:`split_values_of`, and writes a
    partial per bin and side at :meth:`partial_index`."""

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

    def knot_tiles(self, ks: int) -> list:
        """The bins of each staged tile of split ``ks`` (its knots are these
        and one more)."""
        bins = self.fwd_bins(ks)
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


def _launch(kernel: str, fn, *args) -> None:
    """The one launch site: runs ``fn(*args)`` (a C entry, which returns the
    CUDA error after its launches) and counts it. A launch recorded into a
    CUDA graph under capture runs nothing: it goes to the capture's tally
    (:func:`holding`) and counts at each replay (:func:`replayed`)."""
    global launches
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"proxy core {kernel} launch failed: CUDA error {err}")
    if torch.cuda.is_current_stream_capturing():
        if _HELD:
            _HELD[-1][kernel] += 1
        return
    launches += 1
    launches_by_kernel[kernel] += 1
    count(f"proxy.core_{kernel}")


@contextlib.contextmanager
def holding():
    """Around a CUDA graph's capture: yields the launches the graph holds,
    by kernel, which :func:`replayed` counts at each of its replays."""
    held = dict.fromkeys(KERNELS, 0)
    _HELD.append(held)
    try:
        yield held
    finally:
        _HELD.pop()


def replayed(held: dict) -> None:
    """Count the launches ``held`` (:func:`holding`) of a graph replayed
    once, as :func:`_launch` counts its own."""
    global launches
    for kernel, k in held.items():
        if k:
            launches += k
            launches_by_kernel[kernel] += k
            count(f"proxy.core_{kernel}", k)


def _forward(knots: torch.Tensor, x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    n, m = x.shape
    d = knots.shape[1] - 1
    p = plan(n, m, d)
    core = torch.empty_like(x)
    partials = torch.empty(p.n_fwd_partials, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _launch("fwd", _library().pnnp_proxy_core_fwd, knots.data_ptr(), x.data_ptr(),
                s.data_ptr(), n, m, d, int(s.shape[1] != 1), p.knot_splits, p.split_bins,
                partials.data_ptr(), core.data_ptr(), stream)
    return core


def _backward(knots, x, s, g) -> torch.Tensor:
    n, m = x.shape
    d = knots.shape[1] - 1
    p = plan(n, m, d)
    partials = torch.empty(p.n_partials, dtype=torch.float64, device=x.device)
    grad = torch.empty_like(knots)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _launch("bwd", _library().pnnp_proxy_core_bwd, knots.data_ptr(), x.data_ptr(),
                s.data_ptr(), g.data_ptr(), n, m, d, int(s.shape[1] != 1),
                p.splits, p.split_values, partials.data_ptr(), grad.data_ptr(), stream)
    return grad


class ProxyCore(torch.autograd.Function):
    """``core [n, m]`` of ``knots [n, d+1]``, ``x [n, m]`` and ``s`` (``[n,
    1]``, one value per example, or ``[n, m]``), all f32 on one CUDA device:
    :meth:`QuantileHead._core_conv`'s law. The backward gives the knots'
    gradient and none for ``x`` or ``s``."""

    @staticmethod
    def forward(ctx, knots, x, s):
        knots, x, s = knots.contiguous(), x.contiguous(), s.contiguous()
        _check(knots, x, s)
        ctx.save_for_backward(knots, x, s)
        return _forward(knots, x, s)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        knots, x, s = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return None, None, None
        return _backward(knots, x, s, g.contiguous().float()), None, None


def core_conv(knots: torch.Tensor, x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The kernels' core ``[n, m]`` (see :class:`ProxyCore`)."""
    if x.shape[1] == 0:
        return x.new_zeros(x.shape)
    return ProxyCore.apply(knots, x, s)
