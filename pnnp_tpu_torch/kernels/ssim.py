"""SSIM reduction: the eval metric's hot op, as a CUDA kernel.

Counterpart of ``pnnp_tpu/kernels/ssim.py``. The kernel
(``pnnp_tpu_torch/csrc/ssim.cu``) reads a pair of channel-interleaved flat
frames ``[H, W*C]`` once, forms the window moments and the separable 7x7 box,
evaluates the SSIM map and reduces it to one sum in a fixed order
(bit-identical from run to run). It is built with ``nvcc`` at first use and
bound through ``ctypes``. It is bound by the bytes it reads: 2 x 4 B a lane
of x and y at 3.35 TB/s, 28.9 us for the raw Sony frame ``[1424, 8512]``,
86.8 us for ``rgb_quality``'s sRGB one ``[2848, 12768]``.

Two routes compute the same function (:func:`_route` picks one from the
shape and the data's alignment), with one design: a warp walks a strip of
output rows over a chunk of pixel columns, rows stream through a small
shared-memory ring by ``cp.async`` a couple of rows ahead, four running
7-row sums stay in registers (reseeded every 8 rows) and the 7-tap
horizontal sums come from the next lanes by warp shuffles. ``hopper`` takes
C = 4 with 16-byte aligned data (the eval path's frames), a pixel being one
``float4``. ``generic`` takes any 1 <= C <= 16 (``rgb_quality``'s sRGB
frames at C = 3): a template on C whose lanes own P = 4, 2 or 1 pixels
(:func:`generic_grid` mirrors its grid), with 16-byte copies where the row
length and the data are 16-byte aligned and 4-byte copies elsewhere.

Device rule for every entry point: a CPU tensor goes through the plain-torch
version (:mod:`pnnp_tpu_torch.ops.metrics`); a CUDA tensor launches the
kernel or raises. Unlike the TPU entry points there is no size gate: the
kernel runs for any H, W >= 7.

Entry points (all over the same launch, :func:`_ssim_call_sum`):
  * :func:`ssim_flat` / :func:`_ssim_flat_kernel`: flat in, mean out (the
    eval path, ``pnnp_tpu_torch/train/steps.py``);
  * :func:`ssim_flat_sum`: flat in, the raw sum over valid windows;
  * :func:`ssim_kernel`, :func:`ssim_fast`: ``[H, W, C]`` in (a free view of
    the flat layout);
  * :func:`ssim_banded` / :func:`_ssim_bands`: channel-banded ``[C*H, W]``
    in, permuted to the flat layout in front of the kernel (and so on the
    route of that flat shape);
  * :func:`packed_to_banded`: a layout change only.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from pnnp_tpu_torch.kernels.build import CSRC_DIR, load
from pnnp_tpu_torch.ops.metrics import ssim as ssim_plain
from pnnp_tpu_torch.ops.metrics import ssim_sum as ssim_sum_plain

WIN = 7
MAX_C = 16  # the generic route's template instances (csrc/ssim.cu MAX_C)
SOURCE = CSRC_DIR / "ssim.cu"
ROUTES = ("generic", "hopper")  # the C interface's route numbers, in order

# Kernel launches since import (or since a caller reset them to 0), in all
# and by route; counted at the one launch site, _launch.
launches = 0
launches_by_route = dict.fromkeys(ROUTES, 0)


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (first use only), load and declare the C interface."""
    lib = load(SOURCE)
    lib.pnnp_ssim_num_partials.argtypes = [ctypes.c_int] * 4
    lib.pnnp_ssim_num_partials.restype = ctypes.c_int
    lib.pnnp_ssim_strip_rows.argtypes = [ctypes.c_int] * 2
    lib.pnnp_ssim_strip_rows.restype = ctypes.c_int
    lib.pnnp_ssim_blocks_per_sm.argtypes = [ctypes.c_int] * 2
    lib.pnnp_ssim_blocks_per_sm.restype = ctypes.c_int
    lib.pnnp_ssim_sum.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.pnnp_ssim_sum.restype = ctypes.c_int
    return lib


def _check(xf: torch.Tensor, yf: torch.Tensor, C: int) -> None:
    if not (xf.is_cuda and yf.is_cuda and xf.device == yf.device):
        raise ValueError(f"SSIM kernel needs both inputs on one CUDA device, "
                         f"got {xf.device} and {yf.device}")
    if xf.dtype != torch.float32 or yf.dtype != torch.float32:
        raise ValueError(f"SSIM kernel takes float32, got {xf.dtype}/{yf.dtype}")
    if xf.dim() != 2 or xf.shape != yf.shape:
        raise ValueError(f"SSIM kernel takes two [H, W*C] frames of one shape, "
                         f"got {tuple(xf.shape)} and {tuple(yf.shape)}")
    if not (xf.is_contiguous() and yf.is_contiguous()):
        raise ValueError("SSIM kernel takes contiguous inputs")
    H, L = xf.shape
    if not 1 <= C <= MAX_C or L % C:
        raise ValueError(f"lane count {L} is not a multiple of C={C} "
                         f"(1 <= C <= {MAX_C})")
    if H < WIN or L // C < WIN:
        raise ValueError(f"frame {H}x{L // C} is smaller than the {WIN}x{WIN} window")


def _route(H: int, L: int, C: int, *ptrs: int) -> str:
    """The kernel route for an ``[H, L]`` frame of ``C`` channels whose
    data start at ``ptrs``: ``hopper`` when one pixel is one 16-byte
    ``float4`` (C = 4, L % 4 == 0, 16-byte aligned data), else ``generic``.
    A pure function of the shape and the alignment; never of a failure."""
    if C == 4 and L % 4 == 0 and all(p % 16 == 0 for p in ptrs):
        return "hopper"
    return "generic"


def _ssim_call_sum(xf: torch.Tensor, yf: torch.Tensor, C: int,
                   data_range: float = 255.0, route: str | None = None) -> torch.Tensor:
    """Launch the kernel: float64 0-d SUM of the SSIM map over the
    ``C * (H-6) * (W-6)`` valid windows of flat ``[H, W*C]`` CUDA inputs.
    ``route`` defaults to :func:`_route`'s; tests and timings name one to
    hold both against the plain version. Runs on the current stream and
    does not synchronise."""
    _check(xf, yf, C)
    H, L = xf.shape
    fits = _route(H, L, C, xf.data_ptr(), yf.data_ptr())
    route = route or fits
    if route not in ROUTES or (route == "hopper" and fits != "hopper"):
        raise ValueError(f"SSIM route {route!r} does not take a [{H}, {L}] frame "
                         f"of C={C} (routes {ROUTES})")
    partials = torch.empty(_library().pnnp_ssim_num_partials(H, L, C, ROUTES.index(route)),
                           dtype=torch.float64, device=xf.device)
    out = torch.empty((), dtype=torch.float64, device=xf.device)
    _launch(xf, yf, C, data_range, route, partials, out)
    return out


def _launch(xf: torch.Tensor, yf: torch.Tensor, C: int, data_range: float,
            route: str, partials: torch.Tensor, out: torch.Tensor) -> None:
    """The one launch site: inputs checked by :func:`_ssim_call_sum`, scratch
    ``partials`` (float64, ``pnnp_ssim_num_partials`` long) and the float64
    ``out`` on the inputs' device. Counts the launch."""
    global launches
    H, L = xf.shape
    with torch.cuda.device(xf.device):
        err = _library().pnnp_ssim_sum(
            xf.data_ptr(), yf.data_ptr(), H, L, C,
            (0.01 * data_range) ** 2, (0.03 * data_range) ** 2, ROUTES.index(route),
            partials.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(xf.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"SSIM kernel launch failed: CUDA error {err}")
    launches += 1
    launches_by_route[route] += 1


def _hopper_strip_rows(H: int, L: int) -> int:
    """Output rows per strip of the ``hopper`` route for an ``[H, L]`` frame
    (the kernel's own grid rule; needs the built library)."""
    return _library().pnnp_ssim_strip_rows(H, L)


def resident_blocks_per_sm(C: int, route: str) -> int:
    """Blocks of ``route``'s kernel at ``C`` that the runtime keeps resident
    on one SM of the current device (needs the built library and a card)."""
    return _library().pnnp_ssim_blocks_per_sm(C, ROUTES.index(route))


# The generic route's grid, mirrored from csrc/ssim.cu (struct Gen and
# plan_strips): the tests hold it to covering every valid window exactly
# once, chip_smoke.py to the kernel's pnnp_ssim_num_partials.
SMS = 132  # the H100 SXM's SMs
SMEM_PER_SM = 233_472  # bytes of shared memory per SM
SMEM_RESERVED = 1024  # the runtime's share of each block
S_WARPS = 2  # warps per block
MAX_BLOCKS_PER_SM = 8
AHEAD = 2  # rows in flight per warp
MIN_STRIP = 16  # shortest strip of output rows
RESEED = 8  # output rows between fresh running sums


@dataclass(frozen=True)
class GenericGrid:
    """The ``generic`` route's grid for one ``[H, W*C]`` frame: a warp per
    strip of ``rows`` output rows and warp column of ``warp_out`` pixels;
    its lanes own ``lane_pixels`` (P) pixels each, the last ``halo_lanes``
    (D) only feed the windows of the lanes before them."""

    lane_pixels: int
    halo_lanes: int
    warp_out: int
    blocks_per_sm: int
    Hv: int
    Wv: int
    rows: int
    n_strips: int
    n_cols: int

    @property
    def n_partials(self) -> int:
        """Blocks of S_WARPS warps, one partial each."""
        return -(-self.n_strips * self.n_cols // S_WARPS)

    def input_rows(self, strip: int) -> range:
        """The input rows ``strip``'s warps read, in their order: even strips
        walk down, odd strips up. Step k >= 6 outputs the window of rows
        k-6..k of the walk."""
        o0 = strip * self.rows
        rows = range(o0, o0 + min(self.rows, self.Hv - o0) + WIN - 1)
        return rows[::-1] if strip % 2 else rows

    def output_pixel(self, col: int, lane: int, j: int) -> int:
        """The output pixel of pixel ``j`` of ``lane`` in warp column
        ``col``, or -1 where the kernel's mask drops it."""
        k = lane * self.lane_pixels + j
        p = col * self.warp_out + k
        return p if k < self.warp_out and p < self.Wv else -1


def generic_grid(H: int, L: int, C: int) -> GenericGrid:
    """The ``generic`` route's grid for an ``[H, L]`` frame of ``C``
    channels: P = 4 pixels a lane up to C = 4, 2 up to C = 8, 1 above; a
    window reaches D = ceil(6 / P) lanes to the right; a warp outputs the
    largest multiple of 4 / gcd(C, 4) pixels not over (32 - D) P, so that
    every warp column starts 16-byte aligned; as many blocks per SM as the
    rings' shared memory allows; the strip height is the shortest (not under
    MIN_STRIP) that keeps every warp resident in one wave."""
    P = 4 if C <= 4 else 2 if C <= 8 else 1
    D = -(-(WIN - 1) // P)
    align = 1 if C % 4 == 0 else 2 if C % 2 == 0 else 4
    out = (32 - D) * P // align * align
    smem = 4 * (WIN + AHEAD) * 2 * 32 * P * C * S_WARPS
    blocks = min(MAX_BLOCKS_PER_SM, SMEM_PER_SM // (smem + SMEM_RESERVED + 8 * S_WARPS))
    Hv, Wv = H - (WIN - 1), L // C - (WIN - 1)
    n_cols = -(-Wv // out)
    want = max(1, SMS * blocks * S_WARPS // n_cols)
    rows = max(MIN_STRIP, -(-Hv // want))
    return GenericGrid(P, D, out, blocks, Hv, Wv, rows, -(-Hv // rows), n_cols)


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.is_cuda:
        return False
    raise ValueError(f"SSIM runs on CPU or CUDA tensors, got {t.device}")


def ssim_flat_plain(xf: torch.Tensor, yf: torch.Tensor, C: int = 4,
                    data_range: float = 255.0) -> torch.Tensor:
    """The kernel's plain version on flat ``[H, W*C]`` inputs (any device)."""
    H = xf.shape[0]
    return ssim_plain(xf.reshape(H, -1, C), yf.reshape(H, -1, C),
                      data_range=data_range)


def _ssim_flat_kernel(xf: torch.Tensor, yf: torch.Tensor, C: int,
                      data_range: float = 255.0) -> torch.Tensor:
    """Mean SSIM (float32 0-d) of flat ``[H, W*C]`` f32 CUDA inputs."""
    H, L = xf.shape
    n = C * (H - (WIN - 1)) * (L // C - (WIN - 1))
    return (_ssim_call_sum(xf, yf, C, data_range) / n).float()


def ssim_flat(xf: torch.Tensor, yf: torch.Tensor, C: int = 4,
              data_range: float = 255.0) -> torch.Tensor:
    """Mean SSIM from channel-interleaved flat ``[H, W*C]`` inputs: the
    kernel on CUDA, the plain version on the CPU."""
    if _on_cpu(xf):
        return ssim_flat_plain(xf, yf, C, data_range)
    return _ssim_flat_kernel(xf.float(), yf.float(), C, data_range)


def ssim_flat_sum(xf: torch.Tensor, yf: torch.Tensor, C: int = 4,
                  data_range: float = 255.0) -> torch.Tensor:
    """SUM of the valid-window SSIM map from flat ``[H, W*C]`` inputs:
    :func:`ssim_flat` times ``(H-6) * (W-6) * C``. This is the partial the
    width-sharded eval adds up over shards (ROADMAP 1.16)."""
    if _on_cpu(xf):
        H = xf.shape[0]
        return ssim_sum_plain(xf.reshape(H, -1, C), yf.reshape(H, -1, C),
                              data_range=data_range)
    return _ssim_call_sum(xf.float(), yf.float(), C, data_range).float()


def ssim_kernel(x: torch.Tensor, y: torch.Tensor,
                data_range: float = 255.0) -> torch.Tensor:
    """Mean SSIM of an ``[H, W, C]`` pair through the kernel (CUDA) or the
    plain version (CPU). ``[H, W, C]`` contiguous is the flat layout."""
    H, W, C = x.shape
    if _on_cpu(x):
        return ssim_plain(x, y, data_range=data_range)
    return _ssim_flat_kernel(x.float().reshape(H, W * C).contiguous(),
                             y.float().reshape(H, W * C).contiguous(), C,
                             data_range)


# With no size gate on the card, the guarded entry is the kernel entry.
ssim_fast = ssim_kernel


def _banded_to_flat(t: torch.Tensor, C: int) -> torch.Tensor:
    CH, W = t.shape
    return t.reshape(C, CH // C, W).permute(1, 2, 0).reshape(CH // C, W * C)


def _ssim_bands(xf: torch.Tensor, yf: torch.Tensor, C: int,
                data_range: float = 255.0) -> torch.Tensor:
    """Mean SSIM from channel-banded ``[C*H, W]`` f32 CUDA inputs: a permute
    to the flat layout in front of the same kernel."""
    return _ssim_flat_kernel(_banded_to_flat(xf, C).contiguous(),
                             _banded_to_flat(yf, C).contiguous(), C, data_range)


def ssim_banded(xf: torch.Tensor, yf: torch.Tensor, C: int = 4,
                data_range: float = 255.0) -> torch.Tensor:
    """Mean SSIM from channel-banded ``[C*H, W]`` inputs."""
    if _on_cpu(xf):
        H = xf.shape[0] // C
        unband = lambda t: t.reshape(C, H, -1).permute(1, 2, 0)
        return ssim_plain(unband(xf), unband(yf), data_range=data_range)
    return _ssim_bands(xf.float(), yf.float(), C, data_range)


def packed_to_banded(g: torch.Tensor) -> torch.Tensor:
    """4x4-superpixel packed ``[h2, w2, 16]`` -> channel-banded ``[4*H, W]``
    (H = 2*h2, W = 2*w2). Packed channel (2a+b)*4+c at (i, j) is unpacked
    pixel (c, 2i+a, 2j+b)."""
    h2, w2, c16 = g.shape
    if c16 != 16:
        raise ValueError(f"packed frames have 16 channels, got {tuple(g.shape)}")
    t = g.reshape(h2, w2, 2, 2, 4).permute(4, 0, 2, 1, 3)  # [4,h2,2,w2,2]
    return t.reshape(4 * 2 * h2, 2 * w2)
