"""Tiled-reduction SSIM: the eval metric's hot op, as a CUDA kernel.

Counterpart of ``pnnp_tpu/kernels/ssim.py``. The kernel
(``pnnp_tpu_torch/csrc/ssim.cu``) reads a pair of channel-interleaved flat
frames ``[H, W*C]`` once, forms the window moments and the separable 7x7 box,
evaluates the SSIM map and reduces it to one sum in a fixed order
(bit-identical from run to run). It is built with ``nvcc`` at first use and
bound through ``ctypes``.

Two routes compute the same function (:func:`_route` picks one from the
shape and the data's alignment): ``hopper`` streams row strips through a shared-memory ring
with coalesced 16-byte copies and keeps the window sums in registers, for
C = 4 (the eval path's frames); ``generic`` stages halo tiles in shared
memory, for any 1 <= C <= 16.

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

import torch

from pnnp_tpu_torch.kernels.build import CSRC_DIR, load
from pnnp_tpu_torch.ops.metrics import ssim as ssim_plain
from pnnp_tpu_torch.ops.metrics import ssim_sum as ssim_sum_plain

WIN = 7
MAX_C = 16  # shared-memory tile width grows with C (csrc/ssim.cu smem_bytes)
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
