"""Exact int8 convolutions with int32 accumulation (the W8A8 serving path's
convolutions, ``pnnp_tpu_torch/models/unet_s2d_int8.py``).

The JAX package computes these in XLA: ``lax.conv_general_dilated(s8, s8,
preferred_element_type=s32)`` and ``lax.conv_transpose`` likewise
(``pnnp_tpu/models/unet_s2d_int8.py:68-72``, ``:138-150``); no Pallas
kernel. Eager PyTorch has no int8 convolution, so each is an implicit GEMM
here: im2col of the int8 activations into ``[M, K]`` rows, one
``torch._int_mm`` (cuBLASLt's int8 GEMM on the card, s8 x s8 -> s32) against
the ``[K, N]`` kernel, on the CPU and on the card alike. Every sum is an
integer sum, so the result is exact and equal on both.

cuBLASLt's int8 GEMM takes ``M > 16`` and ``K``, ``N`` multiples of 8: the
rows, the depth and the columns are padded with zeros (exact) where they
fall short (conv9_1's up half reads ``2nf + 1`` channels: K = 585 at
nf = 32). The im2col is built in row chunks of at most ``CHUNK_BYTES`` (a
full Sony frame's level 1 would be 757,568 x 1152 int8, 0.87 GB in one).
Nothing falls back to a float path: a GEMM that fails raises.

Layouts: activations NCHW-logical ``[N, C, H, W]`` (any memory format;
``channels_last`` reads with no copy), kernels in torch's layouts (conv
OIHW ``[D, C, 3, 3]``, transposed conv ``[C, D, 2, 2]``), results int32 in
``channels_last`` memory.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

CHUNK_BYTES = 1 << 28  # im2col rows per GEMM: at most 256 MiB of int8


def _pad_to(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact ``[M, K] int8 @ [K, N] int8 -> [M, N] int32`` through
    ``torch._int_mm``, zero-padding M to > 16 and K, N to multiples of 8."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise ValueError(f"int_mm takes int8 operands, got {a.dtype} and {b.dtype}")
    M, K = a.shape
    N = b.shape[1]
    Mp, Kp, Np = max(M, 17), _pad_to(K, 8), _pad_to(N, 8)
    if (Mp, Kp) != (M, K):
        a = F.pad(a, (0, Kp - K, 0, Mp - M))
    if (Kp, Np) != (K, N):
        b = F.pad(b, (0, Np - N, 0, Kp - K))
    out = torch._int_mm(a.contiguous(), b)
    return out[:M, :N] if (Mp, Np) != (M, N) else out


def _check(x: torch.Tensor, k: torch.Tensor) -> None:
    if x.dtype != torch.int8 or k.dtype != torch.int8:
        raise ValueError(f"int8 conv takes int8 operands, got {x.dtype} and {k.dtype}")
    if x.device != k.device:
        raise ValueError(f"int8 conv operands on {x.device} and {k.device}")


def conv3x3_int8(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """3x3 SAME stride-1 conv, ``x`` int8 ``[N, C, H, W]``, ``k`` int8 OIHW
    ``[D, C, 3, 3]`` -> exact int32 ``[N, D, H, W]``.

    im2col over the NHWC view: row (n, y, x) holds the 9 taps' C channels,
    tap-major (``K = 9*C``, the kernel reshaped alike), zero-padded to a
    multiple of 8."""
    _check(x, k)
    n, C, H, W = x.shape
    D = k.shape[0]
    K = 9 * C
    Kp = _pad_to(K, 8)
    xp = F.pad(x.permute(0, 2, 3, 1), (0, 0, 1, 1, 1, 1))  # [N, H+2, W+2, C]
    # b as the transposed view of a contiguous [D, Kp]: cuBLASLt's
    # row-major A x column-major B int8 form
    bt = k.permute(0, 2, 3, 1).reshape(D, K)
    if Kp != K:
        bt = F.pad(bt, (0, Kp - K))
    b = bt.contiguous().t()
    out = torch.empty((n, H, W, D), dtype=torch.int32, device=x.device)
    rows = max(1, CHUNK_BYTES // (n * W * Kp))
    zeros = [x.new_zeros((n, min(rows, H), W, Kp - K))] if Kp != K else []
    for y0 in range(0, H, rows):
        y1 = min(H, y0 + rows)
        taps = [xp[:, y0 + dy:y1 + dy, dx:dx + W] for dy in range(3) for dx in range(3)]
        pad = [z[:, :y1 - y0] for z in zeros]
        cols = torch.cat(taps + pad, dim=3).reshape(-1, Kp)
        out[:, y0:y1] = int_mm(cols, b).reshape(n, y1 - y0, W, D)
    return out.permute(0, 3, 1, 2)


def conv_transpose2x2_int8(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 transposed conv, ``x`` int8 ``[N, C, H, W]``, ``k`` int8
    ``[C, D, 2, 2]`` (``nn.ConvTranspose2d``'s layout) -> exact int32
    ``[N, D, 2H, 2W]``: one GEMM ``[N*H*W, C] x [C, 4D]``, whose column
    ``(2a + b)*D + d`` is output sub-position (a, b)."""
    _check(x, k)
    n, C, H, W = x.shape
    D = k.shape[1]
    a = x.permute(0, 2, 3, 1).reshape(-1, C)
    b = k.permute(2, 3, 1, 0).reshape(4 * D, C).contiguous().t()
    y = int_mm(a, b).reshape(n, H, W, 2, 2, D)
    y = y.permute(0, 1, 3, 2, 4, 5).reshape(n, 2 * H, 2 * W, D)
    return y.permute(0, 3, 1, 2)
