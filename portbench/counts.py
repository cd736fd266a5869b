"""Operations and bytes of the port's work, from shapes, and the peaks of one
NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W limit).

* :func:`unet_flops_per_pixel` / :func:`unet_forward_flops`: the
  UNetSeeInDark forward's multiply-adds x 2, convolutions only (pooling,
  activations, concatenation and bias adds are not counted).
* :func:`ssim_bytes` / :func:`ssim_ops`: the SSIM kernel's bound. Bytes:
  both flat float32 inputs read once and the float32 sum written once.
  Operations: 89 float32 operations a window and 3 a lane, as the kernel's
  design counts them.
* :func:`proxy_nll_ops`: the proxy NLL step, each count read off
  ``pnnp_tpu_torch/models/proxy.py`` (``QuantileHead._core_conv``), one
  operation per element of each elementwise call, a special function
  (erfc, exp) counted as one.
"""

from __future__ import annotations

PEAK_BF16 = 989e12      # FLOP/s, dense bf16 tensor cores
PEAK_FP32 = 67e12       # FLOP/s, float32 outside the tensor cores
PEAK_HBM = 3.35e12      # bytes/s
SSIM_WIN = 7


def unet_flops_per_pixel(nf: int = 32, in_nc: int = 4, out_nc: int = 4) -> float:
    """Forward FLOPs of UNetSeeInDark per full-resolution pixel: two 3x3
    convolutions a level (level k at 1/4^k of the pixels), per decoder
    level a 2x2 stride-2 transposed convolution (one tap per output pixel)
    and two 3x3 convolutions, and a 1x1 head."""
    conv = lambda ci, co, k=3: 2 * k * k * ci * co
    chans = [nf * 2**k for k in range(5)]
    enc = conv(in_nc, nf) + conv(nf, nf) + sum(
        (conv(chans[k - 1], chans[k]) + conv(chans[k], chans[k])) / 4**k for k in range(1, 5))
    dec = sum((2 * chans[k + 1] * chans[k] + conv(2 * chans[k], chans[k])
               + conv(chans[k], chans[k])) / 4**k for k in range(4))
    return enc + dec + conv(nf, out_nc, 1)


def padded(n: int, mult: int = 16) -> int:
    return n + (-n) % mult


def unet_forward_flops(n: int, h: int, w: int, nf: int = 32) -> float:
    """Forward FLOPs of ``n`` packed frames ``h x w``, at the shape the
    network runs (each side padded to a multiple of 16)."""
    return n * padded(h) * padded(w) * unet_flops_per_pixel(nf)


def ssim_bytes(h: int, length: int) -> int:
    """Bytes of one SSIM launch on flat ``[h, length]`` float32 inputs."""
    return 2 * 4 * h * length + 4


def ssim_ops(h: int, length: int, c: int = 4) -> int:
    w = length // c
    return c * (h - SSIM_WIN + 1) * (w - SSIM_WIN + 1) * 89 + 3 * h * length


def ssim_bound_s(h: int, length: int, c: int = 4) -> float:
    """The least time of one SSIM launch: bytes or operations, the larger."""
    return max(ssim_bytes(h, length) / PEAK_HBM, ssim_ops(h, length, c) / PEAK_FP32)


# Operations of the Gaussian-convolved bin law per (value, knot) and per
# (value, bin), as QuantileHead._core_conv computes them:
#   per knot (d + 1): addcmul 2, abs 1, erfc 1
#   per bin (d): ea - eb 1; the tail-side mass: -diff 1, 2 - ea - eb 2,
#   two compares 2, two selects 2; h = width * c 1; hs2 = clamp, square,
#   / 24: 3; m2 = square(0.5 * (ra + rb)): 3; narrow = exp(-m2) * c *
#   (1 + (2 m2 - 1) hs2): 8; dens = where(h < c, narrow, mass2 / c): 3;
#   the sum over bins 1
CORE_OPS_PER_KNOT = 4
CORE_OPS_PER_BIN = 1 + 7 + 1 + 3 + 3 + 8 + 3 + 1


def core_ops(values: int, d: int) -> int:
    """Forward operations of the bin law at ``values`` values."""
    return values * (CORE_OPS_PER_KNOT * (d + 1) + CORE_OPS_PER_BIN * d)


def mlp_flops(d: int, nf: int = 16, nb: int = 2, n_feat: int = 2) -> int:
    """Forward FLOPs of one stage's head MLP for one example."""
    dims = [n_feat] + [nf] * nb + [d + 3]
    return sum(2 * a * b for a, b in zip(dims, dims[1:]))


def proxy_nll_ops(n: int, c: int, h: int, w: int, d: int, nf: int = 16, nb: int = 2) -> int:
    """Operations of one proxy NLL step (forward and backward, the backward
    counted as twice the forward) on ``[n, c, h, w]``: the pixel law at every
    pixel, the row law at every (row, channel), both heads' MLPs. The
    chunks' recomputation in the backward is the implementation's and is not
    counted."""
    fwd = core_ops(n * c * h * w, d) + core_ops(n * c * h, d) + 2 * n * mlp_flops(d, nf, nb)
    return 3 * fwd
