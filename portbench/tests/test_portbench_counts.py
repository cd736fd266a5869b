"""The operation and byte counters against hand counts at small shapes."""

import math

import pytest

from portbench import counts
from portbench.reference import unet


def test_unet_flops_by_walking_the_layers():
    """Per layer: 2 x c_in x c_out x k^2 multiply-adds per output pixel of
    its level (a transposed 2x2 stride-2 layer: one tap per output pixel)."""
    nf, H, W = 8, 32, 48
    level = lambda name: int(name[4:5]) if name.startswith("conv") and name[5] == "_" else None
    total = 0
    for name, (kind, ci, co, k) in unet.layer_shapes(nf).items():
        if kind == "up":
            lvl = 10 - int(name[3:])  # upv6 outputs level 4, ..., upv9 level 1
            taps = 1
        else:
            n = int(name[4:].split("_")[0])
            lvl = n if n <= 5 else 10 - n  # conv6 at level 4, ..., conv9 at level 1, conv10 at 0
            lvl = max(lvl, 1)
            taps = k * k
        pixels = (H // 2 ** (lvl - 1)) * (W // 2 ** (lvl - 1))
        total += 2 * ci * co * taps * pixels
    assert counts.unet_forward_flops(1, H, W, nf) == pytest.approx(total)


def test_unet_flops_at_the_frames():
    assert counts.unet_flops_per_pixel(32) == pytest.approx(369_152)
    assert counts.unet_forward_flops(1, 1736, 2312) == pytest.approx(
        1744 * 2320 * 369_152)


def test_ssim_bound_by_hand():
    # the raw Sony frame: x and y of 1424 x 8512 float32 read once, one sum
    assert counts.ssim_bytes(1424, 8512) == 2 * 4 * 1424 * 8512 + 4
    assert counts.ssim_bound_s(1424, 8512) == pytest.approx(96_968_708 / 3.35e12)
    # operations: 89 a window, 3 a lane; PERF.md's count at the raw Sony frame
    assert counts.ssim_ops(10, 40) == 4 * 4 * 4 * 89 + 3 * 400
    assert counts.ssim_ops(1424, 8512) == 1_107_565_840


def test_proxy_ops_by_hand():
    """d = 2: per value 4 x 3 knot operations and 27 x 2 bin operations;
    one example of 1 x 2 x 2 has 4 pixels and 2 rows; each MLP
    2 x (2 x 16 + 16 x 16 + 16 x 5) FLOPs; the step is 3 forwards."""
    per_value = 4 * 3 + 27 * 2
    mlp = 2 * (2 * 16 + 16 * 16 + 16 * 5)
    assert counts.core_ops(1, 2) == per_value
    assert counts.proxy_nll_ops(1, 1, 2, 2, 2) == 3 * (6 * per_value + 2 * mlp)


def test_proxy_ops_at_the_recipe():
    ops = counts.proxy_nll_ops(1, 4, 512, 512, 1024)
    mlp = 2 * (2 * 16 + 16 * 16 + 16 * 1027)
    assert ops == 3 * ((4 * 512 * 512 + 4 * 512) * (4 * 1025 + 27 * 1024) + 2 * mlp)
    assert math.isclose(ops / counts.PEAK_FP32, 1.49e-3, rel_tol=0.01)
