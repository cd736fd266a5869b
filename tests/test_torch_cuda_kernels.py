"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU (``cuda`` marker) and skip on a host without
one: a CUDA kernel has no CPU or interpret mode. This file imports no JAX,
so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest -q

Both routes of the SSIM kernel (``hopper`` for C = 4, ``generic`` for any C)
are held against the plain version at every shape they take. Tolerance: 1e-4
of the mean SSIM (f32 sums taken in another order); two launches on the same
inputs are bit-identical (fixed-order reduction); at the full frames the two
routes agree within 1e-5.
"""

import numpy as np
import pytest
import torch

import pnnp_tpu_torch.kernels.ssim as K

TOL = 1e-4
ROUTE_TOL = 1e-5
# The hopper route's shortest strip (csrc/ssim.cu MIN_STRIP): the strip height
# of every frame narrow enough to fill the card with strips this short.
STRIP = 16
SONY, IMX686 = (1424, 2128, 4), (1736, 2312, 4)
SHAPES = [(7, 7, 4), (70, 96, 4), (71, 96, 4), (96, 131, 3), (201, 140, 4), SONY,
          IMX686,
          # strip edges: H - 6 = STRIP, STRIP + 1 and 2 STRIP - 1 output rows;
          # widths that end one pixel into a warp's 6-pixel halo (121) and
          # one output pixel into the next warp (127)
          (STRIP + 6, 121, 4), (STRIP + 7, 127, 4), (2 * STRIP + 5, 126, 4)]
DRIFT = (1424, 256, 4)


def structured(shape, seed):
    """Vertical gradient + per-channel scale + noise, on [0, 255] (as
    tests/test_kernels_ssim.py): iid frames would hide band/stride bugs."""
    rng = np.random.default_rng(seed)
    H, W, C = shape
    grad = np.linspace(0, 200, H, dtype=np.float32)[:, None, None]
    chans = (np.arange(C, dtype=np.float32) + 1.0)[None, None, :] * 20.0
    x = np.clip(grad + chans + rng.uniform(0, 40, shape).astype(np.float32),
                0, 255)
    y = np.clip(x + rng.normal(0, 12, shape).astype(np.float32), 0, 255)
    return x, y


def bright(shape, seed):
    """A tall bright low-variance pair, 200 + N(0, 0.5): the window sums are
    large and the variances small, so running sums that drift would show."""
    rng = np.random.default_rng(seed)
    x = (200.0 + rng.normal(0, 0.5, shape)).astype(np.float32)
    y = (x + rng.normal(0, 0.5, shape)).astype(np.float32)
    return x, y


def ssim_f64(x, y, data_range=255.0):
    """Mean SSIM of an ``[H, W, C]`` pair in float64 (numpy and scipy's
    uniform filter, cropped to the valid windows, as skimage does)."""
    from scipy.ndimage import uniform_filter

    x, y = x.astype(np.float64), y.astype(np.float64)
    box = lambda a: uniform_filter(a, size=(7, 7, 1))[3:-3, 3:-3]
    ux, uy = box(x), box(y)
    cn = 49.0 / 48.0
    vx, vy = cn * (box(x * x) - ux * ux), cn * (box(y * y) - uy * uy)
    vxy = cn * (box(x * y) - ux * uy)
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    return float(np.mean((2 * ux * uy + c1) * (2 * vxy + c2)
                         / ((ux * ux + uy * uy + c1) * (vx + vy + c2))))


def routes(C):
    """The routes that take a frame of C channels."""
    return ("generic", "hopper") if C == 4 else ("generic",)


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the SSIM kernel has no CPU mode")
    return torch.device("cuda")


def _flat(pair, card):
    H, W, C = pair[0].shape
    return [torch.from_numpy(a.reshape(H, W * C)).to(card) for a in pair]


def _route_sum(xf, yf, C, route):
    """Two launches on ``route``: the sum, checked bit-identical, and the
    counts showing that this route (and no other) ran."""
    before = dict(K.launches_by_route)
    a = K._ssim_call_sum(xf, yf, C, route=route)
    b = K._ssim_call_sum(xf, yf, C, route=route)
    torch.cuda.synchronize()
    assert torch.equal(a, b), f"{route}: two launches differ"
    assert K.launches_by_route == dict(before, **{route: before[route] + 2})
    return float(a)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_ssim_kernel_matches_plain(card, shape):
    x, y = structured(shape, 0)
    H, W, C = shape
    xf, yf = _flat((x, y), card)
    ref = float(K.ssim_flat_plain(xf, yf, C))
    n = (H - 6) * (W - 6) * C
    for route in routes(C):
        assert abs(_route_sum(xf, yf, C, route) / n - ref) < TOL, route
    default = K._route(H, W * C, C, xf.data_ptr(), yf.data_ptr())
    assert default == ("hopper" if C == 4 else "generic")
    before, by_route = K.launches, dict(K.launches_by_route)
    a = K.ssim_flat(xf, yf, C)
    b = K.ssim_flat(xf, yf, C)
    torch.cuda.synchronize()
    assert K.launches == before + 2
    assert K.launches_by_route[default] == by_route[default] + 2
    assert abs(float(a) - ref) < TOL
    assert torch.equal(a, b)
    assert abs(float(K.ssim_flat_sum(xf, yf, C)) - ref * n) < TOL * n
    band = lambda t: t.reshape(H, W, C).permute(2, 0, 1).reshape(C * H, W)
    assert abs(float(K.ssim_banded(band(xf), band(yf), C)) - ref) < TOL
    assert abs(float(K.ssim_kernel(xf.reshape(H, W, C), yf.reshape(H, W, C))) - ref) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES[-3:])
def test_ssim_strip_edge_shapes_are_at_the_edges(card, shape):
    """The edge shapes above sit where they claim, by the kernel's own rule."""
    H, W, C = shape
    assert K._hopper_strip_rows(H, W * C) == STRIP
    assert H - 6 in (STRIP, STRIP + 1, 2 * STRIP - 1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [SONY, IMX686])
def test_ssim_routes_agree_at_full_frames(card, shape):
    H, W, C = shape
    xf, yf = _flat(structured(shape, 2), card)
    n = (H - 6) * (W - 6) * C
    hop, gen = (_route_sum(xf, yf, C, r) / n for r in ("hopper", "generic"))
    assert abs(hop - gen) < ROUTE_TOL, (hop, gen)


@pytest.mark.cuda
def test_ssim_running_sums_do_not_drift(card):
    """Both routes on a tall bright low-variance frame, against float64."""
    x, y = bright(DRIFT, 0)
    H, W, C = DRIFT
    xf, yf = _flat((x, y), card)
    ref = ssim_f64(x, y)
    n = (H - 6) * (W - 6) * C
    for route in routes(C):
        assert abs(_route_sum(xf, yf, C, route) / n - ref) < TOL, route


@pytest.mark.cuda
def test_ssim_wrapper_rejects_what_the_kernel_does_not_take(card):
    x = torch.zeros(16, 64, device=card)
    with pytest.raises(ValueError, match="float32"):
        K._ssim_call_sum(x.double(), x.double(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        K._ssim_call_sum(x.t(), x.t(), 4)
    with pytest.raises(ValueError, match="multiple"):
        K._ssim_call_sum(x, x, 3)
    with pytest.raises(ValueError, match="smaller"):
        K._ssim_call_sum(x[:6], x[:6], 4)
    x3 = torch.zeros(16, 63, device=card)
    with pytest.raises(ValueError, match="route"):
        K._ssim_call_sum(x3, x3, 3, route="hopper")
    # 4 bytes off 16-byte alignment: the generic route, never hopper
    off = torch.zeros(16 * 64 + 1, device=card)[1:].view(16, 64)
    assert K._route(16, 64, 4, off.data_ptr()) == "generic"
    with pytest.raises(ValueError, match="route"):
        K._ssim_call_sum(off, off, 4, route="hopper")
    before = dict(K.launches_by_route)
    K._ssim_call_sum(off, off, 4)
    torch.cuda.synchronize()
    assert K.launches_by_route["generic"] == before["generic"] + 1
