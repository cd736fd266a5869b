"""The ``generic`` SSIM route's grid and lane arithmetic, on the CPU.

The CUDA kernel (``pnnp_tpu_torch/csrc/ssim.cu``, ``ssim_generic_kernel<C>``)
runs only on the card. Its grid rule is mirrored in Python
(``pnnp_tpu_torch.kernels.ssim.generic_grid``; ``chip_smoke.py`` holds the
mirror to the kernel's ``pnnp_ssim_num_partials``), and this file holds the
mirror to covering every valid window exactly once, and a float32 numpy model
of the lanes (running sums seeded and slid in each strip's walk order,
per-channel suffix sums plus the prefix sums that ``__shfl_down_sync`` brings
from the next lanes, the folded SSIM formula, the mask) to the plain SSIM
within 1e-5 of the mean. JAX-free.
"""

import re

import numpy as np
import pytest
import torch

import pnnp_tpu_torch.kernels.ssim as K
from pnnp_tpu_torch.ops.metrics import ssim as plain_ssim
from tests.test_torch_cuda_kernels import DRIFT3, bright, structured

WIN = 7
MODEL_TOL = 1e-5
# frames of every path that reaches the generic route: rgb_quality's sRGB
# frames (C = 3) and the raw frames when forced onto it (C = 4)
FRAMES = [(2848, 4256, 3), (3472, 4624, 3), (1424, 2128, 4), (1736, 2312, 4)]


def _cover_ok(g, H, W, C):
    """Every valid window of an [H, W*C] frame exactly once, and each
    window inside the rows and the lanes its warp holds."""
    Hv, Wv = H - (WIN - 1), W - (WIN - 1)
    assert (g.Hv, g.Wv) == (Hv, Wv)
    # warps in grid order map one to one onto (strip, warp column)
    warps = [(w // g.n_cols, w % g.n_cols)
             for w in range(g.n_partials * K.S_WARPS) if w < g.n_strips * g.n_cols]
    assert len(set(warps)) == g.n_strips * g.n_cols
    # rows: step k >= 6 of a strip's walk outputs the top row of its window
    rows = np.zeros(Hv, np.int64)
    for strip in range(g.n_strips):
        walk = list(g.input_rows(strip))
        assert walk[0] < H and walk[-1] < H and min(walk) >= 0
        for k in range(WIN - 1, len(walk)):
            window = walk[k - (WIN - 1):k + 1]
            assert max(window) - min(window) == WIN - 1
            rows[min(window)] += 1
    assert (rows == 1).all(), np.flatnonzero(rows != 1)[:8]
    # columns: the kernel's mask; each output pixel's 7 pixels within its
    # warp's 32 P loaded ones, and within the next D lanes
    P, D = g.lane_pixels, g.halo_lanes
    cols = np.zeros(Wv, np.int64)
    for col in range(g.n_cols):
        assert col * g.warp_out * C % 4 == 0  # 16-byte aligned warp column
        for lane in range(32):
            for j in range(P):
                p = g.output_pixel(col, lane, j)
                if p < 0:
                    continue
                assert lane < 32 - D and lane + (j + WIN - 1) // P <= 31
                assert p + WIN - 1 < col * g.warp_out + 32 * P
                cols[p] += 1
    assert (cols == 1).all(), np.flatnonzero(cols != 1)[:8]


@pytest.mark.parametrize("C", range(1, K.MAX_C + 1))
def test_generic_grid_covers_every_window_once(C):
    """A sweep of heights (strip edges: 1, 16, 17, 31, 32, 33 output rows)
    and widths (one output pixel; one pixel short of a warp's output, its
    whole output, one pixel into its halo, one output pixel into the next
    warp; four warp columns, the last ragged) at every C."""
    out = K.generic_grid(64, 64 * C, C).warp_out
    widths = {WIN, out + 1, out + 5, out + 6, out + 7, 3 * out + 10}
    for H in (7, 22, 23, 37, 38, 39):
        for W in sorted(widths):
            g = K.generic_grid(H, W * C, C)
            assert g.rows == K.MIN_STRIP  # frames this small take the shortest strips
            _cover_ok(g, H, W, C)


@pytest.mark.parametrize("shape", FRAMES)
def test_generic_grid_at_full_frames(shape):
    """At the full frames: exact cover, one wave (every warp resident), and
    strips longer than the shortest, so the running sums are reseeded."""
    H, W, C = shape
    g = K.generic_grid(H, W * C, C)
    _cover_ok(g, H, W, C)
    assert g.n_strips * g.n_cols <= K.SMS * g.blocks_per_sm * K.S_WARPS
    assert g.rows > K.MIN_STRIP
    ring = 4 * (WIN + K.AHEAD) * 2 * 32 * g.lane_pixels * C * K.S_WARPS
    assert g.blocks_per_sm * (ring + K.SMEM_RESERVED + 16) <= K.SMEM_PER_SM


@pytest.mark.parametrize("C,P,D,out,blocks", [
    (1, 4, 2, 120, 8), (2, 4, 2, 120, 6), (3, 4, 2, 120, 4), (4, 4, 2, 120, 3),
    (5, 2, 3, 56, 4), (6, 2, 3, 58, 4), (8, 2, 3, 58, 3), (9, 1, 6, 24, 5),
    (10, 1, 6, 26, 4), (16, 1, 6, 26, 3)])
def test_generic_lane_shape(C, P, D, out, blocks):
    """P(C), the halo lanes, the warp's output width and the blocks per SM
    that the rings' shared memory allows, as the kernel's header states."""
    g = K.generic_grid(64, 64 * C, C)
    assert (g.lane_pixels, g.halo_lanes, g.warp_out, g.blocks_per_sm) == (P, D, out, blocks)
    assert P * C <= 16  # the running sums stay in registers


def test_generic_grid_mirror_matches_the_source():
    """The mirror's constants are the kernel's (csrc/ssim.cu)."""
    src = K.SOURCE.read_text()
    for name, value in (("SMS", K.SMS), ("SMEM_PER_SM", K.SMEM_PER_SM),
                        ("SMEM_RESERVED", K.SMEM_RESERVED), ("MIN_STRIP", K.MIN_STRIP),
                        ("RESEED", K.RESEED), ("S_WARPS", K.S_WARPS),
                        ("G_MAX_BLOCKS_PER_SM", K.MAX_BLOCKS_PER_SM), ("MAX_C", K.MAX_C)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert re.search(rf"static constexpr int AHEAD = {K.AHEAD};", src)
    assert "P = C <= 4 ? 4 : C <= 8 ? 2 : 1;" in src
    assert "ALIGN = C % 4 == 0 ? 1 : C % 2 == 0 ? 2 : 4;" in src


# ---------------------------------------------------------------- lane model

def _shfl_down(a, d):
    """__shfl_down_sync over the lane axis (1): lane + d, or the lane's own
    value where lane + d is past the warp."""
    lanes = np.arange(32)
    return a[:, np.where(lanes + d < 32, lanes + d, lanes)]


def _horizontal(v, P, D, shuffles):
    """7-tap sums of one running sum ``v`` [n_cols, 32, P, C]: the suffix
    sums of the lane's own pixels plus, for d = 1..D, prefix sum
    min(j+6-dP, P-1) of lane + d. Records the (d, i) shuffles used."""
    pre = np.cumsum(v, axis=2, dtype=np.float32)
    suf = np.flip(np.cumsum(np.flip(v, 2), axis=2, dtype=np.float32), 2)
    h = suf.copy()
    for j in range(P):
        for d in range(1, D + 1):
            e = j + WIN - 1 - d * P
            if e >= 0:
                i = min(e, P - 1)
                shuffles.add((d, i))
                h[:, :, j] += _shfl_down(pre, d)[:, :, i]
    return h


def lane_model(x, y, data_range=255.0):
    """The generic route's arithmetic on an [H, W, C] pair in float32 numpy,
    lane by lane and strip by strip. Returns the SSIM map [Hv, Wv, C] (each
    window written by the lane that owns it), how many times each window was
    written, and the (d, i) shuffles of the horizontal pass."""
    H, W, C = x.shape
    g = K.generic_grid(H, W * C, C)
    P, D = g.lane_pixels, g.halo_lanes
    pix = (np.arange(g.n_cols)[:, None, None] * g.warp_out
           + np.arange(32)[None, :, None] * P + np.arange(P)[None, None, :])
    out = np.array([[[g.output_pixel(c, lane, j) for j in range(P)] for lane in range(32)]
                    for c in range(g.n_cols)])
    mask = (out >= 0).astype(np.float32)[..., None]

    def chunks(a):  # [H, n_cols, 32, P, C], zero past the right edge
        pad = np.zeros((H, pix.max() + 1, C), np.float32)
        pad[:, :W] = a
        return pad[:, pix]

    xc, yc = chunks(x), chunks(y)
    n = np.float32(WIN * WIN)
    cn = n / np.float32(n - 1)
    c1, c2 = np.float32((0.01 * data_range) ** 2), np.float32((0.03 * data_range) ** 2)
    k_a1, k_b1 = np.float32(2) / (n * n), np.float32(1) / (n * n)
    k_a2, k_a2q = np.float32(2) * cn / n, np.float32(-2) * cn / (n * n)
    k_b2, k_b2q = cn / n, -cn / (n * n)

    ssim_map = np.zeros((g.Hv, g.Wv, C), np.float32)
    written = np.zeros((g.Hv, g.Wv, C), np.int64)
    shuffles = set()
    sel = out >= 0
    for strip in range(g.n_strips):
        walk = list(g.input_rows(strip))
        s = np.zeros((4,) + xc.shape[1:], np.float32)
        for k in range(len(walk)):
            if k >= WIN - 1 and (k - (WIN - 1)) % K.RESEED == 0:  # seed, oldest first
                s[:] = 0
                for t in range(k - (WIN - 1), k + 1):
                    a, b = xc[walk[t]], yc[walk[t]]
                    s += np.stack([a, b, a * a + b * b, a * b])
            elif k >= WIN:  # slide: add row k, drop row k-7
                a, b = xc[walk[k]], yc[walk[k]]
                p, q = xc[walk[k - WIN]], yc[walk[k - WIN]]
                s += np.stack([a - p, b - q, a * a + b * b - p * p - q * q, a * b - p * q])
            if k < WIN - 1:
                continue
            sx, sy, sq, sxy = (_horizontal(s[m], P, D, shuffles) for m in range(4))
            A, Q = sx * sy, sx * sx + sy * sy
            a1, b1 = A * k_a1 + c1, Q * k_b1 + c1
            a2 = sxy * k_a2 + (A * k_a2q + c2)
            b2 = sq * k_b2 + (Q * k_b2q + c2)
            row = (a1 * a2) / (b1 * b2) * mask
            r = min(walk[k - (WIN - 1)], walk[k])
            ssim_map[r, out[sel]] += row[sel]
            written[r, out[sel]] += 1
    return ssim_map, written, shuffles


def _f64_map(x, y, data_range=255.0):
    from scipy.ndimage import uniform_filter

    x, y = x.astype(np.float64), y.astype(np.float64)
    box = lambda a: uniform_filter(a, size=(WIN, WIN, 1))[3:-3, 3:-3]
    ux, uy = box(x), box(y)
    cn = 49.0 / 48.0
    vx, vy = cn * (box(x * x) - ux * ux), cn * (box(y * y) - uy * uy)
    vxy = cn * (box(x * y) - ux * uy)
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    return ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux * ux + uy * uy + c1) * (vx + vy + c2))


# Shapes with several strips in both directions (reseeded within each) and
# three warp columns with a ragged right edge.
MODEL_SHAPES = {1: (45, 260, 1), 2: (40, 250, 2), 3: (45, 251, 3), 5: (40, 130, 5),
                8: (40, 125, 8), 16: (40, 60, 16)}
SHUFFLES = {4: 4, 2: 4, 1: 6}  # (d, i) shuffles per running sum and channel, by P


@pytest.mark.parametrize("C", sorted(MODEL_SHAPES))
def test_lane_model_matches_plain_ssim(C):
    shape = MODEL_SHAPES[C]
    x, y = structured(shape, 4)
    g = K.generic_grid(shape[0], shape[1] * C, C)
    assert g.n_strips >= 3 and g.n_cols == 3
    ssim_map, written, shuffles = lane_model(x, y)
    assert (written == 1).all()  # every window by exactly one lane
    assert len(shuffles) == SHUFFLES[g.lane_pixels]
    # window by window against float64: f32 variance sums of values up to
    # 255 cancel to a few 1e-4 at worst, while a window off by one pixel,
    # row or channel is off by 1e-2 or more; the mean against the plain version
    assert np.abs(ssim_map - _f64_map(x, y)).max() < 1e-3
    ref = float(plain_ssim(torch.from_numpy(x), torch.from_numpy(y)))
    assert abs(float(ssim_map.astype(np.float64).mean()) - ref) < MODEL_TOL


def test_lane_model_running_sums_do_not_drift():
    """The C = 3 drift frame (tall, bright, low variance; strips of 49 rows,
    reseeded every 8): the model's float32 running sums stay within 1e-4 of
    float64, as the kernel's must on the card."""
    x, y = bright(DRIFT3, 0)
    g = K.generic_grid(DRIFT3[0], DRIFT3[1] * 3, 3)
    assert g.rows > 2 * K.RESEED
    ssim_map, written, _ = lane_model(x, y)
    assert (written == 1).all()
    ref = float(_f64_map(x, y).mean())
    assert abs(float(ssim_map.astype(np.float64).mean()) - ref) < 1e-4


@pytest.mark.parametrize("shape,bound_us", [((1424, 2128, 4), 28.9), ((1736, 2312, 4), 38.3),
                                            ((2848, 4256, 3), 86.8), ((3472, 4624, 3), 115.0)])
def test_ab_ssim_bounds_are_the_byte_bounds(shape, bound_us):
    """tools/ab_ssim.py's bound at each frame it times: bound by the bytes
    (x and y read once at 3.35 TB/s), as chip_smoke.py's phase 12 states."""
    from pnnp_tpu_torch.tools import ab_ssim

    got, by = ab_ssim.bound_us(*shape)
    assert by == "bytes" and abs(got - bound_us) < 0.05
    x, y = ab_ssim.frame_pair((9, 8, shape[2]))
    assert x.shape == y.shape == (9, 8 * shape[2]) and x.dtype == np.float32
