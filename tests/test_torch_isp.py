"""The port's ISP and image ops against the JAX package, on the CPU.

``ops/bayer.py``, ``ops/vst.py`` and ``ops/filters.py`` are held to atol
1e-6, with rtol 1e-6 where values exceed 1 (an f32 ulp is larger there;
ADU-range mosaics to 2e-3): the same f32 arithmetic, sums in another order;
layout ops exactly;
``fast_isp`` and its parts before the uint8 floor to atol 1e-5 (the demosaic
is a shifted sum here, a HIGHEST-precision convolution there);
``rgb_quality`` within 0.01 dB and 1e-4 SSIM, where a floor bin may flip.
Inputs are numpy draws from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pnnp_tpu.ops as J
import pnnp_tpu_torch.kernels.ssim as tssim
import pnnp_tpu_torch.ops as T

ATOL = 1e-6


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _close(got, ref, atol=ATOL, rtol=0.0):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), atol=atol, rtol=rtol)


@pytest.fixture()
def mosaic():
    return np.random.default_rng(3).uniform(0, 1, (2, 12, 18)).astype(np.float32)


@pytest.mark.parametrize("name", ["pack_bayer", "bayer2rggb", "bayer2rows", "bayer2gray"])
def test_mosaic_ops_match_jax(mosaic, name):
    got = getattr(T, name)(_t(mosaic))
    ref = getattr(J, name)(jnp.asarray(mosaic))
    assert tuple(got.shape) == ref.shape
    _close(got, ref)


@pytest.mark.parametrize("fwd,inv", [("pack_bayer", "unpack_bayer"),
                                     ("bayer2rggb", "rggb2bayer"),
                                     ("bayer2rows", "rows2bayer")])
def test_mosaic_inverses_match_jax(mosaic, fwd, inv):
    packed = np.asarray(getattr(J, fwd)(jnp.asarray(mosaic)))
    got = getattr(T, inv)(_t(packed))
    np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(J, inv)(jnp.asarray(packed))))
    np.testing.assert_array_equal(got.numpy(), mosaic)


@pytest.mark.parametrize("kw", [{}, {"clip": True}, {"norm": False},
                                {"bias": [1.0, -2.0, 3.0, 0.5], "wp": 16383.0, "bl": 512.0}])
def test_raw2bayer_and_bayer2raw_match_jax(kw):
    raw = np.random.default_rng(4).uniform(0, 16383, (16, 20)).astype(np.float32)
    got = T.raw2bayer(_t(raw), **kw)
    ref = J.raw2bayer(jnp.asarray(raw), **kw)
    _close(got, ref, atol=1e-6, rtol=1e-6)
    back = T.bayer2raw(got, wp=16383.0, bl=512.0)
    _close(back, J.bayer2raw(ref, wp=16383.0, bl=512.0), atol=2e-3, rtol=1e-6)


def test_raw2bayer_matches_host_pack():
    """The device pack and the loader's numpy pack agree (``pack_raw_np``)."""
    from pnnp_tpu_torch.data.io import pack_raw_np

    raw = np.random.default_rng(5).uniform(512, 16383, (8, 12)).astype(np.float32)
    np.testing.assert_allclose(T.raw2bayer(_t(raw), 16383.0, 512.0).numpy(),
                               pack_raw_np(raw, 16383.0, 512.0), atol=ATOL)


def test_repair_bad_pixels_matches_jax():
    rng = np.random.default_rng(6)
    raw = rng.uniform(0, 1, (14, 20)).astype(np.float32)
    mask = rng.uniform(0, 1, raw.shape) < 0.1
    got = T.repair_bad_pixels(_t(raw), torch.from_numpy(mask))
    ref = J.repair_bad_pixels(jnp.asarray(raw), jnp.asarray(mask))
    _close(got, ref)
    np.testing.assert_array_equal(got.numpy()[~mask], raw[~mask])


def test_isp_parts_match_jax():
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 1, (2, 6, 8, 4)).astype(np.float32)
    wbs = rng.uniform(1, 2.5, (2, 4)).astype(np.float32)
    ccms = rng.uniform(-0.5, 1.5, (2, 3, 3)).astype(np.float32)
    _close(T.apply_gains(_t(x), _t(wbs)), J.apply_gains(jnp.asarray(x), jnp.asarray(wbs)))
    lrgb = T.raw2lrgb(_t(x))
    _close(lrgb, J.raw2lrgb(jnp.asarray(x)))
    _close(T.apply_ccms(lrgb, _t(ccms)), J.apply_ccms(jnp.asarray(lrgb.numpy()),
                                                     jnp.asarray(ccms)), atol=1e-5)
    _close(T.simple_isp(_t(x * 16383)), J.simple_isp(jnp.asarray(x * 16383)), atol=1e-5)
    _close(T.isp.SONY_CCM, J.isp.SONY_CCM)


def test_gamma_and_process_match_jax():
    """The uint8 round trip: away from bin edges the levels are equal."""
    rng = np.random.default_rng(8)
    x = rng.uniform(0, 1, (2, 6, 8, 4)).astype(np.float32)
    wbs = rng.uniform(1, 2.5, (2, 4)).astype(np.float32)
    ccms = np.broadcast_to(np.asarray(J.isp.SONY_CCM), (2, 3, 3)).copy()
    got = T.process(_t(x), _t(wbs), _t(ccms)).numpy()
    ref = np.asarray(J.process(jnp.asarray(x), jnp.asarray(wbs), jnp.asarray(ccms)))
    assert np.abs(got - ref).max() <= 1.0 / 255 + 1e-7
    assert np.mean(got == ref) > 0.99
    lin = rng.uniform(0, 1, (3, 5, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(T.gamma_compression(_t(lin)).numpy(),
                                  np.asarray(J.gamma_compression(jnp.asarray(lin))))


def test_bilinear_demosaic_matches_jax():
    m = np.random.default_rng(9).uniform(0, 1, (2, 10, 14)).astype(np.float32)
    got = T.bilinear_demosaic(_t(m))
    ref = J.bilinear_demosaic(jnp.asarray(m))
    assert tuple(got.shape) == ref.shape == (2, 10, 14, 3)
    _close(got, ref, atol=1e-6)


@pytest.mark.parametrize("wb,ccm", [(None, None),
                                    ([2.1, 1.0, 1.7, 1.0], np.eye(3)),
                                    ([1.8, 1.0, 2.2, 1.0], None)])
def test_fast_isp_matches_jax(wb, ccm):
    x = np.random.default_rng(10).uniform(0, 0.6, (12, 16, 4)).astype(np.float32)
    got = T.fast_isp(_t(x), wb=wb, ccm=ccm)
    ref = J.fast_isp(jnp.asarray(x), wb=None if wb is None else jnp.asarray(wb),
                     ccm=ccm)
    assert tuple(got.shape) == ref.shape == (24, 32, 3)
    _close(got, ref, atol=1e-5)


def test_fast_isp_ignores_autocast():
    """Under a bf16 autocast the ISP still computes in float32."""
    x = _t(np.random.default_rng(11).uniform(0, 0.6, (8, 12, 4)))
    plain = T.fast_isp(x)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = T.fast_isp(x)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, plain, rtol=0, atol=0)


def test_rgb_quality_matches_jax():
    rng = np.random.default_rng(12)
    tgt = rng.uniform(0, 0.5, (24, 32, 4)).astype(np.float32)
    out = np.clip(tgt + rng.normal(0, 0.02, tgt.shape), 0, 1).astype(np.float32)
    wb, ccm = np.array([2.0, 1.0, 1.5, 1.0], np.float32), np.eye(3, dtype=np.float32)
    before = tssim.launches
    p, s = T.metrics.rgb_quality(_t(out), _t(tgt), wb, ccm)
    assert tssim.launches == before  # CPU tensors: the plain SSIM, no launch
    pj, sj = J.metrics.rgb_quality(jnp.asarray(out), jnp.asarray(tgt), wb, ccm)
    assert abs(float(p) - float(pj)) < 0.01
    assert abs(float(s) - float(sj)) < 1e-4
    q = T.quality_assess(_t(out) * 255, _t(tgt) * 255)
    qj = J.quality_assess(jnp.asarray(out) * 255, jnp.asarray(tgt) * 255)
    assert abs(float(q["PSNR"]) - float(qj["PSNR"])) < 1e-4
    assert abs(float(q["SSIM"]) - float(qj["SSIM"])) < 1e-4


def test_vst_matches_jax():
    rng = np.random.default_rng(13)
    x = rng.uniform(0, 50, (3, 6, 5)).astype(np.float32)
    kmax = rng.uniform(0.5, 2, 3).astype(np.float32)
    sig = rng.uniform(0.5, 3, 3).astype(np.float32)
    for kw in ({}, {"mu": 0.3, "gain": 1.7, "wp": 1.0}, {"gain": 0.8, "wp": 4.0}):
        _close(T.vst(_t(x), 1.3, **kw), J.vst(jnp.asarray(x), 1.3, **kw), atol=ATOL, rtol=1e-6)
    y = np.asarray(J.vst(jnp.asarray(x), 1.3))
    for kw in ({}, {"gain": 1.7}, {"gain": 0.8, "wp": 4.0}):
        _close(T.inverse_vst(_t(y), 1.3, **kw), J.inverse_vst(jnp.asarray(y), 1.3, **kw),
               atol=ATOL, rtol=1e-6)
    _close(T.inverse_vst_batch(_t(y), _t(kmax), _t(sig)),
           J.inverse_vst_batch(jnp.asarray(y), jnp.asarray(kmax), jnp.asarray(sig)),
           atol=ATOL, rtol=1e-6)


@pytest.mark.parametrize("k", [3, 4, 5])
def test_filters_match_jax(k):
    rng = np.random.default_rng(14)
    img = rng.uniform(0, 1, (2, 11, 13)).astype(np.float32)
    guide = rng.uniform(0, 1, img.shape).astype(np.float32)
    _close(T.stdfilt(_t(img), k), J.stdfilt(jnp.asarray(img), k), atol=ATOL * 4)
    _close(T.guided_filter(_t(guide), _t(img), k),
           J.guided_filter(jnp.asarray(guide), jnp.asarray(img), k), atol=ATOL * 4)
    _close(T.fast_guided_filter(_t(img), k), J.fast_guided_filter(jnp.asarray(img), k),
           atol=ATOL * 4)


def test_row_denoise_matches_jax():
    rng = np.random.default_rng(15)
    raw = (rng.normal(0, 0.1, (40, 24)) + rng.normal(0, 0.3, (40, 1))).astype(np.float32)
    got = T.row_denoise(_t(raw), sigma_s=3.0, sigma_r=0.5)
    _close(got, J.row_denoise(jnp.asarray(raw), sigma_s=3.0, sigma_r=0.5), atol=ATOL)
