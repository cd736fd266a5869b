"""The port's physics noise synth against the JAX package's.

Deterministic parts agree to float32 tolerance or exactly: the Tukey-lambda
quantile and CDF to rtol 1e-5 (atol 1e-6 where the quantile crosses 0 and
the float32 cancellation of two expm1 terms sets the error), the
calibration constants and the noiseparam table exactly.

Samplers cannot share a random stream with JAX, so they are held against
the JAX samplers by moments and by the symmetric histogram KLD, as
tools/validate_noise_model.py and tests/test_noise_physics.py do. Draws are
seeded (numpy for the inputs, a JAX key and a torch.Generator for the
draws), so each comparison is deterministic; the bounds are those of
tests/test_noise_physics.py (std ratio 3%, row-mean std 10%) or a few
standard errors of the sample size, stated at each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnnp_tpu.ops.poisson import poisson_sample as jax_poisson
from pnnp_tpu.ops.tukey import tukeylambda_cdf as jax_cdf
from pnnp_tpu.ops.tukey import tukeylambda_ppf as jax_ppf
from pnnp_tpu.physics import calibration as jcal
from pnnp_tpu.physics.noise import generate_noisy as jax_generate_noisy
from pnnp_tpu.physics.sampling import params_at_iso_regression as jax_params_at_iso
from pnnp_tpu.physics.sampling import sample_params as jax_sample_params
from pnnp_tpu.physics.sampling import sample_params_max as jax_sample_params_max
from pnnp_tpu.train.steps import _raw_synth_params as jax_raw_synth_params
from pnnp_tpu.train.steps import make_raw_synth as jax_make_raw_synth
from pnnp_tpu_torch.ops.poisson import poisson_sample
from pnnp_tpu_torch.ops.tukey import tukeylambda_cdf, tukeylambda_ppf, tukeylambda_sample
from pnnp_tpu_torch.physics import calibration as tcal
from pnnp_tpu_torch.physics.noise import generate_noisy
from pnnp_tpu_torch.physics.sampling import (
    params_at_iso_regression,
    sample_params,
    sample_params_max,
)
from pnnp_tpu_torch.train.steps import _raw_synth_params, make_raw_synth

LAMS = [-0.09, -0.026, 0.0, 1e-8, 1e-6, 0.015, 0.147]


def gen(seed):
    return torch.Generator().manual_seed(seed)


def sym_kld(a, b, bins=200):
    """Symmetric KLD of two samples' histograms on shared bins over the
    pooled 0.1-99.9 percentile range (empty bins floored at 1e-12)."""
    lo, hi = np.percentile(np.concatenate([a, b]), [0.1, 99.9])
    if hi <= lo:
        return 0.0
    edges = np.linspace(lo, hi, bins + 1)
    p = np.histogram(np.clip(a, lo, hi), edges)[0] / a.size + 1e-12
    q = np.histogram(np.clip(b, lo, hi), edges)[0] / b.size + 1e-12
    return float(0.5 * np.sum((p - q) * np.log(p / q)))


# -- deterministic parts ------------------------------------------------------

@pytest.mark.parametrize("lam", LAMS)
def test_tukey_ppf_cdf_match_jax(lam):
    p = np.concatenate([[1e-7, 1e-4, 0.01], np.linspace(0.02, 0.98, 97),
                        [0.99, 1 - 1e-4]]).astype(np.float32)
    got = tukeylambda_ppf(torch.from_numpy(p), lam).numpy()
    ref = np.asarray(jax_ppf(jnp.asarray(p), lam))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    x = np.linspace(-8.0, 8.0, 161).astype(np.float32)
    got = tukeylambda_cdf(torch.from_numpy(x), lam).numpy()
    ref = np.asarray(jax_cdf(jnp.asarray(x), lam))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_tukey_sample_is_inverse_cdf():
    """The draw lies inside (Q(1e-7), Q(1-1e-7)) and its median is 0."""
    s = tukeylambda_sample(gen(0), -0.026, 2.0, (200_000,))
    bound = 2.0 * float(tukeylambda_ppf(torch.tensor(1 - 1e-7), -0.026))
    assert float(s.abs().max()) <= bound * (1 + 1e-6)
    assert abs(float(s.median())) < 0.02


def test_calibration_constants_match_exactly():
    assert tcal.DUAL_ISO_CAMERAS == jcal.DUAL_ISO_CAMERAS
    assert tcal.CAMERA_REGRESSION == jcal.CAMERA_REGRESSION
    assert tcal.SONY_ISO2K == jcal.SONY_ISO2K
    assert tcal.IMX686_NOISEPARAM_KMAX == jcal.IMX686_NOISEPARAM_KMAX
    np.testing.assert_array_equal(tcal.IMX686_NOISEPARAM_BIAS, jcal.IMX686_NOISEPARAM_BIAS)
    for cam in jcal.ISO_TABLES:
        for k, v in jcal.ISO_TABLES[cam].items():
            np.testing.assert_array_equal(tcal.ISO_TABLES[cam][k], v)


def test_noiseparam_h5_and_table_match_exactly(tmp_path):
    import h5py

    rng = np.random.default_rng(0)
    with h5py.File(tmp_path / "noiseparam-iso-6400.h5", "w") as f:
        for k in ("lam", "sigmaGs", "sigmaTL", "sigmaR"):
            f[k] = rng.uniform(0.01, 2.0, 16)
        f["meanRead"] = rng.normal(0, 1, (4, 16))
    got = tcal.load_noiseparam_h5(str(tmp_path), 6400)
    ref = jcal.load_noiseparam_h5(str(tmp_path), 6400)
    assert tcal.load_noiseparam_h5(str(tmp_path), 100) is None
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    t_got = tcal.table_with_noiseparam("IMX686", 6400, got)
    t_ref = jcal.table_with_noiseparam("IMX686", 6400, ref)
    for k in t_ref:
        np.testing.assert_array_equal(t_got[k], t_ref[k])
    # the base table is not modified in place
    np.testing.assert_array_equal(tcal.ISO_TABLES["IMX686"]["Kmax"],
                                  jcal.ISO_TABLES["IMX686"]["Kmax"])


# -- samplers -----------------------------------------------------------------

@pytest.mark.parametrize("lam", [0.0, 0.5, 3.0, 16.0, 17.0, 48.0, 160.0])
def test_poisson_matches_jax_sampler(lam):
    """200k draws each: mean within 5 standard errors, variance ratio within
    3%, sym-KLD of the two count histograms < 2e-3 (empirical-vs-empirical
    noise floor at this size is ~bins/n ~ 5e-4); lam = 0 gives exact zeros."""
    n = 200_000
    s = poisson_sample(gen(int(lam * 10)), torch.full((n,), lam)).numpy()
    r = np.asarray(jax_poisson(jax.random.key(int(lam * 10)), jnp.full((n,), lam)))
    assert s.dtype == np.float32 and (s >= 0).all() and (s == np.round(s)).all()
    if lam == 0.0:
        assert (s == 0).all() and (r == 0).all()
        return
    se = np.sqrt(lam / n)
    assert abs(s.mean() - lam) < 5 * se and abs(s.mean() - r.mean()) < 7 * se
    assert abs(s.var() / r.var() - 1.0) < 0.03
    edges = np.arange(0, max(s.max(), r.max()) + 2) - 0.5
    p = np.histogram(s, edges)[0] / n + 1e-12
    q = np.histogram(r, edges)[0] / n + 1e-12
    assert 0.5 * np.sum((p - q) * np.log(p / q)) < 2e-3


@pytest.mark.parametrize("lam", [1.0, 4.0, 16.0, 23.0, 64.0, 100.0])
def test_poisson_matches_scipy(lam):
    """The sampler against ``scipy.stats.poisson`` (tools/check_poisson.py's
    table): 400k draws, mean and variance within 2% of lam, the count
    histogram's KLD against the exact pmf within 4x its sampling floor
    (bins - 1) / (2n)."""
    from pnnp_tpu_torch.tools.check_poisson import sampler_rows

    (r,) = sampler_rows(torch.device("cpu"), [lam], n=400_000, seed=int(lam))
    assert abs(r["mean_rel"]) < 0.02 and abs(r["var_rel"]) < 0.02, r
    assert r["kl"] < 4 * r["kl_floor"], r


def _moments_close(got: dict, ref: dict, keys, rtol_std=0.06):
    """Means within 5 standard errors of their difference, std within
    ``rtol_std``, ranges within 5% of the spread; constants equal."""
    for k in keys:
        a, b = np.asarray(got[k], np.float64), np.asarray(ref[k], np.float64)
        assert a.shape == b.shape, k
        scale = max(abs(b.mean()), b.std(), 1e-12)
        se = b.std() * np.sqrt(2.0 / len(b))
        assert abs(a.mean() - b.mean()) <= 5 * se + 1e-6 * scale, (k, a.mean(), b.mean())
        if b.std() > 1e-6 * scale:
            assert abs(a.std() / b.std() - 1.0) <= rtol_std, (k, a.std(), b.std())
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6)
        assert a.min() >= b.min() - 0.05 * scale and a.max() <= b.max() + 0.05 * scale, k


PARAM_KEYS = ("K", "sigTL", "sigR", "sigGs", "bias", "lam", "q", "ratio", "wp", "bl")


@pytest.mark.parametrize("case", [
    dict(camera_type="SonyA7S2"),                              # the main path's law
    dict(camera_type="NikonD850"),                             # one-branch regression
    dict(camera_type="SonyA7S2", iso=3200),                    # point calibration
    dict(camera_type="SonyA7S2", iso=3200, jitter_sigmas=False),
    dict(camera_type="SonyA7S2", iso=800, ratio=150.0),
])
def test_sample_params_max_matches_jax(case):
    """20k examples per side (see _moments_close); the dual-ISO coin within
    0.02 of the JAX share (4 standard errors)."""
    n = 20_000
    got = {k: v.numpy() for k, v in sample_params_max(gen(1), n=n, **case).items()}
    ref = {k: np.asarray(v) for k, v in
           jax_sample_params_max(jax.random.key(1), n=n, **case).items()}
    _moments_close(got, ref, PARAM_KEYS)
    if case["camera_type"] == "SonyA7S2" and "iso" not in case:
        assert abs(np.mean(got["lam"] == np.float32(-0.025))
                   - np.mean(ref["lam"] == np.float32(-0.025))) < 0.02
        assert got["ratio"].min() >= 100.0 and got["ratio"].max() <= 300.0


def test_sample_params_max_table_override_matches_jax():
    """The user-h5 path: an overridden table row, point branch."""
    nps = dict(K=8.0, lam=0.02, sigGs=13.0, sigGssig=0.05, sigTL=12.0, sigTLsig=0.04,
               sigR=0.5, sigRsig=0.01, bias=np.array([0.1, 0.2, 0.3, 0.4], np.float32))
    n = 20_000
    table_t = tcal.table_with_noiseparam("IMX686", 6400, nps)
    table_j = jcal.table_with_noiseparam("IMX686", 6400, nps)
    got = {k: v.numpy() for k, v in sample_params_max(
        gen(2), "IMX686", n=n, iso=6400, table=table_t).items()}
    ref = {k: np.asarray(v) for k, v in jax_sample_params_max(
        jax.random.key(2), "IMX686", n=n, iso=6400, table=table_j).items()}
    _moments_close(got, ref, PARAM_KEYS)
    np.testing.assert_allclose(got["bias"][0], nps["bias"])


@pytest.mark.parametrize("lrid,gtdn", [(True, False), (False, True)])
def test_raw_synth_param_laws_match_jax(lrid, gtdn):
    """The lrid law (IMX686 ISO 6400, K-only jitter, ratio ~ U(1, 16)) and
    the GTdn ratio law (max(U(-3, 4), 1): 4/7 of the mass at exactly 1)."""
    n = 20_000
    cam, iso = ("IMX686", 6400) if lrid else ("SonyA7S2", None)
    got = {k: v.numpy() for k, v in _raw_synth_params(
        gen(3), cam, n, iso, None, gtdn, lrid).items()}
    ref = {k: np.asarray(v) for k, v in jax_raw_synth_params(
        jax.random.key(3), cam, n, iso, None, gtdn, lrid).items()}
    _moments_close(got, ref, PARAM_KEYS)
    if lrid:
        assert got["ratio"].min() >= 1.0 and got["ratio"].max() <= 16.0
        assert np.unique(got["sigGs"]).size == 1  # sigmas at their means
    else:
        assert abs(np.mean(got["ratio"] == 1.0) - 4 / 7) < 0.015


@pytest.mark.parametrize("camera,ln_ratio", [("IMX686", True), ("SonyA7S2", False),
                                             ("CRVD", True)])
def test_sample_params_matches_jax(camera, ln_ratio):
    n = 20_000
    got = {k: v.numpy() for k, v in sample_params(gen(4), camera, n, ln_ratio).items()}
    ref = {k: np.asarray(v) for k, v in
           jax_sample_params(jax.random.key(4), camera, n, ln_ratio).items()}
    _moments_close(got, ref, PARAM_KEYS)


def test_params_at_iso_regression_matches_jax():
    iso = np.tile(np.array([400.0, 1600.0, 3200.0, 12800.0], np.float32), 5000)
    got = {k: v.numpy() for k, v in params_at_iso_regression(
        gen(5), "SonyA7S2", torch.from_numpy(iso)).items()}
    ref = {k: np.asarray(v) for k, v in jax_params_at_iso(
        jax.random.key(5), "SonyA7S2", jnp.asarray(iso)).items()}
    for i in range(4):  # per ISO, so the moments are of one law each
        sl = slice(i, None, 4)
        _moments_close({k: v[sl] for k, v in got.items()},
                       {k: v[sl] for k, v in ref.items()},
                       ("K", "sigGs", "wp", "bl", "lam", "q"))


def fixed_params(n, ratio, iso=1600):
    """Unjittered Sony params at one ISO (as tests/test_noise_physics.py),
    with a per-channel dark bias of 1..4 ADU (read only under 'd')."""
    t = jcal.ISO_TABLES["SonyA7S2"]
    i = jcal.iso_index("SonyA7S2", iso)
    rep = lambda v: np.full((n,), v, np.float32)
    return dict(K=rep(t["Kmax"][i]), sigTL=rep(t["sigTL"][i]), sigR=rep(t["sigR"][i]),
                sigGs=rep(t["sigGs"][i]), bias=np.tile(np.float32([1, 2, 3, 4]), (n, 1)),
                lam=rep(t["lam"][i]), q=rep(t["q"]), ratio=rep(ratio), wp=rep(t["wp"]),
                bl=rep(t["bl"]))


@pytest.mark.parametrize("ori,clip", [(False, False), (True, False), (False, True)])
@pytest.mark.parametrize("code", ["p", "g", "pg", "pr", "pgrq", "pgrqd", "pb"])
def test_generate_noisy_matches_jax(code, ori, clip):
    """Clean frames [2, 4, 128, 128] (NHWC on the JAX side) at Sony ISO 1600,
    ratio 100: clip bounds exactly; mean within 3% of the JAX std, std
    within 3%; sym-KLD of the histograms < 0.01; with 'r', the std of the
    row means (read noise averaged over a row, plus the row draw) within
    10%; with 'd', the per-channel means follow the bias within 3% of the
    std."""
    n, h, w, ratio = 2, 128, 128, 100.0
    rng = np.random.default_rng(7)
    y = rng.uniform(0.0005, 0.004, (n, h, w, 4)).astype(np.float32)
    p = fixed_params(n, ratio)
    ref = np.asarray(jax_generate_noisy(jax.random.key(9), jnp.asarray(y),
                                        {k: jnp.asarray(v) for k, v in p.items()},
                                        code, ori=ori, clip=clip))
    got = generate_noisy(gen(9), torch.from_numpy(y).permute(0, 3, 1, 2).contiguous(),
                         {k: torch.from_numpy(v) for k, v in p.items()},
                         code, ori=ori, clip=clip).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32

    amp = 1.0 if ori else ratio
    lo = 0.0 if clip else -512.0 / 16383.0
    assert got.min() >= np.float32(lo * amp) * (1 + 1e-6) - 1e-7
    assert got.max() <= amp * (1 + 1e-6)
    assert (got.min() < 0) == (ref.min() < 0)

    assert abs(got.mean() - ref.mean()) < 0.03 * ref.std()
    assert abs(got.std() / ref.std() - 1.0) < 0.03
    assert sym_kld(got.ravel(), ref.ravel()) < 0.01
    if "r" in code and "b" not in code:
        ra, rb = got.mean(axis=2), ref.mean(axis=2)  # [n, h, 4] row means
        assert abs(ra.std() / rb.std() - 1.0) < 0.1
    if "d" in code:
        np.testing.assert_allclose(got.mean(axis=(0, 1, 2)), ref.mean(axis=(0, 1, 2)),
                                   atol=0.03 * ref.std())


def test_make_raw_synth_main_law_matches_jax():
    """The main path's synth (Sony, pgrq, regression params, ratio ~
    U(100, 300), clip): 4096 crops of 8x8 drawn by each package, on the same
    clean crops. Ratio within [100, 300] and its mean within 5 standard
    errors of the JAX mean; noisy-frame mean and std within 3%, sym-KLD <
    0.01."""
    n = 4096
    hr = np.random.default_rng(11).uniform(0.0, 0.02, (n, 8, 8, 4)).astype(np.float32)
    synth_t = make_raw_synth("SonyA7S2", "pgrq", ori=False, clip=True)
    synth_j = jax_make_raw_synth("SonyA7S2", "pgrq", ori=False, clip=True)
    lr_t, hr_t, ratio_t = synth_t(gen(12), {"hr": torch.from_numpy(hr).permute(0, 3, 1, 2)})
    lr_j, hr_j, ratio_j = synth_j(jax.random.key(12), {"hr": jnp.asarray(hr)})
    lr_t, ratio_t = lr_t.permute(0, 2, 3, 1).numpy(), ratio_t.numpy()
    lr_j, ratio_j = np.asarray(lr_j), np.asarray(ratio_j)
    np.testing.assert_array_equal(hr_t.permute(0, 2, 3, 1).numpy(), np.asarray(hr_j))
    assert ratio_t.shape == (n,) and 100.0 <= ratio_t.min() and ratio_t.max() <= 300.0
    assert abs(ratio_t.mean() - ratio_j.mean()) < 5 * ratio_j.std() * np.sqrt(2 / n)
    assert lr_t.min() >= 0.0 and lr_t.max() <= 300.0
    assert abs(lr_t.mean() / lr_j.mean() - 1.0) < 0.03
    assert abs(lr_t.std() / lr_j.std() - 1.0) < 0.03
    assert sym_kld(lr_t.ravel(), lr_j.ravel()) < 0.01
