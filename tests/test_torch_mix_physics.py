"""The port's PMN augmentations, HighBitRecovery and Mix synth against the
JAX package's.

Deterministic given their draws, so held to JAX at float32 tolerance: with
the Poisson draw replaced by its mean and the same K in both packages,
``sna`` and ``raw_wb_aug`` at rtol 1e-6; ``get_aug_param`` from the same
draws at rtol 1e-6; the HBR lookup tables built from JAX's drawn noise
parameters at rtol 1e-6, and ``map`` through them from one shared uniform
field at atol 1e-5 (normalized); ``make_mix_synth`` with all of that at rtol
1e-6. The samplers cannot share a stream with JAX and are held to it by
moments: within 2% (std) and 5 standard errors (mean), over seeded draws.
Images are NCHW in the port, NHWC in JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pnnp_tpu.physics.noise as jnoise
import pnnp_tpu.train.steps as jsteps
import pnnp_tpu_torch.physics.hbr as thbr
import pnnp_tpu_torch.physics.noise as tnoise
import pnnp_tpu_torch.train.steps as tsteps
from pnnp_tpu.physics.hbr import HighBitRecovery as JHBR
from pnnp_tpu_torch.physics import calibration as tcal
from pnnp_tpu_torch.physics.hbr import HighBitRecovery

N, P = 4, 16


def gen(seed):
    return torch.Generator().manual_seed(seed)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _fixed_k(camera):
    t = tcal.ISO_TABLES[camera]
    K = np.array([0.5, 1.0, 2.0, 4.0][:N], np.float32)
    wp, bl = np.full(N, t["wp"], np.float32), np.full(N, t["bl"], np.float32)
    return K, wp, bl


@pytest.fixture
def poisson_at_mean(monkeypatch):
    """Poisson at its mean and a fixed K in both packages."""
    monkeypatch.setattr(jnoise, "poisson_sample", lambda key, lam: lam)
    monkeypatch.setattr(tnoise, "poisson_sample", lambda g, lam: lam)

    def use(camera):
        K, wp, bl = _fixed_k(camera)
        monkeypatch.setattr(jnoise, "_k_and_wp_for", lambda *a, **k: tuple(
            jnp.asarray(v) for v in (K, wp, bl)))
        monkeypatch.setattr(tnoise, "_k_and_wp_for", lambda *a, **k: tuple(
            torch.from_numpy(v) for v in (K, wp, bl)))
    return use


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0, 0.4, (N, P, P, 4)).astype(np.float32)
    noisy = (gt / 20 + rng.normal(0, 0.002, gt.shape)).astype(np.float32)
    aug = rng.uniform(0, 0.5, (N, 4)).astype(np.float32)
    ratio = np.array([1.0, 2.0, 8.0, 20.0], np.float32)
    iso = np.full(N, 6400.0, np.float32)
    return gt, noisy, aug, ratio, iso


BLACKS = {"false": False, "true": True, "mask": np.array([1, 0, 1, 0], np.float32)}


@pytest.mark.parametrize("ori", [True, False])
@pytest.mark.parametrize("black", sorted(BLACKS))
@pytest.mark.parametrize("camera", ["SonyA7S2", "IMX686"])
def test_sna_matches_jax_at_poisson_mean(poisson_at_mean, camera, black, ori):
    poisson_at_mean(camera)
    gt, _, aug, ratio, iso = _inputs()
    b = BLACKS[black]
    dn_j, dy_j = jnoise.sna(jax.random.key(0), jnp.asarray(gt), jnp.asarray(aug), camera,
                            jnp.asarray(ratio), jnp.asarray(iso), black_lr=b, ori=ori)
    dn_t, dy_t = tnoise.sna(gen(0), nchw(gt), torch.from_numpy(aug), camera,
                            torch.from_numpy(ratio), torch.from_numpy(iso),
                            black_lr=b if isinstance(b, bool) else torch.from_numpy(b), ori=ori)
    np.testing.assert_allclose(nhwc(dn_t), np.asarray(dn_j), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(nhwc(dy_t), np.asarray(dy_j), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("ori", [True, False])
@pytest.mark.parametrize("with_aug", [True, False])
@pytest.mark.parametrize("camera", ["SonyA7S2", "IMX686"])
def test_raw_wb_aug_matches_jax_at_poisson_mean(poisson_at_mean, camera, with_aug, ori):
    poisson_at_mean(camera)
    gt, noisy, aug, ratio, iso = _inputs(1)
    out_j = jnoise.raw_wb_aug(jax.random.key(0), jnp.asarray(noisy), jnp.asarray(gt),
                              jnp.asarray(aug) if with_aug else None, camera,
                              jnp.asarray(ratio), jnp.asarray(iso), ori=ori)
    out_t = tnoise.raw_wb_aug(gen(0), nchw(noisy), nchw(gt),
                              torch.from_numpy(aug) if with_aug else None, camera,
                              torch.from_numpy(ratio), torch.from_numpy(iso), ori=ori)
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(nhwc(a), np.asarray(b), rtol=1e-6, atol=1e-9)


class _RecordedDraws:
    """Stands in for jax.random's randint/uniform/normal: given integer draws,
    seeded numpy floats, every value recorded in call order."""

    def __init__(self, ints, seed=0):
        self.ints, self.rng, self.calls = list(ints), np.random.default_rng(seed), []

    def randint(self, key, shape, minval, maxval):
        v = jnp.full(shape, self.ints.pop(0), jnp.int32)
        self.calls.append(("randint", np.asarray(v)))
        return v

    def uniform(self, key, shape=(), dtype=None, minval=0.0, maxval=1.0):
        u = self.rng.uniform(0, 1, shape).astype(np.float32)
        v = jnp.asarray(u) * (maxval - minval) + minval
        self.calls.append(("uniform", np.asarray(v)))
        return v

    def normal(self, key, shape=(), dtype=None):
        v = jnp.asarray(self.rng.normal(0, 1, shape).astype(np.float32))
        self.calls.append(("normal", np.asarray(v)))
        return v


@pytest.mark.parametrize("bits", [(0, 0), (0, 3), (1, 1), (1, 2)])
@pytest.mark.parametrize("command,camera", [("augv5", "SonyA7S2"), ("augv5", "IMX686"),
                                            ("augv2", "SonyA7S2"), ("noaug", "IMX686")])
def test_get_aug_param_exact_for_given_draws(monkeypatch, command, camera, bits):
    """JAX's get_aug_param on recorded draws (r bit, aug bit, the gains and
    the per-example uniforms or normals) against the port's
    aug_params_from_draws on the same values: the deltas and their joint
    renormalisation."""
    n = 8
    rec = _RecordedDraws(bits, seed=sum(bits))
    for name in ("randint", "uniform", "normal"):
        monkeypatch.setattr(jax.random, name, getattr(rec, name))
    wb = np.random.default_rng(2).uniform(1.0, 2.5, (n, 4)).astype(np.float32)
    ref = jnoise.get_aug_param(jax.random.key(0), jnp.asarray(wb), n, command, camera)
    vals = [torch.from_numpy(np.array(v)) for _, v in rec.calls]
    draws = {"r_bit": vals[0].reshape(1), "aug_bit": vals[1].reshape(1)}
    if command == "augv5":
        (lo, hi), poly = tnoise._GAIN_LAWS[camera]
        z, red = vals[2], vals[3]
        draws["gains"] = (1.0 / (0.8 + 0.1 * z), red, poly[0] + poly[1] * red + poly[2] * red**2)
        draws["u"] = vals[4:7]
    elif command == "augv2":
        draws["z"] = vals[2:5]
    got = tnoise.aug_params_from_draws(draws, torch.from_numpy(wb), n, command)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    m = np.minimum(np.minimum(*[a.numpy() for a in got[:2]]), got[2].numpy())
    assert m.min() >= -1e-6


def _close_moments(got, ref, tol=0.02):
    """Means within 5 standard errors of their difference (or 2% of the
    std), stds within ``tol``."""
    got, ref = np.asarray(got, np.float64).ravel(), np.asarray(ref, np.float64).ravel()
    se = np.sqrt(got.var() / got.size + ref.var() / ref.size)
    assert abs(got.mean() - ref.mean()) <= max(5 * se, tol * ref.std()), (got.mean(), ref.mean())
    assert abs(got.std() / ref.std() - 1.0) <= tol, (got.std(), ref.std())


@pytest.mark.parametrize("camera", ["SonyA7S2", "IMX686"])
def test_random_gains_law_matches_jax(camera):
    n = 200_000
    got = tnoise.random_gains(gen(3), camera, n)
    ref = jnoise.random_gains(jax.random.key(3), camera, n)
    for a, b in zip(got, ref):
        _close_moments(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("command", ["augv5", "augv2"])
def test_get_aug_param_law_matches_jax(command):
    """20k calls of 4 examples per package (r and the aug bit are drawn per
    call): each delta's moments, and the share of calls left unaugmented."""
    calls, n = 20_000, 4
    wb = np.tile(np.float32([[2.0, 1.0, 1.6, 1.0]]), (n, 1))
    keys = jax.random.split(jax.random.key(4), calls)
    ref = jax.jit(jax.vmap(lambda k: jnoise.get_aug_param(
        k, jnp.asarray(wb), n, command, "SonyA7S2")))(keys)
    g, wbt = gen(4), torch.from_numpy(wb)
    got = [torch.stack(v) for v in zip(*[
        tnoise.get_aug_param(g, wbt, n, command, "SonyA7S2") for _ in range(calls)])]
    for a, b in zip(got, ref):
        _close_moments(a.numpy(), np.asarray(b))
    zero = lambda rows: np.mean(np.all(np.asarray(rows) == 0, axis=1))
    assert abs(zero(got[1].numpy()) - zero(ref[1])) < 0.02


@pytest.mark.parametrize("camera,iso", [("SonyA7S2", [400.0, 3200.0]),
                                        ("IMX686", [100.0, 6400.0, 5000.0]),
                                        ("IMX686", None)])
def test_k_and_wp_for_law_matches_jax(camera, iso):
    n = 30_000
    isos = None if iso is None else np.repeat(np.float32(iso), n // len(iso))
    m = n if iso is None else len(isos)
    got = tnoise._k_and_wp_for(gen(5), camera, None if iso is None else torch.from_numpy(isos), m)
    ref = jnoise._k_and_wp_for(jax.random.key(5), camera,
                               None if iso is None else jnp.asarray(isos), m)
    step = m if iso is None else m // len(iso)
    for a, b in zip(got, ref):
        a, b = a.numpy(), np.asarray(b)
        for i in range(0, m, step):  # per ISO, one law each
            if np.ptp(b[i:i + step]) > 0:
                _close_moments(a[i:i + step], b[i:i + step])
            else:
                np.testing.assert_allclose(a[i:i + step], b[i:i + step], rtol=1e-6)


@pytest.mark.parametrize("black", [False, True])
@pytest.mark.parametrize("camera", ["SonyA7S2", "IMX686"])
def test_sna_real_poisson_law_matches_jax(camera, black):
    """Real draws (Poisson and K) on a constant frame: per-channel moments of
    dn and dy."""
    n, h = 8, 64
    gt = np.full((n, h, h, 4), 0.3, np.float32)
    aug = np.tile(np.float32([[0.3, 0.1, 0.25, 0.1]]), (n, 1))
    iso = np.full(n, 6400.0 if camera == "IMX686" else 1600.0, np.float32)
    dn_t, dy_t = tnoise.sna(gen(6), nchw(gt), torch.from_numpy(aug), camera, 4.0,
                            torch.from_numpy(iso), black_lr=black, ori=False)
    dn_j, dy_j = jnoise.sna(jax.random.key(6), jnp.asarray(gt), jnp.asarray(aug), camera,
                            4.0, jnp.asarray(iso), black_lr=black, ori=False)
    dn_t, dy_t, dn_j, dy_j = nhwc(dn_t), nhwc(dy_t), np.asarray(dn_j), np.asarray(dy_j)
    for c in range(4):
        _close_moments(dn_t[..., c], dn_j[..., c])
        np.testing.assert_allclose(dy_t[..., c], dy_j[..., c], rtol=1e-5, atol=1e-7)


def test_sna_moments():
    """tests/test_noise_physics.py::test_sna_moments on the port."""
    n, h, w = 2, 64, 64
    gt = torch.full((n, 4, h, w), 0.4)
    aug_wb = torch.tensor([[0.3, 0.1, 0.25, 0.1]]).repeat(n, 1)
    dn, dy = tnoise.sna(gen(6), gt, aug_wb, camera_type="SonyA7S2", ratio=2.0,
                        iso=torch.full((n,), 6400.0), ori=True)
    np.testing.assert_allclose(dy[0, :, 0, 0].numpy(), 0.4 * np.array([0.3, 0.1, 0.25, 0.1]),
                               rtol=1e-5)
    np.testing.assert_allclose(dn.mean(dim=(0, 2, 3)).numpy(),
                               0.4 / 2.0 * np.array([0.3, 0.1, 0.25, 0.1]), rtol=0.05)


def test_sna_per_sample_black_mask():
    """tests/test_phone_and_nf.py::test_sna_per_sample_black_mask on the
    port: a per-example mask equals the bool calls row by row."""
    rng = np.random.default_rng(0)
    gt = torch.from_numpy(rng.uniform(0, 0.3, (4, 4, 16, 16)).astype(np.float32))
    aug = torch.from_numpy(rng.uniform(0, 0.4, (4, 4)).astype(np.float32))
    kw = dict(camera_type="IMX686", ratio=2.0, iso=torch.full((4,), 6400.0), ori=True)
    dn_t, dy_t = tnoise.sna(gen(11), gt, aug, black_lr=True, **kw)
    dn_f, dy_f = tnoise.sna(gen(11), gt, aug, black_lr=False, **kw)
    dn_m, dy_m = tnoise.sna(gen(11), gt, aug, black_lr=torch.tensor([1.0, 0.0, 1.0, 0.0]), **kw)
    assert torch.equal(dn_m, dn_t)
    for i, ref in enumerate((dy_t, dy_f, dy_t, dy_f)):
        assert torch.equal(dy_m[i], ref[i])


def test_get_aug_param_nonneg():
    """tests/test_physics_extra.py::test_get_aug_param_nonneg on the port."""
    wb = torch.tensor([[2.0, 1.0, 1.6, 1.0]]).repeat(16, 1)
    for cmd in ("augv5", "augv2"):
        for seed in range(4):
            r, g, b = tnoise.get_aug_param(gen(seed), wb, 16, cmd, "SonyA7S2")
            assert float(torch.minimum(torch.minimum(r, g), b).min()) >= -1e-5, (cmd, seed)


def test_raw_wb_aug_gain_only():
    """tests/test_physics_extra.py::test_raw_wb_aug_gain_only on the port."""
    gt = torch.full((2, 4, 16, 16), 0.3)
    noisy = gt + 0.01
    aug = torch.tensor([[0.2, 0.0, 0.1, 0.0]]).repeat(2, 1)
    out_n, out_g = tnoise.raw_wb_aug(gen(0), noisy, gt, aug, camera_type="IMX686",
                                     ratio=2.0, iso=torch.full((2,), 6400.0), ori=True)
    np.testing.assert_allclose(out_g[:, 0].numpy(), 0.36, rtol=1e-4)
    np.testing.assert_allclose(out_g[:, 1].numpy(), 0.3, rtol=1e-4)
    d = (out_n - noisy).mean(dim=(0, 2, 3)).numpy()
    np.testing.assert_allclose(d, [0.3 / 2 * 0.2, 0, 0.3 / 2 * 0.1, 0], atol=0.01)


# -- HighBitRecovery -----------------------------------------------------------

HBR_CASES = [("IMX686", 6400, "pgrq"), ("IMX686", 6400, "pq"),
             ("SonyA7S2", 1600, "pgrq"), ("SonyA7S2", 1600, "pq")]


def _hbr_pair(camera, iso, code):
    """JAX's HBR with its drawn LUT, and the port's built from JAX's param
    and bias (the perturbation is numpy in both, hence equal)."""
    j = JHBR(camera_type=camera, noise_code=code)
    j.get_lut([iso])
    t = HighBitRecovery(camera_type=camera, noise_code=code)
    t.lut[iso] = t._build(iso, float(j.lut[iso]["bias"]), param=j.lut[iso]["param"])
    return j, t


@pytest.mark.parametrize("camera,iso,code", HBR_CASES)
def test_hbr_lut_matches_jax_given_param(camera, iso, code):
    j, t = _hbr_pair(camera, iso, code)
    lj, lt = j.lut[iso], t.lut[iso]
    assert lt["low"] == lj["low"] and lt["use_tl"] == lj["use_tl"]
    for k in ("cdf", "rng"):
        np.testing.assert_allclose(lt[k].numpy(), np.asarray(lj[k]), rtol=1e-6, atol=0)
    for k in ("bias", "scale", "lam"):
        np.testing.assert_allclose(lt[k], lj[k], rtol=1e-6)
    # the perturbed biases of get_lut are the JAX package's, draw for draw
    t2 = HighBitRecovery(camera_type=camera, noise_code=code)
    t2.get_lut([iso])
    assert t2.lut[iso]["bias"] == lj["bias"]


@pytest.mark.parametrize("adu_input", [False, True])
@pytest.mark.parametrize("camera,iso,code", HBR_CASES)
def test_hbr_map_matches_jax_on_a_shared_field(monkeypatch, camera, iso, code, adu_input):
    """Quantized bias crops (plus values outside the LUT range), normalized
    or in ADU, through both maps from one uniform field: atol 1e-5 on the
    normalized output."""
    j, t = _hbr_pair(camera, iso, code)
    lut = j.lut[iso]
    span = float(lut["param"]["wp"]) - float(lut["param"]["bl"])
    rng = np.random.default_rng(7)
    raw = np.round(rng.normal(0, float(lut["scale"]), (N, P, P, 4))).astype(np.float32)
    raw[0, 0, :4, 0] = [lut["low"] - 3, lut["low"] + len(lut["cdf"]) + 2, 40.0, -30.0]
    raw += rng.uniform(-0.2, 0.2, raw.shape).astype(np.float32)  # sub-ADU remainders
    data = raw if adu_input else raw / span
    if adu_input:
        data[0, 0, 0, 1] = 5.0  # max > 1: the map reads ADU
    field = rng.uniform(0, 1, data.shape).astype(np.float32)
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape, *a, **k: jnp.asarray(field))
    monkeypatch.setattr(thbr, "_uniform", lambda g, shape, device: nchw(field))
    ref = np.asarray(j.map(jax.random.key(0), jnp.asarray(data), iso=iso))
    got = nhwc(t.map(gen(0), nchw(data), iso=iso))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    out_adu = nhwc(t.map(gen(0), nchw(data), iso=iso, norm=False))
    ref_adu = np.asarray(j.map(jax.random.key(0), jnp.asarray(data), iso=iso, norm=False))
    np.testing.assert_allclose(out_adu, ref_adu, rtol=1e-6, atol=1e-3)


def test_hbr_recovers_continuous_distribution():
    """tests/test_noise_physics.py::test_hbr_recovers_continuous_distribution
    on the port (its own LUT draw)."""
    hbr = HighBitRecovery(camera_type="IMX686", noise_code="pq", perturb=False)
    hbr.get_lut([6400])
    lut = hbr.lut[6400]
    sig = float(lut["scale"])
    rng = np.random.default_rng(0)
    raw = np.round(rng.normal(0, sig, (256, 256))).astype(np.float32)
    span = float(lut["param"]["wp"]) - float(lut["param"]["bl"])
    mapped = hbr.map(gen(0), torch.from_numpy(raw / span), iso=6400).numpy() * span
    assert len(np.unique(np.round(mapped, 3))) > 1000
    assert abs(mapped.std() / sig - 1.0) < 0.02
    assert abs(mapped.mean()) < 0.05
    true = rng.normal(0, sig, mapped.size)
    bins = np.linspace(-6 * sig, 6 * sig, 200)
    hp, _ = np.histogram(mapped, bins, density=True)
    hq, _ = np.histogram(true, bins, density=True)
    m = (hp > 0) & (hq > 0)
    assert np.sum(hp[m] * np.log(hp[m] / hq[m])) * (bins[1] - bins[0]) < 0.01


def test_hbr_tukey_mode():
    """tests/test_physics_extra.py::test_hbr_tukey_mode on the port."""
    from scipy import stats

    hbr = HighBitRecovery(camera_type="IMX686", noise_code="pgrq", perturb=False)
    hbr.get_lut([6400])
    lut = hbr.lut[6400]
    assert lut["use_tl"]
    lam, sig = float(lut["lam"]), float(lut["scale"])
    raw = np.round(stats.tukeylambda.rvs(lam, scale=sig, size=(128, 128),
                                         random_state=np.random.default_rng(1))).astype(np.float32)
    span = float(lut["param"]["wp"]) - float(lut["param"]["bl"])
    mapped = hbr.map(gen(0), torch.from_numpy(raw / span), iso=6400).numpy() * span
    assert abs(mapped.std() / (stats.tukeylambda.std(lam) * sig) - 1.0) < 0.05


# -- the Mix synth --------------------------------------------------------------

def _fixed_aug(monkeypatch, n):
    """The same WB deltas in both packages' synths."""
    d = np.random.default_rng(9).uniform(0, 0.4, (3, n)).astype(np.float32)
    monkeypatch.setattr(jsteps, "get_aug_param",
                        lambda *a, **k: tuple(jnp.asarray(x) for x in d))
    monkeypatch.setattr(tsteps, "get_aug_param",
                        lambda *a, **k: tuple(torch.from_numpy(x) for x in d))


MIX_CASES = {
    "sony_augv5": dict(camera="SonyA7S2", command="augv5", ori=False, black=None),
    "sony_augv2_black": dict(camera="SonyA7S2", command="augv2", ori=False,
                             black=np.array([True])),
    "imx686_hbr_host_amplified": dict(camera="IMX686", command="augv2", ori=False,
                                      black=np.array([1, 0, 1, 0], np.float32), hbr=True),
    "imx686_hbr_ori": dict(camera="IMX686", command="augv2", ori=True,
                           black=np.array([0, 1, 1, 0], np.float32), hbr=True),
}


@pytest.mark.parametrize("case", sorted(MIX_CASES))
def test_mix_synth_matches_jax_at_poisson_mean(monkeypatch, poisson_at_mean, case):
    c = MIX_CASES[case]
    cam = c["camera"]
    poisson_at_mean(cam)
    _fixed_aug(monkeypatch, N)
    gt, noisy, _, ratio, iso = _inputs(3)
    ratio = np.full(N, 20.0 if cam == "IMX686" else 100.0, np.float32)
    host_amp = cam == "IMX686"
    lr = noisy * ratio[:, None, None, None] if (host_amp and not c["ori"]) else noisy
    batch = dict(hr=gt, lr=lr.astype(np.float32), ratio=ratio, iso=iso,
                 wb=np.tile(np.float32([[2.0, 1.0, 1.8, 1.0]]), (N, 1)))
    if c["black"] is not None:
        batch["black_lr"] = c["black"]
    maps = (None, None)
    if c.get("hbr"):
        j, t = _hbr_pair(cam, 6400, "p")
        field = np.random.default_rng(4).uniform(0, 1, gt.shape).astype(np.float32)
        monkeypatch.setattr(jax.random, "uniform",
                            lambda key, shape, *a, **k: jnp.asarray(field))
        monkeypatch.setattr(thbr, "_uniform", lambda g, shape, device: nchw(field))
        maps = (lambda k, x: j.map(k, x, iso=6400), lambda g, x: t.map(g, x, iso=6400))
    kw = dict(command=c["command"], ori=c["ori"], host_amplified=host_amp)
    ref = jsteps.make_mix_synth(cam, hbr_map=maps[0], **kw)(
        jax.random.key(0), {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: (nchw(v) if np.ndim(v) == 4 else torch.from_numpy(np.asarray(v)))
          for k, v in batch.items()}
    got = tsteps.make_mix_synth(cam, hbr_map=maps[1], **kw)(gen(0), tb)
    for a, b in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(nhwc(a), np.asarray(b), rtol=1e-6, atol=2e-7)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))


def test_mix_synth_hbr_applied_to_black_rows_only():
    """tests/test_phone_and_nf.py::test_mix_synth_hbr_applied_to_black_rows_only
    on the port."""
    n = 2
    batch = {"hr": torch.zeros((n, 4, 8, 8)), "lr": torch.full((n, 4, 8, 8), 0.25),
             "ratio": torch.full((n,), 20.0), "iso": torch.full((n,), 6400.0),
             "wb": torch.tensor([[2.0, 1.0, 1.8, 1.0]]).repeat(n, 1),
             "black_lr": torch.tensor([1.0, 0.0])}
    synth = tsteps.make_mix_synth("IMX686", command="augv5", ori=True,
                                  hbr_map=lambda g, x: x + 100.0)
    lr, hr, _ = synth(gen(0), batch)
    np.testing.assert_allclose(lr[0].numpy(), 100.25, rtol=1e-6)
    np.testing.assert_allclose(lr[1].numpy(), 0.25, rtol=1e-6)
    np.testing.assert_allclose(hr.numpy(), 0.0, atol=1e-7)


def _sony_batch(rng, n=4, p=16):
    hr = rng.uniform(0.05, 0.5, (n, 4, p, p)).astype(np.float32)
    lr = np.clip(hr / 100.0 + rng.normal(0, 0.002, hr.shape), -0.03, 1).astype(np.float32)
    return {"hr": torch.from_numpy(hr), "lr": torch.from_numpy(lr),
            "ratio": torch.full((n,), 100.0), "iso": torch.full((n,), 1600.0),
            "wb": torch.tensor([[2.0, 1.0, 1.6, 1.0]]).repeat(n, 1)}


def test_mix_synth_shapes_and_brightening():
    """tests/test_synth_paths.py::test_mix_synth_shapes_and_brightening on the
    port; and a per-item wb [4] and bool black_lr, as the loader collates a
    batch of one item, broadcast to its crops."""
    batch = _sony_batch(np.random.default_rng(0))
    synth = tsteps.make_mix_synth("SonyA7S2", command="augv5", ori=False)
    lr, hr, _ = synth(gen(0), batch)
    assert lr.shape == batch["hr"].shape and hr.shape == batch["hr"].shape
    assert float(lr.mean()) > float(batch["lr"].mean()) * 10
    assert float((hr - batch["hr"]).min()) > -1e-4
    item = dict(batch, wb=batch["wb"][0], black_lr=torch.tensor([False]))
    lr1, hr1, _ = synth(gen(0), item)
    lr2, hr2, _ = synth(gen(0), batch)
    assert torch.equal(lr1, lr2) and torch.equal(hr1, hr2)


def test_sfrn_synth_adds_shot_over_black():
    """tests/test_synth_paths.py::test_sfrn_synth_adds_shot_over_black on the
    port: the black-frame ('b') raw synth plus the read layer."""
    rng = np.random.default_rng(1)
    batch = _sony_batch(rng)
    batch["lr"] = torch.from_numpy(rng.normal(0, 0.0004, batch["hr"].shape).astype(np.float32))
    raw = tsteps.make_raw_synth("SonyA7S2", "pb", ori=False, clip=False)
    lr_shot, hr, ratio = raw(gen(1), batch)
    lr = lr_shot + batch["lr"]
    assert torch.isfinite(lr).all() and lr.shape == batch["hr"].shape


def test_mix_synth_amplification_convention():
    """tests/test_synth_paths.py::test_mix_synth_amplification_convention on
    the port: lr is amplified exactly once."""
    rng = np.random.default_rng(2)
    base = torch.from_numpy(rng.uniform(0, 0.01, (2, 4, 8, 8)).astype(np.float32))
    dgain = 8.0
    batch = {"hr": torch.from_numpy(rng.uniform(0, 1, (2, 4, 8, 8)).astype(np.float32)),
             "ratio": torch.full((2,), dgain), "iso": torch.full((2,), 6400.0),
             "wb": torch.ones((2, 4))}
    phone = tsteps.make_mix_synth("IMX686", command="noaug", ori=False, host_amplified=True)
    lr, hr, _ = phone(gen(0), dict(batch, lr=base * dgain))
    np.testing.assert_allclose(lr.numpy(), (base * dgain).numpy(), rtol=1e-6)
    np.testing.assert_allclose(hr.numpy(), batch["hr"].numpy(), rtol=1e-6)
    sony = tsteps.make_mix_synth("SonyA7S2", command="noaug", ori=False)
    lr2, _, _ = sony(gen(0), dict(batch, lr=base))
    np.testing.assert_allclose(lr2.numpy(), (base * dgain).numpy(), rtol=1e-6)
