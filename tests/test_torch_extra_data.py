"""The last datasets and the sRGB unprocessing in the PyTorch port against
the JAX package (ROADMAP 1.11, the remainder).

* ``ImgDataset`` on a tree of sRGB images (uint8 and float, a grayscale
  one, one smaller than the crop): every item equal to JAX's, on the main
  thread's generator and after a worker reseed.
* ``MixedSubsetDataset`` and the ``Multi_*`` mixers of ``build_dataset``
  (``Multi_Real`` on the LRID fixture, ``Multi_Mix``, ``Multi_Sync`` and
  ``Multi_Uproc`` on a SID fixture with a bias library): length, the
  extra set's crop count and the items, equal to JAX's (as
  tests/test_data_misc.py:71-115 holds the JAX package).
* ``physics/unprocess.py``: the deterministic stages equal to JAX's to 1e-6
  (tests/test_physics_extra.py:19-52's checks too); the samplers
  (``unprocess``'s gains, ``random_noise_levels``, ``add_noise``) by their
  laws' moments over many draws, since the two packages cannot share a
  random stream.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pnnp_tpu.data as jdata
import pnnp_tpu.physics.unprocess as JU
import pnnp_tpu_torch.data as tdata
import pnnp_tpu_torch.physics.unprocess as TU
from pnnp_tpu.data.extra import ImgDataset as JImg
from pnnp_tpu.data.extra import MixedSubsetDataset as JMixed
from pnnp_tpu.physics.noise import random_gains
from pnnp_tpu_torch.data.extra import ImgDataset, MixedSubsetDataset
from pnnp_tpu_torch.data.fixtures import make_sid_fixture
from tests.test_torch_phone_data import _assert_items_equal, lrid, phone_dst  # noqa: F401


@pytest.fixture(scope="module")
def img_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("srgb")
    rng = np.random.default_rng(0)
    np.save(root / "a.npy", rng.integers(0, 256, (40, 56, 3)).astype(np.uint8))
    np.save(root / "b.npy", rng.uniform(0, 1, (36, 36)).astype(np.float32))  # grayscale
    (root / "sub").mkdir()
    np.save(root / "sub" / "c.npy", rng.uniform(0, 1, (12, 20, 3)).astype(np.float32))
    return root


def _img_dst(root, **kw):
    return dict(dict(root_dir=str(root), patch_size=8, crop_per_image=3, mode="train"), **kw)


def test_img_dataset_matches_jax(img_root):
    t, j = ImgDataset(_img_dst(img_root)), JImg(_img_dst(img_root))
    assert len(t) == len(j) == 3 and t.files == j.files
    for i in range(3):
        _assert_items_equal(t[i], j[i])
    for d in (t, j):
        d.reseed_worker(1997, 2, 1)
    for i in (2, 0):
        a, b = t[i], j[i]
        _assert_items_equal(a, b)
        assert a["srgb"].shape == (3, 16, 16, 3) and a["srgb"].max() <= 1.0
    assert type(tdata.build_dataset(dict(_img_dst(img_root), dataset="Img_Dataset"))) \
        is ImgDataset


def _sid_dst(root, **kw):
    return dict(dict(dataset="SID_Dataset", mode="train", H=32, W=48, patch_size=8,
                     crop_per_image=1, croptype="random_crop", command="", wp=16383,
                     bl=512, ori=False, clip=2, infos_dir=str(root / "infos")), **kw)


def test_mixed_subset_matches_jax(tmp_path):
    make_sid_fixture(tmp_path)
    sets = {}
    for side, data, mixer in (("torch", tdata, MixedSubsetDataset), ("jax", jdata, JMixed)):
        base = data.build_dataset(_sid_dst(tmp_path, crop_per_image=2))
        extra = data.build_dataset(_sid_dst(tmp_path))
        sets[side] = mixer(base, extra, extra_rate=2)
    t, j = sets["torch"], sets["jax"]
    assert len(t) == len(j) == 3 + 3 // 2
    assert t.extra.args["crop_per_image"] == j.extra.args["crop_per_image"] == 1
    for i in range(len(j)):
        _assert_items_equal(t[i], j[i])
    assert t[len(t) - 1]["hr"].shape == (2, 8, 8, 4)
    with pytest.raises(ValueError, match="not divisible"):
        MixedSubsetDataset(tdata.build_dataset(_sid_dst(tmp_path, crop_per_image=3)),
                           tdata.build_dataset(_sid_dst(tmp_path)), extra_rate=2)


@pytest.fixture(scope="module")
def sid_bias(tmp_path_factory):
    root = tmp_path_factory.mktemp("sid_bias")
    make_sid_fixture(root, n_scenes=8, H=64, W=96, bias_isos=(1600,))
    return root


def _mix_dst(root, name):
    return dict(dataset=name, mode="train", dstname="SID", camera_type="SonyA7S2",
                root_dir=str(root), infos_dir=str(root / "infos"), bias_dir=str(root / "bias"),
                ds_dir=None, H=64, W=96, patch_size=8, crop_per_image=4,
                croptype="random_crop", command="augv5", noise_code="p", wp=16383, bl=512,
                ori=False, clip=2)


@pytest.mark.parametrize("name", ["Multi_Real_Dataset", "Multi_Mix_Dataset",
                                  "Multi_Sync_Dataset", "Multi_Uproc_Dataset"])
def test_multi_mixers_match_jax(name, lrid, sid_bias):  # noqa: F811
    if name == "Multi_Real_Dataset":
        # the base is the 'indoor' set: the fixture's indoor_x5 tables under its name
        for kind in ("GT_align_ours", "short"):
            shutil.copyfile(lrid / "infos" / f"indoor_x5_{kind}.info",
                            lrid / "infos" / f"indoor_{kind}.info")
    dst = (phone_dst(lrid, dataset=name, crop_per_image=4) if name == "Multi_Real_Dataset"
           else _mix_dst(sid_bias, name))
    t, j = tdata.build_dataset(dst, seed=1997), jdata.build_dataset(dst, seed=1997)
    assert isinstance(t, MixedSubsetDataset)
    assert type(t.base).__name__ == type(j.base).__name__
    assert type(t.extra).__name__ == type(j.extra).__name__
    assert len(t) == len(j) > len(t.base)
    assert t.extra.args["crop_per_image"] == 1
    for i in (0, len(j.base) - 1, len(j.base), len(j) - 1):
        _assert_items_equal(t[i], j[i])
    with pytest.raises(ValueError, match="divisible"):
        tdata.build_dataset(dict(dst, crop_per_image=6))


# ------------------------------------------------------------------ unprocess
def _srgb(seed, shape=(2, 16, 24, 3)):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def test_unprocess_stages_match_jax():
    x = _srgb(0)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    close = lambda a, b: np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                                    rtol=1e-6, atol=1e-6)
    for cam in ("SonyA7S2", "IMX686"):
        close(TU.random_ccm(cam), JU.random_ccm(cam))
        close(TU.apply_ccm(tx, TU.random_ccm(cam)), JU.apply_ccm(jx, JU.random_ccm(cam)))
    close(TU.inverse_smoothstep(tx), JU.inverse_smoothstep(jx))
    close(TU.gamma_expansion(tx), JU.gamma_expansion(jx))
    gains = (1.2, 2.1, 1.7)
    close(TU.safe_invert_gains(tx, *(torch.tensor(g) for g in gains)),
          JU.safe_invert_gains(jx, *(jnp.float32(g) for g in gains)))
    np.testing.assert_array_equal(TU.mosaic_rggb(tx).numpy(), np.asarray(JU.mosaic_rggb(jx)))
    for lock in (True, (1.1, 1.9, 2.2)):
        got, gm = TU.unprocess(torch.Generator().manual_seed(0), tx, lock_wb=lock)
        ref, jm = JU.unprocess(jax.random.key(0), jx, lock_wb=lock)
        close(got, ref)
        for k in jm:
            close(gm[k], jm[k])
    # tests/test_physics_extra.py's checks: the inverse of smoothstep
    s = TU.inverse_smoothstep(torch.linspace(0.01, 0.99, 17))
    close(3 * s ** 2 - 2 * s ** 3, np.linspace(0.01, 0.99, 17))


def test_unprocess_samplers_match_jax_by_moments():
    """Random gains (``lock_wb=False``) and the noise-level and noise draws:
    means and standard deviations over many draws within 3% of JAX's (the
    laws' own), ranges as the reference's."""
    x = torch.from_numpy(_srgb(1, (8, 8, 3)))
    gen = torch.Generator().manual_seed(0)
    n = 4000
    t_gains = np.array([[float(TU.unprocess(gen, x, camera_type=c)[1][k])
                         for k in ("rgb_gain", "red_gain", "blue_gain")]
                        for c in ("IMX686",) for _ in range(n)])
    keys = jax.random.split(jax.random.key(0), n)
    # JAX's unprocess draws its gains with random_gains(key, camera, 1)
    j_gains = np.stack([np.asarray(g) for g in random_gains(keys[0], "IMX686", n)], axis=1)
    assert t_gains[:, 1].min() >= 1.4 and t_gains[:, 1].max() <= 2.3
    for c in range(3):
        assert t_gains[:, c].mean() == pytest.approx(j_gains[:, c].mean(), rel=0.03)
    t_lv = np.array([[float(v) for v in TU.random_noise_levels(gen)] for _ in range(n)])
    j_lv = np.stack([np.asarray(v) for v in jax.vmap(JU.random_noise_levels)(keys)], axis=1)
    assert 1e-4 <= t_lv[:, 0].min() and t_lv[:, 0].max() <= 0.012
    for c in range(2):
        lt, lj = np.log(t_lv[:, c]), np.log(j_lv[:, c])
        assert lt.mean() == pytest.approx(lj.mean(), rel=0.03)
        assert lt.std() == pytest.approx(lj.std(), rel=0.05)
    img = torch.full((256, 256, 3), 0.3)
    noisy = TU.add_noise(gen, img, shot_noise=0.01, read_noise=0.0005) - img
    ref = np.asarray(JU.add_noise(jax.random.key(1), jnp.asarray(img.numpy()), 0.01, 0.0005)) - 0.3
    assert float(noisy.mean()) == pytest.approx(0.0, abs=1e-3)
    assert float(noisy.std()) == pytest.approx(float(ref.std()), rel=0.03)
    assert float(noisy.std()) == pytest.approx(np.sqrt(0.3 * 0.01 + 0.0005), rel=0.03)
