"""Config, calibration tables and the SID/ELD host data path: the port's
numpy copies against the JAX package, exactly (same code, same seeds)."""

import glob
import os
import pickle

import numpy as np
import pytest

import pnnp_tpu.config as jcfg
import pnnp_tpu.data as jdata
import pnnp_tpu.physics.calibration as jcal
import pnnp_tpu_torch.config as tcfg
import pnnp_tpu_torch.data as tdata
import pnnp_tpu_torch.physics.calibration as tcal
from pnnp_tpu.data.fixtures import make_sid_fixture as jax_make_sid_fixture
from pnnp_tpu_torch.data.fixtures import make_sid_fixture, make_sid_runfile

RUNFILES = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..",
                                         "runfiles", "**", "*.yml"), recursive=True))


def _assert_batches_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def _all_batches(mod, dst, seed=1997, **loader_kw):
    ds = mod.build_dataset(dst, seed=seed)
    return ds, list(mod.DataLoader(ds, batch_size=1, shuffle=False,
                                   num_workers=0, **loader_kw))


def test_all_runfiles_load_to_equal_dicts():
    assert len(RUNFILES) == 16
    for path in RUNFILES:
        assert tcfg.load_runfile(path) == jcfg.load_runfile(path), path
        assert (tcfg.load_runfile(path, mode="eval", root_prefix="/data")
                == jcfg.load_runfile(path, mode="eval", root_prefix="/data")), path
        a = tcfg.load_runfile(path)
        assert tcfg.command_of(a["dst"]).flags() == jcfg.command_of(a["dst"]).flags()
        assert tcfg.noise_code_of(a["dst"]).raw == jcfg.noise_code_of(a["dst"]).raw


def test_calibration_tables_are_equal_arrays():
    assert tcal.HALF_CLIP == jcal.HALF_CLIP
    np.testing.assert_array_equal(tcal.LEGAL_ISO, jcal.LEGAL_ISO)
    assert tcal.LEGAL_ISO.dtype == jcal.LEGAL_ISO.dtype
    assert tcal.ISO_TABLES.keys() == jcal.ISO_TABLES.keys()
    for cam in jcal.ISO_TABLES:
        t, j = tcal.ISO_TABLES[cam], jcal.ISO_TABLES[cam]
        assert t.keys() == j.keys()
        for k in j:
            np.testing.assert_array_equal(t[k], j[k], err_msg=f"{cam}.{k}")
            assert np.asarray(t[k]).dtype == np.asarray(j[k]).dtype
        for iso in j["iso"]:
            assert tcal.iso_index(cam, iso) == jcal.iso_index(cam, iso)
    with pytest.raises(KeyError):
        tcal.iso_index("SonyA7S2", 123)


def test_sid_fixture_trees_and_eval_batches_match(tmp_path):
    H, W = 32, 48
    make_sid_fixture(tmp_path / "t", n_scenes=3, H=H, W=W)
    jax_make_sid_fixture(tmp_path / "j", n_scenes=3, H=H, W=W)
    for name in sorted(os.listdir(tmp_path / "j")):
        if name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(tmp_path / "t" / name),
                                          np.load(tmp_path / "j" / name))
    run = make_sid_runfile(tmp_path / "t", H=H, W=W)
    tds, tb = _all_batches(tdata, run["dst_eval"])
    jds, jb = _all_batches(jdata, run["dst_eval"])
    # 3 scenes: the default 250 split (entries 40-79) is empty
    assert len(tb) == len(jb) == 0
    for ds in (tds, jds):
        ds.change_eval_ratio(100)
    tb = list(tdata.DataLoader(tds, batch_size=1, shuffle=False, num_workers=0))
    jb = list(jdata.DataLoader(jds, batch_size=1, shuffle=False, num_workers=0))
    assert len(tb) == len(jb) == 3
    for a, b in zip(tb, jb):
        assert a["lr"].shape == (1, H // 2, W // 2, 4)
        _assert_batches_equal(a, b)


@pytest.mark.parametrize("name", ["SID_Dataset", "Raw_Dataset"])
def test_seeded_train_crops_match(tmp_path, name):
    """Train-mode crops draw from the dataset RNG: same seed, same crops."""
    make_sid_fixture(tmp_path, n_scenes=3, H=32, W=48)
    dst = dict(make_sid_runfile(tmp_path)["dst_train"], dataset=name,
               command="idremap")
    tds, tb = _all_batches(tdata, dst, seed=7)
    jds, jb = _all_batches(jdata, dst, seed=7)
    assert type(tds).__name__ == type(jds).__name__
    for a, b in zip(tb, jb):
        _assert_batches_equal(a, b)


def _make_eld_fixture(root, H=32, W=48):
    """The ELD tree of tests/test_train_data.py::test_eld_dataset."""
    rng = np.random.default_rng(0)
    scenes = []
    combos = [(i, r) for i in (800, 1600, 3200) for r in (100, 200)] * 2
    for s in range(2):
        entries = []
        ci = 0
        for img_id in range(1, 17):
            p = str(root / f"scene{s}_IMG_{img_id:04d}.npy")
            np.save(p, rng.integers(512, 16383, (H, W)).astype(np.float32))
            if img_id in (1, 6, 11, 16):
                iso, ratio = 100, 1
            else:
                iso, ratio = combos[ci]
                ci += 1
            entries.append({
                "name": f"IMG_{img_id:04d}", "data": p, "ISO": iso, "ratio": ratio,
                "ExposureTime": 1.0, "wb": np.array([2, 1, 1.5, 1], np.float32),
                "ccm": np.eye(3, dtype=np.float32),
            })
        scenes.append(entries)
    os.makedirs(root / "infos", exist_ok=True)
    with open(root / "infos" / "ELD_SonyA7S2.info", "wb") as f:
        pickle.dump(scenes, f)
    return dict(
        dataset="ELD_Dataset", mode="eval", H=H, W=W, wp=16383, bl=512,
        ori=False, clip=2, command="", infos_dir=str(root / "infos"),
        iso_list=[800, 1600, 3200], ratio_list=[100, 200], patch_size=8,
    )


def test_eld_batches_match(tmp_path):
    dst = _make_eld_fixture(tmp_path)
    tds, tb = _all_batches(tdata, dst)
    jds, jb = _all_batches(jdata, dst)
    assert len(tb) == len(jb) == 12
    for a, b in zip(tb, jb):
        _assert_batches_equal(a, b)
    for ds in (tds, jds):  # the in-training subset and the dgain sweep API
        ds.fast_eval(True)
    assert len(tds) == len(jds) == 6
    _assert_batches_equal(tds[5], jds[5])
    for ds in (tds, jds):
        ds.fast_eval(False)
        ds.ratio_list = [200]
        ds.recheck_length()
    _assert_batches_equal(tds[3], jds[3])


def test_multidataset_and_unported_names(tmp_path):
    make_sid_fixture(tmp_path, n_scenes=2, H=32, W=48)
    dst = dict(make_sid_runfile(tmp_path)["dst_eval"], dataset="MultiDataset",
               datasets=["SID_Dataset", "Raw_Dataset"], dstnames=["SID", "SID"])
    m = tdata.build_dataset(dst)
    # SID_Dataset's default 250 split is empty with 2 scenes; Raw_Dataset has 2
    assert isinstance(m, tdata.MultiDataset) and len(m) == 0 + 2
    _assert_batches_equal(m[1], jdata.build_dataset(dst)[1])
    for name in ("Mix_Dataset", "PMNNP_Dataset", "SFRN_Dataset",
                 "IMX686_Dataset", "Multi_Mix_Dataset"):
        with pytest.raises(KeyError, match="ROADMAP 1.11"):
            tdata.build_dataset(dict(dst, dataset=name))
    with pytest.raises(KeyError, match="unknown dataset"):
        tdata.build_dataset(dict(dst, dataset="NoSuch_Dataset"))
