"""The port's LRID (IMX686) and Mix/PMNNP/SFRN datasets and info builders
against the JAX package's: numpy copies, so every key of every item is
identical at seed 1997, with one stated exception.

The exception is the HighBitRecovery of the SonyA7S2 bias pastes, done on
the host inside ``MixDataset``/``SFRNDataset.__getitem__``: each package
draws the uniform field of the remap from its own generator, seeded by the
same one draw of the dataset's stream. There the remap's input is identical
to JAX's, its output lies within +-0.5 ADU of the rounded input plus its
sub-ADU remainder, and pixels outside both packages' LUT ranges are JAX's.
"""

import os
import pickle

import numpy as np
import pytest

import pnnp_tpu.data as jdata
import pnnp_tpu_torch.data as tdata
from pnnp_tpu.data import infos as jinfos
from pnnp_tpu_torch.data import infos as tinfos
from pnnp_tpu_torch.data import phone as tphone
from pnnp_tpu_torch.data.fixtures import make_lrid_fixture, make_sid_fixture

H, W = 32, 48


def _assert_items_equal(a: dict, b: dict, skip=()):
    assert a.keys() == b.keys()
    for k in a:
        if k in skip:
            continue
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def _phone_resources(d, iso=6400):
    """Dark-shading planes and BLE tables (normal and hot) for
    PhoneDarkShading, and a noiseparam-iso-6400.h5 calibration."""
    import h5py

    rng = np.random.default_rng(5)
    os.makedirs(d, exist_ok=True)
    for hs in ("", "_hot"):
        np.save(os.path.join(d, f"darkshading_tk{hs}.npy"),
                rng.normal(0, 0.01, (H, W)).astype(np.float32))
        np.save(os.path.join(d, f"darkshading_tb{hs}.npy"),
                rng.normal(0, 0.5, (H, W)).astype(np.float32))
        with open(os.path.join(d, f"BLE_t{hs}.pkl"), "wb") as f:
            pickle.dump({iso: rng.normal(0, 0.1, (4, 2)), 100: rng.normal(0, 0.1, (4, 2))}, f)
    with h5py.File(os.path.join(d, f"noiseparam-iso-{iso}.h5"), "w") as f:
        for k in ("lam", "sigmaGs", "sigmaTL", "sigmaR"):
            f[k] = rng.uniform(0.01, 2.0, 16)
        f["meanRead"] = rng.normal(0, 1, (4, 16))
    return d


@pytest.fixture(scope="module")
def lrid(tmp_path_factory):
    root = tmp_path_factory.mktemp("lrid")
    make_lrid_fixture(root, H=H, W=W)
    _phone_resources(str(root / "resources"))
    return root


def phone_dst(root, dataset="IMX686_Dataset", mode="train", **kw):
    d = dict(dataset=dataset, mode=mode, dstname="indoor_x5", camera_type="IMX686",
             H=H, W=W, patch_size=8, crop_per_image=2, croptype="random_crop",
             command="alldg", noise_code="p", wp=1023, bl=64, ori=False, clip=False,
             ratio_list=[1, 2, 4, 8, 16], infos_dir=str(root / "infos"),
             bias_dir=str(root / "bias"), ds_dir=str(root / "resources"))
    d.update(kw)
    return d


# hot scenes of indoor_x5 (6, 15, 33, ...) sit among the first train ids
ITEMS = list(range(0, 16)) + [27, 28, 55, 130, 249]

PHONE_CASES = {
    "paired_alldg": dict(),
    "paired_rdg_darkshading": dict(command="rdg, darkshading2++, blc, blc2"),
    "paired_ori_clip": dict(ori=True, clip=2, command="alldg, small"),
    "real_dataset": dict(dataset="Real_Dataset"),
    "raw_noiseparam": dict(dataset="IMX686_Raw_Dataset", command="alldg, darkshading2++"),
    "proxy": dict(dataset="IMX686_Proxy_Dataset", ori=True),
    "mix_hb": dict(dataset="IMX686_Mix_Dataset", command="alldg, HB, darkshading2++, augv2"),
    "mix_hb_lr10_buffer": dict(dataset="IMX686_Mix_Dataset", command="alldg, HB, lr10, buffer"),
    "pmnnp": dict(dataset="IMX686_PMNNP_Dataset", command="alldg, darkshading2++, augv2, HB"),
    "sfrn": dict(dataset="IMX686_SFRN_Raw_Dataset", command="alldg, HB"),
}


@pytest.mark.parametrize("case", sorted(PHONE_CASES))
def test_phone_train_items_equal_jax(lrid, case):
    dst = phone_dst(lrid, **PHONE_CASES[case])
    t = tdata.build_dataset(dst, seed=1997)
    j = jdata.build_dataset(dst, seed=1997)
    assert type(t).__name__ == type(j).__name__
    assert len(t) == len(j) and t.id_remap == j.id_remap
    assert (t.phone_ds is not None) == ("darkshading" in dst["command"])
    for k in ("noiseparam", "blacks", "blacks_hot", "black_exps"):
        if hasattr(j, k):
            a, b = getattr(t, k), getattr(j, k)
            if k == "noiseparam":
                assert a.keys() == b.keys()
                for iso in b:
                    for key in b[iso]:
                        np.testing.assert_array_equal(a[iso][key], b[iso][key])
            else:
                assert a == b
    pastes = 0
    for i in ITEMS:
        if i < len(j):
            a, b = t[i], j[i]
            _assert_items_equal(a, b)
            pastes += int(np.max(b.get("black_lr", 0)) > 0)
    if "HB" in dst["command"] and "Mix" in dst["dataset"]:
        assert pastes > 0


@pytest.mark.parametrize("fast", [False, True])
def test_phone_eval_items_equal_jax(lrid, fast):
    """Eval mode at every dgain of the ladder (change_eval_ratio), and the
    fast-eval scenes of an in-training eval leg."""
    dst = phone_dst(lrid, mode="eval", command="alldg, darkshading2++")
    t, j = tdata.build_dataset(dst), jdata.build_dataset(dst)
    if fast:
        t.fast_eval(True)
        j.fast_eval(True)
    assert t.id_remap == j.id_remap == ([44, 51, 53] if fast else
                                        [4, 14, 25, 41, 44, 51, 52, 53, 58])
    for r in (1, 4, 16):
        t.change_eval_ratio(r)
        j.change_eval_ratio(r)
        for i in range(len(j)):
            _assert_items_equal(t[i], j[i])
    for name in ("IMX686_Proxy_Dataset", "IMX686_Mix_Dataset"):  # dst_test blocks
        d = dict(dst, dataset=name, mode="evaltest")
        a, b = tdata.build_dataset(d), jdata.build_dataset(d)
        _assert_items_equal(a[3], b[3])


def test_imx686_paired_dataset(lrid):
    """tests/test_phone_and_nf.py::test_imx686_paired_dataset on the port."""
    ds = tphone.IMX686Dataset(phone_dst(lrid, ori=True, ratio_list=[1, 2, 4]))
    assert len(ds) == len(ds.id_remap) * 3 == 50 * 3
    s0 = ds[0]
    assert s0["hr"].shape == s0["lr"].shape == (2, 8, 8, 4)
    assert {float(ds[i]["ratio"][0]) for i in range(0, len(ds), 7)} == {1.0, 2.0, 4.0}


def test_imx686_eval_split_and_fast_eval(lrid):
    """tests/test_phone_and_nf.py::test_imx686_eval_split_and_fast_eval."""
    ds = tphone.IMX686Dataset(phone_dst(lrid, mode="eval", ori=True), seed=7)
    ds._data_split(eval_ids=[1, 3])
    ds.recheck_length()
    assert len(ds) == 2
    ds.change_eval_ratio(2)
    s = ds[0]
    assert s["hr"].shape == (1, 16, 24, 4) and float(s["ratio"][0]) == 2.0


def test_imx686_raw_dataset_for_synth(lrid):
    """tests/test_phone_and_nf.py::test_imx686_raw_dataset_for_synth."""
    s = tphone.IMX686RawDataset(phone_dst(lrid, dataset="IMX686_Raw_Dataset"))[0]
    np.testing.assert_array_equal(s["hr"], s["lr"])
    assert s["hr"].min() >= 0 and s["hr"].max() <= 1


def test_imx686_mix_bias_paste(lrid):
    """tests/test_phone_and_nf.py::test_imx686_mix_bias_paste on the port's
    fixture: 1-in-5 items paste a bias frame (dgain 20, black_lr crops), hot
    scenes from the -hot library."""
    ds = tphone.IMX686MixDataset(phone_dst(lrid, dataset="IMX686_Mix_Dataset", ori=True,
                                           command="alldg HB"), seed=7)
    assert len(ds.blacks) == len(ds.blacks_hot) == 3 and ds.black_exps == [25.0] * 3
    seen_black = seen_normal = 0
    for i in range(60):
        d = ds[i % len(ds)]
        assert d["black_lr"].shape == (len(d["hr"]),)
        if d["black_lr"].max() > 0:
            seen_black += 1
            assert d["ratio"][0] == 20.0 and abs(float(d["lr"].mean())) < 0.05
        else:
            seen_normal += 1
    assert seen_black >= 3 and seen_normal >= 30
    ds2 = tphone.IMX686MixDataset(phone_dst(lrid, dataset="IMX686_Mix_Dataset",
                                            command="alldg"), seed=7)
    assert all(ds2[i]["black_lr"].max() == 0 for i in range(8))


# -- SonyA7S2: Mix / PMNNP / SFRN ------------------------------------------------

@pytest.fixture(scope="module")
def sid(tmp_path_factory):
    root = tmp_path_factory.mktemp("sid")
    make_sid_fixture(root, n_scenes=3, H=H, W=W, bias_isos=(800, 1600), n_bias=12)
    return root


def sid_dst(root, dataset, command, mode="train", **kw):
    d = dict(dataset=dataset, mode=mode, dstname="SID", camera_type="SonyA7S2",
             noise_code="pgrq", H=H, W=W, patch_size=8, crop_per_image=2,
             croptype="random_crop", wp=16383, bl=512, ori=False, clip=2,
             command=command, infos_dir=str(root / "infos"), bias_dir=str(root / "bias"))
    d.update(kw)
    return d


def _record_hbr(ds, log):
    inner = ds.hbr.map

    def rec(key, data, iso=6400, norm=True):
        out = inner(key, data, iso=iso, norm=norm)
        log.append((np.array(data), np.array(out), iso))
        return out
    ds.hbr.map = rec


SONY_CASES = {
    "mix_pmn": ("Mix_Dataset", "augv2, idremap, HB"),
    "mix_lr10": ("Mix_Dataset", "augv2, HB, lr10"),
    "mix_prehb": ("Mix_Dataset", "HB, preHB"),
    "mix_mm": ("Mix_Dataset", "augv2, idremap, darkshading2"),
    "pmnnp": ("PMNNP_Dataset", "idremap, darkshading2, preHB, augv2"),
    "sfrn": ("SFRN_Dataset", "HB, lr10"),
    "sfrn_nohb": ("SFRN_Dataset", ""),
}


@pytest.mark.parametrize("mode", ["train", "evaltest"])
@pytest.mark.parametrize("case", sorted(SONY_CASES))
def test_sony_items_equal_jax_but_host_hbr(sid, case, mode):
    name, command = SONY_CASES[case]
    dst = sid_dst(sid, name, command, mode=mode)
    t, j = tdata.build_dataset(dst, seed=1997), jdata.build_dataset(dst, seed=1997)
    if mode == "evaltest" and name != "SFRN_Dataset":
        t.change_eval_ratio(100)
        j.change_eval_ratio(100)
    np.testing.assert_array_equal(t.__dict__.get("legal_iso", 0), j.__dict__.get("legal_iso", 0))
    tlog, jlog = [], []
    if hasattr(j, "hbr"):
        _record_hbr(t, tlog)
        _record_hbr(j, jlog)
    for rep in range(4):  # the same items again: the stream stays in step
        for i in range(len(j)):
            n = len(jlog)
            a, b = t[i], j[i]
            remapped = len(jlog) > n
            _assert_items_equal(a, b, skip=("lr",) if remapped else ())
            if remapped:
                _check_host_hbr(t, tlog[-1], jlog[-1], a["lr"], b["lr"])
    assert len(tlog) == len(jlog)
    if "HB" in command and "preHB" not in command:
        assert jlog, "no bias paste went through HBR"


def _check_host_hbr(t, rec_t, rec_j, lr_t, lr_j):
    (in_t, out_t, iso_t), (in_j, out_j, iso_j) = rec_t, rec_j
    assert iso_t == iso_j
    np.testing.assert_array_equal(in_t, in_j)
    np.testing.assert_array_equal(lr_t, out_t)
    span = 16383.0 - 512.0
    x = in_t.astype(np.float64) * span
    r = np.round(x)
    got = lr_t.astype(np.float64) * span
    # the remap draws within the input's ADU bin: rounded input +- 0.5, plus
    # the input's sub-ADU remainder x - r
    assert np.abs(got - x).max() <= 0.5 + 1e-3
    lut_t = t.hbr.lut[iso_t]
    out_range = (r < lut_t["low"]) | (r >= lut_t["low"] + lut_t["cdf"].shape[0])
    np.testing.assert_allclose(lr_t[out_range], out_j[out_range], rtol=1e-6, atol=1e-9)
    assert np.unique(np.round(got[~out_range], 3)).size > 0.5 * (~out_range).sum()


def test_sfrn_lr10_limits_bias_pick(tmp_path):
    """tests/test_data_misc.py::test_sfrn_lr10_limits_bias_pick on the port."""
    make_sid_fixture(tmp_path, n_scenes=1, H=H, W=W)
    bias = tmp_path / "bias" / "1600"
    bias.mkdir(parents=True)
    for j in range(15):
        np.save(str(bias / f"b{j:02d}.npy"),
                np.full((H, W), 512.0 if j < 10 else 9000.0, np.float32))
    ds = tdata.SFRNDataset(dict(sid_dst(tmp_path, "SFRN_Dataset", "HB, lr10"),
                                crop_per_image=1), seed=3)
    for _ in range(40):
        assert float(np.abs(ds[0]["lr"]).max()) < 0.01


# -- info builders -----------------------------------------------------------------

def _tree(root):
    rng = np.random.default_rng(0)
    for d in ("long", "short"):
        os.makedirs(root / "SID" / d, exist_ok=True)
    for i in range(2):
        np.save(root / "SID" / "long" / f"{i:05d}_00_10s.npy", rng.random((4, 4)))
        for e in ("0.1", "0.04"):
            np.save(root / "SID" / "short" / f"{i:05d}_00_{e}s.npy", rng.random((4, 4)))
    for s in ("scene-1", "scene-2"):
        os.makedirs(root / "ELD" / "SonyA7S2" / s, exist_ok=True)
        for k in range(3):
            np.save(root / "ELD" / "SonyA7S2" / s / f"IMG_{k:04d}.npy", rng.random((4, 4)))
    for s in ("scene001", "scene002"):
        for sub in ("GT", "short_x1", "short_x02"):
            os.makedirs(root / "LRID" / "indoor_x5" / s / sub, exist_ok=True)
            np.save(root / "LRID" / "indoor_x5" / s / sub / "a.npy", rng.random((4, 4)))


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_info_builders_equal_jax(tmp_path):
    _tree(tmp_path)
    for mod, tag in ((tinfos, "t"), (jinfos, "j")):
        mod.get_sid_info(str(tmp_path / "SID"), str(tmp_path / tag / "SID_train.info"))
        mod.get_eld_info(str(tmp_path / "ELD"), str(tmp_path / tag / "ELD_SonyA7S2.info"))
        mod.get_lrid_info(str(tmp_path / "LRID"),
                          str(tmp_path / tag / "indoor_x5_GT_align_ours.info"),
                          ratio_list=(1, 2))
    for name in ("SID_train.info", "ELD_SonyA7S2.info", "indoor_x5_GT_align_ours.info",
                 "indoor_x5_short.info"):
        with open(tmp_path / "t" / name, "rb") as f, open(tmp_path / "j" / name, "rb") as g:
            _same(pickle.load(f), pickle.load(g))
    with open(tmp_path / "t" / "indoor_x5_short.info", "rb") as f:
        short = pickle.load(f)
    assert sorted(short) == [1, 2] and all(len(v) == 2 for v in short.values())
