"""LRID / IMX686 phone datasets (reference: data_process/phone_datasets.py).

Numpy copy of ``pnnp_tpu/data/phone.py``, as the SonyA7S2 datasets: the host
loads/corrects/packs/crops frames; noise synthesis (P-G, SNA with the
bias-paste HighBitRecovery, proxy) runs in the train step on the device.

Info format (reference get_IMX686_info_{long,short}):
  * ``{dstname}_{GT_type}.info`` — list of {'data', 'name', 'wb', 'ccm', ...}
  * ``{dstname}_short.info``     — {dgain: [ {'data': [paths], 'metadata':
      [{'ExposureTime': ...}, ...]} per scene ]}
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np

from pnnp_tpu_torch.data.datasets import BaseRawDataset, _clip_pair
from pnnp_tpu_torch.data.io import dataload, load_info
from pnnp_tpu_torch.physics.darkshading import PhoneDarkShading
from pnnp_tpu_torch.utils.logging import log

# Scene split tables (reference: phone_datasets.py:236-274).
EVAL_IDS = {
    "indoor_x5": [4, 14, 25, 41, 44, 51, 52, 53, 58],
    "indoor_x3": [],
    "outdoor_x5": [1, 2, 5],
    "outdoor_x3": [9, 21, 22, 32, 44, 51],
}
FAST_EVAL_IDS = {
    "indoor_x5": [44, 51, 53],
    "indoor_x3": [0],
    "outdoor_x5": [1, 2, 5],
    "outdoor_x3": [44, 51],
}
# Hot-pixel scene lists (reference: phone_datasets.py:369-381).
HOT_IDS = {
    "indoor_x5": [6, 15, 33, 35, 39, 46, 37, 59],
    "indoor_x3": [1, 2, 4, 5, 6, 10, 12, 13, 14, 15, 16, 17, 18, 19],
    "outdoor_x3": [0, 1, 2, 3, 4, 5, 7, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
                   22, 26, 30, 51, 52, 54, 55, 56],
    "outdoor_x5": [0, 1, 2, 3, 4, 5, 6],
}
IMX686_OLD_BIAS = np.array([-0.08113494, -0.04906388, -1.2048522, -0.9408157], np.float32)


class PhoneBaseDataset(BaseRawDataset):
    DEFAULTS = dict(
        BaseRawDataset.DEFAULTS,
        crop_per_image=12, patch_size=512, ori=True, dstname="indoor_x5",
        camera_type="IMX686", GT_type="GT_align_ours", command="alldg",
        H=3472, W=4624, wp=1023, bl=64, ratio=16, ratio_list=(1, 2, 4, 8, 16),
        noise_code="p",
    )

    def __init__(self, args=None, seed: int = 1997):
        super().__init__(args, seed)
        self.iso = 6400
        # user-recalibrated per-ISO noise params (reference
        # phone_datasets.py:99-112): {ds_dir}/noiseparam-iso-{iso}.h5 when
        # present; otherwise synth falls back to the baked published tables
        self.noiseparam = {}
        if self.args["mode"] == "train":
            from pnnp_tpu_torch.physics.calibration import load_noiseparam_h5

            np_h5 = load_noiseparam_h5(self.args.get("ds_dir"), self.iso)
            if np_h5 is not None:
                self.noiseparam[self.iso] = np_h5
                log(f"Loaded noiseparam-iso-{self.iso}.h5 calibration "
                    f"from {self.args['ds_dir']}")
        self._load_phone_infos()
        self._data_split()
        self.change_ratio_list(list(self.args["ratio_list"]))
        self._apply_small()
        self.length = len(self.id_remap)
        if "alldg" in self.command and self.args["mode"] == "train":
            self.lens_extend(True)
        self._init_phone_darkshading()

    # -- infos -------------------------------------------------------------
    def _load_phone_infos(self):
        d = self.args["infos_dir"]
        gt = load_info(os.path.join(d, f'{self.args["dstname"]}_{self.args["GT_type"]}.info'))
        short = load_info(os.path.join(d, f'{self.args["dstname"]}_short.info'))
        self.infos = []
        for i, e in enumerate(gt):
            entry = dict(e)
            entry["hr"] = entry.pop("data")
            entry["lr"] = {dg: short[dg][i] for dg in short}
            self.infos.append(entry)
        log(f'Loaded {self.args["dstname"]} ({len(self.infos)} scenes)')

    # -- splits / ratio ladder ----------------------------------------------
    def _data_split(self, eval_ids: Optional[list] = None):
        if eval_ids is None:
            eval_ids = EVAL_IDS.get(self.args["dstname"], [])
        all_ids = list(range(len(self.infos)))
        if self.args["mode"] == "train":
            self.id_remap = [i for i in all_ids if i not in eval_ids]
        else:
            self.id_remap = list(eval_ids)

    def _apply_small(self):
        cmd = self.command
        if "small" in cmd and self.args["mode"] == "train":
            div = 0.5 if "small2" in cmd else 0.75 if "small3" in cmd else 0.25
            self.id_remap = self.id_remap[: int(len(self.id_remap) * div)]

    def fast_eval(self, on=True):
        self._data_split(FAST_EVAL_IDS.get(self.args["dstname"]) if on else None)
        self.change_ratio_list(self.ratio_list)
        self.length = len(self.id_remap)

    def lens_extend(self, on=True):
        self.length = len(self.id_remap) * (len(self.ratio_list) if on else 1)

    def change_ratio_list(self, ratio_list):
        self.ratio_list = list(ratio_list)
        self.dgain = self.ratio_list[-1]

    def change_eval_ratio(self, ratio):
        assert int(ratio) in self.ratio_list
        self.dgain = int(ratio)
        log(f"Eval ratio {ratio}")

    def recheck_length(self):
        self.length = len(self.id_remap)

    # -- corrections ---------------------------------------------------------
    def _init_phone_darkshading(self):
        self.phone_ds = None
        cmd = self.command
        if ("darkshading" in cmd or "blc" in cmd) and self.args.get("ds_dir"):
            try:
                ds = PhoneDarkShading(self.args["ds_dir"], naive="++" not in cmd)
                ds(self.iso, 30.0)  # probe: the loads are lazy, so a missing
                # calibration file would otherwise crash mid-epoch in a
                # loader worker instead of falling back here
                self.phone_ds = ds
            except Exception as e:
                log(f"dark shading unavailable: {e}")

    def hot_check(self, scene_idx: int) -> bool:
        # scene_idx comes from the name's trailing digits, like the
        # reference's int(name[-3:]) at every call site
        # (phone_datasets.py:493/580/701/962)
        return scene_idx in HOT_IDS.get(self.args["dstname"], [])

    def _scan_bias(self, root):
        d = os.path.join(root, str(self.iso))
        if not os.path.isdir(d):
            return [], []
        files = [os.path.join(d, f) for f in sorted(os.listdir(d))
                 if not f.endswith((".pkl", ".info"))]
        exps = [30.0] * len(files)
        meta = os.path.join(root, "bias_meta.pkl")
        if os.path.exists(meta):
            with open(meta, "rb") as f:
                m = pickle.load(f)
            exps = [float(m.get(os.path.basename(p), 30.0)) for p in files]
        return files, exps

    def _preload_bias(self, paths):
        """'buffer' command: load the bias library into memory once
        (reference phone_datasets.py:320-327)."""
        self._bias_buf = {}
        if "buffer" in self.command:
            for path in paths:
                self._bias_buf[path] = np.asarray(dataload(path))

    def _load_black(self, path):
        if path in self._bias_buf:
            return self._bias_buf[path]
        return np.asarray(dataload(path))

    @staticmethod
    def blc_rggb(raw: np.ndarray, bias: np.ndarray) -> np.ndarray:
        return PhoneDarkShading.blc_rggb(raw, bias)

    def correct_phone_lr(self, lr_raw, exp_ms, hot, dgain, hr_raw=None, jitter=True):
        cmd = self.command
        if self.phone_ds is None:
            return lr_raw, hr_raw
        if "darkshading" in cmd:
            lr_raw = lr_raw - self.phone_ds(self.iso, exp_ms, hot=hot)
            # no bias jitter on pasted black frames (phone_datasets.py:607-610)
            if "darkshading2" in cmd and self.args["mode"] == "train" and jitter:
                lr_raw = lr_raw + self.rng.standard_normal() * 0.1
        if "blc" in cmd:
            bias = self.phone_ds.get_bias(self.iso, exp_ms, hot)
            lr_raw = self.blc_rggb(lr_raw, -bias)
            if "blc2" in cmd and self.args["mode"] == "train" and hr_raw is not None:
                bias_hr = self.phone_ds.get_bias(100, exp_ms * 64 * dgain, hot)
                hr_raw = self.blc_rggb(hr_raw, -bias_hr)
            if "nblc" in cmd:
                lr_raw = self.blc_rggb(lr_raw, bias + IMX686_OLD_BIAS)
        return lr_raw, hr_raw

    # -- dgain strategy ------------------------------------------------------
    def pick_dgain(self, idx):
        if self.args["mode"] == "train":
            if "alldg" in self.command:
                return self.ratio_list[idx // len(self.id_remap)]
            if "rdg" in self.command:
                return self.ratio_list[self.rng.integers(len(self.ratio_list))]
        return self.dgain


class IMX686Dataset(PhoneBaseDataset):
    """Paired GT/short LRID loader (reference: phone_datasets.py:441-533)."""

    def __getitem__(self, idx):
        dgain = self.pick_dgain(idx)
        idr = self.id_remap[idx % len(self.id_remap)]
        info = self.infos[idr]
        train = self.args["mode"] == "train"

        hr_raw = np.asarray(dataload(info["hr"])).reshape(self.H, self.W)
        lr_entry = info["lr"][dgain]
        n_lr = len(lr_entry["data"])
        lr_id = int(self.rng.integers(n_lr)) if train else 0
        lr_raw = np.asarray(dataload(lr_entry["data"][lr_id])).reshape(self.H, self.W)
        exp_ms = float(lr_entry["metadata"][lr_id]["ExposureTime"]) * 1000.0

        hot = self.hot_check(self._scene_idx(info))
        lr_raw, hr_new = self.correct_phone_lr(lr_raw, exp_ms, hot, dgain, hr_raw)
        if hr_new is not None:
            hr_raw = hr_new

        lr = self.pack(lr_raw, clip=False)
        hr = self.pack(hr_raw, clip=True)
        if train:
            planner = self.make_planner()
            hr = planner.crop(hr)
            lr = planner.crop(lr)
        else:
            hr, lr = hr[None], lr[None]
        if not self.args["ori"]:
            lr = lr * dgain
        lr, hr = _clip_pair(lr, hr, self.args["clip"])
        return {
            "hr": np.ascontiguousarray(hr), "lr": np.ascontiguousarray(lr),
            "ratio": np.full(len(hr), dgain, np.float32),
            "iso": np.full(len(hr), self.iso, np.float32),
            "wb": np.asarray(info["wb"], np.float32),
            "ccm": np.asarray(info["ccm"], np.float32),
            "name": f"{info['name']}_x{dgain:02d}",
        }

    @staticmethod
    def _scene_idx(info):
        try:
            return int(str(info["name"])[-3:])
        except ValueError:
            return -1


# Real_Dataset in the reference is the generic paired loader (phone_datasets.py:383)
LRIDRealDataset = IMX686Dataset


class IMX686RawDataset(PhoneBaseDataset):
    """GT-only loader for on-device P-G synthesis (reference: phone_datasets.py:744)."""

    def __getitem__(self, idx):
        idr = self.id_remap[idx % len(self.id_remap)]
        info = self.infos[idr]
        hr_raw = np.asarray(dataload(info["hr"])).reshape(self.H, self.W)
        hr = self.pack(hr_raw, clip=True)
        if self.args["mode"] == "train":
            planner = self.make_planner()
            hr = planner.crop(hr)
        else:
            hr = hr[None]
        return {
            "hr": np.ascontiguousarray(hr), "lr": np.ascontiguousarray(hr.copy()),
            "ratio": np.ones(len(hr), np.float32),
            "iso": np.full(len(hr), self.iso, np.float32),
            "wb": np.asarray(info["wb"], np.float32),
            "ccm": np.asarray(info["ccm"], np.float32),
            "name": info["name"],
        }


IMX686NFSynDataset = IMX686RawDataset
IMX686ProxyDataset = IMX686RawDataset


class IMX686MixDataset(IMX686Dataset):
    """PMN-style SNA pairing for LRID (reference: phone_datasets.py:534-665).

    Host side is the paired loader; with ``HB`` in command, 1-in-5 training
    items instead paste a *real bias frame* as lr (``black_lr=1`` crops,
    dgain pinned to 20): the LUT HighBitRecovery remap and the SNA signal
    swap then run on the device in the synth stage
    (:func:`pnnp_tpu_torch.train.steps.make_mix_synth`), one batch mixing
    both kinds of crop. Bias library layout: ``bias_dir/6400/*`` (+ ``bias_dir-hot``
    for hot scenes), optional ``bias_meta.pkl`` mapping filename ->
    ExposureTime in ms (default 30, the reference's record_bias_frames
    capture exposure, real_datasets.py:255-280)."""

    def __init__(self, args=None, seed: int = 1997):
        super().__init__(args, seed)
        self.blacks, self.black_exps = [], []
        self.blacks_hot, self.black_exps_hot = [], []
        bias_dir = self.args.get("bias_dir")
        if "HB" in self.command and bias_dir:
            bias_dir = bias_dir.rstrip(os.sep)  # '-hot' suffixes the dir name
            self.blacks, self.black_exps = self._scan_bias(bias_dir)
            self.blacks_hot, self.black_exps_hot = self._scan_bias(bias_dir + "-hot")
            if self.blacks and not self.blacks_hot and HOT_IDS.get(
                    self.args["dstname"]):
                log(f"WARNING: no hot bias library at {bias_dir}-hot; hot "
                    "scenes will never receive bias pastes")
        self._preload_bias(list(self.blacks) + list(self.blacks_hot))

    def __getitem__(self, idx):
        train = self.args["mode"] == "train"
        idr = self.id_remap[idx % len(self.id_remap)]
        info = self.infos[idr]
        hot = self.hot_check(self._scene_idx(info))
        blacks = self.blacks_hot if hot else self.blacks
        use_black = bool(
            train and blacks and "HB" in self.command
            and self.rng.integers(5) == 0
        )
        if not use_black:
            data = super().__getitem__(idx)
            data["black_lr"] = np.zeros(len(data["hr"]), np.float32)
            return data

        # --- pasted bias frame path (phone_datasets.py:586-640) -------------
        exps = self.black_exps_hot if hot else self.black_exps
        dgain = 20
        n_pick = min(10, len(blacks)) if "lr10" in self.command else len(blacks)
        lr_id = int(self.rng.integers(n_pick))
        lr_raw = self._load_black(blacks[lr_id]).reshape(self.H, self.W)
        exp_ms = float(exps[lr_id])
        hr_raw = np.asarray(dataload(info["hr"])).reshape(self.H, self.W)
        lr_raw, hr_new = self.correct_phone_lr(lr_raw, exp_ms, hot, dgain,
                                               hr_raw, jitter=False)
        if hr_new is not None:
            hr_raw = hr_new

        lr = self.pack(lr_raw, clip=False)
        hr = self.pack(hr_raw, clip=True)
        planner = self.make_planner()
        hr = planner.crop(hr)
        planner.replan()  # bias crops are position-independent of the GT
        lr = planner.crop(lr)
        if not self.args["ori"]:
            lr = lr * dgain
        lr, hr = _clip_pair(lr, hr, self.args["clip"])
        return {
            "hr": np.ascontiguousarray(hr), "lr": np.ascontiguousarray(lr),
            "ratio": np.full(len(hr), dgain, np.float32),
            "iso": np.full(len(hr), self.iso, np.float32),
            "wb": np.asarray(info["wb"], np.float32),
            "ccm": np.asarray(info["ccm"], np.float32),
            "name": f"{info['name']}_x{dgain:02d}",
            "black_lr": np.ones(len(hr), np.float32),
        }


class IMX686SFRNRawDataset(PhoneBaseDataset):
    """GT + real bias-frame crops for SFRN-style training
    (reference: phone_datasets.py:928+)."""

    def __init__(self, args=None, seed: int = 1997):
        super().__init__(args, seed)
        bias_dir = self.args.get("bias_dir")
        self.blacks = []
        if bias_dir:
            self.blacks, _ = self._scan_bias(bias_dir.rstrip(os.sep))
        self._preload_bias(self.blacks)

    def __getitem__(self, idx):
        idr = self.id_remap[idx % len(self.id_remap)]
        info = self.infos[idr]
        hr_raw = np.asarray(dataload(info["hr"])).reshape(self.H, self.W)
        hr = self.pack(hr_raw, clip=True)
        if self.blacks:
            b_raw = self._load_black(self.blacks[int(self.rng.integers(len(self.blacks)))])
            black = self.pack(b_raw.reshape(self.H, self.W), clip=False)
        else:
            black = np.zeros_like(hr)
        planner = self.make_planner()
        hr_c = planner.crop(hr)
        planner.replan()
        black_c = planner.crop(black)
        return {
            "hr": np.ascontiguousarray(hr_c), "lr": np.ascontiguousarray(black_c),
            "ratio": np.ones(len(hr_c), np.float32),
            "iso": np.full(len(hr_c), self.iso, np.float32),
            "wb": np.asarray(info["wb"], np.float32),
            "ccm": np.asarray(info["ccm"], np.float32),
            "name": info["name"],
        }
