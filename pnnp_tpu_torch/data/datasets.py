"""Datasets: index -> NHWC example dicts, host-side (NumPy).

Copy of the SID/ELD part of ``pnnp_tpu/data/datasets.py`` (reference
data_process/{real,syn}_datasets.py): datasets only load/correct/pack/crop
clean (and, for paired sets, real noisy) frames on the host; noise synthesis
belongs to the train step. The paired-augmentation and phone datasets
(Mix/PMNNP/SFRN, IMX686/LRID, Img and the Multi_* mixers) are still to be
ported (ROADMAP 1.11); :func:`build_dataset` names that item for them.

Example dict keys (all NumPy): 'hr' [n,p,p,4], optional 'lr', 'ratio' [n],
'wb' [4], 'ccm' [3,3], 'iso', 'name'.

Info-file format is the reference's pickled list-of-dicts
(reference: get_dataset_infos.py): entries hold 'long' / 'short' (list),
'ratio' (list), 'ISO', 'ExposureTime', 'wb', 'ccm', 'name'.
"""

from __future__ import annotations

import os
import threading
from typing import Optional, Sequence

import numpy as np

from pnnp_tpu_torch.config import command_of
from pnnp_tpu_torch.data.crops import CropPlanner
from pnnp_tpu_torch.data.io import dataload, load_info, pack_raw_np
from pnnp_tpu_torch.physics.calibration import HALF_CLIP, ISO_TABLES
from pnnp_tpu_torch.physics.darkshading import SonyDarkShading
from pnnp_tpu_torch.utils.logging import log


def _clip_pair(lr, hr, clip_mode):
    if clip_mode:
        lb = -np.inf if clip_mode == HALF_CLIP else 0.0
        lr = lr.clip(lb, 1.0)
        hr = hr.clip(0.0, 1.0)
    return lr, hr


class BaseRawDataset:
    """Shared plumbing: info index, shapes, dark shading, crop planner, RNG."""

    DEFAULTS = dict(
        crop_per_image=8, patch_size=512, ori=False, dstname="SID",
        camera_type="SonyA7S2", mode="train", croptype="non-overlapped",
        command="", noise_code="p", wp=16383, bl=512, clip=False,
        H=2848, W=4256, infos_dir="infos", ds_dir=None, gpu_preprocess=True,
        lock_wb=True, params=None,
    )

    def __init__(self, args: Optional[dict] = None, seed: int = 1997):
        self.args = dict(self.DEFAULTS)
        if args:
            self.args.update(args)
        self.command = command_of(self.args)
        self.seed = seed
        self._rng_main = np.random.default_rng(seed)
        self._rng_tls = threading.local()
        self.H, self.W = int(self.args["H"]), int(self.args["W"])
        self.h, self.w, self.c = self.H // 2, self.W // 2, 4
        self.darkshading = None
        self.infos = []
        self.length = 0

    @property
    def rng(self) -> np.random.Generator:
        """Thread-local RNG: worker threads each get an independent,
        deterministically-seeded generator (numpy Generators are not
        thread-safe to share); the main thread keeps the init-seeded one."""
        return getattr(self._rng_tls, "gen", self._rng_main)

    def reseed_worker(self, seed: int, epoch: int, worker: int):
        """Per-(epoch, worker) deterministic reseed — the worker_init_fn
        analog (reference: base_trainer.py:20-25); called by DataLoader
        from each worker thread."""
        self._rng_tls.gen = np.random.default_rng(
            np.random.SeedSequence([seed, epoch, worker]))

    # -- info loading ------------------------------------------------------
    def load_infos(self, name: str):
        path = os.path.join(self.args["infos_dir"], name)
        self.infos = load_info(path)
        self.length = len(self.infos)
        log(f'Loaded "{name}" ({self.length} entries)')

    # -- corrections -------------------------------------------------------
    def init_darkshading(self):
        cmd = self.command
        if "darkshading" in cmd and self.args.get("ds_dir"):
            self.darkshading = SonyDarkShading(
                self.args["ds_dir"], naive="++" not in cmd
            )

    # Sony scenes with hot-pixel darkframes (reference: real_datasets.py:241-254).
    SONY_HOT_IDS = frozenset(
        set(range(72, 178)) | set(range(183, 210))
        | set(range(211, 229)) | {230, 231, 232}
    )

    def sony_hot_check(self, name) -> bool:
        """True when scene id chars [2:5] of ``name`` are in the hot list
        (reference: real_datasets.py:241-254)."""
        try:
            return int(str(name)[2:5]) in self.SONY_HOT_IDS
        except ValueError:
            return False

    def hotfix_lr(self, lr_raw: np.ndarray, name, black_lr: bool = False) -> np.ndarray:
        """Opt-in 'hotfix' command: +2 ADU on hot-scene shorts after dark
        shading. The reference carries this correction commented out at its
        only call site (real_datasets.py:552); off by default for parity."""
        if "hotfix" in self.command and not black_lr and self.sony_hot_check(name):
            lr_raw = lr_raw + 2.0
        return lr_raw

    def correct_lr(self, lr_raw: np.ndarray, iso: int, exp: float) -> np.ndarray:
        """Dark-shading / BLC correction on the mosaic (reference: SID getitem)."""
        if self.darkshading is not None:
            ds = self.darkshading(iso, exp)
            lr_raw = lr_raw - ds
            if "d" in self.args["noise_code"]:
                lr_raw = lr_raw + ds.mean()
            if "darkshading2" in self.command and self.args["mode"] == "train":
                table = ISO_TABLES.get(self.args["camera_type"])
                if table is not None:
                    i = int(np.argmin(np.abs(table["iso"] - iso)))
                    lr_raw = lr_raw + self.rng.standard_normal() * table["biassig"][i]
        return lr_raw

    # -- packing + cropping ------------------------------------------------
    def pack(self, raw, clip):
        """Pack+normalize a mosaic; uses the fused C++ path when built."""
        from pnnp_tpu_torch.data import native

        if native.available():
            return native.pack_full(
                np.asarray(raw, np.float32), float(self.args["wp"]),
                float(self.args["bl"]), clip=clip,
            )
        return pack_raw_np(raw, self.args["wp"], self.args["bl"], norm=True, clip=clip)

    AUG_MODES = 4  # paired data: no rot90 (row noise is directional)

    def make_planner(self):
        return CropPlanner(
            self.h, self.w, self.args["patch_size"], self.args["crop_per_image"],
            self.args["croptype"], rng=self.rng, aug_modes=self.AUG_MODES,
        )

    def __len__(self):
        return self.length


class SIDDataset(BaseRawDataset):
    """Paired long/short SID loader (reference: real_datasets.py:282-394).

    Train: ratio-remapped short pick ('idremap'), dark-shading correction,
    pack, shared-plan crops. Eval: full frames with evaltest ratio splits
    {100, 250, 300}.
    """

    RATIO_SPLITS = (100, 250, 300)

    def __init__(self, args=None, seed: int = 1997):
        super().__init__(args, seed)
        self.load_infos(f'SID_{self.args["mode"]}.info')
        self.init_darkshading()
        if self.args["mode"] == "train":
            cmd = self.command.lower()
            if "limitediso" in cmd:
                self.infos = [i for i in self.infos if 400 <= i["ISO"] <= 6400]
            elif "exactiso" in cmd:
                self.infos = [i for i in self.infos if i["ISO"] in (800, 1600, 3200)]
            self.length = len(self.infos)
            self._build_idremap()
        else:
            self._evaltest_remap()
            self.change_eval_ratio(250)

    # ratio-keyed short-exposure remap (reference: real_datasets.py:66-88)
    def _build_idremap(self):
        self.idremap = []
        for info in self.infos:
            groups = {}
            for i, r in enumerate(info["ratio"]):
                groups.setdefault(r, []).append(i)
            self.idremap.append(list(groups.values()))

    def _pick_lr_id(self, idx):
        if "idremap" in self.command:
            group = self.idremap[idx][self.rng.integers(len(self.idremap[idx]))]
            return int(group[self.rng.integers(len(group))])
        return int(self.rng.integers(len(self.infos[idx]["ratio"])))

    # eval split bookkeeping (reference: real_datasets.py:323-343)
    def _evaltest_remap(self):
        self._infos_all = [self.infos[:40], self.infos[40:80], self.infos[80:]]
        for split in self._infos_all:
            for e in split:
                if not isinstance(e["short"], list):
                    e["short"] = [e["short"]]
                    e["ratio"] = [e["ratio"]]

    def change_eval_ratio(self, ratio: int):
        assert int(ratio) in self.RATIO_SPLITS
        self.infos = self._infos_all[int(ratio) // 100 - 1]
        self.length = len(self.infos)
        log(f"Eval ratio {ratio}")

    def __getitem__(self, idx):
        info = self.infos[idx]
        train = self.args["mode"] == "train"
        lr_id = self._pick_lr_id(idx) if train else 0
        ratio = float(info["ratio"][lr_id])
        iso = int(info["ISO"])
        exp_ms = float(info["ExposureTime"]) * 1000.0

        hr_raw = np.asarray(dataload(info["long"])).reshape(self.H, self.W)
        lr_raw = np.asarray(dataload(info["short"][lr_id])).reshape(self.H, self.W)
        lr_raw = self.correct_lr(lr_raw, iso, exp_ms / ratio)
        lr_raw = self.hotfix_lr(lr_raw, info["name"])

        lr = self.pack(lr_raw, clip=False)
        hr = self.pack(hr_raw, clip=True)

        if train:
            planner = self.make_planner()
            hr = planner.crop(hr)
            lr = planner.crop(lr)
        else:
            hr, lr = hr[None], lr[None]

        if not self.args["ori"]:
            lr = lr * ratio
        lr, hr = _clip_pair(lr, hr, self.args["clip"])
        return {
            "hr": np.ascontiguousarray(hr), "lr": np.ascontiguousarray(lr),
            "ratio": np.full(len(hr), ratio, np.float32), "iso": np.full(len(hr), iso, np.float32),
            "wb": np.asarray(info["wb"], np.float32), "ccm": np.asarray(info["ccm"], np.float32),
            "name": f"{info['name'][:5]}_{info['ratio'] if train else ratio}",
        }


class SynDataset(BaseRawDataset):
    """GT-raw-only dataset for on-device synthesis (Raw/NF_Syn/Proxy families,
    reference: syn_datasets.py:285-463). Optional host-side WB gain aug when
    ``lock_wb`` is False (reference: syn_datasets.py:313-319)."""

    # syn data augments with rot90 too (8 modes, syn_datasets.py:75): the
    # noise is synthesized AFTER the aug, so row banding stays row-aligned
    AUG_MODES = 8

    def __init__(self, args=None, seed: int = 1997):
        super().__init__(args, seed)
        self.load_infos(f'SID_{self.args["mode"]}.info')

    def __getitem__(self, idx):
        info = self.infos[idx]
        hr_raw = np.asarray(dataload(info["long"])).reshape(self.H, self.W)
        hr = self.pack(hr_raw, clip=True)
        if self.args["mode"] == "train":
            planner = self.make_planner()
            hr = planner.crop(hr)
        else:
            hr = hr[None]

        if self.args["lock_wb"] is False and self.rng.integers(2):
            rgb_gain = 1.0 / (0.8 + 0.1 * self.rng.standard_normal())
            if self.args["camera_type"] == "SonyA7S2":
                red = self.rng.uniform(1.75, 2.65)
                blue = 14.65 - 9.63942308 * red + 1.80288462 * red**2
            else:
                red = self.rng.uniform(1.4, 2.3)
                blue = 6.14381188 - 3.65620261 * red + 0.70205967 * red**2
            hr = hr * np.float32(rgb_gain)
            hr[..., 0] *= np.float32(info["wb"][0] / red)
            hr[..., 2] *= np.float32(info["wb"][2] / blue)

        return {
            "hr": np.ascontiguousarray(hr.astype(np.float32)),
            "lr": np.ascontiguousarray(hr.astype(np.float32)),
            "ratio": np.ones(len(hr), np.float32),
            "wb": np.asarray(info["wb"], np.float32),
            "ccm": np.asarray(info["ccm"], np.float32),
            "name": info["name"],
        }


# Raw/NF_Syn/Proxy datasets differ only in which synth stage the trainer
# pairs them with; data-side they are identical GT-raw loaders.
RawDataset = SynDataset
NFSynDataset = SynDataset
ProxyDataset = SynDataset


class ELDDataset(BaseRawDataset):
    """ELD eval: scene x ISO x ratio grid with nearest-GT pairing
    (reference: real_datasets.py:588-720)."""

    GT_IDS = np.array([1, 6, 11, 16])

    def __init__(self, args=None, seed: int = 1997):
        super().__init__(args, seed)
        self.args.setdefault("iso_list", [800, 1600, 3200])
        self.args.setdefault("ratio_list", [100, 200])
        self.load_infos("ELD_SonyA7S2.info")
        self.scenes = self.infos
        self.iso_list = list(self.args["iso_list"])
        self.ratio_list = list(self.args["ratio_list"])
        self.init_darkshading()
        self._fast = False
        self.recheck_length()

    def recheck_length(self):
        self.imgs_per_scene = len(self.iso_list) * len(self.ratio_list)
        self.length = len(self.scenes) * self.imgs_per_scene

    def fast_eval(self, on=True):
        """2-scene last-ratio subset for cheap in-training validation."""
        if on and not self._fast:
            self._backup = (self.scenes, self.ratio_list)
            # reference picks scenes [-3] and [-1]; degrade gracefully for
            # smaller scene sets
            picks = sorted({max(-len(self.scenes), -3), -1})
            self.scenes = [self.scenes[i] for i in picks]
            self.ratio_list = list(self.args["ratio_list"])[-1:]
            self._fast = True
        elif not on and self._fast:
            self.scenes, self.ratio_list = self._backup
            self._fast = False
        self.recheck_length()

    def _raw_ids(self, scene, iso, ratio):
        img_id = next(
            i + 1 for i, e in enumerate(scene) if e["ISO"] == iso and e["ratio"] == ratio
        )
        gt_id = int(self.GT_IDS[np.argmin(np.abs(img_id - self.GT_IDS))])
        return img_id - 1, gt_id - 1

    def __getitem__(self, idx):
        scene_id = idx // self.imgs_per_scene
        rem = idx % self.imgs_per_scene
        iso = self.iso_list[rem // len(self.ratio_list)]
        ratio = self.ratio_list[rem % len(self.ratio_list)]
        scene = self.scenes[scene_id]
        lr_id, hr_id = self._raw_ids(scene, iso, ratio)
        exp_ms = float(scene[hr_id]["ExposureTime"]) * 1000.0

        hr_raw = np.asarray(dataload(scene[hr_id]["data"])).reshape(self.H, self.W)
        lr_raw = np.asarray(dataload(scene[lr_id]["data"])).reshape(self.H, self.W)
        lr_raw = self.correct_lr(lr_raw, iso, exp_ms / ratio)

        lr = self.pack(lr_raw, clip=False)[None]
        hr = self.pack(hr_raw, clip=True)[None]
        if not self.args["ori"]:
            lr = lr * ratio
        lr, hr = _clip_pair(lr, hr, self.args["clip"])
        return {
            "hr": np.ascontiguousarray(hr), "lr": np.ascontiguousarray(lr),
            "ratio": np.full(1, ratio, np.float32), "iso": np.full(1, iso, np.float32),
            "wb": np.asarray(scene[hr_id]["wb"], np.float32),
            "ccm": np.asarray(scene[hr_id]["ccm"], np.float32),
            "name": f"scene-{scene_id + 1:02d}_{scene[lr_id]['name']}",
        }


class TestDataset(BaseRawDataset):
    """GT-only folder loader for trainonly/inference (reference: real_datasets.py:721+)."""

    def __init__(self, args=None, seed: int = 1997):
        super().__init__(args, seed)
        root = self.args.get("root_dir", ".")
        self.files = sorted(
            os.path.join(root, f) for f in os.listdir(root)
            if os.path.splitext(f)[-1].lower() in (".npy", ".arw", ".dng", ".raw")
        )
        self.length = len(self.files)

    def __getitem__(self, idx):
        raw = np.asarray(dataload(self.files[idx])).reshape(self.H, self.W)
        hr = self.pack(raw, clip=True)[None]
        return {
            "hr": hr, "lr": hr.copy(), "ratio": np.ones(1, np.float32),
            "name": os.path.basename(self.files[idx]),
        }


class MultiDataset:
    """Concat-by-name combinator (reference: data_process/__init__.py:9-40)."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self.lengths = [len(d) for d in self.datasets]
        self.length = sum(self.lengths)

    def __len__(self):
        return self.length

    def __getitem__(self, idx):
        for d, n in zip(self.datasets, self.lengths):
            if idx < n:
                return d[idx]
            idx -= n
        raise IndexError

    def reseed_worker(self, seed: int, epoch: int, worker: int):
        for d in self.datasets:
            if hasattr(d, "reseed_worker"):
                d.reseed_worker(seed, epoch, worker)


DATASET_REGISTRY = {
    "SID_Dataset": SIDDataset,
    "Raw_Dataset": RawDataset,
    "NF_Syn_Dataset": NFSynDataset,
    "Proxy_Dataset": ProxyDataset,
    "ELD_Dataset": ELDDataset,
    "TestDataset": TestDataset,
}

# Datasets of the JAX package this port does not carry yet.
_NOT_PORTED = ("Mix_Dataset", "PMNNP_Dataset", "SFRN_Dataset", "Img_Dataset",
               "Real_Dataset", "Multi_Real_Dataset", "Multi_Sync_Dataset",
               "Multi_Mix_Dataset", "Multi_Uproc_Dataset")


def build_dataset(dst: dict, seed: int = 1997):
    """Reference-style name dispatch (trainer_SID.py:48)."""
    name = dst["dataset"]
    if name == "MultiDataset":
        subs = [build_dataset(dict(dst, dataset=n, dstname=d), seed=seed)
                for n, d in zip(dst["datasets"], dst["dstnames"])]
        return MultiDataset(subs)
    if name in _NOT_PORTED or name.startswith("IMX686"):
        raise KeyError(
            f"dataset '{name}' is not ported yet (ROADMAP 1.11: other synth "
            "families and datasets)")
    if name not in DATASET_REGISTRY:
        raise KeyError(f"unknown dataset '{name}'")
    return DATASET_REGISTRY[name](dst, seed=seed)
