"""Additional datasets: sRGB unprocessing and the indoor + X mixers
(counterpart of ``pnnp_tpu/data/extra.py``; reference
syn_datasets.Img_Dataset and data_process/__init__.py:42-141).

The host only loads and crops the sRGB images; unprocessing and noise run
on the device (:mod:`pnnp_tpu_torch.physics.unprocess`). The crops, their
draws and the mixing are the JAX package's, numpy for numpy.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from pnnp_tpu_torch.data.crops import CropPlanner
from pnnp_tpu_torch.data.datasets import BaseRawDataset
from pnnp_tpu_torch.data.io import dataload


class ImgDataset(BaseRawDataset):
    """sRGB images under ``root_dir`` (png, jpg, bmp, npy; recursive) ->
    ``crop_per_image`` random sRGB crops of twice ``patch_size`` (the mosaic
    halves it), 8-mode augmented (reference: syn_datasets.py:207-283), as
    ``{"srgb": [n, p, p, 3] float, "name", "ratio": ones [n]}``."""

    def __init__(self, args=None, seed: int = 1997):
        super().__init__(args, seed)
        root = self.args.get("root_dir", ".")
        exts = (".png", ".jpg", ".jpeg", ".bmp", ".npy")
        self.files = sorted(
            p for p in glob.glob(os.path.join(root, "**", "*"), recursive=True)
            if os.path.splitext(p)[-1].lower() in exts)
        self.length = len(self.files)

    def __getitem__(self, idx):
        img = np.asarray(dataload(self.files[idx]), np.float32)
        if img.max() > 1.5:
            img = img / 255.0
        if img.ndim == 2:  # grayscale -> 3-channel
            img = np.stack([img] * 3, axis=-1)
        p = self.args["patch_size"] * 2
        H, W = img.shape[:2]
        if H < p or W < p:  # reflect-pad small images up to the patch size
            img = np.pad(img, ((0, max(p - H, 0)), (0, max(p - W, 0)), (0, 0)),
                         mode="reflect")
            H, W = img.shape[:2]
        n = self.args["crop_per_image"]
        crops = np.empty((n, p, p, 3), np.float32)
        for i in range(n):
            h0 = int(self.rng.integers(0, H - p + 1))
            w0 = int(self.rng.integers(0, W - p + 1))
            # syn-family 8-mode aug (rot90 allowed: noise comes later,
            # reference syn_datasets.py:75,101-107)
            crops[i] = CropPlanner.augment(img[h0:h0 + p, w0:w0 + p, :3],
                                           int(self.rng.integers(8)), aug_modes=8)
        return {"srgb": crops, "name": os.path.basename(self.files[idx]),
                "ratio": np.ones(n, np.float32)}


class MixedSubsetDataset:
    """indoor + X mixer: every item of the ``base`` set, then the ``extra``
    set at ``1/extra_rate`` weight, each mixed item concatenating
    ``extra_rate`` consecutive extra items so that all are covered
    (reference Multi_Real/Mix/Sync semantics, data_process/__init__.py:73-87).
    The extra set is built at ``crop_per_image // extra_rate`` crops so a
    mixed item has the base's crop count; the constructor adjusts the extra
    set's ``crop_per_image`` to that, and raises where the base count does
    not divide."""

    def __init__(self, base, extra, extra_rate: int = 4):
        self.base, self.extra, self.extra_rate = base, extra, extra_rate
        ba, ea = getattr(base, "args", None), getattr(extra, "args", None)
        if (isinstance(ba, dict) and isinstance(ea, dict)
                and "crop_per_image" in ba and "crop_per_image" in ea
                and ea["crop_per_image"] * extra_rate != ba["crop_per_image"]):
            if ba["crop_per_image"] % extra_rate != 0:
                raise ValueError(
                    f"base crop_per_image={ba['crop_per_image']} is not divisible by "
                    f"extra_rate={extra_rate}; build the extra dataset with "
                    "crop_per_image = base // extra_rate")
            ea["crop_per_image"] = ba["crop_per_image"] // extra_rate
        self.l1, self.l2 = len(base), len(extra)

    def __len__(self):
        return self.l1 + self.l2 // self.extra_rate

    def __getitem__(self, idx):
        if idx < self.l1:
            return self.base[idx]
        j = (idx - self.l1) * self.extra_rate
        items = [self.extra[(j + k) % self.l2] for k in range(self.extra_rate)]
        out = dict(items[0])
        for key, v in items[0].items():
            if isinstance(v, np.ndarray) and v.ndim >= 1:
                out[key] = np.concatenate([np.atleast_1d(i[key]) for i in items], axis=0)
        return out

    def reseed_worker(self, seed: int, epoch: int, worker: int):
        for d in (self.base, self.extra):
            if hasattr(d, "reseed_worker"):
                d.reseed_worker(seed, epoch, worker)
