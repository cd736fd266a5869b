"""Dark-shading (fixed-pattern noise + black-level-error) models.

Both cameras model the per-pixel dark signal as
``D(iso) = ds_k * iso + ds_b + BLE`` with calibration planes loaded from a
resource directory (reference: data_process/real_datasets.py:215-239 for
SonyA7S2, data_process/phone_datasets.py:297-368 for IMX686). The calibration
``.npy``/``.pkl`` resources are external data; loaders here accept any
directory with the same file layout and cache per-ISO planes as host arrays
(they are subtracted at the data edge, before crops reach the device).
"""

from __future__ import annotations

import os
import pickle

import numpy as np



class SonyDarkShading:
    """SonyA7S2: branch on ISO<=1600 (low/high conversion gain).

    naive: ``D = ds_k*iso + ds_b + BLE[iso]``
    non-naive ('++' command): BLE split into a bias table plus an
    exposure-linear term ``poly(kt)(iso) * exp``.
    """

    def __init__(self, ds_dir: str, naive: bool = True):
        self.ds_dir = ds_dir
        self.naive = naive
        self._cache: dict = {}
        self._planes: dict = {}
        self.blc_mean = None

    def _load_branch(self, branch: str):
        if branch not in self._planes:
            k = np.load(os.path.join(self.ds_dir, f"darkshading{branch}_k.npy"))
            b = np.load(os.path.join(self.ds_dir, f"darkshading{branch}_b.npy"))
            self._planes[branch] = (k, b)
        return self._planes[branch]

    def _load_ble(self):
        if self.blc_mean is None:
            name = "darkshading_BLE.pkl" if self.naive else "BLE_t.pkl"
            with open(os.path.join(self.ds_dir, name), "rb") as f:
                self.blc_mean = pickle.load(f)
        return self.blc_mean

    def __call__(self, iso: int, exp: float = 25.0) -> np.ndarray:
        branch = "_highISO" if iso > 1600 else "_lowISO"
        if iso not in self._cache:
            ds_k, ds_b = self._load_branch(branch)
            blc = self._load_ble()
            ble = blc[iso] if self.naive else blc[iso]["b"]
            self._cache[iso] = ds_k * iso + ds_b + ble
        if self.naive:
            return self._cache[iso]
        kt = np.poly1d(self._load_ble()[f"kt{branch}"])
        return self._cache[iso] + kt(iso) * exp


class PhoneDarkShading:
    """IMX686: exposure-linear plane pair (normal / hot-pixel variants).

    ``D = ds_tk * 30 + ds_tb + blc_rggb(bias(iso, 30ms))`` cached per ISO, then
    per-read adjusted by the mean BLE delta at the actual exposure
    (reference: phone_datasets.py:330-368).
    """

    def __init__(self, ds_dir: str, naive: bool = False):
        self.ds_dir = ds_dir
        self.naive = naive
        self._cache: dict = {}
        self.blc_mean = None
        self.blc_mean_hot = None

    def _load_ble(self):
        if self.blc_mean is None:
            with open(os.path.join(self.ds_dir, "BLE_t.pkl"), "rb") as f:
                self.blc_mean = pickle.load(f)
            with open(os.path.join(self.ds_dir, "BLE_t_hot.pkl"), "rb") as f:
                self.blc_mean_hot = pickle.load(f)

    def get_bias(self, iso=6400, exp=30.0, hot=False) -> np.ndarray:
        self._load_ble()
        table = self.blc_mean_hot if hot else self.blc_mean
        return table[iso][:, 0] * exp + table[iso][:, 1]  # RGGB (4,)

    @staticmethod
    def blc_rggb(raw: np.ndarray, bias: np.ndarray) -> np.ndarray:
        H, W = raw.shape
        rggb = raw.reshape(H // 2, 2, W // 2, 2).transpose(0, 2, 1, 3).reshape(H // 2, W // 2, 4)
        rggb = rggb + bias.reshape(1, 1, 4)
        return rggb.reshape(H // 2, W // 2, 2, 2).transpose(0, 2, 1, 3).reshape(H, W)

    def __call__(self, iso: int = 6400, exp: float = 16.0, hot: bool = False) -> np.ndarray:
        key = (iso, hot)
        if key not in self._cache:
            if self.naive:
                suffix = "-hot" if hot else ""
                self._cache[key] = np.load(
                    os.path.join(self.ds_dir, f"darkshading-iso-{iso}{suffix}.npy")
                )
            else:
                hs = "_hot" if hot else ""
                tk = np.load(os.path.join(self.ds_dir, f"darkshading_tk{hs}.npy"))
                tb = np.load(os.path.join(self.ds_dir, f"darkshading_tb{hs}.npy"))
                plane = tk * 30 + tb
                bias = self.get_bias(iso, 30.0, hot)
                self._cache[key] = self.blc_rggb(plane, bias)
        ds = self._cache[key]
        if self.naive:
            return ds
        bias_delta = self.get_bias(iso, exp, hot) - self.get_bias(iso, 30.0, hot)
        return ds + bias_delta.mean()
