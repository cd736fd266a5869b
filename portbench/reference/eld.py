"""The ELD evaluation's frame preparation (ELD, Wei et al., CVPR 2020; the
PNNP code's ``ELD_Dataset``), in NumPy, from the raw files on disk.

For the noisy frame: subtract the dark-shading frame of its ISO (the
``darkshading`` command without ``++``: ``k * ISO + b + BLE[ISO]``, with the
low- or high-conversion-gain planes by ISO <= 1600), normalise by the black
and white levels, pack the RGGB mosaic into ``[H/2, W/2, 4]`` as
(R, G1, B, G2), and amplify by the exposure ratio. The ground truth is
packed the same way without dark shading and clipped to [0, 1]. Then the
runfile's clip: mode 2 clips the noisy frame at 1 from above only, any
other true mode to [0, 1]. Done in float64 and handed back as float32.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

HALF_CLIP = 2


def pack(raw: np.ndarray, wp: float, bl: float) -> np.ndarray:
    raw = np.asarray(raw, np.float64)
    out = np.stack((raw[0::2, 0::2], raw[0::2, 1::2], raw[1::2, 1::2], raw[1::2, 0::2]),
                   axis=-1)
    return (out - bl) / (wp - bl)


def dark_frame(ds_dir: str, iso: int) -> np.ndarray:
    branch = "_highISO" if iso > 1600 else "_lowISO"
    k = np.load(os.path.join(ds_dir, f"darkshading{branch}_k.npy")).astype(np.float64)
    b = np.load(os.path.join(ds_dir, f"darkshading{branch}_b.npy")).astype(np.float64)
    with open(os.path.join(ds_dir, "darkshading_BLE.pkl"), "rb") as f:
        ble = pickle.load(f)
    return k * iso + b + float(ble[iso])


def prepare(lr_path: str, hr_path: str, iso: int, ratio: float, ds_dir, wp: float,
            bl: float, clip, ori: bool = False) -> tuple:
    """(lr, hr) ``[H/2, W/2, 4]`` float32 of one ELD pair."""
    lr_raw = np.load(lr_path).astype(np.float64)
    if ds_dir:
        lr_raw = lr_raw - dark_frame(ds_dir, iso)
    lr = pack(lr_raw, wp, bl)
    hr = np.clip(pack(np.load(hr_path), wp, bl), 0.0, 1.0)
    if not ori:
        lr = lr * ratio
    if clip:
        lr = np.minimum(lr, 1.0) if clip == HALF_CLIP else np.clip(lr, 0.0, 1.0)
    return lr.astype(np.float32), hr.astype(np.float32)
