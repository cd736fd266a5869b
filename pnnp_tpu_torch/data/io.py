"""Host-edge raw I/O (NumPy): decode, pack, info files.

The reference leans on rawpy/LibRaw at __getitem__ time (reference:
utils/utils.py:244-255). Here the host edge prefers pre-decoded ``.npy``
mosaics (offline cache; see tools/decode_cache.py) and falls back to rawpy
when present; packed outputs are channel-last RGBG for the device path.
Info files are the reference's pickled list-of-dicts (reference:
get_dataset_infos.py): :func:`load_info` reads them, :func:`save_info`
writes them (the index builders are in :mod:`pnnp_tpu_torch.data.infos`).
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Optional

import numpy as np

try:  # optional — not present in this image
    import rawpy  # type: ignore

    HAS_RAWPY = True
except ImportError:
    HAS_RAWPY = False


def dataload(path: str) -> np.ndarray:
    """Suffix-dispatched raw loader (reference: utils/utils.py:244-255)."""
    suffix = os.path.splitext(path)[-1].lower()
    if suffix == ".npy":
        return np.load(path)
    if suffix in (".arw", ".dng", ".nef", ".cr2", ".raw"):
        if not HAS_RAWPY:
            # offline cache convention: same path + '.npy'
            npy = path + ".npy"
            if os.path.exists(npy):
                return np.load(npy)
            raise RuntimeError(
                f"rawpy unavailable and no .npy cache for {path}; "
                "run tools/decode_cache.py on a machine with LibRaw"
            )
        with rawpy.imread(path) as raw:
            return raw.raw_image_visible.copy()
    if suffix in (".png", ".jpg", ".jpeg", ".bmp"):
        from PIL import Image

        return np.asarray(Image.open(path))
    raise ValueError(f"unsupported suffix: {path}")


def pack_raw_np(raw: np.ndarray, wp=1023.0, bl=64.0, norm=True, clip=False,
                bias: Optional[np.ndarray] = None) -> np.ndarray:
    """NumPy twin of ops.bayer.raw2bayer: mosaic [H, W] -> RGBG [h, w, 4]."""
    raw = raw.astype(np.float32)
    H, W = raw.shape
    out = np.stack(
        (raw[0:H:2, 0:W:2], raw[0:H:2, 1:W:2], raw[1:H:2, 1:W:2], raw[1:H:2, 0:W:2]),
        axis=-1,
    )
    if norm:
        b = np.zeros(4, np.float32) if bias is None else np.asarray(bias, np.float32)
        blc = b + bl
        out = (out - blc) / (wp - blc)
    if clip:
        out = np.clip(out, 0.0, 1.0)
    return np.ascontiguousarray(out, np.float32)


def load_info(path: str):
    """Load a dataset info index (.info pickle or .json)."""
    if path.endswith(".json"):
        with open(path, "r") as f:
            return json.load(f)
    with open(path, "rb") as f:
        return pickle.load(f)


def save_info(infos, path: str):
    """Write a dataset info index (.info pickle, or .json by suffix)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if path.endswith(".json"):
        def clean(o):
            if isinstance(o, np.ndarray):
                return o.tolist()
            if isinstance(o, (np.floating, np.integer)):
                return o.item()
            raise TypeError(type(o))

        with open(path, "w") as f:
            json.dump(infos, f, default=clean)
    else:
        with open(path, "wb") as f:
            pickle.dump(infos, f)
