"""ctypes bindings for the native host loader (native/rawproc.cpp).

Copy of ``pnnp_tpu/data/native.py``: the repo's ``native/librawproc.so``
fuses dark-shading subtraction + black-level normalize + RGGB pack into one
pass over a full frame (:func:`pack_full`), over a plan of crops with their
augmentations (:func:`pack_crops`), or straight into the packed forms'
4x4-superpixel layout (:func:`pack_s2d`). Callers fall back to the NumPy
path (``data.io.pack_raw_np``) when the shared library is unavailable (not
built with ``make -C native``, or built for another host).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(__file__), "..", "..", "native", "librawproc.so")
_lib = None


def _float_ptr(a: Optional[np.ndarray]):
    if a is None:
        return None
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def load_library(build: bool = True):
    """Load (building on demand) the native library; None if unavailable."""
    global _lib
    if _lib is not None:
        return _lib
    path = os.path.abspath(_LIB_PATH)
    if not os.path.exists(path) and build:
        try:
            subprocess.run(
                ["make", "-C", os.path.dirname(path)],
                check=True, capture_output=True, timeout=120,
            )
        except Exception:
            return None
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:  # built for another host: use the NumPy path
        return None
    f32p, i32p, i, f = (ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
                        ctypes.c_int, ctypes.c_float)
    head = [f32p, i, i, f32p, f, f, f32p]  # raw, H, W, darkshading, wp, bl, bias
    signatures = {
        "pnnp_pack_full": head + [i, f32p],
        "pnnp_pack_crops": head + [i32p, i32p, i32p, i, i, i, f, f32p],
        "pnnp_pack_s2d": head + [i, f32p],
    }
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = None
    _lib = lib
    return _lib


def available() -> bool:
    return load_library() is not None


def _require_lib():
    lib = load_library()
    if lib is None:
        raise RuntimeError(
            "native rawproc library unavailable (build it with `make -C "
            "native`); callers should check native.available() and fall "
            "back to the NumPy path (data.io.pack_raw_np)")
    return lib


def pack_full(raw: np.ndarray, wp: float, bl: float, darkshading=None,
              bias=None, clip: bool = False) -> np.ndarray:
    """Native twin of data.io.pack_raw_np (normalize always on)."""
    lib = _require_lib()
    raw = np.ascontiguousarray(raw, np.float32)
    H, W = raw.shape
    out = np.empty((H // 2, W // 2, 4), np.float32)
    ds = None if darkshading is None else np.ascontiguousarray(darkshading, np.float32)
    b = None if bias is None else np.ascontiguousarray(bias, np.float32)
    lib.pnnp_pack_full(
        _float_ptr(raw), ctypes.c_int(H), ctypes.c_int(W), _float_ptr(ds),
        ctypes.c_float(wp), ctypes.c_float(bl), _float_ptr(b),
        ctypes.c_int(1 if clip else 0), _float_ptr(out),
    )
    return out


def pack_crops(raw: np.ndarray, wp: float, bl: float,
               hs: np.ndarray, ws: np.ndarray, aug: np.ndarray, patch: int,
               darkshading=None, bias=None, clip_mode: int = 0,
               ratio_mul: float = 0.0) -> np.ndarray:
    """Fused correct + pack + crop + aug: mosaic ``[H, W]`` -> ``[n, p, p, 4]``
    for the crops at packed offsets ``(hs[i], ws[i])`` with aug codes
    ``aug[i]``. Raises ``ValueError`` on a plan that leaves the packed frame
    (the C worker reads unchecked)."""
    lib = _require_lib()
    raw = np.ascontiguousarray(raw, np.float32)
    H, W = raw.shape
    hs = np.ascontiguousarray(hs, np.int32)
    ws = np.ascontiguousarray(ws, np.int32)
    aug = np.ascontiguousarray(aug, np.int32)
    n = len(hs)
    if n and (hs.min() < 0 or ws.min() < 0
              or hs.max() + patch > H // 2 or ws.max() + patch > W // 2):
        raise ValueError(
            f"crop plan out of bounds for mosaic {H}x{W} (packed "
            f"{H // 2}x{W // 2}, patch {patch})")
    out = np.empty((n, patch, patch, 4), np.float32)
    ds = None if darkshading is None else np.ascontiguousarray(darkshading, np.float32)
    b = None if bias is None else np.ascontiguousarray(bias, np.float32)
    i32p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    lib.pnnp_pack_crops(
        _float_ptr(raw), ctypes.c_int(H), ctypes.c_int(W), _float_ptr(ds),
        ctypes.c_float(wp), ctypes.c_float(bl), _float_ptr(b),
        i32p(hs), i32p(ws), i32p(aug), ctypes.c_int(n), ctypes.c_int(patch),
        ctypes.c_int(clip_mode), ctypes.c_float(ratio_mul), _float_ptr(out),
    )
    return out


def pack_s2d(raw: np.ndarray, wp: float, bl: float, darkshading=None,
             bias=None, clip: bool = False) -> np.ndarray:
    """Fused pack straight into the packed forms' 4x4-superpixel layout:
    mosaic ``[H, W]`` -> NHWC-order ``[H/4, W/4, 16]``, equal to
    ``models.unet_s2d.s2d_np`` of the RGBG packing."""
    lib = _require_lib()
    raw = np.ascontiguousarray(raw, np.float32)
    H, W = raw.shape
    out = np.empty((H // 4, W // 4, 16), np.float32)
    ds = None if darkshading is None else np.ascontiguousarray(darkshading, np.float32)
    b = None if bias is None else np.ascontiguousarray(bias, np.float32)
    lib.pnnp_pack_s2d(
        _float_ptr(raw), ctypes.c_int(H), ctypes.c_int(W), _float_ptr(ds),
        ctypes.c_float(wp), ctypes.c_float(bl), _float_ptr(b),
        ctypes.c_int(1 if clip else 0), _float_ptr(out),
    )
    return out
