"""ctypes bindings for the native host loader (native/rawproc.cpp).

Copy of the full-frame part of ``pnnp_tpu/data/native.py``: the repo's
``native/librawproc.so`` fuses black-level normalize + RGGB pack into one
pass. Callers fall back to the NumPy path (``data.io.pack_raw_np``) when the
shared library is unavailable (not built with ``make -C native``, or built
for another host). The fused crop and s2d packers arrive with the training
and packed-serving slices (ROADMAP 1.4, 1.10).
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
    lib.pnnp_pack_full.restype = None
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
