"""Build the package's CUDA sources into plain-C shared libraries.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into
``pnnp_tpu_torch/_build/<name>_<hash>.so`` at first use, keyed by a hash of
the source, and loaded with ``ctypes``. Nothing is built when a module is
imported. A failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda): "
                       "the CUDA kernels are built on a machine with the toolkit")


def library_path(src: Path) -> Path:
    """Where ``src`` builds to: keyed by a hash of the source and the flags."""
    h = hashlib.sha256(Path(src).read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(src).stem}_{h.hexdigest()[:16]}.so"


def build(src: Path) -> Path:
    """Compile ``src`` unless its hashed library exists; return the path."""
    out = library_path(src)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def build_all(sources) -> list:
    """Build several sources at once, one ``nvcc`` process per source."""
    sources = list(sources)
    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        return list(pool.map(build, sources))


def load(src: Path) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``src``, once per process."""
    src = Path(src)
    with _lock:
        if src not in _loaded:
            _loaded[src] = ctypes.CDLL(str(build(src)))
        return _loaded[src]
