"""Tiny versions of the benchmark's cells for the CPU tests: the committed
``BENCHMARK.json`` with every configuration cut to a few pixels, and a
harness root that may carry extra files."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

from portbench import harness

REPO = harness.ROOT.parent
CELLS = ("sony_eval_sweep", "imx686_eval_resident", "imx686_train_proxy", "sony_proxy_nll")
# limits for the tiny sizes (each crop holds 2 x 16 x 16 x 4 values, so the
# synth's variance is read to a few percent)
TINY_LIMITS = {
    "sony_eval_sweep": {"frame_err_ratio": 2.5, "psnr_self_gap_db": 1e-3, "ssim_self_gap": 1e-4},
    "imx686_eval_resident": {"frame_err_ratio": 2.5, "psnr_self_gap_db": 1e-3,
                             "ssim_self_gap": 1e-4},
    "imx686_train_proxy": {"loss_gap": 3e-3, "grad_gap": 0.05, "delta_gap": 0.1,
                           "synth_pixel_var_gap": 0.3},
    "sony_proxy_nll": {"loss_gap": 1e-5, "grad_gap": 1e-3, "delta_gap": 1e-3},
}


def tiny_tree(tmp: Path) -> tuple:
    """(BENCHMARK.json, harness root) of the tiny cells under ``tmp``."""
    root = tmp / "portbench"
    shutil.copytree(harness.ROOT, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, lim in TINY_LIMITS.items():
        (root / "limits" / f"{name}.json").write_text(json.dumps(lim))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        cfg["arch"]["nf"] = 4
        cfg["arch_proxy"]["d"] = 16
        for k in ("dst", "dst_train", "dst_eval"):
            cfg[k].update(H=64, W=96, patch_size=16, crop_per_image=2)
        (tmp / c["file"]).parent.mkdir(parents=True, exist_ok=True)
        (tmp / c["file"]).write_text(json.dumps(cfg))
    bench_file = tmp / "BENCHMARK.json"
    bench_file.write_text(json.dumps(bench))
    return bench_file, root


def run(bench_file: Path, root: Path, name: str, seed: int = 2**31 + 77, control=False):
    cell = harness.Cell(bench_file, name, root=root)
    return harness.run(cell, seed, 0.3, False, "cpu", time.perf_counter(), control=control)
