"""Synthetic dataset fixtures: tiny on-disk trees in the reference formats.

Used by the test suite and ``chip_smoke.py`` to exercise the full
runfile -> dataset -> loader -> trainer stack without real SID/ELD/LRID
data (reference info format: get_dataset_infos.py).
"""

from __future__ import annotations

import os
import pickle

import numpy as np


def make_sid_fixture(root, n_scenes: int = 3, H: int = 32, W: int = 48):
    """Tiny synthetic SID tree: npy mosaics + reference-format info pickle."""
    root = str(root)
    rng = np.random.default_rng(0)
    infos = []
    os.makedirs(os.path.join(root, "infos"), exist_ok=True)
    for i in range(n_scenes):
        long_path = os.path.join(root, f"{i:05d}_00_10s.npy")
        np.save(long_path, rng.integers(512, 16383, (H, W)).astype(np.float32))
        shorts, ratios = [], []
        for j, r in enumerate([100, 250, 300]):
            sp = os.path.join(root, f"{i:05d}_{j:02d}_short.npy")
            np.save(sp, rng.integers(400, 2000, (H, W)).astype(np.float32))
            shorts.append(sp)
            ratios.append(r)
        infos.append({
            "name": f"{i:05d}_00", "long": long_path, "short": shorts,
            "ratio": ratios, "ISO": 1600, "ExposureTime": 10.0,
            "wb": np.array([2.0, 1.0, 1.5, 1.0], np.float32),
            "ccm": np.eye(3, dtype=np.float32),
        })
    for mode in ("train", "eval", "evaltest"):
        with open(os.path.join(root, "infos", f"SID_{mode}.info"), "wb") as f:
            pickle.dump(
                [dict(e, short=list(e["short"]), ratio=list(e["ratio"]))
                 for e in infos], f)
    return infos


def make_sid_runfile(root, model_name: str = "DRYRUN_Unet", *, nf: int = 4,
                     patch_size: int = 8, H: int = 32, W: int = 48,
                     batch_size: int = 8, stop_epoch: int = 1,
                     noise_code: str = "pr",
                     lr_scheduler: str = "fixed") -> dict:
    """A minimal runfile dict wired to a :func:`make_sid_fixture` tree.

    ``lr_scheduler`` defaults to ``fixed`` (constant 1e-3): the SGDR
    WarmupCosine schedule evaluates to lr=0 at epoch 1 for the degenerate
    ``stop_epoch=1, T=1, step_size=2`` config (period=1 puts epoch 1 at a
    restart boundary inside the zero-warmup window), which made every
    fixture-driven "training" run apply zero updates and its finite-params /
    parity assertions vacuous. Pass ``lr_scheduler="WarmupCosine"`` only for
    tests that exercise the schedule itself.
    """
    root = str(root)
    dst = {
        "root_dir": root, "dataset": "Raw_Dataset", "dstname": "SID",
        "command": "", "camera_type": "SonyA7S2", "noise_code": noise_code,
        "patch_size": patch_size, "H": H, "W": W, "crop_per_image": 2,
        "croptype": "random_crop", "wp": 16383, "bl": 512,
        "ori": False, "clip": 2, "gpu_preprocess": True,
        "infos_dir": os.path.join(root, "infos"),
    }
    return {
        "mode": "train",
        "checkpoint": os.path.join(root, "saved_model"),
        "fast_ckpt": os.path.join(root, "checkpoints"),
        "model_name": model_name,
        "result_dir": os.path.join(root, "images"),
        "num_workers": 0,
        "brightness_correct": True,
        "dst": dst,
        "dst_train": dict(dst, mode="train"),
        "dst_eval": dict(dst, mode="eval", dataset="SID_Dataset"),
        "arch": {"name": "UNetSeeInDark", "in_nc": 4, "out_nc": 4, "nf": nf,
                 "nframes": 1, "res": False},
        "hyper": {"lr_scheduler": lr_scheduler, "learning_rate": 1e-3,
                  "batch_size": batch_size, "last_epoch": 0, "step_size": 2,
                  "stop_epoch": stop_epoch, "T": 1, "save_freq": 1,
                  "plot_freq": 10**6, "best_psnr": 0},
    }
