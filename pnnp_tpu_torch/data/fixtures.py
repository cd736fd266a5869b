"""Synthetic dataset fixtures: tiny on-disk trees in the reference formats.

Used by the test suite and ``chip_smoke.py`` to exercise the full
runfile -> dataset -> loader -> trainer stack without real SID/ELD/LRID
data (reference info format: get_dataset_infos.py): :func:`make_sid_fixture`
(SonyA7S2, with an optional per-ISO bias library) and
:func:`make_lrid_fixture` (IMX686, with its ISO-6400 bias library).
"""

from __future__ import annotations

import os
import pickle

import numpy as np


def _save_bias(root, iso: int, n: int, H: int, W: int, bl: float, rng):
    """``n`` bias frames near the black level ``bl`` in ``root/<iso>/``."""
    d = os.path.join(root, str(iso))
    os.makedirs(d, exist_ok=True)
    for j in range(n):
        np.save(os.path.join(d, f"black{j}.npy"),
                (bl + rng.normal(0, 2, (H, W))).astype(np.float32))


def make_sid_fixture(root, n_scenes: int = 3, H: int = 32, W: int = 48,
                     bias_isos=(), n_bias: int = 2):
    """Tiny synthetic SID tree: npy mosaics + reference-format info pickle.

    ``bias_isos``: also write a per-ISO bias library, ``n_bias`` frames near
    the black level 512 in ``root/bias/<iso>/`` (the ``bias_dir`` of the
    Mix and SFRN datasets)."""
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
    bias_rng = np.random.default_rng(1)
    for iso in bias_isos:
        _save_bias(os.path.join(root, "bias"), iso, n_bias, H, W, 512.0, bias_rng)
    return infos


def make_lrid_fixture(root, n_scenes: int = 59, H: int = 32, W: int = 48,
                      ratios=(1, 2, 4, 8, 16), n_frames: int = 4,
                      shorts_per_dgain: int = 2, n_bias: int = 3,
                      dstname: str = "indoor_x5"):
    """Synthetic LRID (IMX686) tree in the reference's info formats.

    ``n_scenes`` info entries named ``scene000``... share ``n_frames``
    distinct frames on disk (entry i reads frame i % n_frames): the split
    tables of :mod:`pnnp_tpu_torch.data.phone` name scene ids up to 58, so a
    tree needs 59 entries, not 59 frames. Writes ``infos/<dstname>_GT_align_
    ours.info`` (list of scenes) and ``infos/<dstname>_short.info`` ({dgain:
    [{'data': [paths], 'metadata': [...]} per scene]}), GT mosaics in
    [64, 1023), shorts in [50, 400), and an ISO-6400 bias library of
    ``n_bias`` frames near the black level 64 in ``bias/6400/`` with its
    ``bias-hot/6400/`` twin (``bias_meta.pkl`` gives each a 25 ms exposure).
    Returns the GT infos."""
    root = str(root)
    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(root, "infos"), exist_ok=True)
    frames = []
    for f in range(n_frames):
        gt = os.path.join(root, f"frame{f:03d}_gt.npy")
        np.save(gt, rng.integers(64, 1023, (H, W)).astype(np.float32))
        shorts = {}
        for r in ratios:
            shorts[r] = []
            for j in range(shorts_per_dgain):
                p = os.path.join(root, f"frame{f:03d}_x{r}_{j}.npy")
                np.save(p, rng.integers(50, 400, (H, W)).astype(np.float32))
                shorts[r].append(p)
        frames.append((gt, shorts))
    gt_infos, short_infos = [], {r: [] for r in ratios}
    for s in range(n_scenes):
        gt, shorts = frames[s % n_frames]
        gt_infos.append({
            "name": f"scene{s:03d}", "data": gt, "ISO": 6400, "ExposureTime": 0.03,
            "wb": np.array([2.0, 1.0, 1.8, 1.0], np.float32),
            "ccm": np.eye(3, dtype=np.float32),
        })
        for r in ratios:
            short_infos[r].append({"data": list(shorts[r]),
                                   "metadata": [{"ExposureTime": 0.03 / r}] * len(shorts[r])})
    with open(os.path.join(root, "infos", f"{dstname}_GT_align_ours.info"), "wb") as f:
        pickle.dump(gt_infos, f)
    with open(os.path.join(root, "infos", f"{dstname}_short.info"), "wb") as f:
        pickle.dump(short_infos, f)
    bias_rng = np.random.default_rng(1)
    for lib in ("bias", "bias-hot"):
        _save_bias(os.path.join(root, lib), 6400, n_bias, H, W, 64.0, bias_rng)
        with open(os.path.join(root, lib, "bias_meta.pkl"), "wb") as f:
            pickle.dump({f"black{j}.npy": 25.0 for j in range(n_bias)}, f)
    return gt_infos


def place_eval_split(root, infos, ratio: int = 250):
    """Rewrite ``SID_eval.info`` so that the eval split of ``ratio`` holds
    the fixture's scenes.

    ``SIDDataset`` serves ``infos[40:80]`` at its default ratio 250 (and
    ``[:40]`` / ``[80:]`` at 100 / 300), so a fixture of fewer than 41
    scenes leaves that split empty. The scenes go first in the split; the
    entries before it repeat them."""
    start = {100: 0, 250: 40, 300: 80}[int(ratio)]
    entries = [infos[i % len(infos)] for i in range(start)] + list(infos)
    with open(os.path.join(str(root), "infos", "SID_eval.info"), "wb") as f:
        pickle.dump([dict(e, short=list(e["short"]), ratio=list(e["ratio"]))
                     for e in entries], f)


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
