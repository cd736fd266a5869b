"""Dataset info index builder (offline tooling).

Numpy copy of ``pnnp_tpu/data/infos.py``, a port of reference
get_dataset_infos.py: walk SID/ELD/LRID trees, read
ISO/exposure (EXIF when available, else filename conventions or sidecar
JSON), read WB/CCM (rawpy when available), compute exposure ratios, and write
the pickled list-of-dicts the datasets consume.

Filename conventions (SID): ``{id}_{seq}_{exposure}s.ARW`` — exposure parses
from the name, so indexes can build without EXIF libraries.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Optional

import numpy as np

from pnnp_tpu_torch.data.io import save_info
from pnnp_tpu_torch.utils.logging import log

# Fixed SonyA7S2 CCM used by the offline index builder (reference:
# get_dataset_infos.py:5 SonyCCM constant).
SONY_CCM = np.array(
    [
        [1.9712269, -0.6789218, -0.29230508],
        [-0.29104823, 1.748401, -0.45735288],
        [0.02051281, -0.5380369, 1.5175241],
    ],
    np.float32,
)
DEFAULT_WB = np.array([2.0, 1.0, 1.6, 1.0], np.float32)


def _meta_for(path: str) -> dict:
    """ISO/ExposureTime/WB/CCM for a raw file: sidecar JSON > exif > defaults.

    Sidecar lookup tries the path's own stem first, then (for decode-cache
    files like ``IMG_1.ARW.npy``) the source raw's stem — tools/decode_cache
    writes ``IMG_1.json`` next to ``IMG_1.ARW``."""
    stem = os.path.splitext(path)[0]
    sidecar = stem + ".json"
    if not os.path.exists(sidecar):
        sidecar = os.path.splitext(stem)[0] + ".json"
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            m = json.load(f)
        return {
            "ISO": int(m.get("ISO", 100)),
            "ExposureTime": float(m.get("ExposureTime", 0.1)),
            "wb": np.asarray(m.get("wb", DEFAULT_WB), np.float32),
            "ccm": np.asarray(m.get("ccm", SONY_CCM), np.float32),
        }
    try:  # optional EXIF path
        import exifread  # type: ignore

        with open(path, "rb") as f:
            tags = exifread.process_file(f, details=False)
        from fractions import Fraction

        # Fraction parses both '1/30' and '0.5'; never eval() metadata
        expo = float(Fraction(str(
            tags.get("EXIF ExposureTime", tags.get("Image ExposureTime")))))
        iso = int(str(tags.get("EXIF ISOSpeedRatings", tags.get("Image ISOSpeedRatings"))))
        return {"ISO": iso, "ExposureTime": float(expo), "wb": DEFAULT_WB, "ccm": SONY_CCM}
    except Exception:
        pass
    m = re.search(r"_(\d+(?:\.\d+)?)s\.", os.path.basename(path))
    expo = float(m.group(1)) if m else 0.1
    return {"ISO": 100, "ExposureTime": expo, "wb": DEFAULT_WB, "ccm": SONY_CCM}


def _dedup_cached(files) -> list:
    """Sorted unique files, preferring a decode cache over its source raw
    (the cache convention is path + '.npy', tools/decode_cache.py) — without
    this, trees holding both raws and caches double-index every frame."""
    files = sorted(set(files))
    have = set(files)
    return [f for f in files
            if f.endswith(".npy") or (f + ".npy") not in have]


def get_sid_info(root_dir: str, out_path: str, mode: str = "train",
                 pair_list: Optional[str] = None) -> list:
    """Build the SID paired index: one entry per long exposure with the list
    of its short exposures and ratios (reference: get_SID_info[_from_txt])."""
    infos = []
    if pair_list and os.path.exists(pair_list):
        pairs: dict = {}
        with open(pair_list) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 2:
                    continue
                short, long_ = parts[0], parts[1]
                pairs.setdefault(long_, []).append(short)
        for long_, shorts in pairs.items():
            lp = os.path.join(root_dir, long_.lstrip("./"))
            meta_l = _meta_for(lp)
            shorts_full = [os.path.join(root_dir, s.lstrip("./")) for s in shorts]
            ratios = [
                meta_l["ExposureTime"] / _meta_for(s)["ExposureTime"] for s in shorts_full
            ]
            infos.append({
                "name": os.path.basename(long_), "long": lp, "short": shorts_full,
                "ratio": ratios, **meta_l,
            })
    else:
        long_dir = os.path.join(root_dir, "long")
        short_dir = os.path.join(root_dir, "short")
        for lp in _dedup_cached(
            p for p in glob.glob(os.path.join(long_dir, "*"))
            if not p.endswith(".json")
        ):
            fid = os.path.basename(lp).split("_")[0]
            shorts = _dedup_cached(
                s for s in glob.glob(os.path.join(short_dir, f"{fid}_*"))
                if not s.endswith(".json")
            )
            if not shorts:
                continue
            meta_l = _meta_for(lp)
            ratios = [meta_l["ExposureTime"] / _meta_for(s)["ExposureTime"] for s in shorts]
            infos.append({
                "name": os.path.basename(lp), "long": lp, "short": shorts,
                "ratio": ratios, **meta_l,
            })
    save_info(infos, out_path)
    log(f"SID[{mode}] index: {len(infos)} entries -> {out_path}")
    return infos


def get_eld_info(root_dir: str, out_path: str, camera: str = "SonyA7S2",
                 suffix: str = ".ARW") -> list:
    """Build the ELD index: scenes x 16 images, ratio vs the scene's first GT
    (reference: get_ELD_info)."""
    scenes = []
    scene_dirs = sorted(
        glob.glob(os.path.join(root_dir, camera, "scene-*")),
        key=lambda p: int(p.rsplit("-", 1)[-1]),
    )
    for sd in scene_dirs:
        files = _dedup_cached(
            glob.glob(os.path.join(sd, f"IMG_*{suffix}"))
            + glob.glob(os.path.join(sd, "IMG_*.npy"))
        )
        entries = []
        metas = [_meta_for(p) for p in files]
        if not metas:
            continue
        base = metas[0]["ISO"] * metas[0]["ExposureTime"]
        for p, m in zip(files, metas):
            ratio = base / (m["ISO"] * m["ExposureTime"])
            entries.append({
                "name": os.path.basename(p), "data": p, "ratio": round(ratio),
                **m,
            })
        scenes.append(entries)
    save_info(scenes, out_path)
    log(f"ELD index: {len(scenes)} scenes -> {out_path}")
    return scenes


def get_lrid_info(root_dir: str, out_path: str, dstname: str = "indoor_x5",
                  ratio_list=(1, 2, 4, 8, 16), gt_type: str = "GT_align_ours") -> list:
    """Build the LRID index pair the phone datasets consume
    (reference: get_IMX686_info_{long,short}): a GT index
    ``{dstname}_{gt_type}.info`` (list of scenes) plus a short index
    ``{dstname}_short.info`` ``{dgain: [ {'data': [...], 'metadata': [...]}
    per scene ]}``. Expected layout:
    ``{root}/{dstname}/{scene}/{GT*|short*_xN}/*.dng[.npy]``."""
    gt_infos = []
    short_infos = {dg: [] for dg in ratio_list}
    scene_dirs = sorted(glob.glob(os.path.join(root_dir, dstname, "*")))
    for sd in scene_dirs:
        gts = _dedup_cached(
            p for p in glob.glob(os.path.join(sd, "GT*", "*")) if not p.endswith(".json")
        )
        if not gts:
            continue
        meta_g = _meta_for(gts[0])
        gt_infos.append({"name": os.path.basename(sd), "data": gts[0], **meta_g})
        for dg in ratio_list:
            shorts = _dedup_cached(
                p for p in glob.glob(os.path.join(sd, f"short*x{dg}", "*"))
                + glob.glob(os.path.join(sd, f"short_x{dg:02d}", "*"))
                if not p.endswith(".json")
            )
            if not shorts:
                log(f"WARNING: {os.path.basename(sd)} has no short*x{dg} "
                    "frames; dataset sampling at this dgain will fail")
            short_infos[dg].append({
                "data": shorts,
                "metadata": [_meta_for(s) for s in shorts],
            })
    save_info(gt_infos, out_path)
    short_path = os.path.join(os.path.dirname(out_path), f"{dstname}_short.info")
    save_info(short_infos, short_path)
    log(f"LRID[{dstname}] index: {len(gt_infos)} scenes -> {out_path} + {short_path}")
    return gt_infos
