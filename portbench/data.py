"""The benchmark's inputs, made from the seed: weights, scenes, raw trees
and noise. Both the port and the reference receive exactly these.

Weights are drawn on the device in one call per network and split into
leaves. Scenes are smooth random fields (a coarse uniform grid upsampled
bilinearly, per-channel gains, a fine texture) in [0, 1]. Raw files are
uint16 mosaics, as the PNNP decode cache writes them.
"""

from __future__ import annotations

import json
import math
import os
import pickle

import numpy as np
import torch
import torch.nn.functional as F

LEAKY_GAIN = math.sqrt(2.0 / (1.0 + 0.2**2))


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` for one named use of the seed."""
    mixed = (int(seed) * 1_000_003 + 7919 * stream) % (2**63 - 1)
    return torch.Generator(device=device).manual_seed(mixed)


def draw_leaves(shapes: dict, stds: dict, gen: torch.Generator, device) -> dict:
    """Normal leaves of the given shapes and standard deviations, from one
    draw on the device."""
    sizes = [math.prod(s) for s in shapes.values()]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, a = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        out[name] = (flat[a:a + n] * stds[name]).reshape(shape).clone()
        a += n
    return out


def unet_weights(shapes: dict, gen: torch.Generator, device) -> dict:
    """He-normal (fan-in) kernels for the layers followed by LeakyReLU(0.2),
    fan-in normal for the upsampling and head layers, N(0, 0.01) biases: a
    random network whose output keeps the input's scale (the package's own
    N(0, 0.02) init gives an output of nearly zero at this depth)."""
    stds = {}
    for name, shape in shapes.items():
        if name.endswith(".bias"):
            stds[name] = 0.01
            continue
        up = name.startswith("upv")
        fan_in = shape[0] if up else math.prod(shape[1:])
        linear = up or name.startswith("conv10")
        stds[name] = (1.0 if linear else LEAKY_GAIN) / math.sqrt(fan_in)
    return draw_leaves(shapes, stds, gen, device)


def proxy_weights(shapes: dict, gen: torch.Generator, device) -> dict:
    """LeCun-normal (fan-in) dense kernels and N(0, 0.01) biases."""
    stds = {n: (0.01 if n.endswith(".bias") else 1.0 / math.sqrt(s[1]))
            for n, s in shapes.items()}
    return draw_leaves(shapes, stds, gen, device)


def scenes(n: int, c: int, h: int, w: int, gen: torch.Generator, device,
           cell: int = 32) -> torch.Tensor:
    """``n`` smooth scenes ``[n, c, h, w]`` in [0, 1]."""
    coarse = torch.rand((n, 1, -(-h // cell) + 1, -(-w // cell) + 1), generator=gen,
                        device=device)
    base = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
    gains = 0.5 + 0.5 * torch.rand((n, c, 1, 1), generator=gen, device=device)
    tex = 0.05 * torch.rand((n, c, h, w), generator=gen, device=device)
    return torch.clamp(base * gains + tex, 0.0, 1.0)


def noisy(clean: torch.Tensor, ratio: float, gain: float, read: float, span: float,
          gen: torch.Generator) -> torch.Tensor:
    """A short exposure of ``clean`` (in [0, 1] of ``span`` ADU) at
    ``1 / ratio`` of its light, in ADU: Gaussian shot noise of system gain
    ``gain`` and read noise ``read``, not yet amplified."""
    sig = clean * span / ratio
    std = torch.sqrt(gain * sig + read**2)
    return sig + std * torch.randn(clean.shape, generator=gen, device=clean.device)


def dark_noise(n: int, c: int, h: int, w: int, sig_read: float, sig_row: float,
               span: float, gen: torch.Generator, device) -> torch.Tensor:
    """Dark frames of the ``pgrq`` law (no light, so no shot noise): Gaussian
    read noise, one Gaussian offset per (row, channel), quantized to whole
    ADU, over ``span``."""
    read = sig_read * torch.randn((n, c, h, w), generator=gen, device=device)
    row = sig_row * torch.randn((n, c, h, 1), generator=gen, device=device)
    return torch.round(read + row) / span


# ---------------------------------------------------------------------------
# the ELD tree


def _save_synced(path: str, array: np.ndarray) -> None:
    """``np.save``, then the file forced to disk: the tree's write-back
    belongs to set-up, not to the measured window."""
    with open(path, "wb") as f:
        np.save(f, array)
        f.flush()
        os.fsync(f.fileno())


ELD_GT_IDS = (1, 6, 11, 16)
ELD_SLOTS = (2, 3, 4, 5, 7, 8)


def eld_tree(root: str, n_scenes: int, H: int, W: int, iso_list, ratio_list, wp: float,
             bl: float, gen: torch.Generator, device, gain_per_iso: float,
             read_per_iso: float) -> dict:
    """An ELD tree in the ``ELD_SonyA7S2.info`` layout under ``root``: per
    scene 16 ids, the ground truth at ids 1, 6, 11, 16 (ISO 100, 1 s) and the
    ISO x ratio grid at ids 2-5, 7, 8; only the frames a scene uses are
    written, the other ids are hard links to them. A dark-shading resource
    (``darkshading_{low,high}ISO_{k,b}.npy`` and ``darkshading_BLE.pkl``)
    is written too and added into every noisy frame. Returns the paths."""
    span = wp - bl
    grid = [(iso, r) for iso in iso_list for r in ratio_list]
    if len(grid) > len(ELD_SLOTS):
        raise ValueError(f"{len(grid)} ISO x ratio pairs, the layout holds {len(ELD_SLOTS)}")
    ds_dir = os.path.join(root, "resources")
    info_dir = os.path.join(root, "infos")
    os.makedirs(ds_dir, exist_ok=True)
    os.makedirs(info_dir, exist_ok=True)
    ds_k = (1e-4 * torch.randn((H, W), generator=gen, device=device)).cpu().numpy()
    ds_b = (torch.randn((H, W), generator=gen, device=device)).cpu().numpy()
    ble = {int(iso): float(v) for iso, v in
           zip(iso_list, torch.rand(len(iso_list), generator=gen, device=device).tolist())}
    for name, plane in (("k", ds_k), ("b", ds_b)):  # one plane for both gains
        low = os.path.join(ds_dir, f"darkshading_lowISO_{name}.npy")
        _save_synced(low, plane.astype(np.float32))
        os.link(low, os.path.join(ds_dir, f"darkshading_highISO_{name}.npy"))
    with open(os.path.join(ds_dir, "darkshading_BLE.pkl"), "wb") as f:
        pickle.dump(ble, f)
    ds_k_t = torch.from_numpy(ds_k).to(device)
    ds_b_t = torch.from_numpy(ds_b).to(device)

    def save(path, adu):
        raw = torch.clamp(torch.round(adu), 0, 65535).to(torch.int32).cpu().numpy()
        _save_synced(path, raw.astype(np.uint16))

    infos = []
    for s in range(1, n_scenes + 1):
        sd = os.path.join(root, "SonyA7S2", f"scene-{s}")
        os.makedirs(sd, exist_ok=True)
        clean = scenes(1, 1, H, W, gen, device)[0, 0]
        entries = []
        for img_id in range(1, 17):
            path = os.path.join(sd, f"IMG_{img_id:04d}.npy")
            if img_id in ELD_SLOTS[:len(grid)]:
                iso, ratio = grid[ELD_SLOTS.index(img_id)]
                exp = 100.0 / (iso * ratio)
                sig = noisy(clean, ratio, gain_per_iso * iso, read_per_iso * math.sqrt(iso),
                            span, gen)
                save(path, bl + sig + ds_k_t * iso + ds_b_t + ble[int(iso)])
            elif img_id in ELD_GT_IDS[:2]:
                iso, ratio, exp = 100, 1, 1.0
                save(path, bl + clean * span)
            else:
                iso, ratio, exp = 50, 1, 1.0  # an id no pair reads
                os.link(os.path.join(sd, "IMG_0001.npy"), path)
            meta = {"ISO": iso, "ExposureTime": exp}
            with open(os.path.splitext(path)[0] + ".json", "w") as f:
                json.dump(meta, f)
            entries.append({"name": os.path.basename(path), "data": path,
                            "ratio": round(100.0 / (iso * exp)), **meta,
                            "wb": [2.0, 1.0, 1.5, 1.0], "ccm": np.eye(3).tolist()})
        infos.append(entries)
    with open(os.path.join(info_dir, "ELD_SonyA7S2.info"), "wb") as f:
        pickle.dump(infos, f)
    return {"root": root, "ds_dir": ds_dir, "infos_dir": info_dir, "infos": infos}
