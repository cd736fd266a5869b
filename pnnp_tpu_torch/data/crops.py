"""Host-side crop planning + geometric augmentation (NumPy, NHWC).

Mirrors reference data_process/real_datasets.py:98-136, 192-203: a per-frame
crop plan (random or non-overlapped grid) shared by all views of the frame
(so paired lr/hr and video frames crop identically), and the 4-mode aug
{identity, rot180, W-flip, rot180+W-flip} — rot90 is excluded for PAIRED
data because row noise is directional. Synthetic (GT-only) datasets pass
``aug_modes=8`` for the reference's syn aug (rot90 allowed — noise is added
AFTER the aug, so banding stays row-aligned; syn_datasets.py:75,101-107).
"""

from __future__ import annotations

import numpy as np


class CropPlanner:
    """Plans crop windows + aug modes for one frame; reused across its views."""

    def __init__(self, h: int, w: int, patch_size: int, crop_per_image: int = 8,
                 croptype: str = "non-overlapped", rng: np.random.Generator | None = None,
                 aug_modes: int = 4):
        self.h, self.w = h, w
        self.patch = patch_size
        self.n = crop_per_image
        self.croptype = croptype
        self.aug_modes = aug_modes
        self.rng = rng or np.random.default_rng()
        self.replan()

    def replan(self):
        p = self.patch
        rng = self.rng
        self.aug = rng.integers(0, self.aug_modes, size=self.n)
        hs, ws = [], []
        if self.croptype == "non-overlapped":
            nh = self.h // p
            nw = self.w // p
            h0 = rng.integers(0, self.h - nh * p + 1)
            w0 = rng.integers(0, self.w - nw * p + 1)
            for i in range(nh):
                for j in range(nw):
                    hs.append(h0 + i * p)
                    ws.append(w0 + j * p)
            self.n_planned = len(hs)
        else:
            for _ in range(self.n):
                hs.append(rng.integers(0, self.h - p + 1))
                ws.append(rng.integers(0, self.w - p + 1))
            self.n_planned = self.n
        self.h_start = np.array(hs)
        self.w_start = np.array(ws)

    @staticmethod
    def augment(img: np.ndarray, mode: int, aug_modes: int = 4) -> np.ndarray:
        """4-mode (paired, real_datasets.py:129-136): 0 id, 1 rot180,
        2 flip-W, 3 rot180+flip-W. 8-mode (syn, syn_datasets.py:101-107):
        rot90 k=mode%4 then flip-W if mode//4 (HWC arrays)."""
        if aug_modes == 8:
            if mode % 4:
                img = np.rot90(img, k=mode % 4, axes=(-3, -2))
            if mode // 4:
                img = img[..., ::-1, :]
            return img
        if mode == 0:
            return img
        if mode % 2:
            img = np.rot90(img, k=2, axes=(-3, -2))
        if mode // 2:
            img = img[..., ::-1, :]
        return img

    def crop(self, img: np.ndarray) -> np.ndarray:
        """[h, w, c] -> [n, patch, patch, c] using the current plan.

        Like the reference (real_datasets.py:192-204), non-overlapped mode
        keeps only the first crop_per_image row-major grid cells when the
        grid is larger; when crop_per_image exceeds the grid we clamp to the
        grid (the reference would index out of range there)."""
        p = self.patch
        n = min(self.n, len(self.h_start))
        out = np.empty((n, p, p, img.shape[-1]), np.float32)
        for i in range(n):
            patch = img[self.h_start[i] : self.h_start[i] + p,
                        self.w_start[i] : self.w_start[i] + p]
            out[i] = self.augment(patch, int(self.aug[i]), self.aug_modes)
        return out
