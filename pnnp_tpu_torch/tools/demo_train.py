"""Procedural clean scenes for the training demos and the recipe A/B
(counterpart of ``tools/demo_train.py:35-52``).

Only the scene generator is here so far: the demo trainer itself is ROADMAP
1.17. :func:`synthetic_scenes` is numpy and draws from the caller's
``np.random.Generator`` in the JAX tool's order, so the same generator state
gives bit-identical scenes in both packages.
"""

from __future__ import annotations

import numpy as np


def synthetic_scenes(rng: np.random.Generator, n: int, p: int) -> np.ndarray:
    """Procedural low-light 'scenes': smooth gradients + blobs + edges,
    RGBG ``[n, p, p, 4]`` float32 in [0, 1]."""
    yy, xx = np.mgrid[0:p, 0:p].astype(np.float32) / p
    out = np.empty((n, p, p, 4), np.float32)
    for i in range(n):
        base = rng.uniform(0.002, 0.05)
        g = base + rng.uniform(0, 0.1) * (
            np.sin(xx * rng.uniform(2, 9) + rng.uniform(0, 6))
            * np.cos(yy * rng.uniform(2, 9))
            * 0.5 + 0.5
        )
        for _ in range(6):
            cx, cy, r = rng.uniform(0, 1, 3)
            blob = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (0.02 * r + 0.002)))
            g = g + rng.uniform(0, 0.15) * blob
        wb = rng.uniform(0.6, 1.0, 4).astype(np.float32)
        out[i] = np.clip(g[..., None] * wb, 0, 1)
    return out
