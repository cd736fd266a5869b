"""Halo-tiled full-frame inference (counterpart of ``pnnp_tpu/ops/tiling.py``;
reference: data_process/real_datasets.py:139-189, trainer_SID.py:345-360).

Reflect-pad an ``[H, W, C]`` frame with a ``base/2`` halo, cut ``nh*nw``
overlapping tiles of ``patch_size``, run the model over the tiles (in chunks
of ``tile_batch``, a Python loop that bounds peak memory), and stitch the
halo-stripped interiors back in the reference's write order. Tensors stay on
their device; tile coordinates are plain integers.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _tile_starts(size: int, patch: int, stride: int) -> np.ndarray:
    """Main-grid starts [0, l, 2l, ...] plus one end-anchored tile (reference scheme)."""
    n = size // stride + 1
    starts = [i * stride for i in range(n - 1)]
    starts.append(size + 2 * (patch - stride) // 2 - patch)  # == padded_size - patch
    return np.array(starts, np.int32)


def eval_crop(data: torch.Tensor, patch_size: int, base: int = 64) -> torch.Tensor:
    """``[H, W, C]`` -> ``[nh*nw, patch, patch, C]`` overlap tiles with a reflect halo."""
    H, W, C = data.shape
    d = base // 2
    l = patch_size - base
    if H < l or W < l:
        raise ValueError(
            f"image {H}x{W} smaller than the tile stride "
            f"{l} (= patch_size {patch_size} - base {base}); lower patch_size "
            "or evaluate the frame whole")
    padded = F.pad(data.permute(2, 0, 1)[None], (d, d, d, d), mode="reflect")[0]
    padded = padded.permute(1, 2, 0)
    return torch.stack([padded[i:i + patch_size, j:j + patch_size]
                        for i in _tile_starts(H, patch_size, l).tolist()
                        for j in _tile_starts(W, patch_size, l).tolist()])


def eval_merge(tiles: torch.Tensor, out_hw: tuple[int, int], base: int = 64) -> torch.Tensor:
    """Stitch ``[nh*nw, patch, patch, C]`` interiors back into ``[H, W, C]``.

    Writes follow the reference order (main grid, then the right and bottom
    end-anchored strips, then the corner) so overlapping edge regions resolve
    identically (reference: data_process/real_datasets.py:166-189)."""
    H, W = out_hw
    patch, C = tiles.shape[1], tiles.shape[-1]
    d = base // 2
    l = patch - base
    nh, nw = H // l + 1, W // l + 1
    inner = tiles.reshape(nh, nw, patch, patch, C)[:, :, d:patch - d, d:patch - d]
    out = torch.zeros((H, W, C), dtype=tiles.dtype, device=tiles.device)
    # main grid: disjoint l x l blocks
    out[:(nh - 1) * l, :(nw - 1) * l] = (inner[:nh - 1, :nw - 1].permute(0, 2, 1, 3, 4)
                                         .reshape((nh - 1) * l, (nw - 1) * l, C))
    # right strip (end-anchored columns), bottom strip, corner
    out[:(nh - 1) * l, W - l:] = inner[:nh - 1, nw - 1].reshape((nh - 1) * l, l, C)
    out[H - l:, :(nw - 1) * l] = (inner[nh - 1, :nw - 1].permute(1, 0, 2, 3)
                                  .reshape(l, (nw - 1) * l, C))
    out[H - l:, W - l:] = inner[nh - 1, nw - 1]
    return out


def tiled_apply(fn, data: torch.Tensor, patch_size: int, base: int = 64,
                tile_batch: int = 0) -> torch.Tensor:
    """Apply ``fn`` (a ``[N, p, p, C] -> [N, p, p, C]`` batch op) over the
    halo tiles of ``[H, W, C]``; ``tile_batch > 0`` feeds ``fn`` chunks of
    that many tiles (the last one may be shorter)."""
    H, W, _ = data.shape
    tiles = eval_crop(data, patch_size, base)
    if tile_batch and tiles.shape[0] > tile_batch:
        outs = torch.cat([fn(tiles[i:i + tile_batch])
                          for i in range(0, tiles.shape[0], tile_batch)])
    else:
        outs = fn(tiles)
    return eval_merge(outs, (H, W), base)
