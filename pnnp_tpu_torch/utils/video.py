"""Multi-frame (video) index helpers (counterpart of
``pnnp_tpu/utils/video.py``; reference: utils/video_ops.py).

Per-output-frame input-index windows for nframes-input video models, with
reflect or clip boundary handling (numpy index math), and the frame-stack
gather (one torch index on the clip's device).
"""

from __future__ import annotations

import numpy as np
import torch


def _reflect(nums, lo, hi):
    # single bounce + clamp: windows wider than 2x the clip would otherwise
    # go negative after one reflection and wrap in gathers
    nums = np.abs(np.asarray(nums) - lo)
    return np.clip(hi - np.abs(hi - nums), lo, hi)


def frame_index_splitor(nframes: int = 1, pad: bool = True, reflect: bool = True,
                        total: int = 7) -> np.ndarray:
    """Index windows ``[n_out, nframes]`` over a clip of ``total`` frames.

    pad=True keeps n_out == total (centred windows, boundary reflected or
    clipped); pad=False yields only fully interior windows."""
    r = nframes // 2
    if pad:
        frames = [[i + k - r for k in range(nframes)] for i in range(total)]
    else:
        frames = [[i + k for k in range(nframes)] for i in range(total + 1 - nframes)]
    frames = np.asarray(frames)
    if reflect:
        return _reflect(frames, 0, total - 1)
    return np.clip(frames, 0, total - 1)


def multi_frame_gather(clip: torch.Tensor, index: np.ndarray, gt: bool = False,
                       keepdims: bool = False) -> torch.Tensor:
    """Gather input stacks from ``clip [B, T, H, W, C]``.

    gt=False -> ``[n_out, B, nframes, H, W, C]``; gt=True picks each window's
    centre frame -> ``[n_out, B, (1,) H, W, C]``."""
    index = np.asarray(index)
    if gt:
        centers = torch.as_tensor(index[:, index.shape[1] // 2], device=clip.device)
        out = clip[:, centers].movedim(1, 0)  # [n_out, B, ...]
        return out[:, :, None] if keepdims else out
    return clip[:, torch.as_tensor(index, device=clip.device)].movedim(1, 0)
