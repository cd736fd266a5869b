"""Bayer mosaic packing / unpacking, channel-last (counterpart of
``pnnp_tpu/ops/bayer.py``; reference: utils/isp_ops.py:57-123).

The layouts are the JAX package's: packed 4-channel images are ``[..., h,
w, 4]`` in **RGBG** order ``[R, G1, B, G2]``, where for an RGGB mosaic

    R  = raw[0::2, 0::2]    G1 = raw[0::2, 1::2]
    G2 = raw[1::2, 0::2]    B  = raw[1::2, 1::2]

All functions take torch tensors with any leading batch dimensions (but
:func:`repair_bad_pixels`, which takes one ``[H, W]`` mosaic) on any device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Index maps between RGBG plane order and the 2x2 Bayer cell (row-major
# positions [(0,0), (0,1), (1,0), (1,1)]); the map is an involution.
_RGGB_CELL_TO_RGBG = (0, 1, 3, 2)  # cell position -> rgbg channel
_RGGB_RGBG_TO_CELL = (0, 1, 3, 2)  # rgbg channel -> cell position


def bayer2rggb(bayer: torch.Tensor) -> torch.Tensor:
    """``[..., H, W]`` -> ``[..., H/2, W/2, 4]`` in raster cell order R,G,G,B
    (reference utils/isp_ops.py:57-59: cell-position order, *not* RGBG)."""
    *lead, H, W = bayer.shape
    x = bayer.reshape(*lead, H // 2, 2, W // 2, 2)
    return x.movedim(-3, -2).reshape(*lead, H // 2, W // 2, 4)


def rggb2bayer(rggb: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`bayer2rggb` (reference utils/isp_ops.py:61-63)."""
    *lead, h, w, _ = rggb.shape
    x = rggb.reshape(*lead, h, w, 2, 2)
    return x.movedim(-2, -3).reshape(*lead, 2 * h, 2 * w)


def pack_bayer(raw: torch.Tensor) -> torch.Tensor:
    """Pack a mosaic ``[..., H, W]`` into RGBG ``[..., H/2, W/2, 4]`` (RGGB
    pattern, as reference utils/isp_ops.py:84-96 assumes)."""
    return bayer2rggb(raw)[..., list(_RGGB_CELL_TO_RGBG)]


def unpack_bayer(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_bayer`: RGBG ``[..., h, w, 4]`` -> ``[..., 2h, 2w]``."""
    return rggb2bayer(packed[..., list(_RGGB_RGBG_TO_CELL)])


def bayer2rows(bayer: torch.Tensor) -> torch.Tensor:
    """Even/odd row planes ``[..., 2, H/2, W]`` (reference utils/isp_ops.py:65-68)."""
    *lead, H, W = bayer.shape
    return bayer.reshape(*lead, H // 2, 2, W).movedim(-2, -3)


def rows2bayer(rows: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`bayer2rows` (reference utils/isp_ops.py:76-81)."""
    *lead, _, h, W = rows.shape
    return rows.movedim(-3, -2).reshape(*lead, 2 * h, W)


def raw2bayer(raw: torch.Tensor, wp: float = 1023.0, bl: float = 64.0,
              norm: bool = True, clip: bool = False,
              bias: torch.Tensor | None = None) -> torch.Tensor:
    """Pack a raw mosaic to normalized RGBG with per-channel black level:
    ``(packed - (bias + bl)) / (wp - (bias + bl))`` per RGBG channel
    (reference utils/isp_ops.py:84-96); ``bias`` an optional ``[4]``
    black-level error."""
    out = pack_bayer(raw.float())
    if norm:
        b = (torch.zeros(4, device=out.device) if bias is None
             else torch.as_tensor(bias, dtype=torch.float32, device=out.device))
        blc = b + bl
        out = (out - blc) / (wp - blc)
    if clip:
        out = out.clamp(0.0, 1.0)
    return out


def bayer2gray(raw: torch.Tensor) -> torch.Tensor:
    """Bilinear-equivalent grayscale of a mosaic ``[..., H, W]``: the
    ``[[1,2,1],[2,4,2],[1,2,1]]/16`` filter over a reflect pad (reference
    utils/isp_ops.py:70-74 used cv2.filter2D), as f32 shifted sums."""
    lead, (H, W) = raw.shape[:-2], raw.shape[-2:]
    x = F.pad(raw.reshape(-1, 1, H, W).float(), (1, 1, 1, 1), mode="reflect")[:, 0]
    k = ((1.0, 2.0, 1.0), (2.0, 4.0, 2.0), (1.0, 2.0, 1.0))
    out = sum(x[:, dy:dy + H, dx:dx + W] * (k[dy][dx] / 16.0)
              for dy in range(3) for dx in range(3))
    return out.reshape(*lead, H, W)


def repair_bad_pixels(raw: torch.Tensor, bad_mask: torch.Tensor) -> torch.Tensor:
    """Replace flagged pixels of one mosaic ``[H, W]`` with the median of
    their 3x3 same-colour neighbourhood, edge-replicated (reference:
    utils/isp_ops.py:115-123 used cv2.medianBlur per RGGB plane)."""
    rggb = bayer2rggb(raw)  # [h, w, 4]
    h, w, _ = rggb.shape
    xp = F.pad(rggb.permute(2, 0, 1)[None], (1, 1, 1, 1), mode="replicate")[0]
    stack = torch.stack([xp[:, 1 + dy:h + 1 + dy, 1 + dx:w + 1 + dx]
                         for dy in (-1, 0, 1) for dx in (-1, 0, 1)])
    # 9 values: the median is the 5th smallest (torch.median would take the
    # lower middle of an even count; 9 is odd, both agree)
    med = stack.sort(dim=0).values[4].permute(1, 2, 0)
    return torch.where(bad_mask, rggb2bayer(med), raw)


def bayer2raw(packed: torch.Tensor, wp: float = 16383.0, bl: float = 512.0) -> torch.Tensor:
    """Normalized RGBG ``[..., h, w, 4]`` back to an ADU-range mosaic,
    ``clip(packed, 0, 1) * (wp - bl) + bl`` (reference utils/isp_ops.py:98-112),
    float32."""
    return unpack_bayer(packed.clamp(0.0, 1.0) * (wp - bl) + bl)
