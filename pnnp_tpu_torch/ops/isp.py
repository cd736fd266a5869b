"""Device ISP: white balance, CCM, gamma, demosaic (counterpart of
``pnnp_tpu/ops/isp.py``; reference: data_process/process.py:104-155,
utils/isp_ops.py:125-158).

Layouts are the JAX package's (channel-last: RGBG ``[..., h, w, 4]`` in,
sRGB ``[..., 2h, 2w, 3]`` out of :func:`fast_isp`), since its callers hand
over HWC frames. Everything runs on the input's device.

Precision: the RGB metrics floor the output to uint8, where a rounding
difference moves a value across a bin edge, so the JAX module runs its
demosaic convolutions and CCM einsum at ``Precision.HIGHEST``. Here the
demosaic is a sum of shifted planes and the CCM a sum of products, all
elementwise float32: no convolution or matmul that TF32 could take, and
autocast is off inside, whatever the global flags and the caller say.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pnnp_tpu_torch.ops.bayer import unpack_bayer

# SonyA7S2 cam->sRGB CCM used by the reference when rawpy's matrix is
# identity (reference: utils/isp_ops.py:151-153, get_dataset_infos.py:5).
SONY_CCM = torch.tensor(
    [
        [1.9712269, -0.6789218, -0.29230508],
        [-0.29104823, 1.748401, -0.45735288],
        [0.02051281, -0.5380369, 1.5175241],
    ],
    dtype=torch.float32,
)

# bilinear demosaic taps (3x3, symmetric): green from its 4-neighbours,
# red/blue from the 8 around them
_K_G = ((0.0, 0.25, 0.0), (0.25, 1.0, 0.25), (0.0, 0.25, 0.0))
_K_RB = ((0.25, 0.5, 0.25), (0.5, 1.0, 0.5), (0.25, 0.5, 0.25))


def _exact(device: torch.device):
    """No autocast inside the ISP: every op stays float32."""
    return torch.autocast(device.type, enabled=False)


def apply_gains(bayer_images: torch.Tensor, wbs: torch.Tensor) -> torch.Tensor:
    """White-balance RGBG ``[N, h, w, 4]`` with gains ``[N, 4]``
    (reference: data_process/process.py:104-109)."""
    return bayer_images * wbs[:, None, None, :]


def _mix3(img: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``out[..., k] = sum_c img[..., c] * m[..., k, c]``, elementwise f32
    (``m`` broadcasts against ``img``'s leading dims)."""
    return torch.stack([img[..., 0] * m[..., k, 0] + img[..., 1] * m[..., k, 1]
                        + img[..., 2] * m[..., k, 2] for k in range(3)], dim=-1)


def apply_ccms(images: torch.Tensor, ccms: torch.Tensor) -> torch.Tensor:
    """Colour correction ``[N, h, w, 3] @ ccm^T`` with ``[N, 3, 3]``
    (reference: data_process/process.py:112-121)."""
    with _exact(images.device):
        return _mix3(images.float(), ccms.float()[:, None, None])


def gamma_compression(images: torch.Tensor, gamma: float = 2.2) -> torch.Tensor:
    """Linear -> gamma with the reference's uint8 round trip (the int()
    truncation of data_process/process.py:124-129)."""
    outs = images.clamp_min(1e-8) ** (1.0 / gamma)
    return torch.floor(outs * 255.0).to(torch.int32).clamp(0, 255).float() / 255.0


def raw2lrgb(bayer_images: torch.Tensor) -> torch.Tensor:
    """RGBG ``[N, h, w, 4]`` -> linear RGB ``[N, h, w, 3]``, G1/G2 binned
    (reference: data_process/process.py:132-139)."""
    r = bayer_images[..., 0]
    g = 0.5 * (bayer_images[..., 1] + bayer_images[..., 3])
    return torch.stack([r, g, bayer_images[..., 2]], dim=-1)


def process(bayer_images: torch.Tensor, wbs: torch.Tensor, cam2rgbs: torch.Tensor,
            gamma: float = 2.2) -> torch.Tensor:
    """Batched RGBG -> sRGB (reference: data_process/process.py:142-155)."""
    x = apply_gains(bayer_images, wbs).clamp(0.0, 1.0)
    x = apply_ccms(raw2lrgb(x), cam2rgbs).clamp(0.0, 1.0)
    return gamma_compression(x, gamma)


def simple_isp(rggb: torch.Tensor, bl: float = 512.0, wp: float = 16383.0,
               wb=(2.0, 1.0, 1.0, 2.0), gamma: float = 2.2) -> torch.Tensor:
    """Half-resolution preview over cell-order RGGB ``[..., h, w, 4]``.

    NOTE ``wb`` is CELL-order RGGB (blue at index 3, the reference's
    SimpleISP default [2,1,1,2], isp_ops.py:125-132); :func:`fast_isp` and
    the dataset info's ``wb`` are RGBG (blue at index 2)."""
    x = (rggb.float() - bl) / (wp - bl)
    x = x * torch.as_tensor(wb, dtype=torch.float32, device=x.device)
    return x.clamp(0.0, 1.0)[..., [0, 1, 3]] ** (1.0 / gamma)


def _conv3x3(x: torch.Tensor, k) -> torch.Tensor:
    """3x3 correlation of ``[..., H, W]`` with zero 'SAME' padding (the JAX
    module's ``padding="SAME"``), as a sum of shifted planes."""
    H, W = x.shape[-2:]
    xp = F.pad(x, (1, 1, 1, 1))
    out = None
    for dy in range(3):
        for dx in range(3):
            if k[dy][dx]:
                term = xp[..., dy:dy + H, dx:dx + W] * k[dy][dx]
                out = term if out is None else out + term
    return out


def bilinear_demosaic(bayer: torch.Tensor) -> torch.Tensor:
    """Bilinear RGGB demosaic of a mosaic ``[..., H, W]`` -> ``[..., H, W, 3]``
    (replaces the reference's OpenCV/LibRaw demosaic, utils/isp_ops.py:149,
    :190). Each colour's sparse plane is interpolated and normalised by the
    interpolated sample mask, so border windows that see fewer lattice
    samples stay exact."""
    H, W = bayer.shape[-2:]
    dev = bayer.device
    with _exact(dev):
        x = bayer.float()
        ii = torch.arange(H, device=dev)[:, None] % 2
        jj = torch.arange(W, device=dev)[None, :] % 2
        r_mask = ((ii == 0) & (jj == 0)).float()
        b_mask = ((ii == 1) & (jj == 1)).float()
        g_mask = 1.0 - r_mask - b_mask

        def plane(mask, k):
            return _conv3x3(x * mask, k) / _conv3x3(mask, k).clamp_min(1e-8)

        return torch.stack([plane(r_mask, _K_RB), plane(g_mask, _K_G),
                            plane(b_mask, _K_RB)], dim=-1)


def fast_isp(img4c: torch.Tensor, wb=None, ccm=None, gamma: float = 2.2) -> torch.Tensor:
    """Full-resolution ISP over packed RGBG ``[..., h, w, 4]`` -> sRGB
    ``[..., 2h, 2w, 3]``: R/B white-balance gains, clip, the mosaic
    reassembled and demosaiced, the CCM (``SONY_CCM`` when ``ccm`` is None),
    clip and gamma (reference: utils/isp_ops.py:134-158). ``wb`` RGBG gains
    (R and B used; 2.0 when None), numpy or tensor."""
    dev = img4c.device
    with _exact(dev):
        x = img4c.float()
        wb = (torch.full((4,), 2.0, device=dev) if wb is None
              else torch.as_tensor(wb, dtype=torch.float32, device=dev).reshape(-1))
        one = torch.ones((), device=dev)
        gains = torch.stack([wb[0], one, wb[2], one])
        img = bilinear_demosaic(unpack_bayer((x * gains).clamp(0.0, 1.0)))
        ccm = SONY_CCM if ccm is None else torch.as_tensor(ccm, dtype=torch.float32)
        img = _mix3(img, ccm.to(dev).reshape(3, 3))
        return img.clamp(0.0, 1.0) ** (1.0 / gamma)
