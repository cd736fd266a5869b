"""sRGB -> RAW unprocessing (Brooks et al.) on the caller's device
(counterpart of ``pnnp_tpu/physics/unprocess.py``; reference
data_process/unprocess.py): the per-camera fixed CCMs and the white-balance
polynomial fits. Images are ``[..., H, W, 3]`` (channels last, as the
reference and the JAX package); a batched input shares one metadata draw
per call, like the reference. Every draw comes from the
``torch.Generator`` passed in.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pnnp_tpu_torch.physics.noise import random_gains

RGB2CAM = {
    "SonyA7S2": np.eye(3, dtype=np.float32),
    "IMX686": np.array(
        [
            [0.61093086, 0.31565922, 0.07340994],
            [0.09433191, 0.7658969, 0.1397712],
            [0.03532438, 0.3020709, 0.6626047],
        ],
        np.float32,
    ),
}


def random_ccm(camera_type: str = "IMX686", device=None) -> torch.Tensor:
    """Fixed per-camera RGB->cam CCM (reference: unprocess.py:7-46)."""
    return torch.as_tensor(RGB2CAM[camera_type], device=device)


def inverse_smoothstep(image: torch.Tensor) -> torch.Tensor:
    image = image.clamp(0.0, 1.0)
    return 0.5 - torch.sin(torch.asin(1.0 - 2.0 * image) / 3.0)


def gamma_expansion(image: torch.Tensor) -> torch.Tensor:
    return image.clamp_min(1e-8) ** 2.2


def apply_ccm(image: torch.Tensor, ccm: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...c,kc->...k", image, ccm)


def safe_invert_gains(image, rgb_gain, red_gain, blue_gain):
    """Invert the WB gains with the saturation-protecting mask (reference
    unprocess.py:106-121)."""
    gains = torch.stack([1.0 / red_gain, torch.ones_like(red_gain), 1.0 / blue_gain]) / rgb_gain
    gains = gains.reshape(1, 1, 3)
    gray = image.mean(dim=-1, keepdim=True)
    inflection = 0.9
    mask = ((gray - inflection).clamp_min(0.0) / (1.0 - inflection)) ** 2.0
    safe_gains = torch.maximum(mask + (1.0 - mask) * gains, gains)
    return image * safe_gains


def mosaic_rggb(image: torch.Tensor) -> torch.Tensor:
    """RGB ``[..., H, W, 3]`` -> packed RGBG ``[..., H/2, W/2, 4]`` (reference
    unprocess.py:123-144)."""
    red = image[..., 0::2, 0::2, 0]
    green_red = image[..., 0::2, 1::2, 1]
    green_blue = image[..., 1::2, 0::2, 1]
    blue = image[..., 1::2, 1::2, 2]
    return torch.stack([red, green_red, blue, green_blue], dim=-1)


def unprocess(generator: torch.Generator, image: torch.Tensor, lock_wb=False,
              camera_type: str = "IMX686"):
    """sRGB -> unprocessed linear raw + metadata (reference
    unprocess.py:170-217). ``lock_wb`` False/None draws random gains from
    ``generator``; True takes the reference's fixed (1, 2, 2); a 3-sequence
    ``(rgb, red, blue)`` passes gains."""
    dev = image.device
    rgb2cam = random_ccm(camera_type, dev)
    cam2rgb = torch.linalg.inv(rgb2cam)
    if lock_wb is False or lock_wb is None:
        rgb_gain, red_gain, blue_gain = (g[0].to(dev) for g in
                                         random_gains(generator, camera_type, 1))
    else:
        gains = (1.0, 2.0, 2.0) if lock_wb is True else lock_wb
        rgb_gain, red_gain, blue_gain = (torch.tensor(float(g), device=dev) for g in gains)
    x = inverse_smoothstep(image)
    x = gamma_expansion(x)
    x = apply_ccm(x, rgb2cam)
    x = safe_invert_gains(x, rgb_gain, red_gain, blue_gain)
    x = x.clamp(0.0, 1.0)
    metadata = {"cam2rgb": cam2rgb, "rgb_gain": rgb_gain, "red_gain": red_gain,
                "blue_gain": blue_gain}
    return x, metadata


def random_noise_levels(generator: torch.Generator):
    """Log-log linear shot / read noise levels (reference
    unprocess.py:220-231)."""
    dev = generator.device
    lo, hi = math.log(0.0001), math.log(0.012)
    log_shot = torch.rand((), generator=generator, device=dev) * (hi - lo) + lo
    shot = torch.exp(log_shot)
    log_read = 2.18 * log_shot + 1.20 + 0.26 * torch.randn((), generator=generator, device=dev)
    return shot, torch.exp(log_read)


def add_noise(generator: torch.Generator, image: torch.Tensor, shot_noise=0.01,
              read_noise=0.0005):
    """Gaussian-approximated shot + read noise (reference unprocess.py:234-242)."""
    variance = image * shot_noise + read_noise
    noise = torch.randn(image.shape, generator=generator, device=generator.device)
    return image + noise.to(image.device) * torch.sqrt(variance)
