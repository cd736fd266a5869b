"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU (``cuda`` marker) and skip on a host without
one: a CUDA kernel has no CPU or interpret mode. This file imports no JAX,
so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest -q

Tolerance: 1e-4 of the mean SSIM (f32 sums taken in another order), and
two launches on the same inputs are bit-identical (fixed-order reduction).
"""

import numpy as np
import pytest
import torch

import pnnp_tpu_torch.kernels.ssim as K

TOL = 1e-4


def structured(shape, seed):
    """Vertical gradient + per-channel scale + noise, on [0, 255] (as
    tests/test_kernels_ssim.py): iid frames would hide band/stride bugs."""
    rng = np.random.default_rng(seed)
    H, W, C = shape
    grad = np.linspace(0, 200, H, dtype=np.float32)[:, None, None]
    chans = (np.arange(C, dtype=np.float32) + 1.0)[None, None, :] * 20.0
    x = np.clip(grad + chans + rng.uniform(0, 40, shape).astype(np.float32),
                0, 255)
    y = np.clip(x + rng.normal(0, 12, shape).astype(np.float32), 0, 255)
    return x, y


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the SSIM kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(7, 7, 4), (70, 96, 4), (71, 96, 4),
                                   (96, 131, 3), (201, 140, 4), (1424, 2128, 4)])
def test_ssim_kernel_matches_plain(card, shape):
    x, y = structured(shape, 0)
    H, W, C = shape
    xf = torch.from_numpy(x.reshape(H, W * C)).to(card)
    yf = torch.from_numpy(y.reshape(H, W * C)).to(card)
    ref = float(K.ssim_flat_plain(xf, yf, C))
    n = (H - 6) * (W - 6) * C
    before = K.launches
    a = K.ssim_flat(xf, yf, C)
    b = K.ssim_flat(xf, yf, C)
    torch.cuda.synchronize()
    assert K.launches == before + 2
    assert abs(float(a) - ref) < TOL
    assert torch.equal(a, b)
    assert abs(float(K.ssim_flat_sum(xf, yf, C)) - ref * n) < TOL * n
    band = lambda t: t.reshape(H, W, C).permute(2, 0, 1).reshape(C * H, W)
    assert abs(float(K.ssim_banded(band(xf), band(yf), C)) - ref) < TOL
    assert abs(float(K.ssim_kernel(xf.reshape(H, W, C), yf.reshape(H, W, C))) - ref) < TOL


@pytest.mark.cuda
def test_ssim_wrapper_rejects_what_the_kernel_does_not_take(card):
    x = torch.zeros(16, 64, device=card)
    with pytest.raises(ValueError, match="float32"):
        K._ssim_call_sum(x.double(), x.double(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        K._ssim_call_sum(x.t(), x.t(), 4)
    with pytest.raises(ValueError, match="multiple"):
        K._ssim_call_sum(x, x, 3)
    with pytest.raises(ValueError, match="smaller"):
        K._ssim_call_sum(x[:6], x[:6], 4)
