"""ISO/camera-conditional flow layers, Noise2NoiseFlow heritage
(counterpart of ``pnnp_tpu/models/flows/conditional.py``; reference
archs/flow_layers/{affine_coupling.py:55-150, conv2d1x1.py:94-186,
linear_transformation.py, utils.py}).

The condition is a 25-way (5 ISO x 5 camera) selection from image-shaped
``iso`` and ``cam`` fields: a per-example one-hot ``[iso | cam]`` through a
learned ``encoder`` (the couplings) or one flat index ``iso * 5 + cam`` over
the whole batch (the per-condition tables). NCHW. ``torch.round`` rounds
half to even, as ``jnp.round``.

The modules are built with their input widths, which flax infers from the
first call: the couplings' conditioner sees ``clean_channels`` channels of
clean image (``num_channels`` unless given).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from pnnp_tpu_torch.models.flows.base import Bijector, sum_except_batch
from pnnp_tpu_torch.models.flows.coupling import ShiftAndLogScale
from pnnp_tpu_torch.models.proxy import lecun_normal_

ISO_VALS = (100.0, 400.0, 800.0, 1600.0, 3200.0)
CAM_VALS = (0.0, 1.0, 2.0, 3.0, 4.0)  # IP, GP, S6, N6, G4
N_COND = len(ISO_VALS) * len(CAM_VALS)


def _ladder(vals, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(vals, dtype=torch.float32, device=like.device)


def _cam_round(mean: torch.Tensor) -> torch.Tensor:
    return torch.round(mean * 10) / 10


def iso_cam_onehot(iso: torch.Tensor, cam: torch.Tensor) -> torch.Tensor:
    """Per-example ``[n, 10]`` ``[iso-onehot | cam-onehot]`` by equality of
    each example's mean ISO and rounded mean camera with the ladders
    (reference affine_coupling.py:70-74)."""
    iso_mean = iso.reshape(iso.shape[0], -1).mean(dim=1)
    cam_mean = _cam_round(cam.reshape(cam.shape[0], -1).mean(dim=1))
    g = (iso_mean[:, None] == _ladder(ISO_VALS, iso)[None, :]).float()
    c = (cam_mean[:, None] == _ladder(CAM_VALS, cam)[None, :]).float()
    return torch.cat([g, c], dim=1)


def iso_cam_index(iso: torch.Tensor, cam: torch.Tensor) -> torch.Tensor:
    """Flat 25-way index ``iso * 5 + cam`` of the batch (reference
    conv2d1x1.py:169-175): the nearest ladder value of the mean ISO and of
    the rounded mean camera, a tie to the first (``argmin``). An exact hit
    is the reference's equality lookup; an off-table value picks its
    nearest entry. A 0-dim tensor on the inputs' device."""
    i = torch.argmin(torch.abs(_ladder(ISO_VALS, iso) - iso.mean()))
    c = torch.argmin(torch.abs(_ladder(CAM_VALS, cam) - _cam_round(cam.mean())))
    return i * len(CAM_VALS) + c


def _dense(num_in: int, num_out: int, generator) -> nn.Linear:
    """flax ``nn.Dense``: lecun-normal kernel, zero bias."""
    lin = nn.Linear(num_in, num_out)
    lecun_normal_(lin.weight, generator)
    nn.init.zeros_(lin.bias)
    return lin


class ConditionalAffineCoupling(Bijector):
    """Coupling whose conditioner also sees the clean image, the log-scale
    scaled by a learned ISO/camera embedding (reference
    affine_coupling.py:55-101)."""

    def __init__(self, num_channels: int = 4, width: int = 4,
                 clean_channels: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = self.num_channels = num_channels
        clean_channels = num_channels if clean_channels is None else clean_channels
        self.net = ShiftAndLogScale(c // 2 + clean_channels, 2 * (c - c // 2), width, generator)
        self.encoder = _dense(len(ISO_VALS) + len(CAM_VALS), 1, generator)

    def _shift_log_scale(self, half, clean, iso, cam, train):
        shift, log_scale = self.net(torch.cat([half, clean], dim=1), train)
        return shift, log_scale * self.encoder(iso_cam_onehot(iso, cam)).reshape(-1, 1, 1, 1)

    def forward_ldj(self, x, clean=None, iso=None, train: bool = False, cam=None):
        c = self.num_channels
        x0, x1 = x[:, :c // 2], x[:, c // 2:]
        shift, log_scale = self._shift_log_scale(x0, clean, iso, cam, train)
        z1 = x1 * torch.exp(log_scale) + shift
        return torch.cat([x0, z1], dim=1), sum_except_batch(log_scale)

    def inverse(self, z, clean=None, iso=None, cam=None):
        c = self.num_channels
        z0, z1 = z[:, :c // 2], z[:, c // 2:]
        shift, log_scale = self._shift_log_scale(z0, clean, iso, cam, False)
        return torch.cat([z0, (z1 - shift) * torch.exp(-log_scale)], dim=1)


class ConditionalAffine(Bijector):
    """Elementwise affine from the clean image (no channel split), with the
    ISO/camera embedding unless ``only_clean`` (reference
    affine_coupling.py:103-150)."""

    def __init__(self, num_channels: int = 4, width: int = 4, only_clean: bool = False,
                 clean_channels: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_channels, self.only_clean = num_channels, only_clean
        clean_channels = num_channels if clean_channels is None else clean_channels
        self.net = ShiftAndLogScale(clean_channels, 2 * num_channels, width, generator)
        if not only_clean:
            self.encoder = _dense(len(ISO_VALS) + len(CAM_VALS), 1, generator)

    def _shift_log_scale(self, clean, iso, cam, train):
        shift, log_scale = self.net(clean, train)
        if not self.only_clean:
            log_scale = log_scale * self.encoder(iso_cam_onehot(iso, cam)).reshape(-1, 1, 1, 1)
        return shift, log_scale

    def forward_ldj(self, x, clean=None, iso=None, train: bool = False, cam=None):
        shift, log_scale = self._shift_log_scale(clean, iso, cam, train)
        return x * torch.exp(log_scale) + shift, sum_except_batch(log_scale)

    def inverse(self, z, clean=None, iso=None, cam=None):
        shift, log_scale = self._shift_log_scale(clean, iso, cam, False)
        return (z - shift) * torch.exp(-log_scale)


class ConditionalLinear(Bijector):
    """25-way conditional per-channel affine (reference
    linear_transformation.py): ``shift`` and ``log_scale`` ``[25, C]``,
    zero at init."""

    def __init__(self, num_channels: int = 4):
        super().__init__()
        self.num_channels = num_channels
        self.shift = nn.Parameter(torch.zeros(N_COND, num_channels))
        self.log_scale = nn.Parameter(torch.zeros(N_COND, num_channels))

    def forward_ldj(self, x, clean=None, iso=None, train: bool = False, cam=None):
        idx = iso_cam_index(iso, cam)
        s, ls = self.shift[idx], self.log_scale[idx]
        z = x * torch.exp(ls).reshape(1, -1, 1, 1) + s.reshape(1, -1, 1, 1)
        ldj = x.shape[-2] * x.shape[-1] * torch.sum(ls)
        return z, torch.broadcast_to(ldj, (x.shape[0],))

    def inverse(self, z, clean=None, iso=None, cam=None):
        idx = iso_cam_index(iso, cam)
        return ((z - self.shift[idx].reshape(1, -1, 1, 1))
                * torch.exp(-self.log_scale[idx]).reshape(1, -1, 1, 1))


class _LU(nn.Module):
    """The 25-way LU factors of :class:`ConditionalInvertibleConv1x1` under
    JAX's ``lu`` names: the shared permutation ``p`` and signs ``sign_s``
    are buffers (JAX's ``stop_gradient``), the per-condition ``l``, ``u``
    and ``log_s`` parameters."""

    def __init__(self, c: int, generator: Optional[torch.Generator]):
        super().__init__()
        # the JAX init law: QR of a normal draw, then LU (the draws differ)
        w = torch.linalg.qr(torch.randn((c, c), generator=generator))[0]
        p, l, u = torch.linalg.lu(w)
        s = torch.diagonal(u)
        rep = lambda a: a[None].repeat((N_COND,) + (1,) * a.dim())
        self.register_buffer("p", p)
        self.register_buffer("sign_s", torch.sign(s))
        self.l = nn.Parameter(rep(torch.tril(l, -1)))
        self.log_s = nn.Parameter(rep(torch.log(torch.abs(s))))
        self.u = nn.Parameter(rep(torch.triu(u, 1)))


class ConditionalInvertibleConv1x1(Bijector):
    """25-way conditional LU 1x1 convolution (reference
    conv2d1x1.py:94-186): ``W = P @ L[k] @ U[k]`` for the batch's condition
    ``k``; the log-det ``sum(log_s[k]) * H * W``."""

    def __init__(self, num_channels: int = 4, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_channels = num_channels
        self.lu = _LU(num_channels, generator)

    def weight(self, idx) -> torch.Tensor:
        """The recomposed ``[c_out, c_in]`` matrix of condition ``idx``."""
        lu = self.lu
        eye = torch.eye(self.num_channels, device=lu.l.device)
        l_mask = torch.tril(torch.ones_like(eye), -1)
        l = lu.l[idx] * l_mask + eye
        u = lu.u[idx] * l_mask.T + torch.diag(lu.sign_s * torch.exp(lu.log_s[idx]))
        return lu.p @ l @ u

    def forward_ldj(self, x, clean=None, iso=None, train: bool = False, cam=None):
        idx = iso_cam_index(iso, cam)
        z = F.conv2d(x, self.weight(idx)[:, :, None, None])
        ldj = torch.sum(self.lu.log_s[idx]) * x.shape[-2] * x.shape[-1]
        return z, torch.broadcast_to(ldj, (x.shape[0],))

    def inverse(self, z, clean=None, iso=None, cam=None):
        idx = iso_cam_index(iso, cam)
        return F.conv2d(z, torch.linalg.inv(self.weight(idx))[:, :, None, None])


class SdnModelScale(nn.Module):
    """Signal-dependent scale with per-camera gain parameters (reference
    flow_layers/utils.py:17-111): ``sqrt(exp(beta1) * clean / g +
    exp(beta2))``, ``g = mean(iso) / 100 * exp(gain_scale[cam])``, the
    camera by equality of the rounded mean (the first entry when none
    matches, as ``argmax``)."""

    def __init__(self, n_cams: int = 5):
        super().__init__()
        self.beta1 = nn.Parameter(torch.tensor(-5.0))
        self.beta2 = nn.Parameter(torch.tensor(0.0))
        self.gain_scale = nn.Parameter(torch.zeros(n_cams))

    def forward(self, clean, iso, cam):
        hit = _ladder(CAM_VALS, cam) == _cam_round(cam.mean())
        cam_idx = torch.argmax(hit.int())
        gain = iso.mean() / 100.0 * torch.exp(self.gain_scale[cam_idx])
        scale = torch.exp(self.beta1) * clean / gain + torch.exp(self.beta2)
        return torch.sqrt(torch.clamp_min(scale, 1e-12))
