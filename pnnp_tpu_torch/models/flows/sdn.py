"""Signal-dependent (shot-noise) and gain bijectors with per-ISO tables
(counterpart of ``pnnp_tpu/models/flows/sdn.py``; reference
archs/flow_layers/signal_dependant.py:19-73 and gain.py:65-110).

Per-ISO camera parameters live on the 31-entry legal-ISO ladder. The lookup
is the reference's searchsorted pick, whose "interpolation" formula
collapses: an ISO on the ladder returns its own row, an ISO off the ladder
the row of the ladder entry just above it. No true interpolation happens
(tests/test_nf_kld_parity.py pins this as a property).

:class:`SignalDependantNS` (reference signal_dependant.py:131-258) is the
neural-spline variant: an RQ spline whose bins come from a small CNN over
the clean image.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from pnnp_tpu_torch.models.flows.base import Bijector, sum_except_batch
from pnnp_tpu_torch.models.flows.spline import unconstrained_rational_quadratic_spline
from pnnp_tpu_torch.models.proxy import lecun_normal_
from pnnp_tpu_torch.physics.calibration import LEGAL_ISO


def _iso_tensor(iso, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(iso, dtype=torch.float32, device=like.device)


def _interp_iso(legal_iso: torch.Tensor, cam_param: torch.Tensor, iso) -> torch.Tensor:
    """exp(cam_param) rows at ``iso`` (scalar or [n]) by the reference's
    searchsorted pick; shape ``iso.shape + cam_param.shape[1:]``."""
    iso = _iso_tensor(iso, cam_param)
    flat = iso.reshape(-1).contiguous()
    hi = legal_iso.shape[0] - 1
    l = torch.searchsorted(legal_iso, flat, right=False).clamp(0, hi)
    r = torch.searchsorted(legal_iso, flat, right=True).clamp(0, hi)
    iso_l, iso_r = legal_iso[l], legal_iso[r]
    cp_l, cp_r = torch.exp(cam_param[l]), torch.exp(cam_param[r])
    denom = iso_r - iso_l
    w_shape = denom.shape + (1,) * (cp_l.dim() - 1)
    interp = ((flat - iso_l).reshape(w_shape) * cp_r + (iso_r - flat).reshape(w_shape) * cp_l
              ) / torch.where(denom == 0, torch.ones_like(denom), denom).reshape(w_shape)
    out = torch.where((denom == 0).reshape(w_shape), cp_l, interp)
    return out.reshape(iso.shape + cam_param.shape[1:])


class SignalDependantISO(Bijector):
    """``scale = sqrt(beta1 * clean / gain(iso) + beta2)`` (reference sdn
    layer). ``cam_param`` is frozen: it takes no gradient, as the JAX
    module's ``stop_gradient`` on its use."""

    def __init__(self):
        super().__init__()
        # the ladder moves with the module; it is no checkpoint leaf
        self.register_buffer("legal_iso", torch.from_numpy(LEGAL_ISO), persistent=False)
        self.cam_param = nn.Parameter(torch.zeros(len(LEGAL_ISO), 3))
        self.gain = nn.Parameter(torch.tensor(-6.0))
        self.beta1 = nn.Parameter(torch.tensor(-5.0))
        self.beta2 = nn.Parameter(torch.tensor(-4.0))

    def _scale(self, clean, iso):
        cp = _interp_iso(self.legal_iso, self.cam_param.detach(), iso)
        beta1 = torch.exp(self.beta1 * cp[..., 0])
        beta2 = torch.exp(self.beta2 * cp[..., 1])
        gain = torch.exp(self.gain * cp[..., 2]) * _iso_tensor(iso, clean)
        shape = beta1.shape + (1,) * (clean.dim() - beta1.dim())
        scale = beta1.reshape(shape) * clean / gain.reshape(shape) + beta2.reshape(shape)
        return torch.sqrt(torch.clamp_min(scale, 1e-12))

    def forward_ldj(self, x, clean=None, iso=None, train: bool = False):
        scale = self._scale(clean, iso)
        return x / scale, -sum_except_batch(torch.log(torch.broadcast_to(scale, x.shape)))

    def inverse(self, z, clean=None, iso=None):
        return z * self._scale(clean, iso)


class SignalDependantNS(Bijector):
    """Neural-spline signal-dependent bijector: an RQ spline with linear
    tails whose per-pixel, per-channel bins come from ``net2(relu(net1(
    clean)))``; ``net1`` is a 3x3 conv (flax's default init), ``net2`` a
    zero-init 1x1 conv to ``C * (3K - 1)`` channels, split per channel
    into K widths, K heights (both scaled by ``1/sqrt(hidden)``) and K-1
    derivatives (reference signal_dependant.py:131-258)."""

    def __init__(self, num_channels: int = 4, num_bins: int = 10, tail_bound: float = 1.0,
                 hidden: int = 16, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_channels, self.num_bins = num_channels, num_bins
        self.tail_bound, self.hidden = tail_bound, hidden
        self.mult = num_bins * 3 - 1  # linear tails
        self.net1 = nn.Conv2d(num_channels, hidden, 3, padding=1)
        self.net2 = nn.Conv2d(hidden, num_channels * self.mult, 1)
        lecun_normal_(self.net1.weight, generator)
        with torch.no_grad():
            for t in (self.net1.bias, self.net2.weight, self.net2.bias):
                t.zero_()
        # JAX's 1 / jnp.sqrt(hidden), in float32
        self._scale = float(1.0 / torch.sqrt(torch.tensor(float(hidden))))

    def _params(self, clean):
        p = self.net2(F.relu(self.net1(clean)))  # [n, C*mult, H, W]
        n, _, H, W = p.shape
        # channel c*mult + m of the conv -> [n, C, H, W, mult]
        p = p.reshape(n, self.num_channels, self.mult, H, W).permute(0, 1, 3, 4, 2)
        K = self.num_bins
        return p[..., :K] * self._scale, p[..., K:2 * K] * self._scale, p[..., 2 * K:]

    def forward_ldj(self, x, clean=None, iso=None, train: bool = False):
        w, h, d = self._params(clean)
        z, ladj = unconstrained_rational_quadratic_spline(
            x, w, h, d, inverse=False, tail_bound=self.tail_bound)
        return z, sum_except_batch(ladj)

    def inverse(self, z, clean=None, iso=None):
        w, h, d = self._params(clean)
        x, _ = unconstrained_rational_quadratic_spline(
            z, w, h, d, inverse=True, tail_bound=self.tail_bound)
        return x


class GainISO(Bijector):
    """``scale = exp(cam_param(iso) * gain_params) * iso`` (reference
    gain.py:65-110); both parameters train."""

    def __init__(self):
        super().__init__()
        self.register_buffer("legal_iso", torch.from_numpy(LEGAL_ISO), persistent=False)
        self.cam_param = nn.Parameter(torch.zeros(len(LEGAL_ISO)))
        self.gain_params = nn.Parameter(torch.tensor(-5.0))

    def _scale(self, iso):
        cp = _interp_iso(self.legal_iso, self.cam_param, iso)
        return torch.exp(cp * self.gain_params) * _iso_tensor(iso, self.cam_param)

    def _scale_as(self, x, iso):
        scale = self._scale(iso)
        return scale.reshape(scale.shape + (1,) * (x.dim() - scale.dim()))

    def forward_ldj(self, x, clean=None, iso=None, train: bool = False):
        scale = torch.broadcast_to(self._scale_as(x, iso), x.shape)
        return x / scale, -sum_except_batch(torch.log(scale))

    def inverse(self, z, clean=None, iso=None):
        return z * self._scale_as(z, iso)
