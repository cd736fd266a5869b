"""PNNP proxy network ``pw_iso_2stage`` (counterpart of
``pnnp_tpu/models/proxy.py``; the reference ships only its config,
runfiles/SonyA7S2/PNNP.yml:47-59, and its call contract
``proxy_net.sample(clean, iso) -> noise``, trainer_SID.py:463-472).

Physics where physics is exact, a learned law for the dark noise only:
  * shot noise is exact Poisson with system gain
    ``K(iso) = ISO2K[0]*iso + ISO2K[1]``;
  * stage 1, the pixel proxy: a learned inverse CDF on ``d`` uniform
    probability bins plus a Laplace tail (:class:`QuantileHead`),
    conditioned on ISO by an MLP (``nb`` hidden layers of width ``nf``,
    swish); it trains by maximum likelihood on dark noise;
  * stage 2 (mode '2stage'), the row proxy: the same head, one draw per
    (row, channel), broadcast along the row (banding).

Layout is NCHW, the port's: images ``[n, c, h, w]``, a row is a mean over
``w`` (dim 3), row draws are ``[n, c, h, 1]``. ``iso`` is a scalar or a
per-example ``[n]`` tensor. Every draw comes from the ``torch.Generator``
passed in, on its device. Parameter names follow the flax tree
(``pixel_stage.fc0``, ..., ``pixel_stage.bins``, ``row_stage.*``), so
``models/convert.py::params_from_jax`` loads a JAX checkpoint as it is.
The proxy computes in float32.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from pnnp_tpu_torch.kernels import proxy_core
from pnnp_tpu_torch.ops.poisson import poisson_sample
from pnnp_tpu_torch.utils.profiling import count

_SQ2 = math.sqrt(2.0)
_LOG2 = math.log(2.0)
_RSQ2 = 1.0 / _SQ2
_SQPI = math.sqrt(math.pi)
# bins narrower than this many ``s`` take their Gaussian-convolved mass from
# a midpoint series, not from a difference of CDFs (see _core_conv)
NARROW_BIN = 0.05
# Element budget of one chunk of the Gaussian-convolved density's
# [n, pixels, d+1] intermediates (64 Mi float32 = 256 MiB each): at the
# recipe's 512^2 crops and d=1024 an unchunked pixel NLL would hold several
# 4.3 GB tensors per example for autograd.
CONV_CHUNK_ELEMS = 1 << 26


class HeadParams(NamedTuple):
    """Per-example distribution parameters emitted by :class:`QuantileHead`."""

    knots: torch.Tensor      # [n, d+1] monotone PWL quantile knots (ADU)
    log_scale: torch.Tensor  # [n, 1] log support half-width
    tail_pi: torch.Tensor    # [n, 1] Laplace tail mixture weight in (0, 1)
    tail_b: torch.Tensor     # [n, 1] Laplace tail scale (ADU)


def lecun_normal_(weight: torch.Tensor, generator: Optional[torch.Generator]) -> None:
    """flax's default Dense and Conv kernel init: a normal truncated to +-2
    std with variance 1/fan_in after truncation (``variance_scaling(1,
    'fan_in', 'truncated_normal')``); ``weight`` is torch's ``[out, in]``
    or ``[out, in, kh, kw]`` (fan_in ``in * kh * kw``)."""
    std = math.sqrt(1.0 / weight[0].numel()) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, std=std, a=-2.0 * std, b=2.0 * std,
                              generator=generator)


class QuantileHead(nn.Module):
    """ISO-conditioned monotone PWL quantile core + Laplace mixture tail.

    ``p(x) = (1-pi) * p_pwl(x) + pi * Laplace(x; mu, b)`` with ``p_pwl`` the
    piecewise-constant density of a learned inverse CDF on ``d`` uniform
    probability bins and ``mu`` the support midpoint. The tail keeps
    maximum-likelihood training stable on heavy-tailed dark noise: samples
    outside the support get a bounded log-density from the Laplace part
    instead of dragging the support scale outward.
    """

    # learned support half-width (ADU): starts at e^2 ~ 7.4, kept in
    # [e^-2, e^6]; tail weight starts at sigmoid(-2.5) ~ 7.6%, tail scale at
    # e^2 ADU, kept in [e^-2, e^8]
    LOG_SCALE_INIT = 2.0
    LOG_SCALE_RANGE = (-2.0, 6.0)
    TAIL_LOGIT_INIT = -2.5
    LOG_TAIL_RANGE = (-2.0, 8.0)

    def __init__(self, d: int = 1024, nf: int = 16, nb: int = 2, in_features: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.d, self.nf, self.nb = d, nf, nb
        for i in range(nb):
            self.add_module(f"fc{i}", nn.Linear(in_features if i == 0 else nf, nf))
        # d bin heights + log support scale + tail logit + log tail scale
        self.bins = nn.Linear(nf if nb else in_features, d + 3)
        for layer in self.children():
            lecun_normal_(layer.weight, generator)
            nn.init.zeros_(layer.bias)

    def forward(self, iso_feat: torch.Tensor, log_anchor: Optional[torch.Tensor] = None,
                return_raw: bool = False):
        """iso_feat [n, f] -> HeadParams, or with ``return_raw`` the raw MLP
        output [n, d+3] (the ISO-curvature penalty's coordinates).

        ``log_anchor`` [n, 1] (optional): an additive shift of the support and
        tail log-scales, e.g. ``log(K(iso)/K(1600))`` ('+anchor' mode)."""
        h = iso_feat
        for i in range(self.nb):
            h = F.silu(getattr(self, f"fc{i}")(h))
        raw = self.bins(h)
        if return_raw:
            return raw
        return self.from_raw(raw, 0.0 if log_anchor is None else log_anchor)

    @classmethod
    def from_raw(cls, raw: torch.Tensor, shift=0.0) -> HeadParams:
        """HeadParams from the raw head output [n, d+3] (the MLP's, or a
        directly fitted one as the oracle tools fit): softmax bin heights,
        clamped log-scales (plus ``shift``) and the sigmoid tail weight."""
        d = raw.shape[-1] - 3
        heights = torch.softmax(raw[..., :d], dim=-1)
        log_scale = torch.clamp(raw[..., d:d + 1] + cls.LOG_SCALE_INIT + shift,
                                *cls.LOG_SCALE_RANGE)
        tail_pi = torch.sigmoid(raw[..., d + 1:d + 2] + cls.TAIL_LOGIT_INIT)
        tail_b = torch.exp(torch.clamp(raw[..., d + 2:d + 3] + cls.LOG_SCALE_INIT + shift,
                                       *cls.LOG_TAIL_RANGE))
        # monotone knots on [-1, 1], scaled: v_k = scale * (2*cum_k - 1)
        cum = torch.cumsum(heights, dim=-1)
        cum = torch.cat([torch.zeros_like(cum[..., :1]), cum], dim=-1)
        knots = torch.exp(log_scale) * (2.0 * cum - 1.0)
        return HeadParams(knots, log_scale, tail_pi, tail_b)

    @staticmethod
    def _mix_tail(hp: HeadParams, u, u_choice, core):
        """Mix the PWL ``core`` draw with the Laplace tail (prob ``tail_pi``,
        chosen by ``u_choice``; the tail draw reuses the same ``u``)."""
        knots = hp.knots
        bshape = (u.shape[0],) + (1,) * (u.dim() - 1)
        mu = (0.5 * (knots[:, 0] + knots[:, -1])).reshape(bshape)
        b = hp.tail_b.reshape(bshape)
        pi = hp.tail_pi.reshape(bshape)
        # Laplace inverse CDF on v = u - 1/2 (clipped away from +-1/2)
        v = torch.clamp(u - 0.5, -0.5 + 1e-7, 0.5 - 1e-7)
        lap = mu - b * torch.sign(v) * torch.log1p(-2.0 * torch.abs(v))
        return torch.where(u_choice < pi, lap, core)

    @staticmethod
    def _lerp(knots, u):
        d = knots.shape[-1] - 1
        t = u * d
        k = t.to(torch.int32).clamp(0, d - 1)
        frac = t - k
        kf = k.reshape(k.shape[0], -1).long()
        lo = torch.gather(knots, 1, kf).reshape(u.shape)
        hi = torch.gather(knots, 1, kf + 1).reshape(u.shape)
        return lo + frac * (hi - lo)

    @staticmethod
    def quantile(hp: HeadParams, u, u_choice=None):
        """Draw from the mixture: the PWL inverse CDF at ``u``, or (with prob
        ``tail_pi``, chosen by ``u_choice``) a Laplace draw from the same
        ``u``. ``u_choice=None`` draws the core only."""
        core = QuantileHead._lerp(hp.knots, u)
        if u_choice is None:
            return core
        return QuantileHead._mix_tail(hp, u, u_choice, core)

    @staticmethod
    def quantile_dot(hp: HeadParams, u, u_choice=None):
        """:meth:`quantile` on bf16-rounded knots: the JAX package's
        ``lookup='dot'`` law exactly. JAX looks the knots up by a bf16
        one-hot matmul accumulated in f32; one-hot rows are exact, so each
        looked-up knot is ``float(bf16(knot))``. Here that is a gather, with
        no one-hot (17 GB of bf16 at the recipe shape). The tail's ``mu``
        still comes from the f32 knots, as in JAX."""
        core = QuantileHead._lerp(hp.knots.to(torch.bfloat16).float(), u)
        if u_choice is None:
            return core
        return QuantileHead._mix_tail(hp, u, u_choice, core)

    @staticmethod
    def mean(hp: HeadParams):
        """Closed-form mean of the PWL+Laplace mixture, [n, 1] (ADU)."""
        v = hp.knots
        m1_core = torch.mean(0.5 * (v[:, :-1] + v[:, 1:]), dim=-1, keepdim=True)
        mu = 0.5 * (v[:, :1] + v[:, -1:])
        return (1.0 - hp.tail_pi) * m1_core + hp.tail_pi * mu

    @staticmethod
    def center(hp: HeadParams) -> HeadParams:
        """Shift the law so its mixture mean is exactly zero: the mean is
        linear in the knots, so one subtraction zeroes it. Dark read noise
        after black-level subtraction is zero-mean by calibration, and a
        location drift the likelihood barely sees becomes a brightness bias
        after ratio amplification (see the JAX module)."""
        return hp._replace(knots=hp.knots - QuantileHead.mean(hp))

    @staticmethod
    def variance(hp: HeadParams):
        """Closed-form variance of the PWL+Laplace mixture, [n, 1] (ADU^2):
        exact segment sums for the PWL core, mu and 2 b^2 for the tail."""
        v = hp.knots
        lo, hi = v[:, :-1], v[:, 1:]
        m1_core = torch.mean(0.5 * (lo + hi), dim=-1, keepdim=True)
        m2_core = torch.mean((lo * lo + lo * hi + hi * hi) / 3.0, dim=-1, keepdim=True)
        mu = 0.5 * (v[:, :1] + v[:, -1:])
        pi = hp.tail_pi
        m1 = (1.0 - pi) * m1_core + pi * mu
        m2 = (1.0 - pi) * m2_core + pi * (mu * mu + 2.0 * hp.tail_b ** 2)
        return torch.clamp_min(m2 - m1 * m1, 0.0)

    @staticmethod
    def _core_conv(knots, x, s):
        """PWL core density convolved with N(0, s^2): knots [n, 1, d+1],
        x and s [n, m, 1] -> [n, m].

        A bin's mass is ``Phi(z_{k+1}) - Phi(z_k)``, computed so that f32
        keeps its digits: from the smaller tail ``T(z) = erfc(|z|/sqrt2)/2``
        of each knot (a bin on one side of x is a difference of two small,
        exactly rounded tails, not of two CDFs near 1 or of ``1 + erf``
        near 0), and, where the bin is narrow against ``s`` (``h = width /
        s`` below :data:`NARROW_BIN`, where even that difference keeps few
        digits: a 1e-3 ADU bin under s ~ 1 ADU loses a few percent), the
        bin's density ``mass / width`` from the midpoint series
        ``phi(m) / s * (1 + (m^2 - 1) h^2 / 24)``, accurate to ``h^4``
        (and its gradient free of the ``1/width`` terms that cancel). The
        JAX package takes the plain difference of ``ndtr`` values, divided
        by the width floored at 1e-8; the two agree wherever that keeps its
        digits.

        In the code ``r = z / sqrt2``, ``e = erfc(|r|) = 2 T(z)`` and
        ``m2 = m^2 / 2``, which saves passes over the ``[n, m, d+1]``
        intermediates."""
        d = knots.shape[-1] - 1
        inv = _RSQ2 / s                                          # 1 / (s sqrt2)
        r = torch.addcmul(-x * inv, knots, inv)                  # [n, m, d+1]
        e = torch.special.erfc(torch.abs(r))
        ra, rb, ea, eb = r[..., :-1], r[..., 1:], e[..., :-1], e[..., 1:]
        diff = ea - eb
        mass2 = torch.where(ra >= 0, diff, torch.where(rb <= 0, -diff, 2.0 - ea - eb))
        width = knots[..., 1:] - knots[..., :-1]
        h = width * (_SQ2 * inv)                                 # width / s
        hs2 = torch.square(torch.clamp_max(h, NARROW_BIN)) / 24.0  # finite unused branch
        m2 = torch.square(0.5 * (ra + rb))
        narrow = torch.exp(-m2) * (inv / _SQPI) * (1.0 + (2.0 * m2 - 1.0) * hs2)
        dens = torch.where(h < NARROW_BIN, narrow,
                           mass2 / (2.0 * torch.clamp_min(width, 1e-8)))
        return torch.sum(dens, dim=-1) / d

    @staticmethod
    def log_prob_conv_gaussian(hp: HeadParams, x, s, chunk: Optional[int] = None):
        """Exact log-density of (mixture convolved with N(0, s^2)) at x.

        The PWL core convolves to a sum over the d bins of
        ``(Phi((v_{k+1}-x)/s) - Phi((v_k-x)/s)) / (d * width_k)``
        (:meth:`_core_conv`, which keeps f32's digits where bins are narrow); the
        Laplace tail to the two-sided exponentially modified Gaussian,
        evaluated through ``log_ndtr`` so large ``s`` stays finite. ``s``
        broadcasts against ``x``; s -> 0 recovers :meth:`log_prob`.

        On float32 CUDA tensors whose ``x`` and ``s`` do not require grad
        the core is the fused kernels' (:mod:`pnnp_tpu_torch.kernels.proxy_core`,
        the same law; the knots' gradient only). Elsewhere (the CPU, float64
        on the card too) it is evaluated ``chunk`` pixels per example at a
        time (default: :data:`CONV_CHUNK_ELEMS` elements per chunk); with
        autograd on, each chunk's backward recomputes its forward instead of
        keeping the ``[n, chunk, d+1]`` intermediates.
        """
        knots = hp.knots
        n, d = knots.shape[0], knots.shape[-1] - 1
        # a number becomes a fill on x's device, not a copy from the host
        # (which would sync, and a CUDA graph cannot capture a sync)
        s_in = (s.to(dtype=x.dtype, device=x.device) if isinstance(s, torch.Tensor)
                else torch.full((), s, dtype=x.dtype, device=x.device))
        s = torch.clamp_min(torch.broadcast_to(s_in, x.shape), 1e-12)
        xe, se = x.reshape(n, -1, 1), s.reshape(n, -1, 1)
        if proxy_core.routes(knots, x, s_in):
            # one s per example where the input shows it (a broadcast view)
            s_ex = torch.broadcast_to(s_in, x.shape).reshape(n, -1)
            s_k = torch.clamp_min(s_ex[:, :1], 1e-12) if s_ex.stride(1) == 0 else se[..., 0]
            core = proxy_core.core_conv(knots, xe[..., 0], s_k)
        else:
            m = xe.shape[1]
            if chunk is None:
                chunk = max(1, CONV_CHUNK_ELEMS // (n * (d + 1)))
            kn = knots[:, None, :]
            recompute = torch.is_grad_enabled() and knots.requires_grad and m > chunk
            parts = []
            for a in range(0, m, chunk):
                args = (kn, xe[:, a:a + chunk], se[:, a:a + chunk])
                parts.append(checkpoint(QuantileHead._core_conv, *args, use_reentrant=False,
                                        preserve_rng_state=False)
                             if recompute else QuantileHead._core_conv(*args))
            count("proxy.chunks", len(parts))
            core = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        # density floor 1e-10 (lp ~ -23): far outside the support the core
        # underflows and the log's 1/core would overflow the backward; the
        # floor gives those samples a zero core cotangent (the tail owns them)
        lp_core = torch.log(torch.clamp_min(core, 1e-10))

        xe, se = xe[..., 0], se[..., 0]
        mu = 0.5 * (knots[:, :1] + knots[:, -1:])
        b = hp.tail_b
        pi = torch.clamp(hp.tail_pi, 1e-5, 1.0 - 1e-5)
        t = (xe - mu) / b
        r = se / (b * _SQ2)
        u = (xe - mu) / (se * _SQ2)
        log_erfc_rpu = _LOG2 + torch.special.log_ndtr(-(r + u) * _SQ2)
        log_erfc_rmu = _LOG2 + torch.special.log_ndtr(-(r - u) * _SQ2)
        lp_tail = (-torch.log(4.0 * b) + r * r
                   + torch.logaddexp(t + log_erfc_rpu, -t + log_erfc_rmu))
        out = torch.logaddexp(torch.log1p(-pi) + lp_core, torch.log(pi) + lp_tail)
        return out.reshape(x.shape)

    @staticmethod
    def log_prob(hp: HeadParams, x):
        """Exact log-density of the PWL+Laplace mixture at x (ADU)."""
        knots = hp.knots
        n, d = knots.shape[0], knots.shape[-1] - 1
        xs = x.reshape(n, -1)
        mu = 0.5 * (knots[:, :1] + knots[:, -1:])
        b = hp.tail_b.reshape(n, 1)
        pi = torch.clamp(hp.tail_pi.reshape(n, 1), 1e-5, 1.0 - 1e-5)
        idx = (torch.searchsorted(knots.detach().contiguous(), xs.contiguous(), right=True)
               - 1).clamp(0, d - 1)
        width = torch.clamp_min(torch.gather(knots, 1, idx + 1)
                                - torch.gather(knots, 1, idx), 1e-8)
        inside = (xs >= knots[:, :1]) & (xs <= knots[:, -1:])
        lp_core = torch.where(inside, -torch.log(d * width), -1e30)
        lp_tail = -torch.log(2.0 * b) - torch.abs(xs - mu) / b
        out = torch.logaddexp(torch.log1p(-pi) + lp_core, torch.log(pi) + lp_tail)
        return out.reshape(x.shape)


class PixelWiseISOProxy(nn.Module):
    """``pw_iso_2stage``: physics shot + learned pixel/row dark-noise proxies.

    Fields and defaults are the JAX module's; see it for the measurements
    behind each: ``lookup`` ('dot': :meth:`QuantileHead.quantile_dot`, or
    'gather'), ``smooth_s0`` (the pixel law is the mixture convolved with
    N(0, s0^2), in the NLL and in sampling; 0 restores the raw PWL NLL),
    ``contam`` (row deconvolution variance from the pixel 'model' or the
    batch, 'empirical'), ``smooth_iso_w`` / ``smooth_iso_grid`` (opt-in
    ISO-curvature penalty), ``zero_mean`` (:meth:`QuantileHead.center` on
    both heads).

    ``data_mean``: set by the data-parallel noise step
    (:func:`~pnnp_tpu_torch.parallel.bind_data_group`), see
    :meth:`_weight_total`.
    """

    data_mean = None

    def __init__(self, iso2k: Sequence[float] = (0.0009546, -0.00193), nf: int = 16,
                 nb: int = 2, d: int = 1024, mode: str = "2stage+iso",
                 wp: float = 16383.0, bl: float = 512.0, lookup: str = "dot",
                 smooth_s0: float = 0.3, contam: str = "model",
                 smooth_iso_w: float = 0.0,
                 smooth_iso_grid: Sequence[float] = (
                     800.0, 1131.4, 1600.0, 2262.7, 3200.0, 4525.5, 6400.0, 9050.9,
                     12800.0),
                 zero_mean: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.iso2k = tuple(float(v) for v in iso2k)
        self.nf, self.nb, self.d, self.mode = nf, nb, d, mode
        self.wp, self.bl = float(wp), float(bl)
        self.lookup, self.smooth_s0, self.contam = lookup, float(smooth_s0), contam
        self.smooth_iso_w = float(smooth_iso_w)
        self.smooth_iso_grid = tuple(float(v) for v in smooth_iso_grid)
        self.zero_mean = zero_mean
        feat = 2 if "iso" in mode else 1
        self.pixel_stage = QuantileHead(d, nf, nb, feat, generator)
        self.row_stage = (QuantileHead(d, nf, nb, feat, generator)
                          if "2stage" in mode else None)

    def _iso_feat(self, iso) -> torch.Tensor:
        """Normalized ISO features: [K(iso), log-ISO] (the '+iso' conditioning)."""
        w = self.pixel_stage.bins.weight
        iso = torch.atleast_1d(torch.as_tensor(iso, dtype=w.dtype, device=w.device))
        k = self.iso2k[0] * iso + self.iso2k[1]
        if "iso" in self.mode:
            return torch.stack([k, torch.log(iso / 1600.0)], dim=-1)
        return k[:, None]

    def heads(self, iso, n: int):
        """(features [n, f], pixel HeadParams, row HeadParams or None)."""
        feat = self._iso_feat(iso)
        feat = torch.broadcast_to(feat, (n, feat.shape[-1]))
        log_anchor = None
        if "anchor" in self.mode:  # opt-in; measured worse held-out (JAX module)
            k1600 = self.iso2k[0] * 1600.0 + self.iso2k[1]
            log_anchor = torch.log(feat[:, :1] / k1600)
        hp_px = self.pixel_stage(feat, log_anchor)
        hp_row = self.row_stage(feat, log_anchor) if self.row_stage is not None else None
        if self.zero_mean:
            hp_px = QuantileHead.center(hp_px)
            hp_row = QuantileHead.center(hp_row) if hp_row is not None else None
        return feat, hp_px, hp_row

    def forward(self, clean, iso, generator: Optional[torch.Generator] = None,
                mode: str = "sample", weight=None):
        """mode='sample' -> noise draw (needs ``generator``); mode='loss' ->
        (nll, aux). ``weight`` (loss mode): a per-pixel 0/1 (or soft) mask,
        the NLL is fitted where it is set; the heads model signal-independent
        dark noise (sampling re-adds exact Poisson shot), so residuals of
        paired data are masked to dark pixels."""
        feat, hp_px, hp_row = self.heads(iso, clean.shape[0])
        if mode == "sample":
            return self._sample(generator, clean, feat, hp_px, hp_row)
        nll, aux = self._loss(clean, hp_px, hp_row, weight)
        if self.smooth_iso_w > 0:
            pen = self._iso_curvature()
            nll = nll + self.smooth_iso_w * pen
            aux = dict(aux, iso_curvature=pen)
        return nll, aux

    def _iso_curvature(self):
        """Mean-square second difference of the heads' raw outputs along the
        (uniform in log-ISO) ``smooth_iso_grid``."""
        feat_g = self._iso_feat(self.smooth_iso_grid)

        def curv(head):
            raw = head(feat_g, return_raw=True)              # [G, d+3]
            hl = raw[:, :self.d]
            hl = hl - torch.mean(hl, dim=-1, keepdim=True)   # softmax gauge
            y = torch.cat([hl, raw[:, self.d:]], dim=-1)
            d2 = y[2:] - 2.0 * y[1:-1] + y[:-2]
            return torch.mean(d2 ** 2)

        pen = curv(self.pixel_stage)
        if self.row_stage is not None:
            pen = pen + curv(self.row_stage)
        return pen

    def _sample(self, generator, clean, feat, hp_px, hp_row):
        if generator is None:
            raise ValueError("sampling needs a torch.Generator")
        g = generator
        n, c, h, _ = clean.shape
        span = self.wp - self.bl
        K = feat[:, 0].reshape(n, 1, 1, 1)
        clean_adu = torch.clamp_min(clean, 0.0) * span
        shot = poisson_sample(g, clean_adu / torch.clamp_min(K, 1e-6)) * K - clean_adu

        def uniform(shape, lo=0.0, hi=1.0):
            return torch.rand(shape, generator=g, device=g.device) * (hi - lo) + lo

        u_px = uniform(clean.shape, 1e-6, 1 - 1e-6)
        c_px = uniform(clean.shape)
        qfn = QuantileHead.quantile_dot if self.lookup == "dot" else QuantileHead.quantile
        total = shot + qfn(hp_px, u_px, c_px)
        if self.smooth_s0 > 0:
            # the pixel law is (mixture conv N(0, s0)): the matching normal
            total = total + self.smooth_s0 * torch.randn(clean.shape, generator=g,
                                                         device=g.device)
        if hp_row is not None:
            u_row = uniform((n, c, h, 1), 1e-6, 1 - 1e-6)
            c_row = uniform((n, c, h, 1))
            total = total + QuantileHead.quantile(hp_row, u_row, c_row)
        return total / span

    def _loss(self, noise, hp_px, hp_row, weight=None):
        """NLL of observed noise (ADU), split into row + pixel components.

        The row component is the per-(row, channel) (weighted) mean; the
        pixel head models the residual, scaled by sqrt(W/(W-1)). The row NLL
        scores the row means under the row law convolved with the
        contamination Gaussian of the pixel noise's own mean (variance
        var_px / W, no gradient), so the row head learns the deconvolved
        law. In 1-stage mode the pixel head models the full noise."""
        span = self.wp - self.bl
        x = noise * span
        w = (torch.ones_like(x) if weight is None
             else torch.broadcast_to(weight.to(x.dtype), x.shape))
        if hp_row is not None:
            wsum_row = torch.clamp_min(torch.sum(w, dim=3, keepdim=True), 1e-6)
            row_mean = torch.sum(x * w, dim=3, keepdim=True) / wsum_row
            resid = (x - row_mean) * torch.sqrt(
                wsum_row / torch.clamp_min(wsum_row - 1.0, 1.0))
        else:
            row_mean, resid = None, x
        if self.smooth_s0 > 0:
            lp_px = QuantileHead.log_prob_conv_gaussian(hp_px, resid, self.smooth_s0)
        else:
            lp_px = QuantileHead.log_prob(hp_px, resid)
        nll_px = -torch.sum(lp_px * w) / self._weight_total(w)
        if hp_row is not None:
            n = x.shape[0]
            if self.contam == "empirical":
                # the batch's own pixel variance: resid is already the
                # sqrt(W/(W-1))-corrected residual
                var_px = (torch.sum(resid ** 2 * w, dim=(1, 2, 3), keepdim=True)
                          / torch.clamp_min(torch.sum(w, dim=(1, 2, 3), keepdim=True),
                                            1.0)).detach()
            else:
                # the pixel law's variance, with the s0 smoothing sampling adds
                var_px = (QuantileHead.variance(hp_px).detach().reshape(n, 1, 1, 1)
                          + self.smooth_s0 ** 2)
            s_contam = torch.sqrt(var_px / wsum_row)
            lp_row = QuantileHead.log_prob_conv_gaussian(hp_row, row_mean, s_contam)
            w_rows = torch.mean(w, dim=3, keepdim=True)
            nll_row = -torch.sum(lp_row * w_rows) / self._weight_total(w_rows)
        else:
            nll_row = torch.zeros((), device=x.device)
        # the row term weighs by its share of draws (one per row of W pixels)
        w_row = 1.0 / max(noise.shape[3], 1)
        return nll_px + w_row * nll_row, {"nll_px": nll_px, "nll_row": nll_row}

    def _weight_total(self, w):
        """The denominator of a masked mean: the weights' sum, or with
        ``data_mean`` set (the data-parallel step) the data group's mean of
        the ranks' sums, so that the ranks' mean loss is the global batch's
        masked mean."""
        total = torch.sum(w)
        if self.data_mean is not None:
            total = self.data_mean(total)
        return torch.clamp_min(total, 1e-6)

    def sample(self, clean, iso, generator: torch.Generator):
        return self(clean, iso, generator=generator, mode="sample")

    def loss(self, noise, iso, weight=None):
        return self(noise, iso, mode="loss", weight=weight)
