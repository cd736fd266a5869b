"""The PNNP noise proxy ``pw_iso_2stage`` (PNNP, arXiv:2310.09126; the
runfiles' ``arch_proxy``), in plain PyTorch on a dict of parameters.

Each of the two stages (pixel, row) is an MLP on the ISO features
``[K(ISO), log(ISO / 1600)]`` (``K = ISO2K[0] * ISO + ISO2K[1]``): ``nb``
hidden layers of width ``nf`` with swish, then ``d + 3`` outputs. They give
a law of the dark noise in ADU: with probability ``1 - pi`` a piecewise
uniform law on ``d`` equal-probability bins whose knots are the scaled
cumulative softmax of the first ``d`` outputs over a support of half-width
``exp(clamp(raw + 2, -2, 6))``, with probability ``pi = sigmoid(raw - 2.5)``
a Laplace law of scale ``exp(clamp(raw + 2, -2, 8))`` at the support's
midpoint; the law is shifted to mean zero. The pixel law is the mixture
convolved with N(0, s0^2), s0 = 0.3 ADU.

The NLL of a dark frame (``(lr - hr) / ratio`` in [0, 1] units, masked to
pixels whose clean signal is under 2 ADU) splits each (row, channel) into
its mean and the residual, scaled by sqrt(W / (W - 1)): the residual is
scored under the pixel law, the row means under the row law convolved with
the Gaussian of the pixel noise's own mean (variance ``var_px / W``), and
the row term is weighted 1 / W. The PNNP paper describes the pixel and row
proxies and their ISO conditioning; the bin law, the tail, s0 and the
split are the PNNP code's (the paper gives no equations for them), and the
floor of 1e-10 on the core density (the tail owns the far pixels) is the
code's too.

The Gaussian-convolved bin masses are differences of normal tails, taken on
the side of the smaller tail; a bin of zero width contributes its point
mass. The reference runs this in float64 by default.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

LOG_SCALE_INIT, LOG_SCALE_RANGE = 2.0, (-2.0, 6.0)
TAIL_LOGIT_INIT, LOG_TAIL_RANGE = -2.5, (-2.0, 8.0)
SMOOTH_S0 = 0.3
DARK_THRESH = 2.0
# elements of one chunk of the [pixels, d + 1] core intermediates
CHUNK_ELEMS = 1 << 24


def param_shapes(d: int = 1024, nf: int = 16, nb: int = 2, n_feat: int = 2) -> dict:
    """``"<stage>.<layer>.weight" / ".bias" -> shape`` (``[out, in]``)."""
    out = {}
    for stage in ("pixel_stage", "row_stage"):
        fan_in = n_feat
        for i in range(nb):
            out[f"{stage}.fc{i}.weight"] = (nf, fan_in)
            out[f"{stage}.fc{i}.bias"] = (nf,)
            fan_in = nf
        out[f"{stage}.bins.weight"] = (d + 3, fan_in)
        out[f"{stage}.bins.bias"] = (d + 3,)
    return out


def iso_features(iso, iso2k) -> torch.Tensor:
    iso = torch.as_tensor(iso, dtype=torch.float64).reshape(-1)
    return torch.stack([iso2k[0] * iso + iso2k[1], torch.log(iso / 1600.0)], dim=-1)


def head(params: dict, stage: str, feat: torch.Tensor, nb: int = 2) -> dict:
    """The law of one stage at the features ``feat`` [n, 2]: knots
    [n, d + 1], tail weight ``pi``, tail scale ``b``, midpoint ``mu`` (each
    [n, 1]), mean zero."""
    h = feat.to(params[f"{stage}.bins.weight"].dtype)
    for i in range(nb):
        h = F.silu(h @ params[f"{stage}.fc{i}.weight"].T + params[f"{stage}.fc{i}.bias"])
    raw = h @ params[f"{stage}.bins.weight"].T + params[f"{stage}.bins.bias"]
    d = raw.shape[-1] - 3
    cum = torch.cumsum(torch.softmax(raw[:, :d], dim=-1), dim=-1)
    cum = torch.cat([torch.zeros_like(cum[:, :1]), cum], dim=-1)
    scale = torch.exp(torch.clamp(raw[:, d:d + 1] + LOG_SCALE_INIT, *LOG_SCALE_RANGE))
    knots = scale * (2.0 * cum - 1.0)
    pi = torch.sigmoid(raw[:, d + 1:d + 2] + TAIL_LOGIT_INIT)
    b = torch.exp(torch.clamp(raw[:, d + 2:d + 3] + LOG_SCALE_INIT, *LOG_TAIL_RANGE))
    mean = (1.0 - pi) * torch.mean(0.5 * (knots[:, :-1] + knots[:, 1:]), dim=-1,
                                   keepdim=True) + pi * 0.5 * (knots[:, :1] + knots[:, -1:])
    knots = knots - mean
    return {"knots": knots, "pi": pi, "b": b, "mu": 0.5 * (knots[:, :1] + knots[:, -1:])}


def variance(law: dict) -> torch.Tensor:
    """Variance [n, 1] (ADU^2) of the mixture (before the s0 smoothing)."""
    v, pi, mu = law["knots"], law["pi"], law["mu"]
    lo, hi = v[:, :-1], v[:, 1:]
    m1 = torch.mean(0.5 * (lo + hi), dim=-1, keepdim=True)
    m2 = torch.mean((lo * lo + lo * hi + hi * hi) / 3.0, dim=-1, keepdim=True)
    e1 = (1.0 - pi) * m1 + pi * mu
    e2 = (1.0 - pi) * m2 + pi * (mu * mu + 2.0 * law["b"] ** 2)
    return e2 - e1 * e1


def _upper(z):
    return 0.5 * torch.special.erfc(z / math.sqrt(2.0))


def _core(knots, x, s):
    """Bin law convolved with N(0, s^2): knots [1, d + 1], x and s [m, 1]."""
    d = knots.shape[-1] - 1
    z = (knots - x) / s                                  # [m, d + 1]
    za, zb = z[:, :-1], z[:, 1:]
    ta, tb = _upper(za.abs()), _upper(zb.abs())           # the smaller tails
    mass = torch.where(za >= 0, ta - tb, torch.where(zb <= 0, tb - ta, 1.0 - ta - tb))
    width = knots[:, 1:] - knots[:, :-1]
    zm = 0.5 * (za + zb)
    point = torch.exp(-0.5 * zm * zm) / (math.sqrt(2.0 * math.pi) * s)
    safe = torch.where(width > 0, width, torch.ones_like(width))
    dens = torch.where(width > 0, mass / safe, point)
    return torch.sum(dens, dim=-1) / d


def log_prob_conv(law: dict, i: int, x: torch.Tensor, s: torch.Tensor,
                  core_dtype=None) -> torch.Tensor:
    """Log-density of example ``i``'s law convolved with N(0, s^2) at the
    flat values ``x`` (``s`` broadcast to ``x``), chunked over ``x``; the
    bin law in ``core_dtype`` where one is given (the control)."""
    knots = law["knots"][i:i + 1]
    core_fn = _core if core_dtype is None else (
        lambda k, a, b: _core(k.to(core_dtype), a.to(core_dtype), b.to(core_dtype)).to(k.dtype))
    d = knots.shape[-1] - 1
    xe, se = x.reshape(-1, 1), torch.broadcast_to(s, x.shape).reshape(-1, 1)
    step = max(1, CHUNK_ELEMS // (d + 1))
    grad = torch.is_grad_enabled() and knots.requires_grad
    parts = []
    for a in range(0, xe.shape[0], step):
        args = (knots, xe[a:a + step], se[a:a + step])
        parts.append(checkpoint(core_fn, *args, use_reentrant=False) if grad
                     else core_fn(*args))
    core = torch.cat(parts)
    mu, b = law["mu"][i], law["b"][i]
    pi = torch.clamp(law["pi"][i], 1e-5, 1.0 - 1e-5)
    xf, sf = xe[:, 0], se[:, 0]
    t = (xf - mu) / b
    r = sf / (b * math.sqrt(2.0))
    u = (xf - mu) / (sf * math.sqrt(2.0))
    log_erfc = lambda z: math.log(2.0) + torch.special.log_ndtr(-z * math.sqrt(2.0))
    lp_tail = (-torch.log(4.0 * b) + r * r
               + torch.logaddexp(t + log_erfc(r + u), -t + log_erfc(r - u)))
    lp_core = torch.log(torch.clamp_min(core, 1e-10))
    out = torch.logaddexp(torch.log1p(-pi) + lp_core, torch.log(pi) + lp_tail)
    return out.reshape(x.shape)


def nll(params: dict, noise: torch.Tensor, hr: torch.Tensor, ratio: torch.Tensor,
        iso: torch.Tensor, iso2k, wp: float, bl: float, nb: int = 2,
        core_dtype=None) -> torch.Tensor:
    """The proxy's training loss on NCHW ``noise = (lr - hr) / ratio``;
    ``core_dtype`` as in :func:`log_prob_conv`."""
    dtype = params["pixel_stage.bins.weight"].dtype
    span = wp - bl
    rb = ratio.to(dtype).reshape(-1, 1, 1, 1)
    x = noise.to(dtype) * span
    w = (hr.to(dtype) / rb * span < DARK_THRESH).to(dtype)
    feat = iso_features(iso, iso2k).to(dtype)
    feat = torch.broadcast_to(feat, (x.shape[0], 2))
    px, row = head(params, "pixel_stage", feat, nb), head(params, "row_stage", feat, nb)
    W = x.shape[3]
    wsum_row = torch.clamp_min(w.sum(dim=3, keepdim=True), 1e-6)
    row_mean = (x * w).sum(dim=3, keepdim=True) / wsum_row
    resid = (x - row_mean) * torch.sqrt(wsum_row / torch.clamp_min(wsum_row - 1.0, 1.0))
    s0 = torch.full((), SMOOTH_S0, dtype=dtype, device=x.device)
    var_px = (variance(px).detach() + SMOOTH_S0**2).reshape(-1, 1, 1, 1)
    s_contam = torch.sqrt(var_px / wsum_row)
    w_rows = w.mean(dim=3, keepdim=True)
    lp_px = torch.stack([log_prob_conv(px, i, resid[i], s0, core_dtype)
                         for i in range(x.shape[0])])
    lp_row = torch.stack([log_prob_conv(row, i, row_mean[i], s_contam[i], core_dtype)
                          for i in range(x.shape[0])])
    nll_px = -(lp_px * w).sum() / torch.clamp_min(w.sum(), 1e-6)
    nll_row = -(lp_row * w_rows).sum() / torch.clamp_min(w_rows.sum(), 1e-6)
    return nll_px + nll_row / W
