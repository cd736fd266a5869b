"""Tukey-lambda distribution in plain torch (counterpart of
``pnnp_tpu/ops/tukey.py``).

The reference samples TL read noise through scipy (``stats.tukeylambda.rvs``,
reference: data_process/process.py:611). The quantile function is closed
form, the CDF is a bisection on the (strictly monotone) quantile, and
sampling is inverse-CDF from a uniform drawn with an explicit generator.
"""

from __future__ import annotations

import torch

_LAM_EPS = 1e-7


def tukeylambda_ppf(p: torch.Tensor, lam) -> torch.Tensor:
    """Quantile function Q(p; lam) = (p^lam - (1-p)^lam) / lam, logit at lam=0.

    Computed as (expm1(lam*log p) - expm1(lam*log1p(-p))) / lam: the naive
    power form cancels catastrophically for |lam| < ~1e-3 in float32; the
    expm1 form stays accurate for all lam and has the exact logit limit
    below |lam| = 1e-7.
    """
    p = torch.as_tensor(p)
    lam = torch.as_tensor(lam, dtype=p.dtype, device=p.device)
    log_p, log_q = torch.log(p), torch.log1p(-p)
    small = lam.abs() < _LAM_EPS
    lam_safe = torch.where(small, torch.ones_like(lam), lam)
    q_nonzero = (torch.expm1(lam_safe * log_p) - torch.expm1(lam_safe * log_q)) / lam_safe
    return torch.where(small, log_p - log_q, q_nonzero)


def _support_bound(lam) -> torch.Tensor:
    """|Q(1; lam)| = 1/lam for lam > 0 (finite support); inf otherwise."""
    lam = torch.as_tensor(lam, dtype=torch.float32)
    return torch.where(lam > _LAM_EPS, 1.0 / lam.clamp_min(_LAM_EPS),
                       torch.full_like(lam, float("inf")))


def tukeylambda_cdf(x: torch.Tensor, lam, iters: int = 60) -> torch.Tensor:
    """CDF by bisection on the quantile function (monotone in p): ``iters``
    halvings of the [0, 1] bracket, far below float32 resolution at 60."""
    x = torch.as_tensor(x, dtype=torch.float32)
    lam = torch.as_tensor(lam, dtype=torch.float32, device=x.device)
    lo, hi = torch.zeros_like(x), torch.ones_like(x)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        go_right = tukeylambda_ppf(mid, lam) < x
        lo, hi = torch.where(go_right, mid, lo), torch.where(go_right, hi, mid)
    p = 0.5 * (lo + hi)
    # Outside the finite support (lam > 0) the CDF saturates at 0/1 exactly.
    bound = _support_bound(lam).to(x.device)
    return torch.where(x <= -bound, torch.zeros_like(p),
                       torch.where(x >= bound, torch.ones_like(p), p))


def tukeylambda_sample(generator: torch.Generator, lam, scale=1.0, shape=()) -> torch.Tensor:
    """Draw TL(lam) * scale by inverse-CDF sampling, on the generator's device.

    ``lam``/``scale`` may be scalars or tensors broadcastable to ``shape``
    (e.g. per-example noise parameters of shape ``[N, 1, 1, 1]``).
    """
    # Open-interval uniform avoids inf at p in {0, 1} when lam <= 0.
    tiny = 1e-7
    p = torch.rand(shape, generator=generator, device=generator.device)
    p = p * (1.0 - 2 * tiny) + tiny
    return tukeylambda_ppf(p, lam) * scale
