"""Rational-quadratic spline transforms (Durkan et al., NeurIPS 2019;
counterpart of ``pnnp_tpu/models/flows/spline.py``; reference
archs/flow_layers/neural_spline.py).

The monotone RQ spline, branch-free like the JAX version, with JAX's
choices kept where torch would differ:

* the bin of an input is the count of bin edges at or below it, minus 1,
  clamped to ``[0, K-1]`` (``torch.searchsorted`` differs at the right edge
  and on ties);
* the inverse takes the root ``2c / (-b - sqrt(max(disc, 0)))``, not the
  textbook one, which cancels digits;
* the linear tails' derivative pad ``log(expm1(1 - min_derivative))`` is
  computed in float32;
* softplus is ``logaddexp(x, 0)``, as ``jax.nn.softplus``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3


def _bin_index(bin_locations: torch.Tensor, inputs: torch.Tensor) -> torch.Tensor:
    """Per-element bin index: bins along the last axis of ``bin_locations``."""
    return torch.sum(inputs[..., None] >= bin_locations, dim=-1) - 1


def _knots(unnormalized: torch.Tensor, lo: float, hi: float, min_bin: float):
    """(cumulative knots ``[..., K+1]`` pinned to ``lo``/``hi``, bin sizes)."""
    num_bins = unnormalized.shape[-1]
    sizes = torch.softmax(unnormalized, dim=-1)
    sizes = min_bin + (1 - min_bin * num_bins) * sizes
    cum = F.pad(torch.cumsum(sizes, dim=-1), (1, 0))
    cum = (hi - lo) * cum + lo
    edge = lambda v: torch.full_like(cum[..., :1], v)
    cum = torch.cat([edge(lo), cum[..., 1:-1], edge(hi)], dim=-1)
    return cum, cum[..., 1:] - cum[..., :-1]


def rational_quadratic_spline(
    inputs: torch.Tensor,
    unnormalized_widths: torch.Tensor,
    unnormalized_heights: torch.Tensor,
    unnormalized_derivatives: torch.Tensor,
    inverse: bool = False,
    left: float = 0.0,
    right: float = 1.0,
    bottom: float = 0.0,
    top: float = 1.0,
    min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
    min_derivative: float = DEFAULT_MIN_DERIVATIVE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Monotone RQ spline on [left, right] -> [bottom, top].

    ``unnormalized_*`` have a trailing K (num_bins) / K+1 (derivatives) axis
    broadcastable against ``inputs``. Returns (outputs, logabsdet)."""

    def up(p):
        # lower-rank (shared) params broadcast up to the inputs' rank
        p = p.reshape((1,) * max(inputs.dim() + 1 - p.dim(), 0) + tuple(p.shape))
        return p.expand(tuple(inputs.shape) + (p.shape[-1],))

    unnormalized_widths = up(unnormalized_widths)
    unnormalized_heights = up(unnormalized_heights)
    unnormalized_derivatives = up(unnormalized_derivatives)
    num_bins = unnormalized_widths.shape[-1]

    cumwidths, widths = _knots(unnormalized_widths, left, right, min_bin_width)
    derivatives = min_derivative + torch.logaddexp(
        unnormalized_derivatives, torch.zeros_like(unnormalized_derivatives))
    cumheights, heights = _knots(unnormalized_heights, bottom, top, min_bin_height)

    bin_locations = cumheights if inverse else cumwidths
    bin_idx = _bin_index(bin_locations, inputs).clamp(0, num_bins - 1)[..., None]

    take = lambda arr: torch.gather(arr, -1, bin_idx)[..., 0]
    input_cumwidths = take(cumwidths)
    input_bin_widths = take(widths)
    input_cumheights = take(cumheights)
    input_heights = take(heights)
    input_delta = take(heights / widths)
    input_derivatives = take(derivatives)
    input_derivatives_p1 = take(derivatives[..., 1:])
    curvature = input_derivatives + input_derivatives_p1 - 2 * input_delta

    if inverse:
        dy = inputs - input_cumheights
        a = dy * curvature + input_heights * (input_delta - input_derivatives)
        b = input_heights * input_derivatives - dy * curvature
        c = -input_delta * dy
        discriminant = torch.clamp_min(b**2 - 4 * a * c, 0.0)
        root = (2 * c) / (-b - torch.sqrt(discriminant))
        outputs = root * input_bin_widths + input_cumwidths

        theta_one_minus_theta = root * (1 - root)
        denominator = input_delta + curvature * theta_one_minus_theta
        derivative_numerator = input_delta**2 * (
            input_derivatives_p1 * root**2
            + 2 * input_delta * theta_one_minus_theta
            + input_derivatives * (1 - root) ** 2
        )
        logabsdet = -(torch.log(derivative_numerator) - 2 * torch.log(denominator))
        return outputs, logabsdet

    theta = (inputs - input_cumwidths) / input_bin_widths
    theta_one_minus_theta = theta * (1 - theta)
    numerator = input_heights * (input_delta * theta**2 + input_derivatives * theta_one_minus_theta)
    denominator = input_delta + curvature * theta_one_minus_theta
    outputs = input_cumheights + numerator / denominator
    derivative_numerator = input_delta**2 * (
        input_derivatives_p1 * theta**2
        + 2 * input_delta * theta_one_minus_theta
        + input_derivatives * (1 - theta) ** 2
    )
    logabsdet = torch.log(derivative_numerator) - 2 * torch.log(denominator)
    return outputs, logabsdet


def unconstrained_rational_quadratic_spline(
    inputs: torch.Tensor,
    unnormalized_widths: torch.Tensor,
    unnormalized_heights: torch.Tensor,
    unnormalized_derivatives: torch.Tensor,
    inverse: bool = False,
    tails: str = "linear",
    tail_bound: float = 1.0,
    min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
    min_derivative: float = DEFAULT_MIN_DERIVATIVE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Identity outside [-tail_bound, tail_bound], RQ spline inside
    (``unnormalized_derivatives`` has K-1 entries: the two edge derivatives
    are padded to meet the identity tails)."""
    if tails != "linear":
        raise NotImplementedError(tails)
    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)

    constant = float(torch.log(torch.expm1(torch.tensor(1 - min_derivative, dtype=torch.float32))))
    unnormalized_derivatives = F.pad(unnormalized_derivatives, (1, 1), value=constant)

    safe_inputs = torch.clamp(inputs, -tail_bound, tail_bound)
    outputs_in, logabsdet_in = rational_quadratic_spline(
        safe_inputs, unnormalized_widths, unnormalized_heights, unnormalized_derivatives,
        inverse=inverse, left=-tail_bound, right=tail_bound, bottom=-tail_bound,
        top=tail_bound, min_bin_width=min_bin_width, min_bin_height=min_bin_height,
        min_derivative=min_derivative)
    outputs = torch.where(inside, outputs_in, inputs)
    logabsdet = torch.where(inside, logabsdet_in, torch.zeros_like(logabsdet_in))
    return outputs, logabsdet
