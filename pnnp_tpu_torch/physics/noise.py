"""The physics noise synthesis, batched, on the device (counterpart of
``pnnp_tpu/physics/noise.py:37-115``).

Implements the reference's ``noise_code`` char DSL (reference:
data_process/process.py:591-673):

    p = Poisson shot noise        g = Tukey-lambda read (else Gaussian sigGs)
    r = per-(channel,row) noise   q = uniform quantization noise
    d = per-channel dark bias     b = black-frame mode (no read/row/q/d)

Composition (ADU domain): ``z = (shot + read + row + quant + bias) / (wp-bl)``,
clipped to ``[-bl/wp, 1]`` (sensor floor) or ``[0, 1]``, then scaled by the
exposure ratio unless ``ori``.

Layout is NCHW, the port's: images ``[n, 4, h, w]`` RGBG, params ``[n]`` per
example (from :mod:`pnnp_tpu_torch.physics.sampling`). Every draw comes from
the generator passed in, on its device. The stages are plain torch ops: the
JAX package leaves this synthesis to XLA (no Pallas kernel).
"""

from __future__ import annotations

import torch

from pnnp_tpu_torch.config import NoiseCode
from pnnp_tpu_torch.ops.poisson import poisson_sample
from pnnp_tpu_torch.ops.tukey import tukeylambda_sample


def _b(x: torch.Tensor) -> torch.Tensor:
    """Broadcast a [n] param vector against [n, c, h, w] images."""
    return x.reshape(-1, 1, 1, 1)


def generate_noisy(
    generator: torch.Generator,
    y: torch.Tensor,
    params: dict,
    noise_code: str = "p",
    ori: bool = False,
    clip: bool = False,
) -> torch.Tensor:
    """Synthesize a noisy observation from clean RGBG ``y`` [n, 4, h, w] in
    [0, 1].

    Port of ``generate_noisy_torch`` (reference: process.py:634-673) with the
    numpy path's black-frame semantics (row/quant/bias suppressed under 'b',
    reference: process.py:609-622). The JAX function's MultiFrameMean
    factor ``mfm`` is left out: no recipe sets it (it is 1 everywhere).
    """
    nc = NoiseCode(noise_code)
    g = generator
    n, c, h, _ = y.shape

    scale = params["wp"] - params["bl"]  # [n]
    y_adu = y * _b(scale / params["ratio"])
    K = _b(params["K"])

    if nc.shot_poisson:
        z = poisson_sample(g, (y_adu / K).clamp_min_(0.0))
        z *= K
    else:
        # Gaussian stand-in for shot noise: variance y*K, the Poisson
        # branch's (see the JAX module).
        std = (y_adu / K).clamp_min_(1e-10).sqrt_()
        z = torch.randn(y.shape, generator=g, device=g.device).mul_(std * K)
        z += y_adu

    if not nc.black_mode:
        if nc.read_tukey:
            z += tukeylambda_sample(g, _b(params["lam"]), _b(params["sigTL"]), y.shape)
        else:
            z += torch.randn(y.shape, generator=g, device=g.device) * _b(params["sigGs"])
        if nc.row:
            # one draw per (example, channel, row), broadcast over w
            z += torch.randn((n, c, h, 1), generator=g, device=g.device) * _b(params["sigR"])
        if nc.quant:
            z += (torch.rand(y.shape, generator=g, device=g.device) - 0.5) * _b(
                params["q"] * scale)
        if nc.dark_bias:
            z += params["bias"][:, :, None, None]

    z /= _b(scale)
    if clip:
        z.clamp_(0.0, 1.0)
    else:
        z = torch.maximum(z, _b(-params["bl"] / params["wp"])).clamp_max_(1.0)
    if not ori:
        z *= _b(params["ratio"])
    return z
