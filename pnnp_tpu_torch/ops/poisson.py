"""Poisson sampling for the noise synthesis (counterpart of
``pnnp_tpu/ops/poisson.py:43``).

The JAX package replaces ``jax.random.poisson`` by a fixed-unrolled hybrid
(exact CDF inversion up to lam = 16, a Cornish-Fisher normal expansion
above) because XLA fuses it into one TPU kernel; it documents itself as the
same distribution with a different stream. In eager torch that hybrid
would cost ~300 elementwise passes, so the port draws with ``torch.poisson``,
the exact sampler the PyTorch reference itself used (reference:
data_process/process.py:651). The distribution is held against the JAX
sampler by moments and KLD (tests/test_torch_noise.py) and against
``scipy.stats.poisson`` on both devices (``tools/check_poisson.py``).

On CUDA, ``torch.poisson`` advances the generator's Philox offset by 20
values per element, but curand's sampler draws k + 1 uniforms for a count
k below lam = 64 (and two per rejection round above). From lam of about 15
on, a draw reads past its 20 into the values that the generator's next call
gives the same element, so the shot count and the read, row or
quantization noise drawn after it are correlated. :func:`poisson_sample`
therefore moves the generator's offset past ``CUDA_STREAM_RESERVE`` values
after each draw on the card.
"""

from __future__ import annotations

import torch

# Philox values reserved per element for one CUDA ``torch.poisson`` call:
# the chance that a draw at lam < 64 needs more (a count above 1023) or a
# draw above it more than 512 rejection rounds is nil.
CUDA_STREAM_RESERVE = 1024


def poisson_sample(generator: torch.Generator, lam: torch.Tensor) -> torch.Tensor:
    """Draw float32 Poisson(lam) samples elementwise over ``lam``, on the
    generator's device. ``lam`` must be >= 0 (callers clamp); ``lam = 0``
    returns 0."""
    lam = torch.as_tensor(lam, dtype=torch.float32, device=generator.device)
    out = torch.poisson(lam, generator=generator)
    if generator.device.type == "cuda":
        generator.set_offset(generator.get_offset() + CUDA_STREAM_RESERVE)
    return out
