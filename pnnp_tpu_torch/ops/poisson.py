"""Poisson sampling for the noise synthesis (counterpart of
``pnnp_tpu/ops/poisson.py:43``).

The JAX package replaces ``jax.random.poisson`` by a fixed-unrolled hybrid
(exact CDF inversion up to lam = 16, a Cornish-Fisher normal expansion
above) because XLA fuses it into one TPU kernel; it documents itself as the
same distribution with a different stream. In eager torch that hybrid
would cost ~300 elementwise passes, so the port draws with ``torch.poisson``,
the exact sampler the PyTorch reference itself used (reference:
data_process/process.py:651). The distribution is held against the JAX
sampler by moments and KLD (tests/test_torch_noise.py).
"""

from __future__ import annotations

import torch


def poisson_sample(generator: torch.Generator, lam: torch.Tensor) -> torch.Tensor:
    """Draw float32 Poisson(lam) samples elementwise over ``lam``, on the
    generator's device. ``lam`` must be >= 0 (callers clamp); ``lam = 0``
    returns 0."""
    lam = torch.as_tensor(lam, dtype=torch.float32, device=generator.device)
    return torch.poisson(lam, generator=generator)
