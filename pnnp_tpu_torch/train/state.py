"""The optimizer: Adam at unit lr, scaled by ``lr(epoch)`` (counterpart of
``pnnp_tpu/train/state.py:22-52``).

The JAX package chains optax's ``scale_by_adam`` and ``scale(-1)`` and
multiplies the direction by the epoch's lr. That is ``torch.optim.Adam``
with betas (0.9, 0.999) and eps 1e-8 outside the square root (optax's
``eps_root = 0``), bias correction by the step count, no weight decay, and
each parameter group's ``lr`` set to ``lr(epoch)`` before the update. The
optimizer state is not checkpointed, as in the reference.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch


def make_adam(params: Iterable[torch.Tensor]) -> torch.optim.Adam:
    """Adam over ``params``; its lr is set by :func:`apply_scaled_updates`."""
    return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8)


@torch.no_grad()
def clip_by_global_norm(params: Iterable[torch.Tensor], max_norm: float) -> None:
    """optax ``clip_by_global_norm``: scale every gradient by
    ``max_norm / norm`` when the global norm exceeds ``max_norm``. For the
    density models (proxy / NoiseFlow NLL), whose tail terms can spike the
    gradient."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale)


def apply_scaled_updates(opt: torch.optim.Adam, lr: float,
                         clip_norm: Optional[float] = None) -> None:
    """grads -> (optional global-norm clip) -> Adam direction x lr -> apply."""
    if clip_norm is not None:
        clip_by_global_norm([p for grp in opt.param_groups for p in grp["params"]],
                            clip_norm)
    for group in opt.param_groups:
        group["lr"] = float(lr)
    opt.step()
