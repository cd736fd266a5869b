"""ELD-style illuminance correction (counterpart of
``pnnp_tpu/ops/correct.py``; reference: data_process/__init__.py:144-175).

Least-squares brightness alignment of a prediction against its source,
compensating black-level error amplified by the exposure ratio, per image.
"""

from __future__ import annotations

import torch


def illuminance_correct(predict: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
    """Align ``predict`` to ``source`` in brightness. Shapes ``[..., H, W, C]``.

    Batched inputs are corrected per image; a single source broadcasts across
    the predict batch (reference semantics). Saturated source pixels
    (``source == 1``) are left out of the fit; a degenerate fit (``den == 0``)
    leaves the image unscaled.
    """
    predict = predict.clamp(0.0, 1.0)
    source = torch.broadcast_to(source, predict.shape)
    w = (source != 1.0).to(predict.dtype)
    num = (predict * source * w).sum(dim=(-3, -2, -1), keepdim=True)
    den = (predict * predict * w).sum(dim=(-3, -2, -1), keepdim=True)
    scale = torch.where(den > 0, num / den.clamp_min(1e-20),
                        torch.ones_like(den))
    return scale * predict
