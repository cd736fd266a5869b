"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
CUDA device and no explicit ``"cpu"`` they raise instead of carrying on
silently on the host.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (current card); otherwise ``torch.device(device)``.

    Raises ``RuntimeError`` when a CUDA device is asked for (explicitly or
    by default) and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available: pnnp_tpu_torch entry points run on the "
            "card unless device='cpu' is passed explicitly")
    return dev
