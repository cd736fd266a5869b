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


def card_label(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them (its line for the
    device's index), to stand beside a time measured on it; ``"cpu"`` for
    the host."""
    if device.type != "cuda":
        return "cpu"
    import subprocess

    index = torch.cuda.current_device() if device.index is None else device.index
    return subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True).stdout.strip()
