"""Learning-rate schedules as plain functions of the epoch (counterpart of
``pnnp_tpu/train/schedules.py``; reference: base_trainer.py:33-43, 141-159).

SGDR warm-restart cosine with per-period halving, and a multistep schedule.
Each returns a Python float: the train step sets the optimizer's lr from it
before every update, so the schedule needs no state of its own.
"""

from __future__ import annotations

import math


def cosine_warm_restart(step, period=1000, peak=20, lr=1e-4, ratio=0.2) -> float:
    """SGDR (ICLR'17) with warmup after the first restart and 2^T decay."""
    T = math.floor(step / period)
    s = step - T * period
    warm = s / max(peak, 1)
    # guard degenerate configs where the warmup spans the whole period
    span = max(period - peak, 1)
    cos = (1 - ratio) * (math.cos((s - peak) / span * math.pi) * 0.5 + 0.5) + ratio
    mul = warm if (s <= peak and T > 0) else cos
    return lr * mul / 2.0**T


def multistep(step, period=1000, lr=1e-4, milestone=(500, 900), gamma=(0.5, 0.1),
              decay_base=1.0) -> float:
    T = math.floor(step / period)
    s = step - T * period
    mul = 1.0
    for m, g in zip(milestone, gamma):
        if s > m:
            mul = g
    return lr * mul / decay_base**T


def build_lr_schedule(hyper: dict):
    """From a runfile ``hyper`` block (reference: base_trainer.py:33-43):
    ``epoch -> lr`` as a Python float."""
    num_epochs = hyper["stop_epoch"] - hyper.get("last_epoch", 0)
    step_size = hyper.get("step_size", 10)
    T = max(int(hyper.get("T", 1)), 1)
    name = hyper.get("lr_scheduler", "WarmupCosine").lower()
    lr = float(hyper["learning_rate"])
    period = max(num_epochs // T, 1)
    if "cos" in name:
        return lambda e: cosine_warm_restart(e, period=period, lr=lr, peak=step_size)
    if "multi" in name:
        return lambda e: multistep(
            e, period=period, decay_base=1, lr=lr,
            milestone=(step_size, step_size * 9 // 5), gamma=(0.5, 0.1))
    return lambda e: lr
