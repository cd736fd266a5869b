"""Comparisons of what the port produced with the plain reference.

Training (the first steps the window's own call makes): each step's loss
as a relative gap; the norm of the first gradient as Adam got it and the
norm of the parameters' change over the checked steps, each by its worst
leaf: the gap between the two sides' norms of a leaf over the larger of the
reference's norm of that leaf and its median leaf's. Leaves whose
reference gradient is under a thousandth of the median leaf's take no part
(Adam moves them by round-off alone).
"""

from __future__ import annotations

import statistics

import torch

NOUGHT_GRAD = 1e-3
ADAM_BETA1 = 0.9


def norms(leaves: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in leaves.items()}


def counted(ref_grad: dict) -> list:
    n = norms(ref_grad)
    med = statistics.median(n.values())
    return [k for k, v in n.items() if v >= NOUGHT_GRAD * med]


def leaf_gap(prog: dict, ref: dict, keys) -> tuple:
    """(worst gap, its leaf) of the norms of ``prog`` against ``ref``."""
    pn, rn = norms({k: prog[k] for k in keys}), norms({k: ref[k] for k in keys})
    med = statistics.median(rn.values())
    gaps = {k: abs(pn[k] - rn[k]) / max(rn[k], med) for k in keys}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def delta(after: dict, before: dict) -> dict:
    return {k: after[k].double() - before[k].double() for k in before}


def first_grad_from_adam(opt: torch.optim.Optimizer, names: dict) -> dict:
    """The gradient the optimizer got at its first step, from its state after
    that step: the first moment is (1 - beta1) g. A parameter the optimizer
    holds no state for got no gradient: zero."""
    out = {}
    for g in opt.param_groups:
        for p in g["params"]:
            m = opt.state.get(p, {}).get("exp_avg")
            out[names[id(p)]] = (torch.zeros_like(p, dtype=torch.float64) if m is None
                                 else m.detach().double() / (1.0 - ADAM_BETA1))
    return out


def train_checks(losses_p, losses_r, g1_p, g1_r, d_p, d_r, limits) -> list:
    keys = counted(g1_r)
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses_p, losses_r))
    g_gap, _ = leaf_gap(g1_p, g1_r, keys)
    d_gap, _ = leaf_gap(d_p, d_r, keys)
    return [("loss_gap", loss_gap, limits["loss_gap"]),
            ("grad_gap", g_gap, limits["grad_gap"]),
            ("delta_gap", d_gap, limits["delta_gap"])]
