"""Headless algorithm-parameter debugger (counterpart of
``pnnp_tpu/utils/debugger.py``).

The reference's ``AlgoDebugger`` (``utils/__init__.py:8-56``) is an
interactive cv2-trackbar tool for tuning ISP-algorithm parameters (its
default binds the guided filter's ``d``/``eps``). Without a display, each
trackbar is swept over its range (the others held at their defaults), the
algorithm runs on the images' device, and one labelled contact-sheet JPG per
parameter is written.

The args schema is the reference's: ``algo`` (callable ``algo(*imgs,
*params)``) and ``trackbar``, an ordered dict of ``{name: {"default": int,
"max_num": int, "func": raw -> value}}`` where ``func`` maps the integer
slider position to the parameter value.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch


def _default_algo(p, d=5, eps=0.01):
    from pnnp_tpu_torch.ops.filters import fast_guided_filter

    return fast_guided_filter(torch.as_tensor(p), k=int(d), eps=float(eps)).cpu().numpy()


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class AlgoDebugger:
    """Sweep-and-render parameter debugger (reference utils/__init__.py:8)."""

    def __init__(self, args: dict | None = None):
        self.default_args()
        for key in args or {}:
            self.args[key] = args[key]

    def default_args(self):
        self.args = {
            "algo": _default_algo,
            "win_name": "Show",
            "trackbar": {
                "d": {"default": 5, "max_num": 50, "func": lambda x: x // 2 * 2 + 1},
                "eps": {"default": 20, "max_num": 80, "func": lambda x: 10 ** -(x / 10)},
            },
        }

    def _param_values(self):
        tb = self.args["trackbar"]
        return {v: tb[v]["func"](tb[v]["default"]) for v in tb}

    def debug(self, imgs: Sequence, out_dir: str = "images/debug", steps: int = 5) -> list:
        """For each trackbar, sample ``steps`` positions across its range and
        write a contact sheet of the algorithm's output at each position.
        Returns the written file paths. Needs matplotlib."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        algo = self.args["algo"]
        tb = self.args["trackbar"]
        os.makedirs(out_dir, exist_ok=True)
        written = []
        for var in tb:
            raws = np.unique(np.linspace(0, tb[var]["max_num"], steps).astype(int))
            fig, axes = plt.subplots(1, len(raws) + 1, figsize=(3 * (len(raws) + 1), 3))
            axes[0].imshow(np.clip(_numpy(imgs[0])[..., :3], 0, 1))
            axes[0].set_title("input")
            axes[0].axis("off")
            for ax, raw in zip(axes[1:], raws):
                p = self._param_values()
                p[var] = tb[var]["func"](int(raw))
                out = _numpy(algo(*imgs, *p.values()))
                ax.imshow(np.clip(out[..., :3], 0, 1))
                ax.set_title(f"{var}={p[var]:.4g}")
                ax.axis("off")
            path = os.path.join(out_dir, f"{self.args['win_name']}_{var}.jpg")
            fig.tight_layout()
            fig.savefig(path, dpi=80)
            plt.close(fig)
            written.append(path)
        return written
