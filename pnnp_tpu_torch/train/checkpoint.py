"""Checkpoints: the JAX package's pickle tier, file for file.

Counterpart of ``pnnp_tpu/train/checkpoint.py`` (``save_checkpoint`` :27,
``load_checkpoint`` :73, ``load_any`` :78, ``CheckpointManager`` :95).
A checkpoint is a pickled ``{"params", "batch_stats", "meta"}`` dict whose
``params`` is the JAX parameter tree as numpy arrays, so a checkpoint
written by either package loads in the other. Convert to and from a
module's ``state_dict`` with :func:`pnnp_tpu_torch.models.convert.params_from_jax`
/ :func:`~pnnp_tpu_torch.models.convert.params_to_jax`. Orbax is not used.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np
import torch

from pnnp_tpu_torch.models.convert import torch_state_to_flax_full


def _to_numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def save_checkpoint(path: str, params, batch_stats=None, meta: Optional[dict] = None):
    """Pickle a JAX-layout parameter tree (numpy or tensor leaves)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {
        "params": _to_numpy_tree(params),
        "batch_stats": _to_numpy_tree(batch_stats) if batch_stats is not None else None,
        "meta": meta or {},
    }
    with open(path, "wb") as f:
        pickle.dump(payload, f)


def load_checkpoint(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)


def load_any(path: str) -> dict:
    """Load ours (.ckpt pickle) or a torch .pth state_dict, converting layout
    to the JAX parameter tree."""
    if path.endswith(".pth") or path.endswith(".pt"):
        state = torch.load(path, map_location="cpu")
        if isinstance(state, dict) and "netG" in state:  # ELD container
            state = state["netG"]
        if isinstance(state, dict) and "state_dict" in state:
            state = state["state_dict"]
        params, stats = torch_state_to_flax_full(state)
        return {"params": params, "batch_stats": stats or None, "meta": {}}
    return load_checkpoint(path)


class CheckpointManager:
    """last/best rolling checkpoints + periodic saves (reference contract)."""

    def __init__(self, fast_dir: str, model_dir: str, model_name: str, save_freq: int = 10):
        self.fast_dir = fast_dir
        self.model_dir = model_dir
        self.model_name = model_name
        self.save_freq = save_freq
        self.best_psnr = -np.inf
        os.makedirs(fast_dir, exist_ok=True)
        os.makedirs(model_dir, exist_ok=True)

    def last_path(self):
        return os.path.join(self.fast_dir, f"{self.model_name}_last_model.ckpt")

    def best_path(self):
        return os.path.join(self.fast_dir, f"{self.model_name}_best_model.ckpt")

    def epoch_path(self, epoch: int):
        return os.path.join(self.model_dir, f"{self.model_name}_e{epoch:04d}.ckpt")

    def save(self, epoch: int, params, batch_stats=None, eval_psnr: Optional[float] = None):
        meta = {"epoch": epoch, "eval_psnr": eval_psnr}
        save_checkpoint(self.last_path(), params, batch_stats, meta)
        if epoch % self.save_freq == 0:
            save_checkpoint(self.epoch_path(epoch), params, batch_stats, meta)
        if eval_psnr is not None and eval_psnr > self.best_psnr:
            self.best_psnr = eval_psnr
            save_checkpoint(self.best_path(), params, batch_stats, meta)
            return True
        return False

    def restore(self, prefer: str = "best") -> Optional[dict]:
        """best -> last -> None fallback (reference: trainer_SID.py:19-31)."""
        order = [self.best_path(), self.last_path()]
        if prefer == "last":
            order.reverse()
        # Recover the best-PSNR watermark from the best checkpoint's meta so
        # a resumed run's first (possibly worse) eval cannot clobber it.
        if os.path.exists(self.best_path()):
            try:
                bmeta = load_checkpoint(self.best_path()).get("meta", {})
                if bmeta.get("eval_psnr") is not None:
                    self.best_psnr = max(self.best_psnr,
                                         float(bmeta["eval_psnr"]))
            except (OSError, pickle.UnpicklingError, EOFError):
                pass
        for p in order:
            if os.path.exists(p):
                try:
                    return load_checkpoint(p)
                except (OSError, pickle.UnpicklingError, EOFError):
                    continue  # corrupted file: try the other tier
        return None
