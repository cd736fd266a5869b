"""Logging + metric meters (reference: utils/utils.py:73-139).

Same observable behaviour: timestamped log lines tee'd to a per-model log
file, and AverageMeter with a pickle-backed epoch history for plot stitching
across resumed runs.
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Optional


def log(string, logfile: Optional[str] = None, notime: bool = False):
    prefix = "" if notime else time.strftime("%Y-%m-%d %H:%M:%S - ", time.localtime())
    line = f"{prefix}{string}"
    print(line, flush=True)
    if logfile:
        os.makedirs(os.path.dirname(logfile) or ".", exist_ok=True)
        with open(logfile, "a", encoding="utf-8") as f:
            f.write(line + "\n")


class AverageMeter:
    """Running average with persistent epoch history."""

    def __init__(self, name="Meter", fmt=":f", last_epoch=0, history_dir="./history"):
        self.name = name
        self.fmt = fmt
        self.history_dir = history_dir
        self.last_epoch = last_epoch
        self.history = []
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)

    def record(self):
        self.history.append(self.avg)

    def __str__(self):
        fmtstr = "{name} {val" + self.fmt + "} ({avg" + self.fmt + "})"
        return fmtstr.format(name=self.name, val=self.val, avg=self.avg)

    # -- persistence (plot_history analog, utils/utils.py:116-139) --
    def _pkl_path(self, model_name):
        return os.path.join(self.history_dir, f"{model_name}_{self.name}.pkl")

    def save_history(self, model_name):
        os.makedirs(self.history_dir, exist_ok=True)
        with open(self._pkl_path(model_name), "wb") as f:
            pickle.dump(self.history, f)

    def load_history(self, model_name):
        path = self._pkl_path(model_name)
        if os.path.exists(path):
            with open(path, "rb") as f:
                self.history = pickle.load(f)[: self.last_epoch]
        return self.history

    def plot_history(self, model_name, out_dir="./images"):
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        os.makedirs(out_dir, exist_ok=True)
        plt.figure()
        plt.plot(self.history)
        plt.xlabel("epoch")
        plt.ylabel(self.name)
        plt.savefig(os.path.join(out_dir, f"{model_name}_{self.name}.jpg"))
        plt.close()


class StepTimer:
    """Wall-clock bucket split of a train step: loader/synth/net/bp shares.

    The reference shows tqdm percentages per bucket (trainer_SID.py:81-124);
    this is the same instrument, host-side.
    """

    def __init__(self, buckets=("loader", "synth", "net", "bp")):
        self.buckets = {b: 0.0 for b in buckets}
        self._t = time.time()

    def tick(self, bucket: str):
        now = time.time()
        self.buckets[bucket] = self.buckets.get(bucket, 0.0) + (now - self._t)
        self._t = now

    def shares(self) -> dict:
        total = sum(self.buckets.values()) or 1.0
        return {k: v / total for k, v in self.buckets.items()}

    def reset(self):
        for k in self.buckets:
            self.buckets[k] = 0.0
        self._t = time.time()
