"""The whole eval loop on the card (counterpart of
``tools/bench_eval_loop.py``).

Where ``eval_fullres`` times the fused step on frames already on the card,
this drives the loop the way ``Trainer.eval`` does: the port's threaded
``data/loader.py::DataLoader`` with workers over a synthetic full-frame
dataset -> host-to-device copy -> the fused eval step -> the metrics read
back to the host, per frame. The difference from the step's own time is
what the loop costs around it.

The step gets what ``Trainer.eval`` feeds it: the unpacked float32 frame
``[1, h, w, 4]``, which it pads and forwards through the bf16 module in
``channels_last`` memory. The JAX tool packs each frame on the host in the
loader; the port's eval steps take only unpacked frames (a host pre-pack was
no faster on the H100, PERF.md section 6), so this loop does not pack.

Modes:
  sync       read the metrics back every frame (the Trainer's behavior)
  pipelined  read frame k's metrics back only after frame k+1 is
             dispatched, so the host's next load and copy overlap frame k's
             compute

Usage (from the repository root; on the card unless ``--cpu``):

    python -m pnnp_tpu_torch.tools.bench_eval_loop [--frames 8] [--camera SonyA7S2] [--cpu]

Prints one JSON line per mode (the JAX tool's keys, plus ``card``: name and
power limit); :func:`main` returns them.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

SHAPES = {"SonyA7S2": (2848, 4256), "IMX686": (3472, 4624)}
REPEATS = 3
MODEL_SEED = 0


class SyntheticEvalDataset:
    """Minimal eval-shaped dataset: full-frame NHWC lr/hr pairs in host
    memory (the JAX tool's: one shared buffer per role, ``lr`` copied per
    item as a loader would produce it)."""

    def __init__(self, n, h, w):
        rng = np.random.default_rng(0)
        self.lr = rng.uniform(0, 0.3, (1, h, w, 4)).astype(np.float32)
        self.hr = rng.uniform(0, 1.0, (1, h, w, 4)).astype(np.float32)
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"lr": self.lr.copy(), "hr": self.hr,
                "ratio": np.float32(1.0), "name": f"f{i:03d}"}


def run_loop(step, loader, pipeline: bool, device):
    """One pass over ``loader``: (seconds, [(name, psnr, ssim)] in order)."""
    import torch

    to_device = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    read = lambda name, m: (name, float(m["psnr"]), float(m["ssim"]))
    results = []
    pending = None  # (name, metrics) awaiting readback
    t0 = time.perf_counter()
    for batch in loader:
        lr, hr = to_device(batch["lr"]), to_device(batch["hr"])
        ratio = float(np.asarray(batch["ratio"]).reshape(-1)[0])
        _, m = step(lr, hr, ratio, ori=False, correct=True, with_inputs=False)
        name = batch["name"][0]
        if pipeline:
            if pending is not None:
                results.append(read(*pending))
            pending = (name, m)
        else:
            results.append(read(name, m))
    if pending is not None:
        results.append(read(*pending))
    return time.perf_counter() - t0, results


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--camera", default="SonyA7S2", choices=list(SHAPES))
    ap.add_argument("--workers", type=int, default=3)
    ap.add_argument("--cpu", action="store_true")
    a = ap.parse_args(argv)

    import torch

    from pnnp_tpu_torch.data.loader import DataLoader
    from pnnp_tpu_torch.models import UNetSeeInDark
    from pnnp_tpu_torch.train.steps import make_eval_metrics_step
    from pnnp_tpu_torch.utils.device import card_label, resolve_device

    dev = torch.device("cpu") if a.cpu else resolve_device(device)
    H, W = SHAPES[a.camera]
    model = UNetSeeInDark(nf=32, dtype=torch.bfloat16,
                          generator=torch.Generator().manual_seed(MODEL_SEED)).to(dev).eval()
    step = make_eval_metrics_step(model)
    ds = SyntheticEvalDataset(a.frames, H // 2, W // 2)
    make_loader = lambda: DataLoader(ds, batch_size=1, shuffle=False, num_workers=a.workers)
    card = card_label(dev)

    _, base = run_loop(step, make_loader(), False, dev)  # warm-up (cuDNN's choices)
    out = []
    for pipeline in (False, True):
        best = float("inf")
        for _ in range(REPEATS):
            dt, res = run_loop(step, make_loader(), pipeline, dev)
            best = min(best, dt / a.frames)
        assert [r[0] for r in res] == [r[0] for r in base]
        assert all(abs(x[1] - y[1]) < 1e-5 for x, y in zip(res, base))
        row = {"camera": a.camera,
               "mode": "pipelined" if pipeline else "sync",
               "ms_per_frame": best * 1e3,
               "mpix_s": H * W / 1e6 / best,
               "includes": "loader+h2d+fused step+metric readback",
               "frames": a.frames, "workers": a.workers, "card": card}
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


if __name__ == "__main__":
    main()
