#!/usr/bin/env python3
"""The multi-device paths of ``pnnp_tpu_torch/parallel`` against one device,
held to it and timed.

    torchrun --nproc_per_node=N -m pnnp_tpu_torch.tools.multidevice [--cpu]
        [--frames sony,imx686] [--crops 8] [--patch 512] [--nf 32]

Each rank runs on ``cuda:<LOCAL_RANK>`` (the process group from
``torchrun``'s environment: NCCL where each rank has a card of its own,
gloo otherwise; ``--cpu``: gloo on the host, in f32, for a rehearsal at
small sizes).

1. Eval: the width-sharded fused eval (mesh 1 x N, ``spatial_halo`` 96)
   at the full Sony ``[1424, 2128]`` and IMX686 ``[1736, 2312]`` packed
   frames (UNetSeeInDark at ``--nf``, bf16 ``channels_last``), held to the
   single-device fused step on rank 0 (PSNR within 1e-3 dB, SSIM within
   1e-5); timed as the median wall ms per frame of all ranks in lockstep,
   with and without gathering the corrected frame, beside the
   single-device step alone.
2. Train: the data-parallel bf16 train step at ``--crops`` x ``--patch``^2
   ``pgrq`` (``crops / N`` a rank, each rank's synth from its own stream):
   3 steps, then the ranks' params bit-identical; timed beside the one-rank
   step on the whole batch.

Rank 0 prints one JSON line (with the card's name and power limit).
:func:`eval_check` and :func:`train_step_check` are what ``chip_smoke.py``
runs on its ranks.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

FRAMES = {"sony": (1424, 2128), "imx686": (1736, 2312)}  # packed [H, W], C = 4
PSNR_TOL, SSIM_TOL = 1e-3, 1e-5
TRAIN_LR = 2e-4  # ELD.yml's learning rate


def _require(cond, what):
    if not cond:
        raise RuntimeError(what)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def lockstep_ms(fn, dev, warmup=2, iters=5) -> float:
    """Median wall ms per call of ``fn`` run by every rank together (a
    barrier before each call, a device sync after)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        _sync(dev)
        dist.barrier()
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def alone_ms(fn, dev, warmup=3, iters=10) -> float:
    """Median wall ms per call of ``fn`` on this rank alone."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def _on_rank0(dev, fn):
    """``fn()`` on rank 0 while the others wait; its result on rank 0."""
    dist.barrier()
    out = fn() if dist.get_rank() == 0 else None
    dist.barrier()
    return out


def eval_check(dev, frames=None, nf=32, halo=96, dtype=torch.bfloat16) -> dict:
    """The sharded fused eval over every rank against the single-device
    step (rank 0), per frame ``{name: (H, W)}``; see the module doc."""
    from pnnp_tpu_torch.models import UNetSeeInDark
    from pnnp_tpu_torch.parallel import make_eval_metrics_step_sharded, make_mesh
    from pnnp_tpu_torch.train.steps import make_eval_metrics_step

    mesh = make_mesh(n_data=1, n_spatial=dist.get_world_size())
    net = UNetSeeInDark(nf=nf, dtype=dtype,
                        generator=torch.Generator().manual_seed(0)).to(dev).eval()
    sharded = make_eval_metrics_step_sharded(net, mesh, halo=halo)
    single = make_eval_metrics_step(net)
    out = {}
    for name, (H, W) in (frames or FRAMES).items():
        rng = np.random.default_rng(11)
        lr = torch.from_numpy(rng.uniform(0, 0.4, (1, H, W * 4)).astype(np.float32)).to(dev)
        hr = torch.from_numpy(rng.uniform(0, 1, (1, H, W * 4)).astype(np.float32)).to(dev)
        kw = dict(ori=False, correct=True)
        dn, m = sharded(lr, hr, 1.0, **kw)
        row = {"frame": [H, W, 4], "metrics": {k: float(v) for k, v in m.items()}}

        def reference():
            dn1, m1 = single(lr, hr, 1.0, **kw)
            m1 = {k: float(v) for k, v in m1.items()}
            gaps = {k: abs(row["metrics"][k] - m1[k]) for k in m1}
            _require(gaps["psnr"] <= PSNR_TOL and gaps["ssim"] <= SSIM_TOL,
                     f"sharded eval {name}: {row['metrics']} vs single-device {m1}")
            return {"single_metrics": m1, "psnr_gap": gaps["psnr"], "ssim_gap": gaps["ssim"],
                    "frame_max_abs": float((dn - dn1).abs().max()),
                    "single_ms": alone_ms(lambda: single(lr, hr, 1.0, **kw), dev)}

        row.update(_on_rank0(dev, reference) or {})
        row["sharded_ms"] = lockstep_ms(lambda: sharded(lr, hr, 1.0, **kw), dev)
        row["sharded_nogather_ms"] = lockstep_ms(
            lambda: sharded(lr, hr, 1.0, gather=False, **kw), dev)
        out[name] = row
    del net, sharded, single
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def train_step_check(dev, crops=8, patch=512, nf=32, bf16=True) -> dict:
    """The data-parallel train step over every rank against the one-rank
    step; see the module doc."""
    from pnnp_tpu_torch.models import UNetSeeInDark
    from pnnp_tpu_torch.parallel import make_mesh, make_sharded_train_step, rank_seed, shard_batch
    from pnnp_tpu_torch.train import make_adam, make_raw_synth, make_train_step

    mesh = make_mesh()
    hr = torch.from_numpy(np.random.default_rng(5).uniform(
        0, 0.6, (crops, 4, patch, patch)).astype(np.float32)).to(dev)
    synth = make_raw_synth("SonyA7S2", "pgrq", False, 2)

    def setup():
        net = UNetSeeInDark(nf=nf, generator=torch.Generator().manual_seed(0)).to(dev)
        step = make_train_step(lambda e: TRAIN_LR, synth, clip_mode=2, bf16=bf16)
        return net, make_adam(net.parameters()), step

    net, opt, step = setup()
    dp = make_sharded_train_step(mesh, step)
    gen = torch.Generator(device=dev).manual_seed(rank_seed(0, mesh.data_rank))
    local = shard_batch(mesh, {"hr": hr})
    losses = [float(dp(net, opt, local, gen, 1)["loss"]) for _ in range(3)]
    flat = torch.cat([p.detach().reshape(-1) for p in net.parameters()])
    ref = flat.clone()
    dist.broadcast(ref, src=0)
    identical = bool(torch.equal(flat, ref))
    _require(identical, f"rank {dist.get_rank()}: params differ from rank 0's after "
                        "3 data-parallel steps")
    _require(all(math.isfinite(x) for x in losses), f"data-parallel losses {losses}")
    out = {"crops": crops, "patch": patch, "crops_per_rank": local["hr"].shape[0],
           "losses": losses, "params_identical": identical,
           "dp_step_ms": lockstep_ms(lambda: dp(net, opt, local, gen, 1), dev)}
    del net, opt

    def one_rank():
        net1, opt1, step1 = setup()
        return alone_ms(lambda: step1(net1, opt1, {"hr": hr}, gen, 1), dev)

    one = _on_rank0(dev, one_rank)
    if one is not None:
        out["one_rank_step_ms"] = one
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _card():
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return smi.stdout.strip()


def main(argv=None) -> dict:
    from pnnp_tpu_torch.parallel import init_distributed

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cpu", action="store_true", help="gloo on the host, f32")
    p.add_argument("--frames", default="sony,imx686",
                   help="comma list of sony, imx686 or HxW packed frames")
    p.add_argument("--crops", type=int, default=8)
    p.add_argument("--patch", type=int, default=512)
    p.add_argument("--nf", type=int, default=32)
    p.add_argument("--halo", type=int, default=96)
    a = p.parse_args(argv)
    _require(int(os.environ.get("WORLD_SIZE", "1")) > 1,
             "run under torchrun with --nproc_per_node of 2 or more")
    dev = init_distributed("cpu" if a.cpu else None)
    frames = {}
    for f in a.frames.split(","):
        frames[f] = FRAMES[f] if f in FRAMES else tuple(int(v) for v in f.split("x"))
    dtype = torch.float32 if a.cpu else torch.bfloat16
    result = {"world": dist.get_world_size(), "backend": dist.get_backend(),
              "device": str(dev),
              "card": None if a.cpu else torch.cuda.get_device_name(dev),
              "eval": eval_check(dev, frames, nf=a.nf, halo=a.halo, dtype=dtype),
              "train": train_step_check(dev, a.crops, a.patch, a.nf, bf16=not a.cpu)}
    if dist.get_rank() == 0:
        if not a.cpu:
            result["nvidia_smi"] = _card()
        print(json.dumps(result), flush=True)
    dist.destroy_process_group()
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
