"""The ELD evaluation sweep as ``Trainer.eval`` runs it, one frame in flight.

An ELD tree is written from the seed under the run's temporary directory
(``portbench/data.py``). The port's ``ELD_Dataset`` builds each frame from
the raw files (dark shading, pack, ratio, clip) behind its ``DataLoader``
with the Trainer's 2 workers, batch 1, no shuffle, one loader per pass over
the sweep; ``Trainer._to_device`` copies ``lr`` and ``hr`` to the card; the
bf16 fused eval step scores the frame; PSNR and SSIM are read on the host.
The reference prepares each frame again from the same raw files.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from portbench import data
from portbench.evalcell import EvalDriver
from portbench.harness import OFF, Phases
from portbench.reference import eld


class Driver(EvalDriver):
    def setup(self):
        from pnnp_tpu_torch.data import DataLoader, build_dataset

        ph = Phases(self.sync)
        dst, assumed = self.dst_eval, self.cfg["assumed"]
        self.wp, self.bl = float(dst["wp"]), float(dst["bl"])
        self.grid = [(int(i), int(r)) for i in dst["iso_list"] for r in dst["ratio_list"]]
        self.scenes = int(self.traffic["scenes"])
        self.tree = data.eld_tree(
            os.path.join(self.workdir, "eld"), self.scenes, int(dst["H"]), int(dst["W"]),
            dst["iso_list"], dst["ratio_list"], self.wp, self.bl,
            data.generator(self.seed, self.dev, 1), self.dev,
            float(assumed["sensor_gain_per_iso"]), float(assumed["read_noise_per_sqrt_iso"]))
        ph.mark("data_s")
        args = dict(dst, root_dir=self.tree["root"], ds_dir=self.tree["ds_dir"],
                    infos_dir=self.tree["infos_dir"], bias_dir=None)
        self.dataset = build_dataset(args, seed=self.seed)
        self.loader_args = dict(batch_size=1, shuffle=False,
                                num_workers=int(self.traffic["loader_workers"]))
        self.DataLoader = DataLoader
        self.it = None
        self.build_program()
        if self.control:
            cal = [self.to_device(self.dataset[i]["lr"]) for i in range(self.INT8_CAL_FRAMES)]
            self.step_fn = self.control_step(cal)
        ph.mark("program_s")
        for _ in range(len(self.dataset)):  # one pass: every shape, the page cache
            self.step(OFF)
        self.held.clear()
        ph.mark("warmup_s")
        self.setup_split = ph.split

    def keys(self) -> list:
        return [f"scene-{s:02d}_IMG_{data.ELD_SLOTS[i]:04d}.npy"
                for s in range(1, self.scenes + 1) for i in range(len(self.grid))]

    def _next(self):
        while True:
            if self.it is None:
                self.it = iter(self.DataLoader(self.dataset, **self.loader_args))
            try:
                return next(self.it)
            except StopIteration:
                self.it = None

    def step(self, spans):
        with spans.host("loader_wait"):
            batch = self._next()
        with spans.dev("h2d"):
            lr, hr = self.to_device(batch["lr"]), self.to_device(batch["hr"])
        name = batch["name"][0] if isinstance(batch["name"], list) else batch["name"]
        ratio = float(np.asarray(batch["ratio"]).reshape(-1)[0])
        self.score(name, lr, hr, ratio, spans)

    def reference_inputs(self, key):
        scene, lr_name = int(key[6:8]), key[9:]
        slot = int(lr_name[4:8])
        iso, ratio = self.grid[data.ELD_SLOTS.index(slot)]
        gt = min(data.ELD_GT_IDS, key=lambda g: abs(g - slot))
        sd = os.path.join(self.tree["root"], "SonyA7S2", f"scene-{scene}")
        dst = self.dst_eval
        lr, hr = eld.prepare(os.path.join(sd, lr_name), os.path.join(sd, f"IMG_{gt:04d}.npy"),
                             iso, ratio, self.tree["ds_dir"], self.wp, self.bl, dst["clip"],
                             bool(dst.get("ori", False)))
        return (torch.from_numpy(lr[0] if lr.ndim == 4 else lr).to(self.dev),
                torch.from_numpy(hr).to(self.dev), float(ratio))

    def close(self):
        if self.it is not None:
            self.it.close()
            self.it = None
