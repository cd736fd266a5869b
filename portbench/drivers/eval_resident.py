"""The fused eval step on frames already on the card, as
``pnnp_tpu_torch/tools/eval_fullres.py`` serves them: no loader and no
copy, PSNR and SSIM read on the host every frame, as ``Trainer.eval`` reads
them.

Pairs are made on the card from the seed (``portbench/data.py``): a clean
scene and its short exposure at the ratios of the configuration's
``dst_eval.ratio_list`` in turn, amplified by the ratio and clipped as the
runfile clips, cycled for the window.
"""

from __future__ import annotations

from portbench import data
from portbench.evalcell import EvalDriver
from portbench.harness import OFF, Phases


class Driver(EvalDriver):
    def setup(self):
        ph = Phases(self.sync)
        dst, assumed = self.dst_eval, self.cfg["assumed"]
        n = int(self.traffic["frames"])
        span = float(dst["wp"]) - float(dst["bl"])
        iso = float(self.cfg.get("iso", 6400))
        gen = data.generator(self.seed, self.dev, 1)
        clean = data.scenes(n, 4, self.h, self.w, gen, self.dev)
        ratios = [float(dst["ratio_list"][k % len(dst["ratio_list"])]) for k in range(n)]
        self.frames = []
        for k in range(n):
            hr = clean[k].permute(1, 2, 0)[None].contiguous()
            lr = data.noisy(hr, ratios[k], float(assumed["sensor_gain_per_iso"]) * iso,
                            float(assumed["read_noise_per_sqrt_iso"]) * iso**0.5, span, gen)
            lr = lr / span * ratios[k]
            if dst.get("clip"):
                lr = lr.clamp_max(1.0) if dst["clip"] == 2 else lr.clamp(0.0, 1.0)
            self.frames.append((lr, hr, ratios[k]))
        del clean
        self.k = 0
        ph.mark("data_s")
        self.build_program()
        if self.control:
            self.step_fn = self.control_step([f[0] for f in self.frames[:self.INT8_CAL_FRAMES]])
        ph.mark("program_s")
        for _ in range(n):
            self.step(OFF)
        self.held.clear()
        ph.mark("warmup_s")
        self.setup_split = ph.split

    def keys(self) -> list:
        return list(range(int(self.traffic["frames"])))

    def step(self, spans):
        k = self.k % len(self.frames)
        self.k += 1
        lr, hr, ratio = self.frames[k]
        self.score(k, lr, hr, ratio, spans)

    def reference_inputs(self, key):
        lr, hr, ratio = self.frames[key]
        return lr[0], hr[0], ratio

    def close(self):
        self.frames = []
