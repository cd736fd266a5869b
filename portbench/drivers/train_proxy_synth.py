"""Denoiser training with the PNNP proxy's noise, the step ``Trainer.train``
runs for a ``*Proxy_Dataset`` runfile: ``TrainStep`` in bf16 (autocast over
float32 master weights) with the synth ``Trainer._family_synth`` builds over
``PixelWiseISOProxy.sample`` (seeded, frozen, float32, as
``Trainer._init_proxy`` leaves it), Adam at the runfile's schedule, the
step's PSNR read on the host every step as the Trainer reads it.

Each step's batch is ``crop_per_image`` packed crops of ``patch_size``,
cut at positions drawn from the seed out of a pool of clean full frames
made on the card, with the dataset's ISO. The loader is bypassed.

The comparison: the reference follows the checked steps from the same
weights. The noisy crops of those steps are the port's synth run again
from the same generator state (the reference cannot draw the port's
stream), so the synth is checked by itself: the crops' noise variance
against the proxy law's, worked out by the reference from the proxy's
weights (``synth_gap``).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import counts, data
from portbench.harness import Phases
from portbench.reference import exact_f32
from portbench.reference import proxy as ref_proxy
from portbench.reference import train as ref_train
from portbench.reference import unet as ref_unet
from portbench.traincell import TrainDriver, fp8


class Driver(TrainDriver):
    def setup(self):
        from pnnp_tpu_torch.models import build_model, build_proxy
        from pnnp_tpu_torch.train import build_lr_schedule, make_adam, make_train_step
        from pnnp_tpu_torch.trainer import Trainer

        ph = Phases(self.sync)
        cfg, dst = self.cfg, self.cfg["dst_train"]
        self.patch, self.crops = int(dst["patch_size"]), int(dst["crop_per_image"])
        self.h, self.w = int(dst["H"]) // 2, int(dst["W"]) // 2
        self.wp, self.bl = float(dst["wp"]), float(dst["bl"])
        self.iso = float(cfg.get("iso", 6400))
        self.clip = cfg["dst"].get("clip", 0)
        arch, ap = cfg["arch"], cfg["arch_proxy"]
        self.nf = int(arch["nf"])
        self.pool = data.scenes(int(self.traffic["pool_frames"]), 4, self.h, self.w,
                                data.generator(self.seed, self.dev, 3), self.dev)
        self.rng = np.random.default_rng([self.seed, 6])
        self.params = data.unet_weights(ref_unet.param_shapes(self.nf), data.generator(
            self.seed, self.dev, 2), self.dev)
        self.proxy_params = data.proxy_weights(
            ref_proxy.param_shapes(int(ap["d"]), int(ap["nf"]), int(ap["nb"])),
            data.generator(self.seed, self.dev, 4), self.dev)
        ph.mark("data_s")
        proxy = build_proxy(ap, wp=self.wp, bl=self.bl).to(self.dev)
        proxy.load_state_dict(self.proxy_params)
        proxy.eval().requires_grad_(False)
        # the Trainer's own synth dispatch, on a Trainer holding only what it reads
        owner = Trainer.__new__(Trainer)
        owner.dst_train, owner.dst, owner.training = dst, cfg["dst"], True
        owner.proxy, owner.dataset_train = proxy, None
        synth = owner._family_synth()
        self.model = build_model(arch, dtype=torch.float32).to(self.dev)
        self.model.load_state_dict(self.params)
        self.model.train()
        self.step_obj = make_train_step(build_lr_schedule(cfg["hyper"]), synth,
                                        clip_mode=self.clip, bf16=True)
        self.rate = ref_train.warmup_cosine(self.epoch, cfg["hyper"])
        self.gen = data.generator(self.seed, self.dev, 5)
        ph.mark("program_s")
        if self.control:
            self.leaves, self.opt = self.control_optimizer(self.params)
            self.run_checked(lambda: self.leaves.items(), self.opt, self.control_call)
        else:
            self.opt = make_adam(self.model.parameters())
            self.run_checked(self.model.named_parameters, self.opt, self.call)
        ph.mark("steps_s")
        self.setup_split = ph.split

    def feed(self) -> dict:
        p, n = self.patch, self.crops
        f = self.rng.integers(len(self.pool), size=n)
        y = self.rng.integers(self.h - p + 1, size=n)
        x = self.rng.integers(self.w - p + 1, size=n)
        hr = torch.stack([self.pool[i, :, a:a + p, b:b + p] for i, a, b in zip(f, y, x)])
        return {"hr": hr, "iso": torch.full((n,), self.iso, device=self.dev)}

    def call(self, batch, spans=None):
        st = self.step_obj
        if spans is None or not spans.enabled:
            m = st(self.model, self.opt, batch, self.gen, self.epoch)
        else:
            with spans.dev("synth"):
                lr_img, hr_img = st.make_pair(batch, self.gen)
            with spans.dev("fwd_bwd"):
                loss, pred = st.forward_backward(self.model, lr_img, hr_img)
            with spans.dev("adam"):
                rate = st.update(self.opt, self.epoch)
            m = st.metrics(loss, pred, hr_img, rate)
        float(m["psnr"])
        return m["loss"]

    def control_call(self, batch, spans=None):
        """The reference in the program's place, its convolutions in fp8."""
        lr_img, hr_img = self.step_obj.make_pair(batch, self.gen)
        loss = torch.mean(torch.abs(ref_unet.forward(self.leaves, lr_img, fp8) - hr_img))
        self.control_update(self.leaves, self.opt, loss)
        return loss

    def step(self, spans):
        with spans.host("feed"):
            batch = self.feed()
        (self.control_call if self.control else self.call)(batch, spans)

    def counts(self) -> dict:
        return {"flops_per_unit": 3 * counts.unet_forward_flops(self.crops, self.patch,
                                                               self.patch, self.nf)}

    def release(self):
        self.model = self.opt = self.leaves = None
        self.pool = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def pairs(self) -> list:
        """The checked steps' (lr, hr, ratio): the port's synth from the
        generator state each step started from."""
        out = []
        for batch, state in zip(self.batches, self.states):
            g = torch.Generator(device=self.dev)
            g.set_state(state)
            with torch.no_grad():
                lr, hr, ratio = self.step_obj.synth(g, batch)
            if self.clip:
                lr = lr.clamp_max(1.0) if self.clip == 2 else lr.clamp(0.0, 1.0)
                hr = hr.clamp(0.0, 1.0)
            out.append((lr, hr, ratio))
        return out

    def synth_gap(self, pairs) -> float:
        """The noise of every checked crop about its (row, channel) means,
        all crops together, against the proxy law's (ADU^2): Poisson shot of
        gain K(ISO) and the pixel law with its s0 smoothing, (1 - 1/W) of
        their sum. The pixel law is read as the port samples it, at its knots
        rounded to bfloat16 (``lookup: dot``). The row law is left out: on
        some seeds its tail is so heavy that the rows of a run cannot read
        its variance (the row means' kurtosis reached 1.6e4)."""
        ap = self.cfg["arch_proxy"]
        span = self.wp - self.bl
        params = {k: v.double() for k, v in self.proxy_params.items()}
        feat = ref_proxy.iso_features([self.iso], ap["ISO2K"]).to(self.dev)
        with torch.no_grad():
            law = ref_proxy.head(params, "pixel_stage", feat)
            law["knots"] = law["knots"].to(torch.bfloat16).double()
            var_px = float(ref_proxy.variance(law)) + ref_proxy.SMOOTH_S0**2
        k_gain = ap["ISO2K"][0] * self.iso + ap["ISO2K"][1]
        emp = want = 0.0
        for lr, hr, ratio in pairs:
            rb = ratio.double().reshape(-1, 1, 1, 1)
            noise = (lr.double() - hr.double()) / rb * span
            shot = k_gain * torch.clamp_min(hr.double() / rb, 0.0).mean(dim=(1, 2, 3)) * span
            emp += float(((noise - noise.mean(dim=3, keepdim=True)) ** 2).mean(dim=(1, 2, 3)).sum())
            want += float(((shot + var_px) * (1.0 - 1.0 / noise.shape[3])).sum())
        return abs(emp / want - 1.0)

    def check(self) -> list:
        exact_f32()
        pairs = self.pairs()
        before = {k: v.detach().clone() for k, v in self.params.items()}
        params = {k: v.clone() for k, v in self.params.items()}
        adam = ref_train.Adam(params)
        losses, g1 = [], None
        for lr, hr, _ in pairs:
            loss, grads = ref_train.unet_step(params, adam, lr, hr, self.rate)
            losses.append(loss)
            g1 = g1 or grads
        out = self.checks(losses, g1, params, before)
        out.append(("synth_pixel_var_gap", self.synth_gap(pairs),
                    self.limits["synth_pixel_var_gap"]))
        return out

    def close(self):
        self.batches, self.states, self.pool = [], [], None
