"""The proxy's own training, PNNP's first stage: ``trainer_nf``'s
``make_proxy_train_step`` (the masked NLL of ``pw_iso_2stage``, its
backward, Adam at the runfile's schedule) in float32, its NLL read on the
host every step as ``NFTrainer.train`` reads it.

Each step takes one packed dark frame of ``patch_size`` (ratio 1, a clean
frame of zeros), drawn on the card from the seed by the ``pgrq`` law at
the ISOs of the configuration's dark table in turn (a pool of frames,
cycled).

The comparison: the reference follows the checked steps from the same
weights in float64. The step's work is elementwise float32, where TF32 does
not apply, so the control is the reference with its bin law (the
``[pixels, d + 1]`` work) in bfloat16, put in the program's place.
"""

from __future__ import annotations

import torch

from portbench import counts, data
from portbench.harness import Phases
from portbench.reference import exact_f32
from portbench.reference import proxy as ref_proxy
from portbench.reference import train as ref_train
from portbench.traincell import TrainDriver


class Driver(TrainDriver):
    def setup(self):
        from pnnp_tpu_torch.models import build_proxy
        from pnnp_tpu_torch.train import build_lr_schedule, make_adam
        from pnnp_tpu_torch.trainer_nf import make_proxy_train_step

        ph = Phases(self.sync)
        cfg, dst = self.cfg, self.cfg["dst_train"]
        self.patch = int(dst["patch_size"])
        self.wp, self.bl = float(dst["wp"]), float(dst["bl"])
        self.ap = cfg["arch_proxy"]
        hyper = cfg["hyper"]
        table = cfg["assumed"]["dark_iso_table"]
        self.isos = [float(i) for i in self.traffic["isos"]]
        gen = data.generator(self.seed, self.dev, 8)
        span = self.wp - self.bl
        self.pool = [data.dark_noise(1, 4, self.patch, self.patch, *table[str(int(iso))], span,
                                     gen, self.dev)
                     for iso in self.isos * int(self.traffic["pool_per_iso"])]
        self.zeros = torch.zeros_like(self.pool[0])
        self.ones = torch.ones(1, device=self.dev)
        self.params = data.proxy_weights(
            ref_proxy.param_shapes(int(self.ap["d"]), int(self.ap["nf"]), int(self.ap["nb"])),
            data.generator(self.seed, self.dev, 4), self.dev)
        ph.mark("data_s")
        self.proxy = build_proxy(dict(self.ap, name="pw_iso_2stage"), wp=self.wp,
                                 bl=self.bl).to(self.dev)
        self.proxy.load_state_dict(self.params)
        clip = float(hyper["clip_norm"]) if hyper.get("clip_norm") else None
        self.step_obj = make_proxy_train_step(
            self.proxy, build_lr_schedule(hyper),
            dark_thresh=float(hyper.get("dark_thresh", ref_proxy.DARK_THRESH)), clip_norm=clip)
        self.rate = ref_train.warmup_cosine(self.epoch, hyper)
        self.gen = data.generator(self.seed, self.dev, 9)  # no draws: the feed is the pool
        ph.mark("program_s")
        if self.control:
            self.leaves, self.opt = self.control_optimizer(self.params)
            self.run_checked(lambda: self.leaves.items(), self.opt, self.control_call)
        else:
            self.opt = make_adam(self.proxy.parameters())
            self.run_checked(self.proxy.named_parameters, self.opt, self.call)
        ph.mark("steps_s")
        self.setup_split = ph.split

    def feed(self) -> dict:
        k = self.k
        self.k += 1
        return {"lr": self.pool[k % len(self.pool)], "hr": self.zeros, "ratio": self.ones,
                "iso": torch.full((1,), self.isos[k % len(self.isos)], device=self.dev)}

    def call(self, b, spans=None):
        st = self.step_obj
        if spans is None or not spans.enabled:
            m = st(self.opt, b["lr"], b["hr"], b["ratio"], b["iso"], self.epoch)
        else:
            with spans.dev("nll_fwd_bwd"):
                m = st.forward_backward(self.opt, b["lr"], b["hr"], b["ratio"], b["iso"])
            with spans.dev("adam"):
                st.update(self.opt, self.epoch)
        float(m["nll"])
        return m["nll"]

    def control_call(self, b, spans=None):
        """The reference in the program's place, its bin law in bfloat16."""
        loss = ref_proxy.nll(self.leaves, (b["lr"] - b["hr"]) / b["ratio"].reshape(-1, 1, 1, 1),
                             b["hr"], b["ratio"], b["iso"], self.ap["ISO2K"], self.wp, self.bl,
                             int(self.ap["nb"]), core_dtype=torch.bfloat16)
        self.control_update(self.leaves, self.opt, loss)
        return loss

    def step(self, spans):
        with spans.host("feed"):
            batch = self.feed()
        (self.control_call if self.control else self.call)(batch, spans)

    def counts(self) -> dict:
        p, d = self.patch, int(self.ap["d"])
        return {"ops_per_unit": counts.proxy_nll_ops(1, 4, p, p, d, int(self.ap["nf"]),
                                                    int(self.ap["nb"]))}

    def release(self):
        self.proxy = self.step_obj = self.opt = self.leaves = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> list:
        exact_f32()
        before = {k: v.detach().double() for k, v in self.params.items()}
        params = {k: v.clone() for k, v in before.items()}
        adam = ref_train.Adam(params)
        losses, g1 = [], None
        for b in self.batches:
            leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            noise = (b["lr"] - b["hr"]) / b["ratio"].reshape(-1, 1, 1, 1)
            loss = ref_proxy.nll(leaves, noise, b["hr"], b["ratio"], b["iso"],
                                 self.ap["ISO2K"], self.wp, self.bl, int(self.ap["nb"]))
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            adam.step(params, grads, self.rate)
            losses.append(float(loss))
            g1 = g1 or grads
        return self.checks(losses, g1, params, before)

    def close(self):
        self.batches, self.pool = [], []
