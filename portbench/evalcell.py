"""What the two eval drivers share: the served model from the seed, the
fused eval step as ``Trainer.eval`` calls it, the per-frame record and the
comparison with the plain reference.

The comparison, on a sample of the inputs drawn from the seed (the last
time the window scored each):

* ``frame_err_ratio``: the step's scored frame (its corrected, clipped
  output) against the reference's float32 frame, by relative L2 error, over
  the same error of the reference run with bfloat16 inputs and weights in
  every convolution. A random network amplifies rounding by an amount that
  depends on its weights (a seed's bfloat16 error reads 0.7-4.3% of the
  frame); the ratio reads how far the port's error is from a bfloat16
  network's on the same weights.
* ``psnr_self_gap_db`` / ``ssim_self_gap``: the PSNR and SSIM the step
  reported against the reference's PSNR and SSIM of the frame the step
  scored.

The control is the port's own int8 serving path (W8A8, calibrated on the
cell's first three frames at percentile 99.95, as ``Trainer`` calibrates)
with the scores computed in bfloat16 by the reference: the precision below
the configuration's in each part of the step.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import counts, data
from portbench.reference import exact_f32
from portbench.reference import metrics as ref_metrics
from portbench.reference import unet as ref_unet


def bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.reshape(b.shape).double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


class EvalDriver:
    unit = "frame"
    INT8_CAL_FRAMES = 3

    def __init__(self, cfg, traffic, limits, seed, device, workdir):
        self.cfg, self.traffic, self.limits = cfg, traffic, limits
        self.seed, self.dev, self.workdir = int(seed), device, workdir
        self.arch = cfg["arch"]
        self.dst_eval = cfg["dst_eval"]
        self.h, self.w = int(self.dst_eval["H"]) // 2, int(self.dst_eval["W"]) // 2
        self.held = {}
        self.control = False
        self.model = self.step_fn = None

    def use_control(self):
        self.control = True

    # -- the program -----------------------------------------------------
    def build_program(self):
        from pnnp_tpu_torch.models import build_model
        from pnnp_tpu_torch.train.steps import make_eval_metrics_step
        from pnnp_tpu_torch.trainer import Trainer

        shapes = ref_unet.param_shapes(int(self.arch["nf"]), int(self.arch["in_nc"]),
                                       int(self.arch["out_nc"]))
        self.params = data.unet_weights(shapes, data.generator(self.seed, self.dev, 2), self.dev)
        # the Trainer's serving model: UNetSeeInDark in bf16 (its fast path)
        self.model = build_model(self.arch, dtype=torch.bfloat16).to(self.dev)
        self.model.load_state_dict(self.params)
        self.model.eval()
        self.step_fn = make_eval_metrics_step(self.model)
        # Trainer.eval's choices and its copy, on a Trainer holding only what
        # they read: the sweep's eval (epoch -1) corrects where the dataset does
        owner = Trainer.__new__(Trainer)
        owner.args, owner.device = self.cfg, self.dev
        self.correct = owner._brightness_correct(self.dst_eval)
        self.ori = bool(self.dst_eval.get("ori", self.cfg["dst"].get("ori", False)))
        self.to_device = owner._to_device
        keys = self.keys()
        rng = np.random.default_rng([self.seed, 7])
        pick = rng.choice(len(keys), size=min(int(self.traffic["sample_frames"]), len(keys)),
                          replace=False)
        self.sampled = {keys[i] for i in pick}

    def control_step(self, cal_frames):
        """The control: the port's W8A8 serving step, calibrated as the
        Trainer calibrates on its first eval frames, scored in bfloat16."""
        import pnnp_tpu_torch.models.unet_s2d_int8 as i8
        from pnnp_tpu_torch.models.unet_s2d import s2d
        from pnnp_tpu_torch.train.steps import make_eval_metrics_step, pad_to_multiple

        cal = [s2d(pad_to_multiple(x, 16)[0].permute(0, 3, 1, 2)) for x in cal_frames]
        tp = self.step_fn.tparams()
        qp = i8.quantize_params_int8(tp, i8.calibrate_act_scales(tp, cal, self.model.dtype,
                                                                 pct=99.95))
        int8 = make_eval_metrics_step(self.model, qparams=qp)

        def step(lr, hr, ratio, **kw):
            dn, _ = int8(lr, hr, ratio, **kw)
            frame = dn.reshape(hr.shape[1], -1, 4) * 255.0
            hrc = hr[0].float().clamp(0.0, 1.0) * 255.0
            m = {"psnr": ref_metrics.psnr(frame, hrc, dtype=torch.bfloat16),
                 "ssim": ref_metrics.ssim(frame, hrc, dtype=torch.bfloat16)}
            return dn, m

        return step

    def score(self, key, lr, hr, ratio, spans):
        with spans.dev("eval_step"):
            dn, m = self.step_fn(lr, hr, ratio, ori=self.ori, correct=self.correct)
            p, s = float(m["psnr"]), float(m["ssim"])
        if key in self.sampled:
            self.held[key] = (dn, p, s)

    # -- the harness's interface -------------------------------------------
    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def counts(self) -> dict:
        return {"flops_per_unit": counts.unet_forward_flops(1, self.h, self.w,
                                                           int(self.arch["nf"])),
                "ssim_bound_s": counts.ssim_bound_s(self.h, 4 * self.w)}

    def counters(self) -> dict:
        from pnnp_tpu_torch.kernels.ssim import launches_by_route

        return {"ssim_launches": dict(launches_by_route)}

    def release(self):
        self.model = self.step_fn = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> list:
        exact_f32()
        ratio_err = psnr_gap = ssim_gap = 0.0
        for key, (dn, p, s) in self.held.items():
            lr, hr, ratio = self.reference_inputs(key)
            x = lr.permute(2, 0, 1)[None]
            with torch.no_grad():
                frames = [ref_metrics.score_frame(
                    ref_unet.forward_frame(self.params, x, quant)[0].permute(1, 2, 0), hr,
                    ratio, self.ori, self.correct)[0] for quant in (None, bf16)]
            ratio_err = max(ratio_err, rel_err(dn, frames[0]) / rel_err(frames[1], frames[0]))
            mine = dn.reshape(hr.shape).float() * 255.0
            hrc = hr.float().clamp(0.0, 1.0) * 255.0
            psnr_gap = max(psnr_gap, abs(p - ref_metrics.psnr(mine, hrc)))
            ssim_gap = max(ssim_gap, abs(s - ref_metrics.ssim(mine, hrc)))
        lim = self.limits
        return [("frame_err_ratio", ratio_err, lim["frame_err_ratio"]),
                ("psnr_self_gap_db", psnr_gap, lim["psnr_self_gap_db"]),
                ("ssim_self_gap", ssim_gap, lim["ssim_self_gap"])]
