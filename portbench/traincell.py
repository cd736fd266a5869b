"""What the two training drivers share.

Set-up builds one step object with its model and optimizer state, drives
it from the seed through its first ``checked_steps`` steps through the
window's own call and feed (each step on other rows), keeps what the
comparison needs (each step's loss, the first gradient as Adam holds it,
the parameters after the checked steps, the inputs and the generator state
before each step), and hands the same object to the window. Once the window
has closed the reference follows the checked steps from the same weights.
"""

from __future__ import annotations

import torch

from portbench import compare
from portbench.harness import OFF


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with a per-tensor scale (amax to 448),
    the gradient passed straight through: the lower-precision control."""
    scale = torch.clamp_min(t.detach().abs().amax(), 1e-30) / 448.0
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t).detach()


class TrainDriver:
    unit = "step"

    def __init__(self, cfg, traffic, limits, seed, device, workdir):
        self.cfg, self.traffic, self.limits = cfg, traffic, limits
        self.seed, self.dev, self.workdir = int(seed), device, workdir
        self.control = False
        self.epoch = int(cfg["hyper"].get("last_epoch", 0)) + 1
        self.k = 0
        self.losses, self.batches, self.states = [], [], []

    def use_control(self):
        self.control = True

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def run_checked(self, named, opt, call):
        """The first steps: ``call(batch)`` returns the step's loss tensor;
        ``named()`` gives the (name, parameter) pairs ``opt`` updates."""
        names = {id(p): n for n, p in named()}
        for k in range(int(self.traffic["checked_steps"])):
            batch = self.feed()
            self.batches.append(batch)
            self.states.append(self.gen.get_state())
            self.losses.append(call(batch).detach().clone())
            if k == 0:
                self.g1 = compare.first_grad_from_adam(opt, names)
        self.after = {n: p.detach().clone() for n, p in named()}
        for _ in range(int(self.traffic.get("warmup_steps", 0))):
            self.step(OFF)

    def control_optimizer(self, params: dict):
        """The control's parameters (leaves that take gradients) and a plain
        ``torch.optim.Adam`` with the recipes' constants over them."""
        leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        opt = torch.optim.Adam(list(leaves.values()), lr=0.0, betas=(0.9, 0.999), eps=1e-8)
        return leaves, opt

    def control_update(self, leaves: dict, opt, loss) -> None:
        opt.zero_grad(set_to_none=True)
        loss.backward()
        for g in opt.param_groups:
            g["lr"] = self.rate
        opt.step()

    def checks(self, losses_r, g1_r, after_r, before) -> list:
        return compare.train_checks(
            [float(v) for v in self.losses], losses_r, self.g1, g1_r,
            compare.delta(self.after, before), compare.delta(after_r, before), self.limits)
