"""Composed-prefix profile of the PNNP (proxy-synth) train step
(counterpart of ``tools/profile_proxy_step.py``).

Times successively longer prefixes of the denoiser's train step with the
learned proxy's noise, at the recipe geometry (8 crops of 512^2 packed RGBG;
the proxy at PNNP.yml's d = 1024), beside a
physics-synth control at the same shapes; the marginal column says what
each stage costs:

  sample     per-example ratio ~ U(100, 300), one ISO from ``LEGAL_ISO``,
             ``PixelWiseISOProxy.sample(hr / ratio, iso)``
  synth      ``make_proxy_synth`` (lr and hr)
  fwd        + ``clip_lr_hr`` (HALF_CLIP) + the forward + the L1 loss
  bwd        + the backward (``TrainStep.forward_backward``), every gradient
             read by one fused norm
  step       the step as ``TrainStep`` runs it (Adam included)

The step is the one the port's trainer builds: ``TrainStep(bf16=True)``,
autocast over f32 master params in ``channels_last`` memory. The control is
``make_raw_synth`` with ``pgrq`` through the same step. The clean crops are
U(0, 0.02), drawn in the s2d layout and unpacked, as in the JAX tool.

Timing: ``--scan`` calls of a prefix issued back to back between two CUDA
events, each call's scalar summed into one accumulator read back once; the
median of ``--iters`` such runs after one warm-up run (``bench_int8.median_ms``;
the host clock with ``--cpu``). The JAX tool's flags keep their meaning:
``--scan`` steps chained, ``--iters`` timed repeats.

Usage (from the repository root; on the card unless ``--cpu``):

    python -m pnnp_tpu_torch.tools.profile_proxy_step [--d 1024] [--scan 8] [--iters 8] [--small] [--cpu]

Prints one line per prefix, the control, and last the JAX tool's JSON line
(``metric``, ``d``, ``rows`` of ``prefix`` / ``cum_ms`` / ``marginal_ms``,
``physics_step_ms``, ``gap_ms``); :func:`main` returns that dict.
"""

from __future__ import annotations

import argparse
import json
import sys
from types import SimpleNamespace

import torch

from pnnp_tpu_torch.models import PixelWiseISOProxy
from pnnp_tpu_torch.models.unet_s2d import d2s
from pnnp_tpu_torch.physics.calibration import HALF_CLIP, LEGAL_ISO
from pnnp_tpu_torch.tools.profile_prefix import autocast, calls_ms, make_net
from pnnp_tpu_torch.train import make_adam
from pnnp_tpu_torch.train.losses import unet_loss
from pnnp_tpu_torch.train.steps import TrainStep, make_proxy_synth, make_raw_synth
from pnnp_tpu_torch.utils.device import card_label, resolve_device

PREFIXES = ("sample", "synth", "fwd", "bwd", "step")
LR = 1e-4  # PNNP.yml's learning_rate, held fixed
CROPS = 8
PROXY_SEED, DATA_SEED, STEP_SEED = 5, 1, 2


def forward_loss(step: TrainStep, model, lr_img, hr_img):
    """The step's forward and L1 loss, no backward: the module under bf16
    autocast (f32 with ``bf16=False``)."""
    dtype = torch.bfloat16 if step.bf16 else torch.float32
    with autocast(lr_img, dtype):
        return unet_loss(model(lr_img), hr_img)


def backward_loss(step: TrainStep, model, lr_img, hr_img):
    """``step.forward_backward``: the loss, with every parameter's gradient
    filled; returns (loss, the sum of the gradients' norms, one fused
    reduction that reads every gradient, as ``clip_grad_norm_`` does)."""
    loss, _ = step.forward_backward(model, lr_img, hr_img)
    return loss, torch.stack(torch._foreach_norm([p.grad for p in model.parameters()])).sum()


def build(d: int, small: bool, dev) -> SimpleNamespace:
    """The proxy's sample (d bins, seeded), the seeded nf=32 net and its
    Adam, the proxy and the physics ``TrainStep``, their batch and the
    step's generator."""
    hw = 32 if small else 256  # the s2d draw's side; the crop is 2 * hw
    proxy = PixelWiseISOProxy(d=d, generator=torch.Generator().manual_seed(PROXY_SEED)).to(dev)
    proxy.requires_grad_(False)

    def sample_fn(generator, clean, iso):
        with torch.autocast(clean.device.type, enabled=False):
            return proxy.sample(clean.float(), iso, generator)

    g = torch.Generator(device=dev).manual_seed(DATA_SEED)
    hr_packed = torch.rand((CROPS, 16, hw, hw), generator=g, device=dev) * 0.02
    hr = d2s(hr_packed).contiguous()
    synth = make_proxy_synth(sample_fn, ratio_range=(100.0, 300.0))
    phys = make_raw_synth("SonyA7S2", "pgrq", ori=False, clip=False)
    mk = lambda s: TrainStep(lambda epoch: LR, s, clip_mode=HALF_CLIP, bf16=True)
    net = make_net(dev)
    return SimpleNamespace(
        sample_fn=sample_fn, net=net, opt=make_adam(net.parameters()),
        step=mk(synth), step_phys=mk(phys), batch={"hr": hr},
        gen=torch.Generator(device=dev).manual_seed(STEP_SEED))


def programs(s: SimpleNamespace) -> dict:
    """Each prefix as a call returning one scalar on the device."""
    legal = torch.as_tensor(LEGAL_ISO, device=s.gen.device)

    def sample():
        hr = s.batch["hr"]
        ratio = torch.rand(hr.shape[0], generator=s.gen, device=hr.device) * 200.0 + 100.0
        iso = legal[torch.randint(len(legal), (1,), generator=s.gen, device=hr.device)]
        return s.sample_fn(s.gen, hr / ratio.reshape(-1, 1, 1, 1), iso).sum()

    def synth():
        lr, hr, _ = s.step.synth(s.gen, s.batch)
        return lr.sum() + hr.sum()

    def fwd():
        with torch.no_grad():
            return forward_loss(s.step, s.net, *s.step.make_pair(s.batch, s.gen))

    def bwd():
        loss, gsum = backward_loss(s.step, s.net, *s.step.make_pair(s.batch, s.gen))
        return loss + 0.0 * gsum

    return {"sample": sample, "synth": synth, "fwd": fwd, "bwd": bwd,
            "step": lambda: s.step(s.net, s.opt, s.batch, s.gen, 1)["loss"],
            "physics": lambda: s.step_phys(s.net, s.opt, s.batch, s.gen, 1)["loss"]}


def main(argv=None, device=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=8, help="timed repeats (median)")
    ap.add_argument("--scan", type=int, default=8, help="steps chained per timed run")
    ap.add_argument("--d", type=int, default=1024,
                    help="proxy quantile bins (runfile PNNP.yml d=1024)")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--small", action="store_true",
                    help="8x(64^2) crops instead of the 8x(512^2) recipe")
    a = ap.parse_args(argv)

    dev = torch.device("cpu") if a.cpu else resolve_device(device)
    print(f"devices: {dev} ({card_label(dev)})", file=sys.stderr)
    progs = programs(build(a.d, a.small, dev))
    rows, prev = [], 0.0
    for name in PREFIXES:
        ms = calls_ms(progs[name], a.scan, a.iters, dev)
        rows.append({"prefix": name, "cum_ms": round(ms, 3), "marginal_ms": round(ms - prev, 3)})
        prev = ms
        print(f"{name:>7}: cum {ms:7.2f} ms  marginal {rows[-1]['marginal_ms']:+7.2f} ms",
              flush=True)
    phys = calls_ms(progs["physics"], a.scan, a.iters, dev)
    print(f"physics: cum {phys:7.2f} ms  (control, full step)")
    out = {"metric": "proxy_step_profile", "d": a.d, "rows": rows,
           "physics_step_ms": round(phys, 3), "gap_ms": round(prev - phys, 3)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
