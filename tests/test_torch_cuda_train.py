"""The port's train step on the card against the same step on the CPU.

These tests need an NVIDIA GPU (``cuda`` marker) and skip on a host without
one. This file imports no JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda_train.py -m cuda --noconftest -q

* The f32 step (TF32 off) at nf=4 on 8 crops of 32x32, same weights and
  batch on ``cuda`` and on ``cpu``: loss within 1e-5 relative, every
  parameter's gradient within 1e-4 of that gradient's largest magnitude
  (f32 convolutions summed in another order by cuDNN).
* The bf16 step's loss within 2e-3 of the f32 step's, the bar the JAX
  package holds its bf16 train path to, and its gradients within 5e-2 of
  each f32 gradient's largest magnitude (bf16 rounding reads 1.4e-2 on the
  CPU at these weights and batch; a zero gradient reads 1, a sign-flipped
  one 2).
* The physics-synth step (``pgrq``) on the card: finite metrics, float32
  master params on the card that moved by about lr (two Adam steps), draws
  from a generator on the card.
"""

import numpy as np
import pytest
import torch

from pnnp_tpu_torch.models import UNetSeeInDark
from pnnp_tpu_torch.train import identity_synth, make_adam, make_raw_synth, make_train_step

LR = 1e-3


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the train step's card check")
    return torch.device("cuda")


def _pair(seed=0, n=8, size=32):
    rng = np.random.default_rng(seed)
    hr = rng.uniform(0, 0.5, (n, 4, size, size)).astype(np.float32)
    lr = (hr + rng.normal(0, 0.05, hr.shape)).astype(np.float32)
    return torch.from_numpy(lr), torch.from_numpy(hr)


def _grads(device, bf16=False):
    net = UNetSeeInDark(nf=4, generator=torch.Generator().manual_seed(1)).to(device)
    step = make_train_step(lambda e: LR, identity_synth, clip_mode=2, bf16=bf16)
    lr, hr = (t.to(device) for t in _pair())
    loss, _ = step.forward_backward(net, lr, hr)
    return float(loss), {n: p.grad.detach().cpu() for n, p in net.named_parameters()}


@pytest.mark.cuda
def test_f32_step_on_card_matches_cpu(card):
    loss_c, g_c = _grads(card)
    loss_h, g_h = _grads(torch.device("cpu"))
    assert abs(loss_c - loss_h) <= 1e-5 * abs(loss_h)
    for name, ref in g_h.items():
        err = float((g_c[name] - ref).abs().max())
        assert err <= 1e-4 * float(ref.abs().max()), (name, err)


@pytest.mark.cuda
def test_bf16_step_matches_f32(card):
    loss16, g16 = _grads(card, bf16=True)
    loss32, g32 = _grads(card)
    assert abs(loss16 - loss32) < 2e-3
    for name, ref in g32.items():
        err = float((g16[name] - ref).abs().max())
        assert err < 5e-2 * float(ref.abs().max()), (name, err)


@pytest.mark.cuda
def test_physics_synth_step_on_card(card):
    net = UNetSeeInDark(nf=4, generator=torch.Generator().manual_seed(2)).to(card)
    before = {n: p.detach().clone() for n, p in net.named_parameters()}
    opt = make_adam(net.parameters())
    step = make_train_step(lambda e: LR, make_raw_synth("SonyA7S2", "pgrq", False, True),
                           clip_mode=True, bf16=True)
    gen = torch.Generator(device=card).manual_seed(3)
    hr = _pair(4)[1].to(card) * 0.05
    for e in (1, 2):
        m = step(net, opt, {"hr": hr}, gen, e)
        assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["psnr"]))
        assert m["lr"] == LR
    # Adam moves a weight by about lr where its gradient is well above eps
    # (1e-8); deep layers of this small N(0, 0.02) net may sit near eps, so
    # the check is that the params moved, not that each tensor did
    moved = max(float((p.detach() - before[n]).abs().max())
                for n, p in net.named_parameters())
    assert 0.5 * LR < moved < 3 * LR
    assert all(p.dtype == torch.float32 and p.is_cuda for p in net.parameters())
