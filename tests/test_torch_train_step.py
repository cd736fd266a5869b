"""The port's train step against the JAX package's.

* Losses, lr schedules and the lr/hr clip: equal to the JAX functions to
  1e-7 (the JAX schedules compute in float32, the port's in float64).
* Adam: ``make_adam`` + ``apply_scaled_updates`` against optax's
  ``scale_by_adam`` + ``scale(-1)`` x lr (with and without global-norm
  clipping) over 3 steps, rtol 1e-6.
* The f32 step (``identity_synth``, TF32 off) against JAX
  ``make_train_step(fast=False, donate=False)`` on the same weights
  (``params_from_jax``) and batches: loss, psnr and lr, and the params after
  1 and after 3 steps, to rtol 1e-4 / atol 1e-5 (f32 convolutions summed in
  another order; gradients are far above Adam's eps, so the first step's
  sign-like update cannot flip).
* The bf16 step against the port's own f32 step: loss within 2e-3 and
  params within atol 5e-3 after one step, the bars the JAX package holds its
  own bf16 path to (tests/test_parity_and_sharding.py:100-128). Adam's
  first step moves every element by about +-lr whatever the gradient, so
  that param bar cannot see a wrong backward: the bf16 gradients are held
  against the f32 gradients on the same weights and batch, each parameter's
  within 5e-2 of its largest f32 magnitude (see the test for the readings).
* One seed gives identical params in two runs, synth included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pnnp_tpu.models import UNetSeeInDark as FlaxUNet
from pnnp_tpu.train.losses import charbonnier_loss as jax_charbonnier
from pnnp_tpu.train.losses import unet_loss as jax_unet_loss
from pnnp_tpu.train.schedules import build_lr_schedule as jax_build_lr_schedule
from pnnp_tpu.train.state import TrainState, make_adam_direction
from pnnp_tpu.train.steps import clip_lr_hr as jax_clip_lr_hr
from pnnp_tpu.train.steps import identity_synth as jax_identity_synth
from pnnp_tpu.train.steps import make_train_step as jax_make_train_step
from pnnp_tpu_torch.models import UNetSeeInDark, params_from_jax, params_to_jax
from pnnp_tpu_torch.train import (
    apply_scaled_updates,
    build_lr_schedule,
    charbonnier_loss,
    clip_lr_hr,
    identity_synth,
    make_adam,
    make_raw_synth,
    make_train_step,
    unet_loss,
)
from tests.test_torch_models import jax_unet_params

HYPERS = [
    {"lr_scheduler": "WarmupCosine", "learning_rate": 2e-4, "stop_epoch": 60,
     "last_epoch": 0, "step_size": 10, "T": 3},
    {"lr_scheduler": "WarmupCosine", "learning_rate": 1e-4, "stop_epoch": 2,
     "last_epoch": 0, "step_size": 10, "T": 3},
    {"lr_scheduler": "multistep", "learning_rate": 1e-3, "stop_epoch": 40,
     "last_epoch": 5, "step_size": 7, "T": 2},
    {"lr_scheduler": "fixed", "learning_rate": 2e-4, "stop_epoch": 5},
]
LR = 1e-3
N, H, W = 2, 32, 32


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    a, b = (rng.uniform(-0.2, 1.2, (2, 4, 8, 8)).astype(np.float32) for _ in range(2))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for ours, theirs in ((unet_loss(ta, tb), jax_unet_loss(ja, jb)),
                         (unet_loss(ta, tb, charbonnier=True),
                          jax_unet_loss(ja, jb, charbonnier=True)),
                         (charbonnier_loss(ta, tb, eps=1e-3),
                          jax_charbonnier(ja, jb, eps=1e-3))):
        assert abs(float(ours) - float(theirs)) <= 1e-7


@pytest.mark.parametrize("hyper", HYPERS, ids=lambda h: h["lr_scheduler"] + str(h["stop_epoch"]))
def test_lr_schedule_matches_jax(hyper):
    ours, theirs = build_lr_schedule(hyper), jax_build_lr_schedule(hyper)
    for e in range(0, hyper["stop_epoch"] + 1):
        assert isinstance(ours(e), float)
        assert abs(ours(e) - float(theirs(e))) <= 1e-7 * hyper["learning_rate"] * 10, e


@pytest.mark.parametrize("clip_mode", [0, False, 1, True, 2])
def test_clip_lr_hr_matches_jax(clip_mode):
    rng = np.random.default_rng(1)
    lr, hr = (rng.uniform(-0.5, 1.5, (2, 4, 4, 4)).astype(np.float32) for _ in range(2))
    got = clip_lr_hr(torch.from_numpy(lr), torch.from_numpy(hr), clip_mode)
    ref = jax_clip_lr_hr(jnp.asarray(lr), jnp.asarray(hr), clip_mode)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("clip_norm", [None, 0.5])
def test_adam_matches_optax(clip_norm):
    rng = np.random.default_rng(2)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    p0 = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(0, 0.3, s).astype(np.float32) for s in shapes] for _ in range(3)]
    lrs = [1e-3, 5e-4, 2e-3]

    tx = make_adam_direction(clip_norm=clip_norm)
    jp = [jnp.asarray(p) for p in p0]
    st = tx.init(jp)
    for g, lr in zip(grads, lrs):
        upd, st = tx.update([jnp.asarray(x) for x in g], st, jp)
        jp = optax.apply_updates(jp, jax.tree.map(lambda u: u * lr, upd))

    tp = [torch.from_numpy(p.copy()).requires_grad_() for p in p0]
    opt = make_adam(tp)
    for g, lr in zip(grads, lrs):
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x.copy())
        apply_scaled_updates(opt, lr, clip_norm)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-6, atol=1e-9)


def _batches(k):
    """k paired batches, NHWC numpy: hr on [0, 0.5], lr = hr + N(0, 0.05)."""
    rng = np.random.default_rng(3)
    out = []
    for _ in range(k):
        hr = rng.uniform(0, 0.5, (N, H, W, 4)).astype(np.float32)
        lr = (hr + rng.normal(0, 0.05, hr.shape)).astype(np.float32)
        out.append({"lr": lr, "hr": hr, "ratio": np.ones(N, np.float32)})
    return out


def _to_torch(batch):
    return {k: (torch.from_numpy(v).permute(0, 3, 1, 2).contiguous() if v.ndim == 4
                else torch.from_numpy(v)) for k, v in batch.items()}


def _port_net(params, dtype=torch.float32):
    net = UNetSeeInDark(nf=4, dtype=dtype)
    net.load_state_dict(params_from_jax(params), strict=True)
    return net


@pytest.fixture(scope="module")
def jax_trajectory():
    """JAX f32 train step (one compile), 3 steps from shared weights: the
    params after step 1 and 3 and each step's metrics."""
    params = jax_unet_params(4, seed=21, std=0.05, head_bias=0.2)
    model = FlaxUNet(nf=4)
    sched = jax_build_lr_schedule({"lr_scheduler": "fixed", "learning_rate": LR,
                                   "stop_epoch": 10})
    step = jax_make_train_step(model, sched, jax_identity_synth, clip_mode=2,
                               donate=False, fast=False)
    state = TrainState.create(apply_fn=model.apply, params=jax.tree.map(jnp.asarray, params),
                              tx=make_adam_direction())
    snaps, metrics = {}, []
    for i, b in enumerate(_batches(3)):
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                        jax.random.key(i), 1)
        metrics.append({k: float(v) for k, v in m.items()})
        if i in (0, 2):
            snaps[i + 1] = jax.tree.map(np.asarray, state.params)
    return params, snaps, metrics


def _port_run(params, steps, bf16=False):
    net = _port_net(params)
    opt = make_adam(net.parameters())
    step = make_train_step(build_lr_schedule({"lr_scheduler": "fixed", "learning_rate": LR,
                                              "stop_epoch": 10}),
                           identity_synth, clip_mode=2, bf16=bf16)
    metrics, snaps = [], {}
    for i, b in enumerate(_batches(steps)):
        m = step(net, opt, _to_torch(b), torch.Generator().manual_seed(i), 1)
        metrics.append({k: float(v) for k, v in m.items()})
        snaps[i + 1] = params_to_jax(net.state_dict())
    return snaps, metrics


def _assert_trees_close(a, b, **tol):
    assert a.keys() == b.keys()
    for name in a:
        for leaf in a[name]:
            np.testing.assert_allclose(a[name][leaf], b[name][leaf], err_msg=f"{name}/{leaf}",
                                       **tol)


def test_f32_step_matches_jax(jax_trajectory):
    params, ref_snaps, ref_metrics = jax_trajectory
    snaps, metrics = _port_run(params, 3)
    for got, ref in zip(metrics, ref_metrics):
        assert got["lr"] == pytest.approx(ref["lr"], rel=1e-6)
        assert got["loss"] == pytest.approx(ref["loss"], rel=1e-4, abs=1e-6)
        assert got["psnr"] == pytest.approx(ref["psnr"], rel=1e-4, abs=1e-4)
    for k in (1, 3):
        _assert_trees_close(snaps[k], ref_snaps[k], rtol=1e-4, atol=1e-5)
    # the params moved: a step of about lr per element
    moved = max(float(np.abs(snaps[1][n][leaf] - params[n][leaf]).max())
                for n in params for leaf in params[n])
    assert 0.5 * LR < moved < 2 * LR


def test_bf16_step_matches_f32_step(jax_trajectory):
    params = jax_trajectory[0]
    s32, m32 = _port_run(params, 1)
    s16, m16 = _port_run(params, 1, bf16=True)
    assert abs(m16[0]["loss"] - m32[0]["loss"]) < 2e-3
    _assert_trees_close(s16[1], s32[1], rtol=0, atol=5e-3)


def _grads(net, lr, hr, bf16):
    step = make_train_step(lambda e: LR, identity_synth, clip_mode=2, bf16=bf16)
    step.forward_backward(net, lr, hr)
    return {n: p.grad.clone() for n, p in net.named_parameters()}


def test_bf16_gradients_match_f32_gradients():
    """bf16 backward (autocast) against f32 backward, same N(0, 0.02) nf=4
    weights and batch of 8 crops of 32x32: every parameter's gradient within
    5e-2 of that gradient's largest f32 magnitude. Readings on the CPU: 1.4e-2
    here, 1.4e-2 to 3.3e-2 over other seeds of weights and batch. A zero
    gradient reads 1 and a sign-flipped one 2. (The wider-init weights of the
    JAX comparison above read up to 0.54 on their 2x32x32 batch: their
    prediction crosses hr, where bf16 rounding flips the L1 gradient's sign.)"""
    rng = np.random.default_rng(0)
    hr = rng.uniform(0, 0.5, (8, 4, H, W)).astype(np.float32)
    lr = (hr + rng.normal(0, 0.05, hr.shape)).astype(np.float32)
    lr, hr = torch.from_numpy(lr), torch.from_numpy(hr)
    net = UNetSeeInDark(nf=4, generator=torch.Generator().manual_seed(1))
    g32 = _grads(net, lr, hr, bf16=False)
    g16 = _grads(net, lr, hr, bf16=True)
    assert all(g.dtype == torch.float32 for g in g16.values())
    err = {n: float((g16[n] - g32[n]).abs().max() / g32[n].abs().max()) for n in g32}
    assert max(err.values()) < 5e-2, sorted(err.items(), key=lambda x: -x[1])[:3]


def test_step_is_deterministic_with_one_seed():
    """Two runs of the physics-synth bf16 step from one seed: identical params."""
    hr = np.random.default_rng(4).uniform(0, 0.05, (N, H, W, 4)).astype(np.float32)

    def run():
        net = UNetSeeInDark(nf=4, generator=torch.Generator().manual_seed(5))
        opt = make_adam(net.parameters())
        step = make_train_step(lambda e: LR, make_raw_synth("SonyA7S2", "pgrq", False, True),
                               clip_mode=True, bf16=True)
        gen = torch.Generator().manual_seed(6)
        for e in (1, 2):
            step(net, opt, _to_torch({"hr": hr}), gen, e)
        return net.state_dict()

    a, b = run(), run()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_deep_supervision_raises():
    """ROADMAP 1.13 is ported (tests/test_torch_unet_family.py holds the step
    against JAX): the deep-supervision step builds."""
    assert make_train_step(lambda e: LR, deep_supervision=True).deep_supervision
