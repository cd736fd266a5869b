"""The port's fused eval step against the JAX package on the same frames.

f32: the port's ``make_eval_metrics_step`` on an f32 model reproduces the
JAX unfused f32 eval sequence (``make_eval_step(fast=False)`` -> ori ->
clip -> illuminance correction -> ``ops.metrics`` PSNR/SSIM, the sequence
of tests/test_eval_metrics_step.py) within PSNR 5e-3 dB, SSIM 1e-4 and a
frame rtol of 1e-4: the same f32 math summed in another order.

bf16: against JAX's fused step on ``transform_params_hybrid(params)``.
Both serve bf16 weights and activations, but round at different places
(JAX casts weights after folding upv9 into conv9_1 and runs level 1 in the
dense space-to-depth form; the port casts each layer's weights as they
are), so outputs differ by about one bf16 ulp (2**-8 relative). Measured
on these frames: PSNR 3.0e-4 dB, SSIM 1.7e-4, frame 3.9e-3 at values up to
0.77. Tolerances: PSNR 1e-2 dB, SSIM 1e-3, frame atol 2**-6 (four ulps at
the top binade).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnnp_tpu.models import UNetSeeInDark as FlaxUNet
from pnnp_tpu.models.unet_s2d import transform_params_hybrid
from pnnp_tpu.ops import illuminance_correct, psnr, ssim
from pnnp_tpu.train import make_eval_step as jax_make_eval_step
from pnnp_tpu.train.state import TrainState, make_adam_direction
from pnnp_tpu.train.steps import make_eval_metrics_step as jax_make_fused
from pnnp_tpu_torch.models import UNetSeeInDark, params_from_jax
from pnnp_tpu_torch.train.steps import (
    make_eval_metrics_step,
    make_eval_step,
    pad_split,
    pad_to_multiple,
)
from tests.test_torch_models import jax_unet_params

NF = 4


@pytest.fixture(scope="module")
def params():
    return jax_unet_params(NF, seed=5, head_bias=0.3)


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(0)
    lr = rng.uniform(0, 0.4, (1, 32, 48, 4)).astype(np.float32)
    hr = rng.uniform(0, 1.0, (1, 32, 48, 4)).astype(np.float32)
    hr[0, :3, :5] = 1.0  # saturated pixels: excluded from the correction fit
    return lr, hr


def _port_model(params, dtype):
    net = UNetSeeInDark(nf=NF, dtype=dtype)
    net.load_state_dict(params_from_jax(params), strict=True)
    return net.eval()


def _jax_state(params):
    model = FlaxUNet(nf=NF)
    return model, TrainState.create(apply_fn=model.apply, params=params,
                                    tx=make_adam_direction())


@pytest.mark.parametrize("ori,correct", [(False, True), (True, False)])
def test_f32_step_matches_jax_unfused_sequence(params, frames, ori, correct):
    lr, hr = frames
    ratio = 2.0
    model, state = _jax_state(params)
    dn = jax_make_eval_step(model, fast=False)(state, jnp.asarray(lr))
    lr2 = jnp.asarray(lr) * ratio if ori else jnp.asarray(lr)
    dn = dn * ratio if ori else dn
    lr2, dn = jnp.clip(lr2, 0, 1), jnp.clip(dn, 0, 1)
    if correct:
        dn = illuminance_correct(dn, jnp.asarray(hr))
    hrc = jnp.clip(jnp.asarray(hr), 0, 1)
    ref = {"psnr": psnr(dn[0] * 255.0, hrc[0] * 255.0),
           "ssim": ssim(dn[0] * 255.0, hrc[0] * 255.0),
           "psnr_in": psnr(lr2[0] * 255.0, hrc[0] * 255.0),
           "ssim_in": ssim(lr2[0] * 255.0, hrc[0] * 255.0)}

    step = make_eval_metrics_step(_port_model(params, torch.float32))
    # flat [1, H, W*4] input, the production layout
    dnf, m, lr_panel = step(torch.from_numpy(lr.reshape(1, 32, -1)),
                            torch.from_numpy(hr.reshape(1, 32, -1)), ratio,
                            ori=ori, correct=correct, with_inputs=True)
    assert set(m) == set(ref)
    for k in ("psnr", "psnr_in"):
        assert abs(float(m[k]) - float(ref[k])) < 5e-3, (k, float(m[k]), float(ref[k]))
    for k in ("ssim", "ssim_in"):
        assert abs(float(m[k]) - float(ref[k])) < 1e-4, (k, float(m[k]), float(ref[k]))
    assert dnf.shape == (1, 32, 48 * 4)
    np.testing.assert_allclose(dnf.numpy().reshape(dn.shape), np.asarray(dn),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(lr_panel.numpy().reshape(lr2.shape),
                               np.asarray(lr2), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("ori,correct", [(False, True), (True, False)])
def test_bf16_step_matches_jax_fused(params, frames, ori, correct):
    lr, hr = frames
    model = FlaxUNet(nf=NF)
    d_ref, m_ref, l_ref = jax_make_fused(model)(
        transform_params_hybrid(params), jnp.asarray(lr), jnp.asarray(hr),
        jnp.float32(2.0), ori=ori, correct=correct, with_inputs=True)
    step = make_eval_metrics_step(_port_model(params, torch.bfloat16))
    d, m, l_panel = step(torch.from_numpy(lr), torch.from_numpy(hr), 2.0,
                         ori=ori, correct=correct, with_inputs=True)
    assert set(m) == set(m_ref)
    assert abs(float(m["psnr"]) - float(m_ref["psnr"])) < 1e-2
    assert abs(float(m["ssim"]) - float(m_ref["ssim"])) < 1e-3
    # the input panel never goes through the network: f32-exact
    assert abs(float(m["psnr_in"]) - float(m_ref["psnr_in"])) < 5e-3
    assert abs(float(m["ssim_in"]) - float(m_ref["ssim_in"])) < 1e-4
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), rtol=0, atol=2**-6)
    np.testing.assert_allclose(l_panel.numpy(), np.asarray(l_ref),
                               rtol=1e-5, atol=1e-6)


def test_dump_step_matches_jax_f32(params):
    """make_eval_step (the padded plain forward of dump mode) on a
    %16-misaligned frame against JAX's make_eval_step(fast=False)."""
    x = np.random.default_rng(4).uniform(0, 1, (1, 36, 44, 4)).astype(np.float32)
    model, state = _jax_state(params)
    ref = np.asarray(jax_make_eval_step(model, fast=False)(state, jnp.asarray(x)))
    got = make_eval_step(_port_model(params, torch.float32))(torch.from_numpy(x))
    assert got.shape == (1, 36, 44, 4)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_pad_to_multiple_matches_reference_symmetric_pad():
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (1, 24, 40, 4)).astype(np.float32)  # residues 8, 8
    p, (oy, ox, H, W) = pad_to_multiple(torch.from_numpy(x), 16)
    ref = np.pad(x, ((0, 0), (4, 4), (4, 4), (0, 0)), mode="reflect")
    np.testing.assert_array_equal(p.numpy(), ref)
    assert (oy, ox, H, W) == (4, 4, 24, 40)
    y = rng.uniform(0, 1, (1, 36, 45, 4)).astype(np.float32)  # odd splits
    p, geom = pad_to_multiple(torch.from_numpy(y), 16)
    ref = np.pad(y, ((0, 0), (6, 6), (1, 2), (0, 0)), mode="reflect")
    np.testing.assert_array_equal(p.numpy(), ref)
    assert geom == (6, 1, 36, 45)
    assert pad_split(1736) == (4, 4) and pad_split(2312) == (4, 4)
    assert pad_split(1424) == (0, 0) and pad_split(2128) == (0, 0)


def test_packed_16_channel_input_raises(params):
    """A ``[.., 16]`` frame (the packed dense-s2d layout) given to a model
    of 4-channel frames is refused with a ValueError that names the layout,
    by the module and the int8 route alike, flat hr or not."""
    import pnnp_tpu_torch.models.unet_s2d_int8 as PI

    net = _port_model(params, torch.float32)
    g = torch.rand((1, 24, 32, 16), generator=torch.Generator().manual_seed(6))
    tp = make_eval_metrics_step(net).tparams()
    qp = PI.quantize_params_int8(tp, PI.calibrate_act_scales(tp, [g.permute(0, 3, 1, 2)],
                                                             torch.float32))
    for step in (make_eval_metrics_step(net), make_eval_metrics_step(net, qparams=qp)):
        for hr in (torch.zeros(1, 40, 56, 4), torch.zeros(1, 40, 56 * 4)):
            with pytest.raises(ValueError, match="packed .*16-channel layout"):
                step(g, hr, 2.0, ori=True, with_inputs=True)
