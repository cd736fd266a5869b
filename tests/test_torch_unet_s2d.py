"""The port's space-to-depth forms (``pnnp_tpu_torch/models/unet_s2d.py``)
against the JAX module on the same numpy inputs and weights.

Counterparts of tests/test_unet_s2d.py's 8 tests but its host frame pack
(the port packs no frame on the host), at its tolerances: the layout
functions bit-equal; the 2x2 s2d conv and the transposed
conv's 1x1 form rtol 1e-4 / atol 1e-5; the forwards rtol 1e-3 / atol 2e-5,
against JAX and against the port's own NCHW UNet (f32 convolutions summed
in another order). Weights are 5x the N(0, 0.02) init (std 0.1), as JAX's
tests amplify theirs, so that a mis-mapped tap cannot hide.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import pnnp_tpu.models.unet_s2d as J
import pnnp_tpu_torch.models.unet_s2d as P
from pnnp_tpu.models import UNetSeeInDark as FlaxUNet
from pnnp_tpu_torch.models import UNetSeeInDark, params_from_jax
from tests.test_torch_models import jax_unet_params

RTOL, ATOL = 1e-3, 2e-5


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def weights():
    params = jax_unet_params(4, seed=3, std=0.1)
    net = UNetSeeInDark(nf=4)
    net.load_state_dict(params_from_jax(params), strict=True)
    return params, net


def test_s2d_roundtrip(rng):
    x = rng.standard_normal((2, 8, 12, 3)).astype(np.float32)
    g = P.s2d(nchw(x))
    assert g.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(nhwc(g), np.asarray(J.s2d(jnp.asarray(x))))
    np.testing.assert_array_equal(nhwc(P.d2s(g)), x)
    np.testing.assert_array_equal(P.s2d_np(x), J.s2d_np(x))
    np.testing.assert_array_equal(P.d2s_np(P.s2d_np(x)), x)
    g4 = np.concatenate([x] * 4, -1)
    np.testing.assert_array_equal(P.d2s_np(g4), J.d2s_np(g4))


def test_s2d_conv_matches_conv3x3(rng):
    C, D = 3, 5
    x = rng.standard_normal((1, 16, 12, C)).astype(np.float32)
    k3 = rng.standard_normal((3, 3, C, D)).astype(np.float32)  # HWIO
    bias = rng.standard_normal((D,)).astype(np.float32)
    kt = torch.from_numpy(k3).permute(3, 2, 0, 1)  # OIHW
    ref = F.conv2d(nchw(x), kt, torch.from_numpy(bias), padding=1)
    ours = P.d2s(P._s2d_conv_pre(P.s2d(nchw(x)), P._transform_conv3_kernel(kt),
                                 torch.from_numpy(bias).repeat(4)))
    np.testing.assert_allclose(nhwc(ours), nhwc(ref), rtol=1e-4, atol=1e-5)
    jx = J.d2s(J._s2d_conv_pre(J.s2d(jnp.asarray(x)), J._transform_conv3_kernel(jnp.asarray(k3)),
                               jnp.tile(jnp.asarray(bias), 4)))
    np.testing.assert_allclose(nhwc(ours), np.asarray(jx), rtol=1e-4, atol=1e-5)
    # the dense form is JAX's, tap for tap
    dense = P.transform_conv3_dense(kt).permute(2, 3, 1, 0).numpy()
    np.testing.assert_array_equal(dense, np.asarray(J.transform_conv3_dense(jnp.asarray(k3))))


def test_group_max_matches_maxpool(rng):
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ours = P._group_max(P.s2d(nchw(x)))
    np.testing.assert_array_equal(nhwc(ours), nhwc(F.max_pool2d(nchw(x), 2)))
    np.testing.assert_array_equal(nhwc(ours), np.asarray(J._group_max(J.s2d(jnp.asarray(x)))))


def test_up_as_1x1_matches_convtranspose(rng):
    """The transposed conv's 1x1 s2d form against torch's own transposed
    conv, and against JAX's form on the flax (flipped) kernel."""
    Cin, Cout = 6, 4
    x = rng.standard_normal((1, 5, 7, Cin)).astype(np.float32)
    w = rng.standard_normal((Cin, Cout, 2, 2)).astype(np.float32)  # torch layout
    bias = rng.standard_normal((Cout,)).astype(np.float32)
    wt, bt = torch.from_numpy(w), torch.from_numpy(bias)
    ref = F.conv_transpose2d(nchw(x), wt, bt, stride=2)
    ours = P.d2s(P._up_as_1x1(nchw(x), wt, bt))
    np.testing.assert_allclose(nhwc(ours), nhwc(ref), rtol=1e-4, atol=1e-5)
    kt_flax = jnp.asarray(w.transpose(2, 3, 0, 1)[::-1, ::-1])
    jx = J.d2s(J._up_as_1x1(jnp.asarray(x), kt_flax, jnp.asarray(bias)))
    np.testing.assert_allclose(nhwc(ours), np.asarray(jx), rtol=1e-4, atol=1e-5)


def _flax_ref(params, x, res=False):
    return np.asarray(FlaxUNet(nf=4, res=res).apply({"params": params}, jnp.asarray(x)))


@pytest.mark.parametrize("res,shape", [(False, (1, 64, 96, 4)), (True, (1, 32, 32, 4))])
def test_full_unet_equivalence(weights, rng, res, shape):
    """The reference s2d forward (2x2 block kernels) in f32, against JAX's
    and against the port's NCHW UNet."""
    params, net = weights
    x = rng.uniform(0, 1, shape).astype(np.float32)
    net.res = res
    try:
        with torch.no_grad():
            ref = nhwc(net(nchw(x)))
            ours = nhwc(P.unet_s2d_forward(net, nchw(x), res=res, dtype=torch.float32))
    finally:
        net.res = False
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)
    jx = np.asarray(J.unet_s2d_forward(params, jnp.asarray(x), res=res, dtype=jnp.float32))
    np.testing.assert_allclose(ours, jx, rtol=RTOL, atol=ATOL)


def test_hybrid_forward_equivalence(weights, rng):
    """The hybrid form (dense-s2d level 1, upv9 folded into conv9_1) in f32,
    HWC in and out; and its weights against JAX's: the dense kernels copied
    tap for tap, the fold to f32 rounding."""
    params, net = weights
    x = rng.uniform(0, 1, (1, 64, 96, 4)).astype(np.float32)
    tp = P.transform_params_hybrid(net, dtype=torch.float32)
    with torch.no_grad():
        ours = nhwc(P.unet_hybrid_forward(tp, nchw(x), dtype=torch.float32))
        ref = nhwc(net(nchw(x)))
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)
    jtp = J.transform_params_hybrid(params, dtype=jnp.float32)
    jx = np.asarray(J.unet_hybrid_forward(jtp, jnp.asarray(x), dtype=jnp.float32))
    np.testing.assert_allclose(ours, jx, rtol=RTOL, atol=ATOL)
    hwio = lambda t: t.detach().permute(2, 3, 1, 0).numpy()
    for name in ("conv1_1", "conv1_2", "conv9_2", "conv5_1"):
        np.testing.assert_array_equal(hwio(tp[name]["kernel"]), np.asarray(jtp[name]["kernel"]))
    for key in ("kernel_up", "kernel_skip"):
        np.testing.assert_allclose(hwio(tp["conv9_1"][key]), np.asarray(jtp["conv9_1"][key]),
                                   rtol=1e-5, atol=1e-6)


def test_packed_forward_equivalence(weights, rng):
    """The packed production forward: packed in and out, against JAX's
    packed forward and against the NCHW UNet modulo the packing."""
    params, net = weights
    x = rng.uniform(0, 1, (1, 64, 96, 4)).astype(np.float32)
    tp = P.transform_params_hybrid(net, dtype=torch.float32)
    g = nchw(P.s2d_np(x))
    with torch.no_grad():
        out = P.unet_hybrid_forward_packed(tp, g, dtype=torch.float32)
        ref = nhwc(net(nchw(x)))
    assert out.shape == (1, 16, 32, 48) and out.dtype == torch.float32
    np.testing.assert_allclose(nhwc(P.d2s(out)), ref, rtol=RTOL, atol=ATOL)
    jtp = J.transform_params_hybrid(params, dtype=jnp.float32)
    jx = np.asarray(J.unet_hybrid_forward_packed(jtp, J.s2d(jnp.asarray(x)), dtype=jnp.float32))
    np.testing.assert_allclose(nhwc(out), jx, rtol=RTOL, atol=ATOL)


def test_hybrid_transform_is_differentiable(weights, rng):
    """Gradients through transform_params_hybrid land on the standard
    parameters and equal the NCHW UNet's own (f32, rtol 1e-3 of each
    gradient's max): the packed train step relies on it."""
    _, net = weights
    x = nchw(rng.uniform(0, 1, (2, 32, 32, 4)).astype(np.float32))
    y = nchw(rng.uniform(0, 1, (2, 32, 32, 4)).astype(np.float32))
    net.zero_grad()
    torch.mean(torch.abs(net(x) - y)).backward()
    ref = {n: p.grad.clone() for n, p in net.named_parameters()}
    net.zero_grad()
    tp = P.transform_params_hybrid(net, dtype=torch.float32)
    out = P.unet_hybrid_forward_packed(tp, P.s2d(x), dtype=torch.float32)
    torch.mean(torch.abs(out - P.s2d(y))).backward()
    for n, p in net.named_parameters():
        scale = float(ref[n].abs().max())
        assert float((p.grad - ref[n]).abs().max()) <= 1e-3 * scale + 1e-7, n
    net.zero_grad()
