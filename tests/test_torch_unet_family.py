"""The rest of the UNet family, its blocks and its losses in the PyTorch port
against the flax modules and the JAX functions.

* ``DeepUNet``, ``ResUNet`` and ``DeepResUNet`` on a JAX parameter tree
  carried across (``params_from_jax``): f32 forwards, eval and train mode
  (the deep-supervision tuple), at an even size (32 x 48), where XLA's
  stride-2 SAME padding is ``(0, 1)`` and torch's ``padding=1`` would shift
  every ResUNet level by half a pixel: rtol 1e-5 / atol 1e-5.
* ``build_model`` under every alias of ``pnnp_tpu/models/registry.py``.
* The blocks of ``models/blocks.py`` on the same weights: 1e-5.
* Every loss of ``train/losses.py`` and ``train/flow_losses.py``: 1e-6
  (the port's NCHW against JAX's NHWC).
* Two f32 ``use_dpsv`` train steps (DeepUNet, the deep-supervision loss)
  against JAX ``make_train_step(deep_supervision=True)``: loss and params
  after each step, rtol 1e-4 / atol 1e-5 (the f32 step's bar in
  tests/test_torch_train_step.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pnnp_tpu.models.blocks as JB
import pnnp_tpu.train.flow_losses as JFL
import pnnp_tpu.train.losses as JL
from pnnp_tpu.models import unet as JU
from pnnp_tpu.models.registry import _REGISTRY as JAX_REGISTRY
from pnnp_tpu.train.schedules import build_lr_schedule as jax_build_lr_schedule
from pnnp_tpu.train.state import TrainState, make_adam_direction
from pnnp_tpu.train.steps import identity_synth as jax_identity_synth
from pnnp_tpu.train.steps import make_train_step as jax_make_train_step
import pnnp_tpu_torch.models.blocks as TB
import pnnp_tpu_torch.train.flow_losses as TFL
import pnnp_tpu_torch.train.losses as TL
from pnnp_tpu_torch.models import build_model, params_from_jax, params_to_jax
from pnnp_tpu_torch.models import unet as TU
from pnnp_tpu_torch.train import build_lr_schedule, identity_synth, make_adam, make_train_step

ARCHS = {"DeepUNet": (JU.DeepUNet, TU.DeepUNet), "ResUNet": (JU.ResUNet, TU.ResUNet),
         "DeepResUNet": (JU.DeepResUNet, TU.DeepResUNet)}
DEEP = ("DeepUNet", "DeepResUNet")
TOL = dict(rtol=1e-5, atol=1e-5)


def _seeded_tree(shapes, seed, std):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: (rng.standard_normal(s.shape) * std).astype(np.float32),
                        shapes)


def jax_params(name, nf=4, seed=0, std=0.05):
    """Seeded numpy params of a flax arch (``jax.eval_shape`` of its init, in
    train mode where it has heads, so that the tree holds them)."""
    cls = ARCHS[name][0]
    kw = {"train": True} if name in DEEP else {}
    shapes = jax.eval_shape(
        lambda k, x: cls(nf=nf).init(k, x, **kw), jax.random.key(0),
        jax.ShapeDtypeStruct((1, 16, 16, 4), jnp.float32))["params"]
    return _seeded_tree(shapes, seed, std)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(1).uniform(0, 1, (2, 32, 48, 4)).astype(np.float32)


@pytest.mark.parametrize("res", [False, True])
@pytest.mark.parametrize("name", list(ARCHS))
def test_forward_matches_flax(name, res, frames):
    jcls, tcls = ARCHS[name]
    params = jax_params(name)
    ref = np.asarray(jcls(nf=4, res=res).apply({"params": params}, jnp.asarray(frames)))
    net = tcls(nf=4, res=res)
    net.load_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        got = _nhwc(net(_nchw(frames)))
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("res", [False, True])
@pytest.mark.parametrize("name", DEEP)
def test_train_mode_heads_match_flax(name, res, frames):
    jcls, tcls = ARCHS[name]
    params = jax_params(name, seed=2)
    ref = jcls(nf=4, res=res).apply({"params": params}, jnp.asarray(frames), train=True)
    net = tcls(nf=4, res=res)
    net.load_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        got = net(_nchw(frames), train=True)
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(_nhwc(g), np.asarray(r), **TOL)


@pytest.mark.parametrize("size", [(32, 48), (33, 47)])
def test_stride2_same_padding_is_xla_s(size):
    """SameConv2d at stride 2 against flax's SAME convolution, even and odd;
    torch's symmetric ``padding=1`` differs at the even size (the trap)."""
    import flax.linen as nn

    x = np.random.default_rng(3).standard_normal((1, *size, 3)).astype(np.float32)
    conv = nn.Conv(5, (3, 3), strides=(2, 2), padding="SAME")
    p = _seeded_tree(jax.eval_shape(conv.init, jax.random.key(0),
                                    jax.ShapeDtypeStruct(x.shape, jnp.float32))["params"], 4, 0.3)
    ref = np.asarray(conv.apply({"params": p}, jnp.asarray(x)))
    ours = TU.SameConv2d(3, 5, 3, stride=2)
    with torch.no_grad():
        ours.weight.copy_(torch.from_numpy(np.asarray(p["kernel"]).transpose(3, 2, 0, 1)))
        ours.bias.copy_(torch.from_numpy(np.asarray(p["bias"])))
        got = _nhwc(ours(_nchw(x)))
        sym = _nhwc(torch.nn.functional.conv2d(_nchw(x), ours.weight, ours.bias,
                                               stride=2, padding=1))
    np.testing.assert_allclose(got, ref, **TOL)
    if size[0] % 2 == 0:
        assert np.abs(sym - ref).max() > 1e-2


@pytest.mark.parametrize("alias", sorted(JAX_REGISTRY))
def test_build_model_every_alias(alias):
    net = build_model({"name": alias, "nf": 4, "res": True}, dtype=torch.bfloat16,
                      generator=torch.Generator().manual_seed(0))
    assert type(net).__name__ == JAX_REGISTRY[alias].__name__
    assert net.res and net.dtype == torch.bfloat16
    y = net(torch.zeros(1, 4, 16, 16))
    assert y.dtype == torch.float32 and y.shape == (1, 4, 16, 16)
    # the checkpoint tree goes to JAX and back by name
    state = params_from_jax(params_to_jax(net.state_dict()))
    assert state.keys() == net.state_dict().keys()


# ------------------------------------------------------------------ blocks
def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _load(module, params, names, stats=None):
    """Copy flax leaves into ``module``: ``names`` maps a flax module path
    to the torch submodule name."""
    state = {}
    for path, v in _flat(params):
        mod, leaf = names["/".join(path[:-1])], path[-1]
        if leaf == "kernel":
            v = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        state[f"{mod}.{leaf}"] = torch.from_numpy(np.ascontiguousarray(v))
    for path, v in _flat(stats or {}):
        state[f"{names['/'.join(path[:-1])]}.running_{path[-1]}"] = torch.from_numpy(v.copy())
    missing = module.load_state_dict(state, strict=False)
    assert not missing.unexpected_keys
    assert all(k.endswith(("running_mean", "running_var")) for k in missing.missing_keys)


def _block_case(jmod, tmod, names, x, train=None, seed=5):
    kw = {} if train is None else {"train": train}
    variables = jax.eval_shape(lambda k, a: jmod.init(k, a, **kw), jax.random.key(0),
                               jax.ShapeDtypeStruct(x.shape, jnp.float32))
    params = _seeded_tree(variables["params"], seed, 0.2)
    stats = None
    if "batch_stats" in variables:
        stats = _seeded_tree(variables["batch_stats"], seed + 1, 0.2)
        stats = jax.tree.map(np.abs, stats)
    _load(tmod, params, names, stats)
    jv = {"params": params} | ({"batch_stats": stats} if stats else {})
    if train:
        ref, _ = jmod.apply(jv, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        ref = jmod.apply(jv, jnp.asarray(x), **kw)
    with torch.no_grad():
        got = tmod(_nchw(x), **kw) if kw else tmod(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), **TOL)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv_with_bn_matches_flax(stride, train):
    x = np.random.default_rng(6).standard_normal((2, 12, 16, 3)).astype(np.float32)
    _block_case(JB.ConvWithBN(6, stride=stride), TB.ConvWithBN(3, 6, stride=stride),
                {"Conv_0": "conv", "BatchNorm_0": "bn"}, x, train=train)


def test_double_conv_and_attention_blocks_match_flax():
    x = np.random.default_rng(7).standard_normal((2, 12, 16, 32)).astype(np.float32)
    _block_case(JB.DoubleConvBlock(8), TB.DoubleConvBlock(32, 8),
                {"ConvWithBN_0/Conv_0": "conv_a.conv", "ConvWithBN_1/Conv_0": "conv_b.conv"},
                x, train=False)
    _block_case(JB.ChannelAttention(ratio=8), TB.ChannelAttention(32, ratio=8),
                {"Dense_0": "fc1", "Dense_1": "fc2"}, x)
    _block_case(JB.SpatialAttention(), TB.SpatialAttention(), {"Conv_0": "conv"}, x)
    _block_case(JB.CBAM(ratio=8), TB.CBAM(32, ratio=8),
                {"ChannelAttention_0/Dense_0": "channel.fc1",
                 "ChannelAttention_0/Dense_1": "channel.fc2",
                 "SpatialAttention_0/Conv_0": "spatial.conv"}, x)


def test_upsample_resstack_shuffle_and_concat_match_flax():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 6, 10, 8)).astype(np.float32)
    _block_case(JB.UpsampleBlock(3), TB.UpsampleBlock(8, 3), {"Conv_0": "conv"}, x)
    _block_case(JB.ResBlockStack(5, n_layers=2), TB.ResBlockStack(8, 5, n_layers=2),
                {f"block{i}/{c}": f"block{i}.{c}" for i in range(2)
                 for c in ("conv1", "conv2", "short_cut")}, x)
    np.testing.assert_array_equal(_nhwc(TB.pixel_shuffle(_nchw(x), 2)),
                                  np.asarray(JB.pixel_shuffle(jnp.asarray(x), 2)))
    np.testing.assert_array_equal(_nhwc(TB.pixel_unshuffle(_nchw(x), 2)),
                                  np.asarray(JB.pixel_unshuffle(jnp.asarray(x), 2)))
    a = rng.standard_normal((1, 5, 7, 3)).astype(np.float32)
    b = rng.standard_normal((1, 8, 6, 2)).astype(np.float32)
    np.testing.assert_array_equal(_nhwc(TB.concat_pad(_nchw(a), _nchw(b))),
                                  np.asarray(JB.concat_pad(jnp.asarray(a), jnp.asarray(b))))


# ------------------------------------------------------------------ losses
def _pair(seed, shape=(2, 16, 24, 4), lo=-0.2, hi=1.2):
    rng = np.random.default_rng(seed)
    return [rng.uniform(lo, hi, shape).astype(np.float32) for _ in range(2)]


def _close(got, ref, tol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(ref, np.float64),
                               rtol=tol, atol=tol)


def test_pyramid_and_dpsv_losses_match_jax():
    a, b = _pair(10)
    ta, tb, ja, jb = _nchw(a), _nchw(b), jnp.asarray(a), jnp.asarray(b)
    for g, r in zip(TL.pyramid_sample(ta, 8), JL.pyramid_sample(ja, 8)):
        _close(_nhwc(g), r)
    lows_t, lows_j = [ta] + TL.pyramid_sample(ta), [ja] + JL.pyramid_sample(ja)
    highs_t, highs_j = [tb] + TL.pyramid_sample(tb), [jb] + JL.pyramid_sample(jb)
    for cb in (False, True):
        _close(TL.pyramid_loss(lows_t, highs_t, 0.5, cb), JL.pyramid_loss(lows_j, highs_j, 0.5, cb))
        _close(TL.unet_dpsv_loss(lows_t, tb, cb), JL.unet_dpsv_loss(lows_j, jb, cb))
        outs_t = [ta, ta] + TL.pyramid_sample(ta, 4)
        outs_j = [ja, ja] + JL.pyramid_sample(ja, 4)
        _close(TL.unet_dpsv_up_loss(outs_t, tb, cb), JL.unet_dpsv_up_loss(outs_j, jb, cb))


@pytest.mark.parametrize("mode", ["sobel", "robert"])
def test_gradient_losses_match_jax(mode):
    a, b = _pair(11)
    ta, tb, ja, jb = _nchw(a), _nchw(b), jnp.asarray(a), jnp.asarray(b)
    for d in ("x", "y"):
        _close(_nhwc(TL.gradient(ta, d, mode)), JL.gradient(ja, d, mode))
    _close(TL.grad_loss(ta, tb, mode), JL.grad_loss(ja, jb, mode))


def test_gan_psnr_charbonnier_losses_match_jax():
    a, b = _pair(12, lo=0.0, hi=1.0)
    ta, tb, ja, jb = _nchw(a), _nchw(b), jnp.asarray(a), jnp.asarray(b)
    logits = np.random.default_rng(13).normal(0, 3, (4, 1, 5, 5)).astype(np.float32)
    for mode in ("lsgan", "vanilla"):
        for real in (True, False):
            _close(TL.gan_loss(torch.from_numpy(logits), real, mode),
                   JL.gan_loss(jnp.asarray(logits), real, mode))
    _close(TL.psnr_loss(ta, tb), JL.psnr_loss(ja, jb), 1e-5)
    _close(TL.charbonnier_loss(ta, tb), JL.charbonnier_loss(ja, jb))


def test_flow_losses_match_jax():
    a, b = _pair(14, shape=(2, 16, 20, 3), lo=0.0, hi=1.0)
    ta, tb, ja, jb = _nchw(a), _nchw(b), jnp.asarray(a), jnp.asarray(b)
    mask = (np.random.default_rng(15).uniform(size=(2, 16, 20, 1)) > 0.3).astype(np.float32)
    _close(_nhwc(TFL.epe_loss(ta, tb, _nchw(mask))), JFL.epe_loss(ja, jb, jnp.asarray(mask)))
    _close(_nhwc(TFL.ternary_loss(ta, tb)), JFL.ternary_loss(ja, jb), 1e-5)
    _close(_nhwc(TFL.sobel_loss(ta, tb)), JFL.sobel_loss(ja, jb))


# --------------------------------------------------------- use_dpsv step
LR = 1e-3


def _dpsv_batches(k, n=2, h=32, w=32):
    rng = np.random.default_rng(16)
    out = []
    for _ in range(k):
        hr = rng.uniform(0, 0.5, (n, h, w, 4)).astype(np.float32)
        lr = (hr + rng.normal(0, 0.05, hr.shape)).astype(np.float32)
        out.append({"lr": lr, "hr": hr, "ratio": np.ones(n, np.float32)})
    return out


def test_dpsv_train_step_matches_jax():
    params = jax_params("DeepUNet", seed=17)
    hyper = {"lr_scheduler": "fixed", "learning_rate": LR, "stop_epoch": 10}
    model = JU.DeepUNet(nf=4)
    step = jax_make_train_step(model, jax_build_lr_schedule(hyper), jax_identity_synth,
                               clip_mode=2, deep_supervision=True, donate=False)
    state = TrainState.create(apply_fn=model.apply, params=jax.tree.map(jnp.asarray, params),
                              tx=make_adam_direction())
    net = TU.DeepUNet(nf=4)
    net.load_state_dict(params_from_jax(params), strict=True)
    opt = make_adam(net.parameters())
    tstep = make_train_step(build_lr_schedule(hyper), identity_synth, clip_mode=2,
                            deep_supervision=True)
    for i, b in enumerate(_dpsv_batches(2)):
        state, m_ref = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                            jax.random.key(i), 1)
        tb = {k: (_nchw(v).contiguous() if v.ndim == 4 else torch.from_numpy(v))
              for k, v in b.items()}
        m = tstep(net, opt, tb, torch.Generator().manual_seed(i), 1)
        assert float(m["loss"]) == pytest.approx(float(m_ref["loss"]), rel=1e-4, abs=1e-6)
        assert float(m["psnr"]) == pytest.approx(float(m_ref["psnr"]), rel=1e-4, abs=1e-4)
        got = params_to_jax(net.state_dict())
        ref = jax.tree.map(np.asarray, state.params)
        for path, v in _flat(ref):
            node = got
            for p in path:
                node = node[p]
            np.testing.assert_allclose(node, v, rtol=1e-4, atol=1e-5, err_msg=str(path))
