"""NoiseFlow's layers and the whole flow against the JAX package's, on
shared weights and ``batch_stats`` carried across by
``models/convert.py::flow_params_{to,from}_jax``.

* The parameter and ``batch_stats`` trees equal the flax init's, path for
  path and shape for shape (``jax.eval_shape``: no eager flax init), for the
  production arch string with and without the permutation layers.
* ``_interp_iso`` on the ladder, off it and out of its range, scalar and
  per-example: within 1e-6 (the last bit of ``exp``), each row the ladder
  entry's at or just above the ISO.

Tolerances are f32's: each value within ``rtol`` of JAX's or within
``atol`` times the largest magnitude of JAX's array.

* Each bijector (SignalDependantISO, GainISO, InvertibleConv1x1,
  AffineCoupling in eval and train mode) on random non-init weights:
  forward z and log-det within rtol 1e-5 / atol 1e-5, inverse 1e-5 / 1e-6,
  the coupling's running stats after a train-mode pass 1e-5 / 1e-6.
* NoiseFlow at ``sdn|unc|unc|unc|unc|giso|unc|unc|unc|unc`` on 2 x 4 x
  16 x 16 (tests/test_models.py:107-146 on the port): forward z and
  log-det (1e-5 / 1e-5; the log-det also against ``slogdet`` of each 1x1
  conv), inverse (1e-4 / 1e-4: eighteen layers of f32), the NLL and
  ``sd_z`` (rtol 1e-5) and the NLL's gradients (eval mode: atol 1e-4 of
  each leaf's largest, measured 9.5e-7; train mode, where JAX's f32 batch
  statistics lose digits: 1e-4 of the largest over all leaves, measured
  3.2e-5, and the port within rtol 1e-4 / 1e-6 of that of its float64
  value);
  ``batch_stats`` after 1 and 3 train-mode passes (atol 1e-6).
* A checkpoint of either package loads in the other and samples the same
  noise from the same ``z`` (1e-4 / 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnnp_tpu.models.flows import conv1x1 as jconv, coupling as jcoup, sdn as jsdn
from pnnp_tpu.models.noise_flow import NoiseFlow as JNoiseFlow
from pnnp_tpu.train.checkpoint import load_any as jax_load_any
from pnnp_tpu_torch.models import NoiseFlow, flow_params_from_jax, flow_params_to_jax
from pnnp_tpu_torch.models.flows import (
    AffineCoupling,
    GainISO,
    InvertibleConv1x1,
    SignalDependantISO,
)
from pnnp_tpu_torch.models.flows.sdn import _interp_iso
from pnnp_tpu_torch.physics.calibration import LEGAL_ISO
from pnnp_tpu_torch.train import CheckpointManager

ARCH = "sdn|unc|unc|unc|unc|giso|unc|unc|unc|unc"
N, H, W = 2, 16, 16
ISOS = np.array([800.0, 3200.0], np.float32)


def nhwc(t):
    return jnp.asarray(t.detach().permute(0, 2, 3, 1).numpy())


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _inputs(seed=0, n=N, h=H, w=W):
    """Noise at a few hundred ADU over the Sony span and clean in [0, 0.2]."""
    rng = np.random.default_rng(seed)
    noise = torch.from_numpy((rng.normal(0, 0.01, (n, 4, h, w))).astype(np.float32))
    clean = torch.from_numpy(rng.uniform(0, 0.2, (n, 4, h, w)).astype(np.float32))
    return noise, clean


def _randomize(module, seed=0):
    """Non-init weights and stats: every learned leaf moved off its init
    (the frozen permutation and signs and the ISO ladder stay), BatchNorm
    stats away from 0/1."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in list(module.named_parameters()) + list(module.named_buffers()):
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("p", "sign_s", "legal_iso"):
                continue
            if leaf == "running_var":
                v = rng.uniform(0.5, 1.5, p.shape)
            elif leaf == "scale":
                v = rng.uniform(0.05, 0.2, p.shape)
            elif leaf in ("cam_param", "logs"):
                v = rng.normal(0, 0.05, p.shape)
            elif p.dim() == 0:  # gain, beta1, beta2, gain_params: near their init
                v = float(p) + rng.normal(0, 0.3)
            else:
                v = rng.normal(0, 0.1, p.shape)
            p.copy_(torch.as_tensor(v, dtype=torch.float32))
    return module


def _trees(module):
    params, stats = flow_params_to_jax(module.state_dict())
    params = jax.tree.map(jnp.asarray, params)
    return ({"params": params, "batch_stats": jax.tree.map(jnp.asarray, stats)}
            if stats else {"params": params})


def _close(got, ref, rtol=1e-5, atol=1e-6, what=""):
    """Within ``rtol`` or ``atol`` times the largest magnitude of ``ref``."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol,
                               atol=atol * max(float(np.abs(ref).max()), 1e-30), err_msg=what)


def _paths(tree):
    return sorted((jax.tree_util.keystr(p), tuple(np.shape(v)))
                  for p, v in jax.tree_util.tree_leaves_with_path(tree))


# ------------------------------------------------------------ trees, init
@pytest.mark.parametrize("perm", [1, 0])
def test_trees_equal_the_flax_init(perm):
    shapes = jax.eval_shape(
        lambda k: JNoiseFlow(x_shape=(H, W, 4), arch=ARCH, flow_permutation=perm).init(
            k, jnp.zeros((1, H, W, 4)), clean=jnp.zeros((1, H, W, 4)), iso=1600.0),
        jax.random.key(0))
    params, stats = flow_params_to_jax(NoiseFlow(ARCH, perm).state_dict())
    assert _paths(params) == _paths(shapes["params"])
    assert _paths(stats) == _paths(shapes["batch_stats"])
    # and back: the state_dict round-trips bit for bit
    tf = NoiseFlow(ARCH, perm, generator=torch.Generator().manual_seed(1))
    back = flow_params_from_jax(*flow_params_to_jax(tf.state_dict()))
    assert back.keys() == tf.state_dict().keys()
    assert all(torch.equal(back[k], v) for k, v in tf.state_dict().items())


def test_init_follows_the_jax_law():
    """QR of a normal draw then LU; normal(width / 512 * 0.05) on the first
    two coupling kernels, zeros on the last and on ``logs``, ``scale``
    1e-4, BatchNorm at (1, 0) with stats (0, 1); the ISO tables at their
    constants."""
    tf = NoiseFlow(ARCH, generator=torch.Generator().manual_seed(0))
    conv = tf.conv1x1_1
    w = conv.weight().detach()
    torch.testing.assert_close(w @ w.T, torch.eye(4), atol=1e-5, rtol=0)
    lu = {k: v.detach() for k, v in conv.lu.items()}
    assert torch.equal(lu["p"] @ lu["p"].T, torch.eye(4))
    assert torch.equal(torch.tril(lu["l"], -1), lu["l"]) and torch.equal(torch.triu(lu["u"], 1), lu["u"])
    assert set(lu["sign_s"].tolist()) <= {-1.0, 1.0}
    kernels = torch.cat([getattr(tf, f"unc_{i}").net.conv2d_1.weight.detach().reshape(-1)
                         for i in (1, 2, 3, 4, 6, 7, 8, 9)])
    assert abs(float(kernels.std()) / (4 / 512 * 0.05) - 1) < 0.1
    net = tf.unc_1.net
    assert not net.conv2d_3.weight.any() and not net.logs.any() and net.scale.item() == pytest.approx(1e-4)
    assert torch.equal(net.bn1.running_var, torch.ones(4)) and not net.bn1.running_mean.any()
    assert (tf.sdn_0.gain.item(), tf.sdn_0.beta1.item(), tf.sdn_0.beta2.item()) == (-6.0, -5.0, -4.0)
    assert tf.giso_5.gain_params.item() == -5.0 and tf.giso_5.cam_param.shape == (len(LEGAL_ISO),)


# ---------------------------------------------------------------- the ladder
@pytest.mark.parametrize("iso", [800.0, 1600.0, 51200.0, 50.0, 700.0, 6000.0, 11000.0,
                                 10.0, 60000.0, [800.0, 700.0, 60000.0, 12800.0]])
def test_interp_iso_matches_jax(iso):
    cam = np.random.default_rng(1).normal(0, 0.5, (len(LEGAL_ISO), 3)).astype(np.float32)
    got = _interp_iso(torch.from_numpy(LEGAL_ISO), torch.from_numpy(cam), iso)
    ref = jsdn._interp_iso(jnp.asarray(LEGAL_ISO), jnp.asarray(cam), jnp.asarray(iso, jnp.float32))
    assert tuple(got.shape) == ref.shape
    _close(got.numpy(), ref, rtol=1e-6, atol=0)  # exp's last bit may differ
    # an off-ladder ISO takes the row of the ladder entry just above it
    for v, row in zip(np.atleast_1d(iso), got.reshape(-1, 3)):
        j = min(int(np.searchsorted(LEGAL_ISO, v)), len(LEGAL_ISO) - 1)
        _close(row.numpy(), np.exp(cam[j]), rtol=1e-6, atol=0)


# ----------------------------------------------------------------- bijectors
LAYERS = {
    "sdn": (SignalDependantISO, lambda: jsdn.SignalDependantISO()),
    "giso": (GainISO, lambda: jsdn.GainISO()),
    "conv1x1": (lambda: InvertibleConv1x1(4, torch.Generator().manual_seed(2)),
                lambda: jconv.InvertibleConv1x1(num_channels=4)),
    "coupling": (lambda: AffineCoupling(4, generator=torch.Generator().manual_seed(3)),
                 lambda: jcoup.AffineCoupling(num_channels=4)),
}


@pytest.mark.parametrize("name,train", [("sdn", False), ("giso", False), ("conv1x1", False),
                                        ("coupling", False), ("coupling", True)])
def test_bijector_matches_jax(name, train):
    make_t, make_j = LAYERS[name]
    layer = _randomize(make_t(), seed=5)
    jl = make_j()
    x, clean = _inputs(1)
    x = x * 50.0  # latent-scale inputs
    iso = torch.from_numpy(ISOS)
    variables = _trees(layer)
    ctx = dict(clean=nhwc(clean), iso=jnp.asarray(ISOS))
    if train:
        (zj, lj), new = jl.apply(variables, nhwc(x), train=True, method=jl.forward_ldj,
                                 mutable=["batch_stats"], **ctx)
    else:
        zj, lj = jl.apply(variables, nhwc(x), method=jl.forward_ldj, **ctx)
    zt, lt = layer.forward_ldj(x, clean=clean, iso=iso, train=train)
    _close(zt.permute(0, 2, 3, 1).detach(), zj, atol=1e-5, what="z")
    _close(lt.detach(), lj, atol=1e-5, what="ldj")
    if train:
        stats = flow_params_to_jax(layer.state_dict())[1]
        for path, v in jax.tree_util.tree_leaves_with_path(new["batch_stats"]):
            got = stats
            for k in path:
                got = got[k.key]
            _close(got, v, rtol=0, atol=1e-6, what=jax.tree_util.keystr(path))
        return
    back_t = layer.inverse(zt.detach(), clean=clean, iso=iso)
    back_j = jl.apply(variables, zj, method=jl.inverse, **ctx)
    _close(back_t.permute(0, 2, 3, 1).detach(), back_j, what="inverse")
    _close(back_t.detach(), x, rtol=1e-4, atol=1e-5, what="round trip")


def test_conv1x1_logdet_is_slogdet():
    layer = _randomize(InvertibleConv1x1(4, torch.Generator().manual_seed(4)), seed=6)
    x = torch.randn((2, 4, 6, 5), generator=torch.Generator().manual_seed(0))
    z, ldj = layer.forward_ldj(x)
    want = torch.linalg.slogdet(layer.weight().double())[1] * 6 * 5
    torch.testing.assert_close(ldj.double(), want.expand(2), rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(layer.inverse(z), x, rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------------ the flow
def _flow(seed=7, randomize=True):
    tf = NoiseFlow(ARCH, generator=torch.Generator().manual_seed(seed))
    return _randomize(tf, seed) if randomize else tf


def _jax_loss_grads(jf, variables, noise, clean, train):
    def lf(params):
        v = dict(variables, params=params)
        out = jf.apply(v, nhwc(noise), clean=nhwc(clean), iso=jnp.asarray(ISOS), train=train,
                       method=jf.loss, mutable=["batch_stats"] if train else False)
        return (out[0] if train else out)[0], out
    (_, out), grads = jax.value_and_grad(lf, has_aux=True)(variables["params"])
    return out, grads


@pytest.mark.parametrize("train", [False, True])
def test_noise_flow_matches_jax(train):
    tf = _flow()
    jf = JNoiseFlow(x_shape=(H, W, 4), arch=ARCH)
    variables = _trees(tf)
    noise, clean = _inputs(2)
    iso = torch.from_numpy(ISOS)
    ctx = dict(clean=nhwc(clean), iso=jnp.asarray(ISOS))
    # forward and log-det (eval mode: running stats), inverse
    zj, lj = jf.apply(variables, nhwc(noise), method=jf.forward, **ctx)
    zt, lt = tf.forward(noise, clean=clean, iso=iso)
    _close(zt.permute(0, 2, 3, 1).detach(), zj, atol=1e-5, what="z")
    _close(lt.detach(), lj, rtol=1e-5, what="log-det")
    _close(tf.inverse(zt.detach(), clean, iso).permute(0, 2, 3, 1).detach(),
           jf.apply(variables, zj, method=jf.inverse, **ctx), rtol=1e-4, atol=1e-4, what="inverse")
    # the NLL, sd_z and their gradients
    out, jgrads = _jax_loss_grads(jf, variables, noise, clean, train)
    (nll_j, sd_j), new = (out if train else (out, None))
    nll_t, sd_t = tf.loss(noise, clean=clean, iso=iso, train=train)
    nll_t.backward()
    _close(nll_t.item(), nll_j, rtol=1e-5, atol=0, what="nll")
    _close(sd_t.item(), sd_j, rtol=1e-5, atol=0, what="sd_z")
    tgrads, _ = flow_params_to_jax({k: (p.grad if p.grad is not None else torch.zeros_like(p))
                                    for k, p in tf.named_parameters()})
    # train mode: JAX's f32 batch statistics lose digits (its per-leaf
    # gradients sit up to 5e-2 of the leaf's largest from float64, the
    # port's within 4e-5), so there the port is held to JAX within 1e-4 of
    # the largest gradient over all leaves (measured 3.2e-5) and to its own
    # float64 evaluation within rtol 1e-4 or 1e-6 of that largest gradient
    # (the biases before a BatchNorm: a zero gradient, f32 noise in both)
    gmax = max(float(np.abs(np.asarray(g)).max()) for g in jax.tree.leaves(jgrads))
    if train:
        f64 = _flow().double()
        f64.loss(noise.double(), clean=clean.double(), iso=iso.double(), train=True)[0].backward()
        g64, _ = flow_params_to_jax({k: (p.grad if p.grad is not None else torch.zeros_like(p))
                                     for k, p in f64.named_parameters()})
    for path, g in jax.tree_util.tree_leaves_with_path(jgrads):
        got, ref64 = tgrads, g64 if train else None
        for k in path:
            got = got[k.key]
            ref64 = ref64[k.key] if train else None
        what = jax.tree_util.keystr(path)
        if train:
            _close(got, g, rtol=0, atol=1e-4 * gmax / max(float(np.abs(np.asarray(g)).max()),
                                                          1e-30), what=what)
            _close(got, ref64, rtol=1e-4, atol=1e-6 * gmax / max(float(np.abs(ref64).max()),
                                                                1e-30), what=what + " (f64)")
        else:
            _close(got, g, rtol=0, atol=1e-4, what=what)
    # the frozen leaves take no gradient in either package
    assert tf.sdn_0.cam_param.grad is None and tf.conv1x1_1.lu["p"].grad is None
    assert not np.asarray(jgrads["sdn_0"]["cam_param"]).any()
    if train:
        _close(flow_params_to_jax(tf.state_dict())[1]["unc_9"]["net"]["bn2"]["var"],
               new["batch_stats"]["unc_9"]["net"]["bn2"]["var"], rtol=0, atol=1e-6)


def test_flow_logdet_is_the_sum_of_slogdets():
    """Only the 1x1 convs and the ISO layers move the log-det of a noise
    batch at zero couplings: sum(log|det W|) * H * W per conv, plus the
    diagonal ISO scales."""
    tf = _flow(randomize=False)
    noise, clean = _inputs(3)
    iso = torch.from_numpy(ISOS)
    _, ldj = tf.forward(noise, clean=clean, iso=iso)
    convs = sum(torch.linalg.slogdet(getattr(tf, f"conv1x1_{i}").weight().double())[1]
                for i in (1, 2, 3, 4, 6, 7, 8, 9)) * H * W
    sdn = -torch.log(tf.sdn_0._scale(clean, iso).double()).reshape(N, -1).sum(1)
    giso = -torch.log(tf.giso_5._scale(iso).double()) * 4 * H * W
    torch.testing.assert_close(ldj.double(), convs + sdn + giso, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("steps", [1, 3])
def test_batch_stats_after_train_steps_match_jax(steps):
    tf = _flow(seed=8)
    jf = JNoiseFlow(x_shape=(H, W, 4), arch=ARCH)
    variables = _trees(tf)
    iso = torch.from_numpy(ISOS)
    for s in range(steps):
        noise, clean = _inputs(10 + s)
        (_, _), new = jf.apply(variables, nhwc(noise), clean=nhwc(clean), iso=jnp.asarray(ISOS),
                               train=True, method=jf.loss, mutable=["batch_stats"])
        variables = dict(variables, batch_stats=new["batch_stats"])
        with torch.no_grad():
            tf.loss(noise, clean=clean, iso=iso, train=True)
    got = flow_params_to_jax(tf.state_dict())[1]
    leaves = jax.tree_util.tree_leaves_with_path(variables["batch_stats"])
    assert len(leaves) == 32  # 8 couplings x 2 BatchNorms x (mean, var)
    for path, v in leaves:
        g = got
        for k in path:
            g = g[k.key]
        _close(g, v, rtol=0, atol=1e-6, what=jax.tree_util.keystr(path))
        assert not np.allclose(v, 0.0) and not np.allclose(v, 1.0)


def test_checkpoints_cross_load_and_sample_alike(tmp_path):
    """The port's checkpoint loads in JAX (and JAX's tree in the port): the
    same z draws the same noise in both packages."""
    tf = _flow(seed=9)
    mgr = CheckpointManager(str(tmp_path / "ck"), str(tmp_path / "sm"), "NF")
    params, stats = flow_params_to_jax(tf.state_dict())
    mgr.save(1, params, stats, eval_psnr=-0.1)
    loaded = jax_load_any(mgr.last_path())
    assert loaded["batch_stats"] is not None
    jf = JNoiseFlow(x_shape=(H, W, 4), arch=ARCH)
    variables = {"params": jax.tree.map(jnp.asarray, loaded["params"]),
                 "batch_stats": jax.tree.map(jnp.asarray, loaded["batch_stats"])}
    z, clean = _inputs(4)
    iso = torch.from_numpy(ISOS)
    ref = jf.apply(variables, nhwc(z), clean=nhwc(clean), iso=jnp.asarray(ISOS),
                   method=jf.inverse)
    _close(tf.inverse(z, clean, iso).permute(0, 2, 3, 1).detach(), ref, rtol=1e-4, atol=1e-4)
    # a JAX-side tree into a fresh port flow
    back = NoiseFlow(ARCH)
    back.load_state_dict(flow_params_from_jax(loaded["params"], loaded["batch_stats"]),
                         strict=True)
    _close(back.inverse(z, clean, iso).permute(0, 2, 3, 1).detach(), ref, rtol=1e-4, atol=1e-4)
    # sample: the same z from a seeded generator, eps_std scaling it
    g = torch.Generator().manual_seed(3)
    s = back.sample(clean, iso, g, eps_std=torch.tensor([1.0, 0.5]))
    eps = torch.randn(clean.shape, generator=torch.Generator().manual_seed(3))
    eps = eps * torch.tensor([1.0, 0.5]).reshape(-1, 1, 1, 1)
    _close(s.detach(), tf.inverse(eps, clean, iso).detach(), rtol=1e-6, atol=1e-6)
