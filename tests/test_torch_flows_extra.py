"""The flow layers no runfile reaches (``pnnp_tpu/models/flows/{spline,
basic,conditional}.py``, ``AffineCouplingV2``, ``SignalDependantNS``)
against the JAX package on shared weights, carried across by
``models/convert.py::flow_params_{to,from}_jax``.

Tolerances are f32's, each stated where it is used: a value within
``rtol`` of JAX's or within ``atol`` times the largest magnitude of JAX's
array. Forward output, log-det and inverse: rtol 1e-5 / atol 1e-6; the
spline's round trip 1e-5; index maps and layouts (the Squeeze channel
order, the condition index, the one-hot) exactly.

* The RQ spline, forward and inverse, on inputs that include exactly
  ``+-tail_bound``, exactly a knot and points outside the tails; the
  lower-rank (shared) parameter broadcast; the float32 tail constant.
* Each module on random non-init weights (every learned leaf moved off its
  init, BatchNorm stats off 0/1): forward, log-det and inverse; the V2
  coupling's running stats after a train-mode pass (atol 1e-6).
* The parameter and ``batch_stats`` trees equal the flax init's, path for
  path and shape for shape (``jax.eval_shape``), and the converter
  round-trips a state dict bit for bit; the 25-way 1x1's ``p`` and
  ``sign_s`` are buffers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnnp_tpu.models.flows import basic as jbasic
from pnnp_tpu.models.flows import conditional as jcond
from pnnp_tpu.models.flows import coupling as jcoup
from pnnp_tpu.models.flows import sdn as jsdn
from pnnp_tpu.models.flows import spline as jspline
from pnnp_tpu_torch.models import flow_params_from_jax, flow_params_to_jax
from pnnp_tpu_torch.models import flows as tflows
from pnnp_tpu_torch.models.flows import spline as tspline
from tests.test_torch_flows import _close, _paths, _randomize, _trees, nhwc

RTOL, ATOL = 1e-5, 1e-6


def _spline_params(seed, shape, K, tails=True):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape + (K,)).astype(np.float32)
    h = rng.standard_normal(shape + (K,)).astype(np.float32)
    d = rng.standard_normal(shape + ((K - 1) if tails else (K + 1),)).astype(np.float32)
    return w, h, d


def _edge_inputs(knots, tail_bound, seed):
    """Uniform points on [-1.5, 1.5] x tail_bound, then exactly
    ``+-tail_bound``, exactly one interior knot per row and two points
    outside the tails."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.5 * tail_bound, 1.5 * tail_bound, knots.shape[:-1]).astype(np.float32)
    x[..., 0], x[..., 1] = -tail_bound, tail_bound
    x[..., 2] = knots[..., 2, 3]  # each element on a knot of its own spline
    x[..., 3] = knots[..., 3, 1]
    x[..., 4], x[..., 5] = -2.0 * tail_bound, 2.0 * tail_bound
    return x


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("tail_bound", [1.0, 3.0])
def test_unconstrained_spline_matches_jax(inverse, tail_bound):
    K, shape = 8, (3, 16)
    w, h, d = _spline_params(0, shape, K)
    # the knots the inputs sit on: heights for the inverse, widths forward
    knots = tspline._knots(torch.from_numpy(h if inverse else w), -tail_bound, tail_bound,
                           tspline.DEFAULT_MIN_BIN_WIDTH)[0].numpy()
    x = _edge_inputs(knots, tail_bound, 1)
    got, ladj = tspline.unconstrained_rational_quadratic_spline(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(h), torch.from_numpy(d),
        inverse=inverse, tail_bound=tail_bound)
    ref, ladj_ref = jspline.unconstrained_rational_quadratic_spline(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(h), jnp.asarray(d),
        inverse=inverse, tail_bound=tail_bound)
    _close(got, ref, RTOL, ATOL, "outputs")
    _close(ladj, ladj_ref, RTOL, ATOL, "logabsdet")
    # identity with zero log-det outside the tails, exact
    out = np.abs(x) > tail_bound
    assert np.array_equal(got.numpy()[out], x[out]) and not ladj.numpy()[out].any()
    # the round trip, to 1e-5
    back, ladj_back = tspline.unconstrained_rational_quadratic_spline(
        got, torch.from_numpy(w), torch.from_numpy(h), torch.from_numpy(d),
        inverse=not inverse, tail_bound=tail_bound)
    np.testing.assert_allclose(back.numpy(), x, rtol=0, atol=1e-5 * tail_bound)
    np.testing.assert_allclose(ladj_back.numpy(), -ladj.numpy(), rtol=0, atol=1e-4)


def test_spline_tail_constant_and_tails():
    """The derivative pad is JAX's float32 constant, and only linear tails
    exist."""
    want = float(jnp.log(jnp.expm1(1 - tspline.DEFAULT_MIN_DERIVATIVE)))
    got = float(torch.log(torch.expm1(torch.tensor(1 - 1e-3, dtype=torch.float32))))
    assert got == want
    w, h, d = (torch.zeros(1, 4), torch.zeros(1, 4), torch.zeros(1, 3))
    with pytest.raises(NotImplementedError):
        tspline.unconstrained_rational_quadratic_spline(torch.zeros(1), w, h, d,
                                                        tails="circular")


@pytest.mark.parametrize("inverse", [False, True])
def test_rq_spline_broadcast_and_edges_match_jax(inverse):
    """``rational_quadratic_spline`` on [0, 1] with parameters shared across
    the batch (lower rank than the inputs), inputs at both ends and on a
    knot. One exception to the JAX bar: the inverse's log-det at ``y ==
    top`` with a small end derivative is ill-conditioned in f32 (the root's
    discriminant cancels to ``h^2 d_K^2``), and both packages lose digits
    there (measured: the port 7e-6, JAX 2.3e-5 relative of float64). That
    row is held to float64 instead: the port within rtol 1e-5 / atol 1e-6,
    JAX within 1e-4 / 1e-5."""
    K = 6
    w, h, d = _spline_params(2, (5,), K, tails=False)
    x = np.random.default_rng(3).uniform(0, 1, (4, 5)).astype(np.float32)
    knots = tspline._knots(torch.from_numpy(h if inverse else w), 0.0, 1.0, 1e-3)[0].numpy()
    x[0], x[1], x[2] = 0.0, 1.0, knots[:, 2]  # knots [5, K+1]: x[2, j] on knot 2 of j
    got, ladj = tspline.rational_quadratic_spline(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(h), torch.from_numpy(d),
        inverse=inverse)
    ref, ladj_ref = jspline.rational_quadratic_spline(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(h), jnp.asarray(d), inverse=inverse)
    _close(got, ref, RTOL, ATOL, "outputs")
    rows = [0, 2, 3] if inverse else [0, 1, 2, 3]
    _close(ladj[rows], np.asarray(ladj_ref)[rows], RTOL, ATOL, "logabsdet")
    if inverse:
        _, ladj64 = tspline.rational_quadratic_spline(
            *(torch.from_numpy(a).double() for a in (x, w, h, d)), inverse=True)
        _close(ladj[1], ladj64[1].numpy(), RTOL, ATOL, "logabsdet at top, port")
        _close(np.asarray(ladj_ref)[1], ladj64[1].numpy(), 1e-4, 1e-5, "logabsdet at top, JAX")


def test_bin_index_counts_edges_as_jax():
    """An input equal to an edge falls in the bin that starts there; the
    right end falls in the last bin after the clamp (``searchsorted`` would
    say otherwise at ties)."""
    loc = torch.tensor([0.0, 0.25, 0.25, 0.5, 1.0])
    x = torch.tensor([0.0, 0.25, 0.3, 0.5, 1.0, -0.1])
    got = tspline._bin_index(loc, x).clamp(0, 3)
    ref = jnp.clip(jspline._searchsorted_vec(jnp.asarray(loc.numpy()), jnp.asarray(x.numpy())),
                   0, 3)
    assert got.tolist() == np.asarray(ref).tolist() == [0, 2, 2, 3, 3, 0]


# ------------------------------------------------------------------ modules
N, H, W = 2, 8, 12
ISO = np.array([800.0, 3200.0], np.float32)
CAM = np.array([2.0, 3.0], np.float32)


def _field(vals, c=4):
    """Per-example values as an image-shaped NCHW field."""
    return torch.from_numpy(np.broadcast_to(vals[:, None, None, None], (N, c, H, W)).copy())


def _ctx(kind, clean):
    iso, cam = _field(ISO), _field(CAM)
    t = {"clean": clean, "iso": iso, "cam": cam}
    j = {"clean": nhwc(clean), "iso": nhwc(iso), "cam": nhwc(cam)}
    if kind == "plain":
        return {}, {}
    if kind == "clean":
        return {"clean": clean}, {"clean": nhwc(clean)}
    return t, j


# name -> (port factory, JAX factory, context kind, input law)
MODULES = {
    "actnorm": (lambda: tflows.ActNorm(4), lambda: jbasic.ActNorm(features=4), "plain", "normal"),
    "squeeze": (lambda: tflows.Squeeze(2), lambda: jbasic.Squeeze(factor=2), "plain", "normal"),
    "logit": (lambda: tflows.Logit(0.7), lambda: jbasic.Logit(temperature=0.7), "plain", "unit"),
    "noise_extraction": (tflows.NoiseExtraction, jbasic.NoiseExtraction, "clean", "normal"),
    "coupling_v2": (lambda: tflows.AffineCouplingV2(4, 8, torch.Generator().manual_seed(1)),
                    lambda: jcoup.AffineCouplingV2(num_channels=4, width=8), "plain", "normal"),
    "sdn_ns": (lambda: tflows.SignalDependantNS(4, num_bins=6, tail_bound=1.0, hidden=8,
                                                generator=torch.Generator().manual_seed(2)),
               lambda: jsdn.SignalDependantNS(num_channels=4, num_bins=6, hidden=8),
               "clean", "spline"),
    "cond_coupling": (lambda: tflows.ConditionalAffineCoupling(
        4, 8, generator=torch.Generator().manual_seed(3)),
        lambda: jcond.ConditionalAffineCoupling(num_channels=4, width=8), "cond", "normal"),
    "cond_affine": (lambda: tflows.ConditionalAffine(4, 8, generator=torch.Generator().manual_seed(4)),
                    lambda: jcond.ConditionalAffine(num_channels=4, width=8), "cond", "normal"),
    "cond_affine_only_clean": (
        lambda: tflows.ConditionalAffine(4, 8, only_clean=True,
                                         generator=torch.Generator().manual_seed(5)),
        lambda: jcond.ConditionalAffine(num_channels=4, width=8, only_clean=True),
        "cond", "normal"),
    "cond_linear": (lambda: tflows.ConditionalLinear(4),
                    lambda: jcond.ConditionalLinear(num_channels=4), "cond", "normal"),
    "cond_conv1x1": (lambda: tflows.ConditionalInvertibleConv1x1(
        4, torch.Generator().manual_seed(6)),
        lambda: jcond.ConditionalInvertibleConv1x1(num_channels=4), "cond", "normal"),
}


def _module_inputs(law, seed=0):
    rng = np.random.default_rng(seed)
    if law == "unit":
        x = rng.uniform(0.02, 0.98, (N, 4, H, W))
    elif law == "spline":  # inside and outside the tails
        x = rng.uniform(-1.3, 1.3, (N, 4, H, W))
    else:
        x = rng.normal(0.5, 1.0, (N, 4, H, W))
    clean = rng.uniform(0, 0.3, (N, 4, H, W))
    return torch.from_numpy(x.astype(np.float32)), torch.from_numpy(clean.astype(np.float32))


@pytest.mark.parametrize("name,train", [(n, False) for n in MODULES]
                         + [("coupling_v2", True), ("cond_coupling", True)])
def test_module_matches_jax(name, train):
    make_t, make_j, kind, law = MODULES[name]
    layer = _randomize(make_t(), seed=7)
    jl = make_j()
    x, clean = _module_inputs(law, 1)
    tctx, jctx = _ctx(kind, clean)
    variables = _trees(layer)
    if train:
        (zj, lj), new = jl.apply(variables, nhwc(x), train=True, method=jl.forward_ldj,
                                 mutable=["batch_stats"], **jctx)
    else:
        zj, lj = jl.apply(variables, nhwc(x), method=jl.forward_ldj, **jctx)
    zt, lt = layer.forward_ldj(x, train=train, **tctx)
    _close(zt.permute(0, 2, 3, 1).detach(), zj, RTOL, ATOL, "z")
    _close(lt.detach(), lj, RTOL, ATOL, "ldj")
    if train:
        stats = flow_params_to_jax(layer.state_dict())[1]
        for path, v in jax.tree_util.tree_leaves_with_path(new["batch_stats"]):
            got = stats
            for k in path:
                got = got[k.key]
            _close(got, v, 0, 1e-6, jax.tree_util.keystr(path))
        return
    back_t = layer.inverse(zt.detach(), **tctx)
    back_j = jl.apply(variables, zj, method=jl.inverse, **jctx)
    _close(back_t.permute(0, 2, 3, 1).detach(), back_j, RTOL, ATOL, "inverse")
    _close(back_t.detach(), x, 1e-4, 1e-5, "round trip")


def test_squeeze_channel_order_is_jax():
    """Bit-equal to JAX's Squeeze: channel ``c*f*f + fy*f + fx``."""
    x = torch.randn((2, 3, 8, 12), generator=torch.Generator().manual_seed(0))
    z, _ = tflows.Squeeze(2).forward_ldj(x)
    ref = jbasic.Squeeze(factor=2).apply({}, nhwc(x), method="forward_ldj")[0]
    assert np.array_equal(z.permute(0, 2, 3, 1).numpy(), np.asarray(ref))
    assert z[0, 1 * 4 + 1 * 2 + 0, 2, 3] == x[0, 1, 2 * 2 + 1, 3 * 2 + 0]


def test_actnorm_data_init_matches_jax():
    x = torch.from_numpy(np.random.default_rng(3).normal(3.0, 2.5, (4, 4, 8, 8)).astype(np.float32))
    x[:, 2] = 0.5  # a constant channel: the std floor
    got = tflows.actnorm_data_init(x)
    ref = jbasic.actnorm_data_init(nhwc(x))
    for k in ("log_scale", "shift"):
        _close(got[k], ref[k], RTOL, ATOL, k)
    layer = tflows.ActNorm(4)
    with torch.no_grad():
        for k, v in got.items():
            getattr(layer, k).copy_(v)
    z, _ = layer.forward_ldj(x)
    z = z.detach()
    assert abs(float(z[:, [0, 1, 3]].mean())) < 1e-4 and abs(float(z[:, 0].std()) - 1) < 0.02


def test_uniform_dequantization():
    """The uniform comes from the caller's generator; the ldj and the
    inverse are JAX's (the draws differ)."""
    x = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (N, 1, 4, 4)).astype(np.float32))
    layer = tflows.UniformDequantization(8)
    z1, ldj = layer.forward_ldj(x, generator=torch.Generator().manual_seed(5))
    z2, _ = layer.forward_ldj(x, generator=torch.Generator().manual_seed(5))
    assert torch.equal(z1, z2) and float(z1.min()) >= 0 and float(z1.max()) <= 1
    jl = jbasic.UniformDequantization(num_bits=8)
    _, lj = jl.apply({}, nhwc(x), method=jl.forward_ldj, rngs={"sample": jax.random.key(0)})
    _close(ldj, lj, RTOL, ATOL, "ldj")
    back = layer.inverse(z1)
    assert torch.equal(back, x)
    assert np.array_equal(back.permute(0, 2, 3, 1).numpy(),
                          np.asarray(jl.apply({}, nhwc(z1), method=jl.inverse)))


# --------------------------------------------------------- the conditions
@pytest.mark.parametrize("iso,cam", [([800.0, 3200.0], [2.0, 3.0]), ([100.0, 100.0], [0.04, 4.0]),
                                     ([250.0, 250.0], [2.25, 2.25]), ([5000.0, 900.0], [2.25, 7.0]),
                                     ([600.0, 600.0], [0.5, 0.5])])
def test_conditions_match_jax(iso, cam):
    """The one-hot per example and the flat index of the batch: exact, a
    tie to the first entry (ISO 250), half to even in the camera's rounding
    (2.25 and 0.5: ties exact in f32)."""
    iso_f, cam_f = _field(np.array(iso, np.float32)), _field(np.array(cam, np.float32))
    oh = tflows.iso_cam_onehot(iso_f, cam_f)
    assert np.array_equal(oh.numpy(), np.asarray(jcond.iso_cam_onehot(nhwc(iso_f), nhwc(cam_f))))
    idx = tflows.iso_cam_index(iso_f, cam_f)
    assert int(idx) == int(jcond.iso_cam_index(nhwc(iso_f), nhwc(cam_f)))
    scale = tflows.SdnModelScale(5)
    _randomize(scale, seed=9)
    clean = torch.rand((N, 4, H, W), generator=torch.Generator().manual_seed(1))
    ref = jcond.SdnModelScale().apply(_trees(scale), nhwc(clean), nhwc(iso_f), nhwc(cam_f))
    _close(scale(clean, iso_f, cam_f).permute(0, 2, 3, 1).detach(), ref, RTOL, ATOL, "sdn scale")


# -------------------------------------------------------- trees, converter
def _jax_tree_shapes(name):
    make_t, make_j, kind, law = MODULES[name]
    x, clean = _module_inputs(law)
    _, jctx = _ctx(kind, clean)
    jl = make_j()
    if name == "sdn_ns":  # its spline reads a concrete constant: init the nets alone
        return jax.eval_shape(lambda k: jl.init(k, nhwc(clean), method=jl._params),
                              jax.random.key(0))
    return jax.eval_shape(lambda k: jl.init(k, nhwc(x), method=jl.forward_ldj, **jctx),
                          jax.random.key(0))


@pytest.mark.parametrize("name", [n for n in MODULES
                                  if n not in ("squeeze", "logit", "noise_extraction")])
def test_trees_equal_the_flax_init_and_round_trip(name):
    layer = MODULES[name][0]()
    shapes = _jax_tree_shapes(name)
    params, stats = flow_params_to_jax(layer.state_dict())
    assert _paths(params) == _paths(shapes["params"])
    assert _paths(stats) == _paths(shapes.get("batch_stats", {}))
    _randomize(layer, seed=11)
    back = flow_params_from_jax(*flow_params_to_jax(layer.state_dict()))
    assert back.keys() == layer.state_dict().keys()
    assert all(torch.equal(back[k], v) for k, v in layer.state_dict().items())
    fresh = MODULES[name][0]()
    fresh.load_state_dict(back, strict=True)


def test_sdm_scale_tree_and_lu_buffers():
    """SdnModelScale's tree is flax's; the 25-way 1x1 keeps ``p`` and
    ``sign_s`` as buffers, its 25-way ``l``/``u``/``log_s`` as parameters."""
    shapes = jax.eval_shape(
        lambda k: jcond.SdnModelScale().init(k, jnp.ones((1, 4, 4, 4)), jnp.full((1, 4, 4, 4), 800.0),
                                             jnp.full((1, 4, 4, 4), 2.0)), jax.random.key(0))
    assert _paths(flow_params_to_jax(tflows.SdnModelScale().state_dict())[0]) == _paths(
        shapes["params"])
    conv = tflows.ConditionalInvertibleConv1x1(4)
    assert {n for n, _ in conv.named_buffers()} == {"lu.p", "lu.sign_s"}
    assert {n: tuple(p.shape) for n, p in conv.named_parameters()} == {
        "lu.l": (25, 4, 4), "lu.log_s": (25, 4), "lu.u": (25, 4, 4)}
    x = torch.randn((N, 4, H, W), generator=torch.Generator().manual_seed(0))
    z, ldj = conv.forward_ldj(x, iso=_field(ISO), cam=_field(CAM))
    (z.sum() + ldj.sum()).backward()
    assert conv.lu.p.grad is None and conv.lu.l.grad is not None
