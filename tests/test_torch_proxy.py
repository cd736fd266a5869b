"""The port's ``pw_iso_2stage`` proxy against the JAX package's.

Shared weights: the JAX tree of a flax ``init`` loads into the port's module
through ``params_from_jax`` (strict), and the port's own init goes the other
way through ``params_to_jax``. Inputs are seeded numpy arrays, NHWC for JAX
and the same values permuted to NCHW for the port.

* ``HeadParams``, ``mean`` / ``variance`` / ``center``: rtol 1e-5 (with
  an atol of 1e-6 of the knot scale, where terms cancel).
* ``quantile`` and ``quantile_dot`` on the same ``u``/``c``: the core
  lookup is equal (atol 0; ``quantile_dot`` is a gather of bf16-rounded
  knots, JAX's one-hot bf16 matmul looks up exactly those); a Laplace tail
  draw goes through ``log1p``, whose last bit differs between XLA and
  torch, so tail draws are held to rtol 1e-6.
* ``log_prob`` and ``log_prob_conv_gaussian`` (chunked and unchunked, with
  ``s`` up to 4000): values rtol 1e-5 / atol 1e-5 and knot gradients rtol
  1e-4 of ``jax.grad`` at the recipe's s0, every gradient finite; where
  f32 cancellation dominates (large ``s``), both against float64;
  chunked equals unchunked.
* The loss over the mode matrix (2-stage, 1-stage, '+anchor', s0 0 and
  0.3, contamination from the model and the batch, the ISO-curvature
  penalty, a dark mask): ``nll``, ``nll_px``, ``nll_row`` rtol 1e-5. The
  param gradients are held to a float64 evaluation of the same loss (the
  port's module in double) at rtol 1e-4 / atol 1e-4 of each leaf's largest
  magnitude, and to ``jax.grad`` at the same tolerance wherever JAX's f32
  gradient is itself within half of it from float64 (at least half of all
  elements).
  The pixel NLL sums differences of nearly equal CDFs: JAX's f32 gradients
  (XLA on the CPU) sit 1e-5 to 6e-5 of a leaf's largest magnitude from
  float64 in most modes, 2e-3 with the dark mask and 3e-2 in '+anchor'
  mode; the port's sit within 3e-5 ('+anchor') and 3e-6 elsewhere: it takes
  a bin's mass from the smaller CDF tails, and from a midpoint series where
  the bin is narrow against ``s`` (``QuantileHead._core_conv``), which a
  test on narrow bins holds to float64.
* Samples, which share no stream: mean and variance within 2% (the mean
  against the standard deviation) and symmetric integer-ADU KLD <= 0.01 at
  2^20 draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnnp_tpu.models.proxy import HeadParams as JHeadParams
from pnnp_tpu.models.proxy import PixelWiseISOProxy as JProxy
from pnnp_tpu.models.proxy import QuantileHead as JHead
from pnnp_tpu_torch.models import (
    HeadParams,
    PixelWiseISOProxy,
    QuantileHead,
    build_proxy,
    params_from_jax,
    params_to_jax,
)
from pnnp_tpu_torch.models.convert import torch_state_to_flax
from pnnp_tpu_torch.ops.kld import kl_div_norm

D, NF, NB = 64, 8, 2
SPAN = 16383.0 - 512.0
ISO = np.array([800.0, 6400.0], np.float32)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _noise(seed=0, n=2, h=8, w=12, c=4, px=6.0, row=2.0):
    """Dark-noise-like residual (normalized): Gaussian pixels + row banding
    + a heavy-ish tail."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, px, (n, h, w, c)) + rng.normal(0, row, (n, h, 1, c))
    x += rng.standard_t(3, (n, h, w, c))
    return (x / SPAN).astype(np.float32)


def _torch_proxy(seed=3, **kw):
    kw = dict(dict(d=D, nf=NF, nb=NB), **kw)
    return PixelWiseISOProxy(generator=torch.Generator().manual_seed(seed), **kw)


def _head_params(seed=0, iso=ISO):
    """Pixel-head params (not centered) from the port's init, as numpy."""
    p = _torch_proxy(seed, zero_mean=False)
    with torch.no_grad():
        _, hp, _ = p.heads(torch.from_numpy(iso), len(iso))
    return [t.numpy() for t in hp]


def _jhp(arrs):
    return JHeadParams(*[jnp.asarray(a) for a in arrs])


def _thp(arrs, grad=False):
    return HeadParams(*[torch.tensor(a, requires_grad=grad) for a in arrs])


def test_flax_tree_loads_strict_and_heads_match():
    jp = JProxy(d=D, nf=NF, nb=NB)
    v = jax.jit(jp.init)({"params": jax.random.key(0), "sample": jax.random.key(1)},
                         jnp.zeros((1, 4, 4, 4)), jnp.full((1,), 1600.0))
    tp = PixelWiseISOProxy(d=D, nf=NF, nb=NB)
    tp.load_state_dict(params_from_jax(jax.tree.map(np.asarray, v["params"])), strict=True)
    # the round trip gives the same tree back
    back = params_to_jax(tp.state_dict())
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(v["params"]),
                                jax.tree_util.tree_leaves_with_path(back)):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), b)
    feat = np.stack([0.0009546 * ISO - 0.00193, np.log(ISO / 1600.0)], -1)
    for anchor in (None, np.log(feat[:, :1] / (0.0009546 * 1600 - 0.00193))):
        ref = JHead(D, NF, NB).apply({"params": v["params"]["pixel_stage"]},
                                     jnp.asarray(feat),
                                     None if anchor is None else jnp.asarray(anchor))
        got = tp.pixel_stage(torch.from_numpy(feat),
                             None if anchor is None else torch.from_numpy(anchor))
        for r, g in zip(ref, got):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(r), rtol=1e-5,
                                       atol=1e-6 * float(np.abs(ref.knots).max()))


def test_init_follows_flax_dense_law():
    """lecun-normal kernels (normal truncated at 2 std, variance 1/fan_in)
    and zero biases, reproducible from the seed."""
    a, b = _torch_proxy(seed=5, d=1024, nf=16), _torch_proxy(seed=5, d=1024, nf=16)
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
        if name.endswith("bias"):
            assert not p.any(), name
            continue
        fan_in = p.shape[1]
        std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
        assert float(p.detach().abs().max()) <= 2 * std + 1e-7, name
        if p.numel() > 1000:  # the bins layer: its variance is 1/fan_in
            assert abs(float(p.var()) * fan_in - 1.0) < 0.05, name
    c = _torch_proxy(seed=6, d=1024, nf=16)
    assert not torch.equal(a.pixel_stage.bins.weight, c.pixel_stage.bins.weight)


def test_mean_variance_center_match_jax():
    hp = _head_params()
    scale = float(np.abs(hp[0]).max())
    # the mean sums knots of both signs: its rounding is relative to the
    # knot scale, the variance's to its square
    for ours, theirs, power in ((QuantileHead.mean, JHead.mean, 1),
                                (QuantileHead.variance, JHead.variance, 2)):
        ref = np.asarray(theirs(_jhp(hp)))
        assert np.abs(ref).min() > 1e-3
        np.testing.assert_allclose(ours(_thp(hp)).numpy(), ref, rtol=1e-5,
                                   atol=1e-6 * scale ** power)
    got, ref = QuantileHead.center(_thp(hp)), JHead.center(_jhp(hp))
    np.testing.assert_allclose(got.knots.numpy(), np.asarray(ref.knots), rtol=1e-5,
                               atol=1e-6 * float(np.abs(hp[0]).max()))
    assert float(QuantileHead.mean(got).abs().max()) < 1e-5


@pytest.mark.parametrize("name", ["quantile", "quantile_dot"])
def test_quantile_matches_jax(name):
    hp = _head_params()
    rng = np.random.default_rng(1)
    u = rng.uniform(1e-6, 1 - 1e-6, (2, 16, 16, 4)).astype(np.float32)
    c = rng.uniform(0, 1, u.shape).astype(np.float32)
    ours, theirs = getattr(QuantileHead, name), getattr(JHead, name)
    core = ours(_thp(hp), torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(core, np.asarray(theirs(_jhp(hp), jnp.asarray(u))))
    got = ours(_thp(hp), torch.from_numpy(u), torch.from_numpy(c)).numpy()
    ref = np.asarray(theirs(_jhp(hp), jnp.asarray(u), jnp.asarray(c)))
    tail = c < hp[2].reshape(-1, 1, 1, 1)
    assert 0 < tail.sum() < tail.size
    np.testing.assert_array_equal(got[~tail], ref[~tail])
    np.testing.assert_allclose(got[tail], ref[tail], rtol=1e-6)
    if name == "quantile_dot":  # exactly the gather on bf16-rounded knots
        kb = hp[0].copy()
        kb[:] = torch.from_numpy(kb).bfloat16().float().numpy()
        gather = QuantileHead.quantile(_thp([kb] + hp[1:]), torch.from_numpy(u)).numpy()
        np.testing.assert_array_equal(core, gather)


def _lp_cases():
    rng = np.random.default_rng(2)
    x = rng.normal(0, 8, (2, 6, 10, 4)).astype(np.float32)
    x[0, 0, 0, 0], x[1, 0, 0, 1] = 400.0, -900.0  # far outside the support
    return x


def _port_log_prob(hp, x, s, dtype=torch.float32, chunk=None):
    """The port's log-density and its knot gradient (of the sum), in ``dtype``."""
    thp = HeadParams(*[torch.tensor(a, dtype=dtype, requires_grad=True) for a in hp])
    xt = torch.from_numpy(x).to(dtype)
    lp = (QuantileHead.log_prob(thp, xt) if s is None else
          QuantileHead.log_prob_conv_gaussian(thp, xt, torch.as_tensor(s, dtype=dtype),
                                              chunk=chunk))
    lp.sum().backward()
    return lp.detach().double().numpy(), thp.knots.grad.double().numpy()


@pytest.mark.parametrize("s", [None, 0.3, 4000.0, "per_pixel"])
def test_log_prob_matches_jax(s):
    """At s 0.3 (the recipe's s0) and without smoothing: rtol 1e-5. Where
    width/s is small (s up to 20 per pixel, and 4000) both packages lose
    digits to the f32 differences of nearly equal CDFs, so both are held to
    the port's float64 evaluation: the port's f32 error may not exceed
    JAX's (x2)."""
    hp = _head_params()
    x = _lp_cases()
    if s == "per_pixel":
        s = np.random.default_rng(3).uniform(0.1, 20, x.shape).astype(np.float32)

    def jax_fn(knots):
        h = _jhp(hp)._replace(knots=knots)
        if s is None:
            return JHead.log_prob(h, jnp.asarray(x))
        return JHead.log_prob_conv_gaussian(h, jnp.asarray(x), jnp.asarray(s))

    ref = np.asarray(jax_fn(jnp.asarray(hp[0])))
    ref_g = np.asarray(jax.grad(lambda k: jnp.sum(jax_fn(k)))(jnp.asarray(hp[0])))
    exact, exact_g = _port_log_prob(hp, x, s, torch.float64)
    err_jax, err_jax_g = np.abs(ref - exact).max(), np.abs(ref_g - exact_g).max()
    for chunk in ([None] if s is None else [None, 7, 240]):
        got, g = _port_log_prob(hp, x, s, chunk=chunk)
        assert np.isfinite(got).all() and np.isfinite(g).all()
        if s is None or np.isscalar(s) and s == 0.3:
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(g, ref_g, rtol=1e-4, atol=1e-6 * np.abs(ref_g).max())
        else:
            assert np.abs(got - exact).max() <= 2 * err_jax + 1e-6
            assert np.abs(g - exact_g).max() <= 2 * err_jax_g + 1e-6 * np.abs(ref_g).max()


def test_conv_gaussian_keeps_f32_digits_on_narrow_bins():
    """d=1024 knots over ~1 ADU under s ~ 1 ADU (a row stage's contamination
    width against a narrow row law), x into the far tails: the port's f32
    log-density within 1e-6 and its knot gradient within 1e-5 of float64
    (of their largest magnitudes). JAX's plain difference of f32 CDFs keeps
    fewer digits there (its error is at least 10x the port's)."""
    rng = np.random.default_rng(7)
    d = 1024
    heights = np.exp(rng.normal(0, 1.5, (2, d)))
    cum = np.concatenate([np.zeros((2, 1)), np.cumsum(heights / heights.sum(-1, keepdims=True), -1)], -1)
    hp = [(0.6 * (2 * cum - 1)).astype(np.float32), np.zeros((2, 1), np.float32),
          np.array([[0.08], [0.05]], np.float32), np.array([[6.3], [9.5]], np.float32)]
    x = rng.normal(0, 1.5, (2, 4, 16, 1)).astype(np.float32)
    s = np.float32(1.1)
    exact, exact_g = _port_log_prob(hp, x, s, torch.float64)
    got, g = _port_log_prob(hp, x, s)
    err, err_g = np.abs(got - exact).max(), np.abs(g - exact_g).max()
    assert err <= 1e-6 * np.abs(exact).max()
    assert err_g <= 1e-5 * np.abs(exact_g).max()
    ref = np.asarray(JHead.log_prob_conv_gaussian(_jhp(hp), jnp.asarray(x), jnp.asarray(s)))
    assert np.abs(ref - exact).max() >= 10 * err


def test_conv_gaussian_chunked_equals_unchunked():
    hp = _head_params()
    x = torch.from_numpy(_lp_cases())
    out = {}
    for chunk in (None, 1, 13):
        thp = _thp(hp, grad=True)
        lp = QuantileHead.log_prob_conv_gaussian(thp, x, 0.3, chunk=chunk)
        (lp * torch.linspace(0.5, 1.5, lp.numel()).reshape(lp.shape)).sum().backward()
        out[chunk] = (lp.detach(), thp.knots.grad, thp.tail_b.grad, thp.tail_pi.grad)
    for chunk in (1, 13):
        for a, b in zip(out[chunk], out[None]):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * float(b.abs().max()))


LOSS_MODES = {
    "2stage": dict(),
    "1stage": dict(mode="iso"),
    "anchor": dict(mode="2stage+iso+anchor"),
    "raw_s0": dict(smooth_s0=0.0),
    "empirical": dict(contam="empirical"),
    "smooth_iso": dict(smooth_iso_w=0.5),
    "no_center_mask": dict(zero_mean=False),
}


@pytest.mark.parametrize("case", list(LOSS_MODES))
def test_loss_and_grads_match_jax(case):
    kw = LOSS_MODES[case]
    tp = _torch_proxy(seed=11, **kw)
    params = params_to_jax(tp.state_dict())
    jp = JProxy(d=D, nf=NF, nb=NB, **kw)
    noise = _noise(seed=4)
    weight = None
    if case == "no_center_mask":  # the NF trainer's dark mask
        weight = (np.random.default_rng(5).uniform(0, 1, noise.shape) < 0.7).astype(np.float32)

    def loss_fn(p):
        return jp.apply({"params": p}, jnp.asarray(noise), jnp.asarray(ISO), mode="loss",
                        weight=None if weight is None else jnp.asarray(weight))

    (nll, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    tn, ta = tp.loss(nchw(noise), torch.from_numpy(ISO),
                     weight=None if weight is None else nchw(weight))
    tn.backward()
    np.testing.assert_allclose(float(tn), float(nll), rtol=1e-5)
    assert set(ta) == set(aux)
    for k in aux:
        np.testing.assert_allclose(float(ta[k]), float(aux[k]), rtol=1e-5, atol=1e-7)
    # float64 oracle: the same module and inputs in double
    tp64 = _torch_proxy(seed=11, **kw).double()
    tp64.loss(nchw(noise).double(), torch.from_numpy(ISO).double(),
              weight=None if weight is None else nchw(weight).double())[0].backward()
    leaves = lambda m: jax.tree_util.tree_leaves_with_path(
        torch_state_to_flax({n: p.grad for n, p in m.named_parameters()}))
    accurate = []
    for (path, r), (_, g), (_, e) in zip(jax.tree_util.tree_leaves_with_path(grads),
                                         leaves(tp), leaves(tp64)):
        r, top = np.asarray(r), float(np.abs(e).max())
        np.testing.assert_allclose(g, e, rtol=1e-4, atol=1e-4 * top, err_msg=str(path))
        # against JAX wherever JAX's f32 gradient is itself within half that
        # of float64
        ok = np.abs(r - e) <= 0.5e-4 * (np.abs(e) + top)
        accurate.append(ok.ravel())
        np.testing.assert_allclose(g[ok], r[ok], rtol=1e-4, atol=1e-4 * top, err_msg=str(path))
    assert np.concatenate(accurate).mean() >= 0.5
    assert max(float(np.abs(np.asarray(x)).max()) for x in jax.tree.leaves(grads)) > 1e-4


def test_samples_match_jax_by_moments_and_kld():
    """2^20 draws per ISO (ISO 800 and 12800; 256 rows x 64 x 64 channels,
    so the row stage gets 16384 draws), a dim clean signal: shot + pixel +
    row noise. Both against each other, and the port's variance against the
    closed form (pixel + s0^2 + row + shot K*clean)."""
    tp = _torch_proxy(seed=21)
    params = jax.tree.map(jnp.asarray, params_to_jax(tp.state_dict()))
    jp = JProxy(d=D, nf=NF, nb=NB)
    iso = np.array([800.0, 12800.0], np.float32)
    clean = np.full((2, 256, 64, 64), 0.002, np.float32)
    ref = np.asarray(jax.jit(lambda p, k: jp.apply(
        {"params": p}, jnp.asarray(clean), jnp.asarray(iso), rngs={"sample": k},
        mode="sample"))(params, jax.random.key(0))) * SPAN
    with torch.no_grad():
        got = tp.sample(nchw(clean), torch.from_numpy(iso),
                        torch.Generator().manual_seed(0)).numpy().transpose(0, 2, 3, 1) * SPAN
        feat, hp_px, hp_row = tp.heads(torch.from_numpy(iso), 2)
        closed = (QuantileHead.variance(hp_px) + tp.smooth_s0 ** 2
                  + QuantileHead.variance(hp_row))[:, 0] + feat[:, 0] * 0.002 * SPAN
    for e in range(2):
        assert got[e].size == 1 << 20
        sd = ref[e].std()
        assert abs(got[e].mean() - ref[e].mean()) < 0.02 * sd, e
        assert abs(got[e].var() / ref[e].var() - 1.0) < 0.02, e
        assert abs(got[e].var() / float(closed[e]) - 1.0) < 0.02, e
        assert kl_div_norm(ref[e], got[e])["kl_sym"] <= 0.01, e


def test_build_proxy_reads_the_jax_trainer_keys():
    p = build_proxy({"name": "pw_iso_2stage", "ISO2K": [0.001, -0.002], "nf": 8, "nb": 1,
                     "d": 32, "mode": "iso", "lookup": "gather", "smooth_s0": 0.0},
                    wp=1023, bl=64)
    assert (p.iso2k, p.nf, p.nb, p.d, p.mode, p.lookup, p.smooth_s0, p.wp, p.bl) == (
        (0.001, -0.002), 8, 1, 32, "iso", "gather", 0.0, 1023.0, 64.0)
    assert p.row_stage is None and p.contam == "model" and p.zero_mean
    q = build_proxy({"name": "pw_iso_2stage"})
    assert (q.d, q.nf, q.nb, q.mode, q.lookup, q.smooth_s0, q.iso2k) == (
        1024, 16, 2, "2stage+iso", "dot", 0.3, (0.0009546, -0.00193))
    # NoiseFlow names build the flow, with the block's arch string and
    # flow_permutation (tests/test_torch_flows.py holds it against JAX)
    from pnnp_tpu_torch.models import NoiseFlow

    f = build_proxy({"name": "NoiseFlow", "arch": "sdn|unc|giso", "flow_permutation": 0})
    assert isinstance(f, NoiseFlow) and (f.arch, f.flow_permutation) == ("sdn|unc|giso", 0)
    assert f.order == ("sdn_0", "unc_1", "giso_2")
    assert build_proxy({"name": "noise_flow"}).order[:3] == ("sdn_0", "conv1x1_1", "unc_1")
    with pytest.raises(KeyError, match="unknown arch_proxy"):
        build_proxy({"name": "Gaussian"})
