"""The bf16 forward profilers, the proxy-step profilers and the serving A/Bs
of the port (``pnnp_tpu_torch/tools/``: ``profile_prefix``,
``profile_layers``, ``profile_ablate``, ``profile_proxy_step``,
``profile_proxy_synth``, ``bench_halfdense``, ``bench_serving_variants``)
against the JAX package and the JAX tools, on the CPU.

Shared weights: a seeded numpy parameter tree of the nf=32 flax
UNetSeeInDark (std 0.05, so that activations neither vanish nor blow up
over the 18 layers) loaded into the port's module by ``params_from_jax``;
a flax proxy init loaded the same way. Errors are max |port - JAX| over the
reference's max |value| ("relative" below).

* ``profile_prefix``: prefixes 0, 5 and 6 of the packed form against JAX's
  ``_group_max`` of the level-1 convs, ``_mid_levels`` and
  ``unet_hybrid_forward_packed``, and the ``channels_last`` form's prefix 6
  against JAX's ``UNetSeeInDark``, in f32 within 1e-5 relative; every
  prefix of both forms by shape.
* ``profile_ablate.forward`` against ``tools/profile_ablate.py::forward``
  for ``()`` and each of the nine groups, that module's ``DT`` patched to
  float32, within 1e-5 relative; the ``channels_last`` ablation with no
  group equals the module's forward.
* ``profile_layers.LAYERS["packed"]`` against the conv shapes in the jaxpr
  of JAX's ``unet_hybrid_forward_packed`` at the Sony frame: counts and
  FLOPs of the 3x3 convs, and the transposed convs.
* ``bench_halfdense.transform_conv3_halfdense`` equal to the JAX tool's;
  the half-dense forward against the dense hybrid in f32 within 1e-5.
* ``profile_proxy_synth``: ``mlp``'s ``HeadParams`` against JAX's
  ``QuantileHead`` on shared weights within 1e-6 relative; the ``core``
  lookup against JAX's ``quantile`` within 1e-6 and the ``dot`` lookup
  against ``quantile_dot`` within the bf16 knot bound (a knot near a bf16
  rounding boundary may round apart); ``full`` equal to the module's
  ``sample`` on the same generator state.
* ``profile_proxy_step``: the step's ``fwd`` loss and ``bwd`` gradients
  (``TrainStep`` in f32) on fixed lr / hr against JAX's ``unet_loss`` of
  the flax UNetSeeInDark and its ``jax.value_and_grad``, in f32 within 1e-5
  relative (each gradient leaf against its largest magnitude); the JSON
  line of a ``--cpu --small`` run has exactly the JAX tool's keys.
* ``bench_serving_variants --cpu --small``: one JSON line per CPU variant,
  every frame bit-equal to the loop's but ``int8``'s, which is held to the
  W8A8 path's random-weight bar (tests/test_unet_s2d_int8.py: relative L2
  0.08 against bf16).
* With no card and no ``--cpu`` every tool raises.
"""

import ast
import json
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pnnp_tpu.models.unet_s2d as J
from pnnp_tpu.models import UNetSeeInDark as FlaxUNet
from pnnp_tpu.models.proxy import PixelWiseISOProxy as JProxy
from pnnp_tpu.models.proxy import QuantileHead as JHead
from pnnp_tpu.train.losses import unet_loss as jax_unet_loss
from pnnp_tpu_torch.models import PixelWiseISOProxy, UNetSeeInDark, params_from_jax, params_to_jax
from pnnp_tpu_torch.models.unet_s2d import transform_params_hybrid, unet_hybrid_forward_packed
from pnnp_tpu_torch.tools import bench_halfdense as BH
from pnnp_tpu_torch.tools import bench_serving_variants as BS
from pnnp_tpu_torch.tools import profile_ablate as PA
from pnnp_tpu_torch.tools import profile_layers as PL
from pnnp_tpu_torch.tools import profile_prefix as PP
from pnnp_tpu_torch.tools import profile_proxy_step as PPS
from pnnp_tpu_torch.tools import profile_proxy_synth as PPY
from pnnp_tpu_torch.train.steps import TrainStep
from tests.test_torch_models import jax_unet_params

NF, STD = 32, 0.05
TOL = 1e-5
MOSAIC = (1, 64, 64, 4)  # NHWC; packed (1, 32, 32, 16)
TOOLS = (PP, PL, PA, PPS, PPY, BH, BS)


def rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def unet():
    """(JAX params, port module, JAX f32 hybrid params, port f32 hybrid
    params, an unpacked [1, 64, 64, 4] frame, its packed form)."""
    params = jax_unet_params(NF, seed=7, std=STD)
    net = UNetSeeInDark(nf=NF)
    net.load_state_dict(params_from_jax(params), strict=True)
    x = np.random.default_rng(3).normal(0.0, 0.1, MOSAIC).astype(np.float32)
    with torch.no_grad():
        tp = transform_params_hybrid(net, torch.float32)
    return params, net, J.transform_params_hybrid(params, jnp.float32), tp, x, J.s2d_np(x)


def _jax_prefix(jtp, g, n):
    """JAX's own functions at prefixes 0, 5 and 6 of the packed forward."""
    g = jnp.asarray(g)
    if n == 6:
        return J.unet_hybrid_forward_packed(jtp, g, dtype=jnp.float32)
    conv = lambda t, name: J._lrelu(J._conv_same(t, jtp[name]["kernel"]) + jtp[name]["bias"])
    p1 = J._group_max(conv(conv(g, "conv1_1"), "conv1_2"))
    return p1 if n == 0 else J._mid_levels(jtp, p1)


@pytest.mark.parametrize("form,n", [("packed", 0), ("packed", 5), ("packed", 6),
                                    ("channels_last", 6)])
def test_prefix_matches_jax(unet, form, n):
    params, net, jtp, tp, x, g = unet
    if form == "packed":
        ref = np.asarray(_jax_prefix(jtp, g, n))
        inp, sub = nchw(g), tp
    else:
        ref = np.asarray(FlaxUNet(nf=NF).apply({"params": params}, jnp.asarray(x)))
        inp, sub = nchw(x).contiguous(memory_format=torch.channels_last), net
    with torch.no_grad():
        got = nhwc(PP.prefix_fn(form, sub, n, torch.float32)(inp).float())
    assert got.shape == ref.shape
    assert rel(got, ref) <= TOL, rel(got, ref)


@pytest.mark.parametrize("form", PP.FORMS)
def test_prefix_shapes(unet, form):
    """Band n's output: p1, c2, c3, c5, c7, c8, the frame."""
    _, net, _, tp, x, g = unet
    nf = NF
    if form == "packed":
        inp, sub, h = nchw(g), tp, 32
        want = [(4 * nf // 4, h), (2 * nf, h), (4 * nf, h // 2), (16 * nf, h // 8),
                (4 * nf, h // 2), (2 * nf, h), (16, h)]
    else:
        inp, sub, h = nchw(x), net, 64
        want = [(nf, h // 2), (2 * nf, h // 2), (4 * nf, h // 4), (16 * nf, h // 16),
                (4 * nf, h // 4), (2 * nf, h // 2), (4, h)]
    with torch.no_grad():
        for n, (c, s) in enumerate(want):
            assert PP.prefix_fn(form, sub, n, torch.float32)(inp).shape == (1, c, s, s), n
    assert len(PP.NAMES) == 7


@pytest.fixture(scope="module")
def jax_ablate():
    import tools.profile_ablate as jax_tool

    return jax_tool


@pytest.mark.parametrize("skip", [()] + [g for g in PA.GROUPS["packed"]],
                         ids=lambda g: "+".join(g) or "none")
def test_ablate_matches_jax_tool(unet, jax_ablate, monkeypatch, skip):
    _, _, jtp, tp, _, g = unet
    monkeypatch.setattr(jax_ablate, "DT", jnp.float32)
    ref = np.asarray(jax_ablate.forward(jtp, jnp.asarray(g), skip=skip))
    with torch.no_grad():
        got = nhwc(PA.forward(tp, nchw(g), skip=skip, dtype=torch.float32))
    assert got.shape == ref.shape
    assert rel(got, ref) <= TOL, rel(got, ref)


def test_ablate_groups_and_channels_last(unet):
    """The JAX tool's nine groups; ``channels_last`` drops ``gmax``; its
    forward with nothing ablated is the module's, and each group keeps the
    frame's shape."""
    import tools.profile_ablate as jax_tool

    src = ast.parse(open(jax_tool.__file__).read())
    groups = next(n.value for n in ast.walk(src) if isinstance(n, ast.Assign)
                  and getattr(n.targets[0], "id", None) == "groups")
    assert PA.GROUPS["packed"] == tuple(ast.literal_eval(groups))
    assert all("gmax" not in g for g in PA.GROUPS["channels_last"])
    assert len(PA.GROUPS["channels_last"]) == 8
    _, net, _, _, x, _ = unet
    inp = nchw(x).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        ref = net(inp)
        assert torch.equal(PA.forward_channels_last(net, inp, dtype=torch.float32), ref)
        for grp in PA.GROUPS["channels_last"]:
            assert PA.forward_channels_last(net, inp, grp).shape == ref.shape, grp


def _convs(jaxpr):
    """Every conv_general_dilated of a jaxpr and its sub-jaxprs."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "conv_general_dilated":
            yield eqn
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else [v]):
                inner = getattr(sub, "jaxpr", None)
                if inner is not None:
                    yield from _convs(getattr(inner, "jaxpr", inner))


def test_layers_table_matches_jaxpr():
    """The packed table's 3x3 convs and transposes against the convs that
    JAX's packed forward traces at the Sony frame (no convolution runs)."""
    shapes = jax.eval_shape(FlaxUNet(nf=NF).init, jax.random.key(0),
                            jax.ShapeDtypeStruct((1, 16, 16, 4), jnp.float32))["params"]
    tps = jax.eval_shape(lambda p: J.transform_params_hybrid(p, jnp.bfloat16), shapes)
    h, w = PP.FRAME["channels_last"][2:]
    g1 = jax.ShapeDtypeStruct((1, h // 2, w // 2, 16), jnp.float32)
    jaxpr = jax.make_jaxpr(J.unet_hybrid_forward_packed)(tps, g1).jaxpr
    c3, ups = Counter(), Counter()
    for eqn in _convs(jaxpr):
        lhs, rhs = (v.aval.shape for v in eqn.invars[:2])  # NHWC, HWIO
        key = (lhs[1], lhs[2], rhs[2], rhs[3])
        if eqn.params["lhs_dilation"] == (2, 2):
            ups[key] += 1
        else:
            assert rhs[:2] == (3, 3), rhs
            c3[key] += 1
    table = Counter()
    for _, sp, ci, co, count in PL.LAYERS["packed"]:
        table[(sp[1], sp[2], ci, co)] += count
    assert table == c3
    flops = lambda cnt: sum(PL.flops((1, k[0], k[1]), k[2], k[3]) * v for k, v in cnt.items())
    assert flops(table) == flops(c3)
    assert Counter((sp[1], sp[2], ci, co) for _, sp, ci, co in PL.up_layers("packed", h, w)) == ups
    assert len(PL.up_layers("channels_last", h, w)) == 4


def test_halfdense_transform_matches_jax_tool(rng):
    import tools.bench_halfdense as jax_tool

    for C, D in ((3, 5), (32, 32)):
        k3 = rng.standard_normal((3, 3, C, D)).astype(np.float32)
        np.testing.assert_array_equal(BH.transform_conv3_halfdense(k3),
                                      jax_tool.transform_conv3_halfdense(k3))


def test_halfdense_forward_matches_dense_hybrid(unet):
    _, net, _, tp, _, g = unet
    with torch.no_grad():
        ref = unet_hybrid_forward_packed(tp, nchw(g), dtype=torch.float32)
        got = BH.forward_halfdense(tp, BH.halfdense_params(net, torch.float32), nchw(g),
                                   torch.float32)
    assert got.shape == ref.shape
    assert rel(got.numpy(), ref.numpy()) <= TOL, rel(got.numpy(), ref.numpy())


PROXY_D = 64


@pytest.fixture(scope="module")
def proxies():
    jp = JProxy(d=PROXY_D)
    v = jax.jit(jp.init)({"params": jax.random.key(0), "sample": jax.random.key(1)},
                         jnp.zeros((1, 4, 4, 4)), jnp.full((1,), 1600.0))
    params = jax.tree.map(np.asarray, v["params"])
    tp = PixelWiseISOProxy(d=PROXY_D)
    tp.load_state_dict(params_from_jax(params), strict=True)
    return params, tp


@pytest.mark.parametrize("scope", ["pixel_stage", "row_stage"])
def test_proxy_synth_mlp_matches_jax(proxies, scope):
    params, tp = proxies
    with torch.no_grad():
        feat = PPY.iso_feat(tp, PPY.ISO, 2, torch.device("cpu"))
        got = PPY.mlp(tp, feat, scope)
    ref = JHead(PROXY_D, tp.nf, tp.nb).apply({"params": params[scope]}, jnp.asarray(feat.numpy()))
    for name, a, b in zip(ref._fields, got, ref):
        assert rel(a.numpy(), np.asarray(b)) <= 1e-6, (name, rel(a.numpy(), np.asarray(b)))


@pytest.mark.parametrize("which,bound", [("core", 1e-6), ("dot", PPY.DOT_BOUND)])
def test_proxy_synth_lookups_match_jax(proxies, which, bound):
    params, tp = proxies
    r = np.random.default_rng(5)
    u = r.uniform(1e-6, 1 - 1e-6, (2, 4, 8, 8)).astype(np.float32)
    c = r.uniform(0, 1, u.shape).astype(np.float32)
    with torch.no_grad():
        hp = PPY.mlp(tp, PPY.iso_feat(tp, PPY.ISO, 2, torch.device("cpu")), "pixel_stage")
        got = PPY.pixel_lookup(tp, which, hp, torch.from_numpy(u), torch.from_numpy(c))
    feat = np.stack([[0.0009546 * PPY.ISO - 0.00193, 0.0]] * 2).astype(np.float32)
    jh = JHead(PROXY_D, tp.nf, tp.nb).apply({"params": params["pixel_stage"]}, jnp.asarray(feat))
    ju, jc = jnp.asarray(u.transpose(0, 2, 3, 1)), jnp.asarray(c.transpose(0, 2, 3, 1))
    ref = (JHead.quantile(jh, ju) if which == "core" else JHead.quantile_dot(jh, ju, jc))
    assert rel(got.numpy(), np.asarray(ref).transpose(0, 3, 1, 2)) <= bound


def test_proxy_synth_full_is_the_production_sample(proxies):
    _, tp = proxies
    clean = torch.rand((2, 4, 16, 16), generator=torch.Generator().manual_seed(2)) * 0.3
    with torch.no_grad():
        ref = tp.sample(clean, torch.tensor([PPY.ISO]), torch.Generator().manual_seed(4))
        got = PPY.build(tp, "full")(torch.Generator().manual_seed(4), clean)
    assert torch.equal(got, ref)
    assert PPY.VARIANTS == ("u", "shot", "core", "full", "fixedk", "dot")


def test_proxy_step_fwd_bwd_match_jax(unet):
    params, _, _, _, _, _ = unet
    r = np.random.default_rng(11)
    lr = r.uniform(0, 0.1, (2, 32, 32, 4)).astype(np.float32)
    hr = r.uniform(0, 1, lr.shape).astype(np.float32)

    def loss_val(p, a, b):
        return jax_unet_loss(FlaxUNet(nf=NF).apply({"params": p}, a), b)

    ref_loss, ref_grads = jax.value_and_grad(loss_val)(params, jnp.asarray(lr), jnp.asarray(hr))
    net = UNetSeeInDark(nf=NF)
    net.load_state_dict(params_from_jax(params), strict=True)
    step = TrainStep(lambda epoch: 1e-4, bf16=False, clip_mode=2)
    with torch.no_grad():
        fwd = float(PPS.forward_loss(step, net, nchw(lr), nchw(hr)))
    loss, gsum = PPS.backward_loss(step, net, nchw(lr), nchw(hr))
    assert abs(fwd - float(ref_loss)) <= TOL * abs(float(ref_loss))
    assert abs(float(loss) - float(ref_loss)) <= TOL * abs(float(ref_loss))
    grads = params_to_jax({k: p.grad for k, p in net.named_parameters()})
    got_leaves = jax.tree_util.tree_leaves_with_path(grads)
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref_grads)
    assert [p for p, _ in got_leaves] == [p for p, _ in ref_leaves]
    for (path, a), (_, b) in zip(got_leaves, ref_leaves):
        assert rel(a, b) <= TOL, (jax.tree_util.keystr(path), rel(a, b))
    assert torch.isclose(gsum, sum(p.grad.norm() for p in net.parameters()))


def test_proxy_step_json_keys(capsys):
    import tools.profile_proxy_step as jax_tool

    src = ast.parse(open(jax_tool.__file__).read())
    dumps = [n for n in ast.walk(src) if isinstance(n, ast.Call)
             and getattr(n.func, "attr", None) == "dumps"]
    jax_keys = {k.value for k in dumps[-1].args[0].keys}
    row_keys = next({k.value for k in n.keys} for n in ast.walk(src) if isinstance(n, ast.Dict)
                    and any(getattr(k, "value", None) == "prefix" for k in n.keys))
    out = PPS.main(["--cpu", "--small", "--iters", "1", "--scan", "1", "--d", "16"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out and set(line) == jax_keys
    assert [r["prefix"] for r in line["rows"]] == list(PPS.PREFIXES)
    assert all(set(r) == row_keys for r in line["rows"]), row_keys
    assert all(np.isfinite(r["cum_ms"]) for r in line["rows"])


def test_serving_variants_cpu(capsys):
    rows = BS.main(["--cpu", "--small", "--repeats", "1"])
    lines = [json.loads(s) for s in capsys.readouterr().out.strip().splitlines()]
    names = ["loop", "sequential x2", "sequential x4", "int8"]
    assert [r["variant"] for r in rows] == [ln["variant"] for ln in lines] == names
    assert all(set(ln) == {"variant", "ms_per_frame"} for ln in lines)
    for r in rows[:-1]:
        assert r["max_abs_diff"] == 0.0, r
    assert 0.0 < rows[-1]["rel_err"] < 0.08, rows[-1]


@pytest.mark.parametrize("tool", TOOLS, ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_tools_raise_without_cuda(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(["--small"])
