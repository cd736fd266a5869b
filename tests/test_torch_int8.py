"""The port's W8A8 serving path (``pnnp_tpu_torch/ops/int8conv.py``,
``pnnp_tpu_torch/models/unet_s2d_int8.py``) against the JAX module.

Counterparts of tests/test_unet_s2d_int8.py's 7 tests, at nf=8 with std 0.1
weights (the 5x-amplified init of JAX's tests), plus the JAX comparisons:

* the int8 convolutions int32-equal to JAX's ``preferred_element_type=int32``
  convolutions and to an int64 numpy oracle, at padded depths (K = 9C not a
  multiple of 8, conv9_1's ``2nf + 1`` channels), short rows (M <= 16) and
  row-chunked im2col;
* activation scales rtol 1e-6 of JAX's with both skeletons in f32 (the
  statistics of the same activations to f32 rounding) at pct 100; 2e-4 at
  pct 99.95, max- and mean-combined, where JAX's float32 percentile index
  differs from the exact one; the port's percentile against
  ``np.percentile``;
* ``kq`` equal and ``m`` rtol 1e-6 on JAX's own transformed weights;
* the int8 forward on JAX's qparams against JAX's int8 forward, both in
  f32: codes flip where f32 rounding moves an activation across a rounding
  boundary, so the test reports the flipped share and holds it to 1e-3 and
  the output to 1e-3 of its norm (measured on the CPU: 0 of 371,712
  codes flipped, the outputs 4.8e-8 apart);
* the skeleton with no quantization bit-equal to the bf16 hybrid forward;
  the deviation bounds of JAX's tests for the int8 forward against bf16.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pnnp_tpu.models.unet_s2d_int8 as JI
import pnnp_tpu_torch.models.unet_s2d_int8 as PI
import pnnp_tpu_torch.ops.int8conv as IC
from pnnp_tpu.models.unet_s2d import transform_params_hybrid as jax_transform
from pnnp_tpu.models.unet_s2d import unet_hybrid_forward_packed as jax_packed
from pnnp_tpu_torch.models import UNetSeeInDark, params_from_jax
from pnnp_tpu_torch.models.unet_s2d import transform_params_hybrid, unet_hybrid_forward_packed
from tests.test_torch_models import jax_unet_params

NF = 8


def packed(a):
    """A host NHWC packed frame ``[N, h, w, 16]`` as the port's
    ``[N, 16, h, w]`` (a permute: ``channels_last`` memory)."""
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-9))


@pytest.fixture(scope="module")
def setup():
    params = jax_unet_params(NF, seed=5, std=0.1)
    net = UNetSeeInDark(nf=NF)
    net.load_state_dict(params_from_jax(params), strict=True)
    g1 = (np.random.default_rng(1).uniform(0, 1, (1, 32, 48, 16)) * 0.5).astype(np.float32)
    return params, net, g1


def _port_tparams(jtp):
    """JAX transformed weights in the port's layouts (OIHW; ConvTranspose
    ``[I, O, 2, 2]`` with flax's flip undone)."""
    out = {}
    for name, leaf in jtp.items():
        t = {}
        for key, v in leaf.items():
            v = np.asarray(v, np.float32)
            if v.ndim == 4 and name.startswith("upv"):
                v = v[::-1, ::-1].transpose(2, 3, 0, 1)
            elif v.ndim == 4:
                v = v.transpose(3, 2, 0, 1)
            t[key] = torch.from_numpy(np.array(v))
        out[name] = t
    return out


def _port_qparams(jqp):
    layers = {}
    for name, layer in jqp["layers"].items():
        kq = np.asarray(layer["kq"])
        kq = kq[::-1, ::-1].transpose(2, 3, 0, 1) if name.startswith("upv") else kq.transpose(3, 2, 0, 1)
        sa = float(jqp["act_scale"][name])
        layers[name] = {"kq": torch.from_numpy(np.ascontiguousarray(kq)),
                        "m": torch.from_numpy(np.array(layer["m"], np.float32)),
                        "bias": torch.from_numpy(np.array(layer["bias"], np.float32)),
                        "s_act": torch.tensor(sa, dtype=torch.float32)}
    return {"layers": layers, "act_scale": dict(jqp["act_scale"])}


# ------------------------------------------------------------ int8 conv op
def _oracle_conv3(x, k):
    """int64 numpy SAME 3x3 conv: x [N, H, W, C], k HWIO."""
    n, H, W, _ = x.shape
    xp = np.pad(x.astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    acc = np.zeros((n, H, W, k.shape[-1]), np.int64)
    for dy in range(3):
        for dx in range(3):
            acc += np.einsum("nhwc,cd->nhwd", xp[:, dy:dy + H, dx:dx + W], k[dy, dx].astype(np.int64))
    return acc


@pytest.mark.parametrize("n,h,w,c,d", [
    (1, 9, 13, 16, 32),    # K = 144
    (1, 6, 7, 17, 32),     # conv9_1u at nf=8: K = 153, padded to 160
    (2, 3, 2, 4, 8),       # M = 12 <= 16: padded rows
    (1, 2, 3, 65, 128),    # conv9_1u at nf=32: K = 585
])
def test_int8_conv_exact(n, h, w, c, d, monkeypatch):
    rng = np.random.default_rng(c * d)
    x = rng.integers(-127, 128, (n, h, w, c)).astype(np.int8)
    k = rng.integers(-127, 128, (3, 3, c, d)).astype(np.int8)
    want = _oracle_conv3(x, k)
    kt = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
    got = IC.conv3x3_int8(packed(x), kt)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(nhwc(got).astype(np.int64), want)
    jx = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(jx))
    # row-chunked im2col: one image row per GEMM
    monkeypatch.setattr(IC, "CHUNK_BYTES", 1)
    np.testing.assert_array_equal(IC.conv3x3_int8(packed(x), kt).numpy(), got.numpy())


def test_int8_conv_transpose_exact():
    rng = np.random.default_rng(0)
    x = rng.integers(-127, 128, (2, 3, 5, 24)).astype(np.int8)
    w = rng.integers(-127, 128, (24, 16, 2, 2)).astype(np.int8)  # torch layout
    got = IC.conv_transpose2x2_int8(packed(x), torch.from_numpy(w)).permute(0, 2, 3, 1).numpy()
    want = np.einsum("nhwc,cdab->nhawbd", x.astype(np.int64),
                     w.astype(np.int64)).reshape(2, 6, 10, 16)
    np.testing.assert_array_equal(got.astype(np.int64), want)
    kflax = jnp.asarray(np.ascontiguousarray(w.transpose(2, 3, 0, 1)[::-1, ::-1]))
    jx = jax.lax.conv_transpose(jnp.asarray(x), kflax, (2, 2), "SAME",
                                dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(got, np.asarray(jx))


def test_int8_conv_refuses_floats():
    with pytest.raises(ValueError, match="int8"):
        IC.conv3x3_int8(torch.zeros(1, 8, 4, 4), torch.zeros(8, 8, 3, 3, dtype=torch.int8))


# ------------------------------------------------------------ calibration
@pytest.mark.parametrize("q", [0.0, 37.5, 99.95, 100.0])
def test_percentile_matches_numpy(q):
    """numpy's linear rule, the position taken exactly: against
    ``np.percentile`` of the float64 copy (numpy 2 takes a float32 array's
    position ``q/100 * (n-1)`` in float32, 0.008 of an index at n = 1e5,
    which at the far tail moves the value by more than rtol 1e-6)."""
    x = np.random.default_rng(3).standard_normal(100_003).astype(np.float32)
    got = float(PI.percentile(torch.from_numpy(x), q))
    np.testing.assert_allclose(got, np.percentile(x.astype(np.float64), q), rtol=1e-6)


def test_calibration_scales_match_jax(setup):
    """Both skeletons in f32 over the same frames. maxabs scales (pct 100)
    rtol 1e-6 of JAX's: the same activations to f32 rounding. At pct 99.95
    rtol 2e-4: ``jnp.percentile`` takes its index ``q/100 * (n-1)`` in
    XLA-compiled float32 (it reads 4e-5 off ``np.percentile`` on 9999
    normals), the port takes it exactly, and between two far-apart order
    statistics, as at conv9_1u's ones channel, that moves the value by up to
    1e-4 (measured)."""
    params, net, g1 = setup
    jtp = jax_transform(params, jnp.float32)
    tp = transform_params_hybrid(net, torch.float32)
    frames = [g1, g1 * 0.3 + 0.01]
    for pct, combine in ((100.0, "max"), (99.95, "max"), (99.95, "mean")):
        want = JI.calibrate_act_scales(jtp, [jnp.asarray(f) for f in frames], jnp.float32,
                                       pct=pct, combine=combine)
        got = PI.calibrate_act_scales(tp, [packed(f) for f in frames], torch.float32,
                                      pct=pct, combine=combine)
        assert got.keys() == want.keys() == set(PI.QUANT_LAYERS) | set(PI.OPTIONAL_QUANT)
        tol = 1e-6 if pct == 100.0 else 2e-4
        for name in want:
            np.testing.assert_allclose(got[name], float(want[name]), rtol=tol, err_msg=name)


def test_quantize_params_match_jax(setup):
    """On JAX's own transformed weights and scales: kq equal, m rtol 1e-6,
    bias equal, for the default set and the optional layers."""
    params, _, g1 = setup
    jtp = jax_transform(params, jnp.bfloat16)
    scales = JI.calibrate_act_scales(jtp, [jnp.asarray(g1)])
    quant = PI.QUANT_LAYERS + PI.OPTIONAL_QUANT
    want = _port_qparams(JI.quantize_params_int8(jtp, scales, quant=quant))
    got = PI.quantize_params_int8(_port_tparams(jtp), scales, quant=quant)
    assert got["layers"].keys() == want["layers"].keys()
    for name, layer in want["layers"].items():
        np.testing.assert_array_equal(got["layers"][name]["kq"].numpy(), layer["kq"].numpy())
        np.testing.assert_allclose(got["layers"][name]["m"].numpy(), layer["m"].numpy(), rtol=1e-6)
        np.testing.assert_array_equal(got["layers"][name]["bias"].numpy(), layer["bias"].numpy())


# ------------------------------------------------------------ forwards
def test_int8_skeleton_matches_bf16_path(setup):
    """_walk with no quantization equals the production bf16 forward."""
    _, net, g1 = setup
    tp = transform_params_hybrid(net, torch.bfloat16)
    with torch.no_grad():
        a = unet_hybrid_forward_packed(tp, packed(g1))
        b = PI.unet_hybrid_forward_packed_ref(tp, packed(g1))
    assert a.dtype == b.dtype == torch.bfloat16
    assert torch.equal(a, b)


def test_int8_forward_matches_jax(setup, monkeypatch):
    """The int8 forward on JAX's qparams against JAX's, both in f32. The
    int8 convolutions are exact in both; what differs is f32 rounding
    ahead of each quantization (conv1_1, the dequantized layers), which
    flips a code where an activation sits on a rounding boundary."""
    params, _, g1 = setup
    jtp = jax_transform(params, jnp.float32)
    jqp = JI.quantize_params_int8(jtp, JI.calibrate_act_scales(
        jtp, [jnp.asarray(g1), jnp.asarray(g1 * 0.3 + 0.01)], jnp.float32, pct=99.95))
    jcodes = []
    real_conv = JI._conv_same

    def spy(t, kk, prefer=None):
        if prefer is not None:
            jcodes.append(np.asarray(t))
        return real_conv(t, kk, prefer)

    monkeypatch.setattr(JI, "_conv_same", spy)
    want = np.asarray(JI.unet_hybrid_forward_packed_int8(jtp, jqp, jnp.asarray(g1), jnp.float32))
    trace = []
    with torch.no_grad():
        got = nhwc(PI._walk(_port_tparams(jtp), packed(g1), torch.float32,
                            qparams=_port_qparams(jqp), trace=trace))
    assert [n for n, _ in trace] == [n for n in PI.QUANT_LAYERS]
    assert len(jcodes) == len(trace)
    flipped = sum(int((nhwc(c) != j).sum()) for (_, c), j in zip(trace, jcodes))
    total = sum(j.size for j in jcodes)
    err = rel(got, want)
    assert flipped / total <= 1e-3, f"{flipped} of {total} int8 codes flipped"
    assert err <= 1e-3, f"int8 forward vs JAX: {err:.3e} of the norm ({flipped}/{total} codes flipped)"


def test_int8_forward_end_to_end(setup):
    """Full W8A8 forward against the bf16 path: finite, same shape, JAX's
    deviation bounds on random weights (relative 0.08, correlation 0.995).
    Every default input gets a scale; the optional ones are observed too."""
    _, net, g1 = setup
    tp = transform_params_hybrid(net, torch.bfloat16)
    scales = PI.calibrate_act_scales(tp, [packed(g1), packed(g1 * 0.3 + 0.01)])
    assert set(PI.QUANT_LAYERS) <= set(scales) <= set(PI.QUANT_LAYERS) | set(PI.OPTIONAL_QUANT)
    qp = PI.quantize_params_int8(tp, scales)
    with torch.no_grad():
        ref = nhwc(unet_hybrid_forward_packed(tp, packed(g1)))
        out = nhwc(PI.unet_hybrid_forward_packed_int8(tp, qp, packed(g1)))
    assert out.shape == ref.shape and np.isfinite(out).all()
    assert rel(out, ref) < 0.08, rel(out, ref)
    assert np.corrcoef(out.ravel(), ref.ravel())[0, 1] > 0.995


def test_build_int8_server(setup):
    """The one-call constructor: standard weights -> packed serve function,
    at pct 99.95; the same output as the steps taken one by one."""
    _, net, g1 = setup
    serve = PI.build_int8_server(net, [packed(g1)])
    tp = transform_params_hybrid(net, torch.bfloat16)
    qp = PI.quantize_params_int8(tp, PI.calibrate_act_scales(tp, [packed(g1)], pct=99.95))
    with torch.no_grad():
        out = nhwc(serve(packed(g1)))
        ref = nhwc(unet_hybrid_forward_packed(tp, packed(g1)))
        np.testing.assert_array_equal(out, nhwc(PI.unet_hybrid_forward_packed_int8(tp, qp, packed(g1))))
    assert np.isfinite(out).all() and np.corrcoef(out.ravel(), ref.ravel())[0, 1] > 0.995


def test_int8_fused_eval_step(setup):
    """make_eval_metrics_step(qparams=...) swaps in the W8A8 forward: within
    0.5 dB of the bf16 step, and of JAX's int8 fused step on the same
    qparams; a res model is refused."""
    from pnnp_tpu.train.steps import make_eval_metrics_step as jax_fused
    from pnnp_tpu_torch.train.steps import make_eval_metrics_step

    params, _, _ = setup
    net = UNetSeeInDark(nf=NF, dtype=torch.bfloat16)
    net.load_state_dict(params_from_jax(params))
    rng = np.random.default_rng(2)
    cal = (rng.uniform(0, 1, (1, 32, 48, 16)) * 0.3).astype(np.float32)
    lr = (rng.uniform(0, 1, (1, 60, 92, 4)) * 0.4).astype(np.float32)
    hr = rng.uniform(0, 1, (1, 60, 92, 4)).astype(np.float32)
    tp = transform_params_hybrid(net, torch.bfloat16)
    qp = PI.quantize_params_int8(tp, PI.calibrate_act_scales(tp, [packed(cal)]))
    kw = dict(ori=False, correct=True, with_inputs=False)
    t = lambda a: torch.from_numpy(a)
    dn8, m8 = make_eval_metrics_step(net, qparams=qp)(t(lr), t(hr), 1.0, **kw)
    dn16, m16 = make_eval_metrics_step(net)(t(lr), t(hr), 1.0, **kw)
    assert dn8.shape == dn16.shape and torch.isfinite(dn8).all()
    assert abs(float(m8["psnr"]) - float(m16["psnr"])) < 0.5

    from pnnp_tpu.models import UNetSeeInDark as FlaxUNet

    jtp = jax_transform(params)
    jqp = JI.quantize_params_int8(jtp, JI.calibrate_act_scales(jtp, [jnp.asarray(cal)]))
    _, mj = jax_fused(FlaxUNet(nf=NF), qparams=jqp)(jtp, jnp.asarray(lr), jnp.asarray(hr),
                                                     jnp.float32(1.0), **kw)
    assert abs(float(m8["psnr"]) - float(mj["psnr"])) < 0.5
    res_net = UNetSeeInDark(nf=NF, res=True)
    with pytest.raises(ValueError, match="residual"):
        make_eval_metrics_step(res_net, qparams=qp)


def test_int8_fused_eval_step_crop_and_inputs():
    """The int8 route pads the frame to %16, packs it with ``s2d`` and crops
    its output back itself. At the %16-misaligned 40x56, with ori and
    with_inputs: the input panel and its meters equal the bf16 step's bit
    for bit; the output has the bf16 step's shape and crop (closer to the
    bf16 output than that output shifted by a row or a column is, and
    within the random-weight int8 bar, relative L2 0.08). The head bias 0.3
    keeps the output inside the [0, 1] clip (measured: 0.011 against 0.18
    and 0.20 shifted)."""
    from pnnp_tpu_torch.models.unet_s2d import s2d
    from pnnp_tpu_torch.train.steps import make_eval_metrics_step, pad_to_multiple

    net = UNetSeeInDark(nf=NF, dtype=torch.bfloat16)
    net.load_state_dict(params_from_jax(jax_unet_params(NF, seed=5, std=0.1, head_bias=0.3)))
    rng = np.random.default_rng(9)
    lr = torch.from_numpy((rng.uniform(0, 1, (1, 40, 56, 4)) * 0.4).astype(np.float32))
    hr = torch.from_numpy(rng.uniform(0, 1, (1, 40, 56, 4)).astype(np.float32))
    tp = transform_params_hybrid(net, torch.bfloat16)
    cal = s2d(pad_to_multiple(lr, 16)[0].permute(0, 3, 1, 2))
    qp = PI.quantize_params_int8(tp, PI.calibrate_act_scales(tp, [cal], pct=99.95))
    kw = dict(ori=True, correct=True, with_inputs=True)
    dn8, m8, p8 = make_eval_metrics_step(net, qparams=qp)(lr, hr, 2.0, **kw)
    dn16, m16, p16 = make_eval_metrics_step(net)(lr, hr, 2.0, **kw)
    assert torch.equal(p8, p16) and p8.shape == (1, 40, 56 * 4)
    assert float(m8["psnr_in"]) == float(m16["psnr_in"])
    assert float(m8["ssim_in"]) == float(m16["ssim_in"])
    assert dn8.shape == dn16.shape == (1, 40, 56 * 4)
    a, b = dn8.reshape(40, 56, 4).numpy(), dn16.reshape(40, 56, 4).numpy()
    err = rel(a, b)
    assert err < 0.08, err
    assert err < rel(a[1:], b[:-1]) and err < rel(a[:, 1:], b[:, :-1]), err


def test_int8_partial_quant_ablation(setup):
    """Restricting ``quant`` leaves the other layers on the bf16 path."""
    _, net, g1 = setup
    tp = transform_params_hybrid(net, torch.bfloat16)
    qp = PI.quantize_params_int8(tp, PI.calibrate_act_scales(tp, [packed(g1)]),
                                 quant=["conv1_2", "conv9_2"])
    with torch.no_grad():
        out = nhwc(PI.unet_hybrid_forward_packed_int8(tp, qp, packed(g1)))
        ref = nhwc(unet_hybrid_forward_packed(tp, packed(g1)))
    assert np.isfinite(out).all() and rel(out, ref) < 0.03, rel(out, ref)


def test_optional_quant_layers_run(setup):
    """OPTIONAL_QUANT (conv1_1 and the transposes, through the int8
    transposed conv) quantize on request and track the bf16 forward."""
    _, net, g1 = setup
    tp = transform_params_hybrid(net, torch.bfloat16)
    scales = PI.calibrate_act_scales(tp, [packed(g1), packed(g1 * 0.3 + 0.01)])
    qp = PI.quantize_params_int8(tp, scales, quant=PI.QUANT_LAYERS + PI.OPTIONAL_QUANT)
    assert "conv1_1" in qp["layers"] and "upv8" in qp["layers"]
    with torch.no_grad():
        out = nhwc(PI.unet_hybrid_forward_packed_int8(tp, qp, packed(g1)))
        ref = nhwc(unet_hybrid_forward_packed(tp, packed(g1)))
    assert out.shape == ref.shape and np.isfinite(out).all()
    assert rel(out, ref) < 0.25, rel(out, ref)
    assert np.corrcoef(out.ravel(), ref.ravel())[0, 1] > 0.98


def test_validate_int8_tool_runs(tmp_path, monkeypatch):
    """pnnp_tpu_torch/tools/validate_int8.py at a tiny budget on the CPU: it
    trains, writes its checkpoint, scores every ratio per percentile and
    returns (and prints last) the JAX tool's JSON line; ``--skip-train``
    with the trainer-style ``--cal-from-eval --cal-frames 3`` reuses it."""
    from pnnp_tpu_torch.tools import validate_int8

    monkeypatch.chdir(tmp_path)
    small = ["--cpu", "--patch", "32", "--batch", "2", "--pool", "2", "--eval-size", "64",
             "--eval-frames", "1"]
    res = validate_int8.main(small + ["--steps", "2", "--pct", "99.95,100"])
    assert os.path.exists(tmp_path / "checkpoints" / "validate_int8.ckpt")
    assert res["metric"] == "int8_psnr_delta" and res["cal_mode"] == "disjoint x3"
    assert set(res["by_pct"]) == {"99.95", "100.0"} and [r["ratio"] for r in res["rows"]] == [
        100, 250, 300]
    assert all(np.isfinite(r[k]) for r in res["rows"] for k in
               ("psnr_in", "psnr_f32", "psnr_bf16", "psnr_int8"))
    again = validate_int8.main(small + ["--skip-train", "--cal-from-eval", "--cal-frames", "3",
                                        "--pct", "99.95", "--cal-combine", "mean"])
    assert again["cal_mode"] == "from-eval x3 mean"


# ------------------------------------------------- one trained net, both packages
def int8_psnr_deltas(params, pairs, cal, pcts, dtype=torch.bfloat16):
    """int8 minus ``dtype`` PSNR per frame through the port and through JAX,
    each package calibrating (max-combined), quantizing and serving with its
    own code on one checkpoint (``params``, a JAX parameter tree) and the
    same frames: ``pairs`` of (hr, lr) ``[1, 4, H, W]`` tensors, ``cal``
    packed calibration frames. Returns ``{"port": {pct: [dB]}, "jax": {pct:
    [dB]}, "scale_rel": {pct: max relative scale difference}}``."""
    from pnnp_tpu.models.unet_s2d import d2s as jax_d2s
    from pnnp_tpu_torch.models.unet_s2d import d2s, s2d
    from pnnp_tpu_torch.ops.metrics import psnr

    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    net = UNetSeeInDark(nf=int(np.asarray(params["conv1_1"]["bias"]).shape[0]))
    net.load_state_dict(params_from_jax(params), strict=True)
    tp = transform_params_hybrid(net, dtype)
    jtp = jax_transform(jax.tree.map(jnp.asarray, params), jdt)
    jcal = [nhwc(g) for g in cal]
    out = {"port": {}, "jax": {}, "scale_rel": {}}
    score = lambda dn, hr: float(psnr(dn.clamp(0, 1) * 255.0, hr * 255.0))
    as_nchw = lambda y: torch.from_numpy(np.array(jax_d2s(y), np.float32)).permute(0, 3, 1, 2)
    with torch.no_grad():
        for pct in pcts:
            ps = PI.calibrate_act_scales(tp, cal, dtype, pct=pct)
            js = JI.calibrate_act_scales(jtp, jcal, jdt, pct=pct)
            out["scale_rel"][pct] = max(abs(float(ps[k]) / float(js[k]) - 1) for k in js)
            pq, jq = PI.quantize_params_int8(tp, ps), JI.quantize_params_int8(jtp, js)
            j_ref = jax.jit(lambda g: jax_packed(jtp, g, dtype=jdt).astype(jnp.float32))
            j_int8 = jax.jit(lambda g: JI.unet_hybrid_forward_packed_int8(
                jtp, jq, g, jdt).astype(jnp.float32))
            out["port"][pct], out["jax"][pct] = [], []
            for hr, lr in pairs:
                g = s2d(lr)
                ref = d2s(unet_hybrid_forward_packed(tp, g, dtype=dtype)).float()
                q8 = d2s(PI.unet_hybrid_forward_packed_int8(tp, pq, g, dtype)).float()
                out["port"][pct].append(score(q8, hr) - score(ref, hr))
                jg = nhwc(g)
                out["jax"][pct].append(score(as_nchw(j_int8(jg)), hr)
                                       - score(as_nchw(j_ref(jg)), hr))
    return out


def _sony_prq(seed, hr, ratio):
    """validate_int8's held-out noise: the SID ``prq`` law at ``ratio``."""
    from pnnp_tpu_torch.physics.noise import generate_noisy
    from pnnp_tpu_torch.physics.sampling import sample_params_max

    gen = torch.Generator().manual_seed(seed)
    p = sample_params_max(gen, "SonyA7S2", n=hr.shape[0], ratio=float(ratio))
    return generate_noisy(gen, hr, p, "prq").clamp_max(1.0)


def _validate_int8_frames(size, n, ratios=(100, 250, 300)):
    """validate_int8's held-out frames (n per ratio) and its disjoint
    calibration frames, drawn on the CPU."""
    from pnnp_tpu_torch.models.unet_s2d import s2d
    from pnnp_tpu_torch.tools.demo_train import synthetic_scenes

    scene = lambda rng: torch.from_numpy(synthetic_scenes(rng, 1, size)).permute(0, 3, 1, 2)
    ev, cr = np.random.default_rng(42), np.random.default_rng(7)
    pairs = []
    for ratio in ratios:
        for i in range(n):
            hr = scene(ev)
            pairs.append((hr, _sony_prq(1000 + 31 * i + ratio, hr, ratio)))
    cal = [s2d(_sony_prq(500 + i, scene(cr), r)) for i, r in enumerate(ratios)]
    return pairs, cal


def test_int8_psnr_delta_matches_jax_on_trained_net():
    """On a briefly trained net (nf=8, 60 f32 steps of validate_int8's
    ``prq`` recipe on 64^2 crops), the port's int8 - f32 PSNR per frame
    equals JAX's on the same weights and frames within 5e-4 dB, at maxabs
    and at pct 99.95 (each package calibrating, quantizing and serving with
    its own code; f32 serving dtype, so that the two skeletons agree to f32
    rounding; measured on the CPU: 1.2e-4 dB apart at pct 99.95, equal at
    maxabs, the deltas themselves up to 7.9e-3 dB); the scales within 2e-4
    (JAX's float32 percentile index)."""
    from pnnp_tpu_torch.models import params_to_jax
    from pnnp_tpu_torch.tools.demo_train import synthetic_scenes
    from pnnp_tpu_torch.train import make_adam, make_raw_synth, make_train_step

    torch.manual_seed(0)
    net = UNetSeeInDark(nf=NF, generator=torch.Generator().manual_seed(0))
    opt = make_adam(net.parameters())
    step = make_train_step(lambda e: 1e-3, make_raw_synth("SonyA7S2", "prq", ori=False,
                                                          clip=False), clip_mode=2)
    rng = np.random.default_rng(1997)
    pool = [torch.from_numpy(synthetic_scenes(rng, 4, 64)).permute(0, 3, 1, 2).contiguous()
            for _ in range(3)]
    gen = torch.Generator().manual_seed(1)
    losses = [float(step(net, opt, {"hr": pool[i % 3]}, gen, i + 1)["loss"]) for i in range(60)]
    assert losses[-1] < losses[0]
    pairs, cal = _validate_int8_frames(96, 1)
    d = int8_psnr_deltas(params_to_jax(net.state_dict()), pairs, cal, (99.95, 100.0),
                         dtype=torch.float32)
    for pct in (99.95, 100.0):
        assert d["scale_rel"][pct] <= 2e-4, d["scale_rel"]
        gap = np.abs(np.subtract(d["port"][pct], d["jax"][pct]))
        assert np.isfinite(d["port"][pct]).all() and gap.max() <= 5e-4, (pct, d)


if __name__ == "__main__":
    # The int8 - bf16 PSNR of one trained checkpoint through both packages
    # on the CPU, on validate_int8's held-out frames and disjoint calibration:
    #   JAX_PLATFORMS=cpu python -m tests.test_torch_int8 CKPT [FRAMES_PER_RATIO]
    # CKPT from pnnp_tpu_torch/tools/validate_int8.py (--ckpt); one JSON line.
    import json
    import sys

    from pnnp_tpu_torch.train import load_checkpoint

    n = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    pairs, cal = _validate_int8_frames(512, n)
    res = int8_psnr_deltas(load_checkpoint(sys.argv[1])["params"], pairs, cal, (99.95, 100.0))
    summary = {side: {str(p): {"mean": float(np.mean(v)), "worst_ratio": float(min(
        np.mean(v[i * n:(i + 1) * n]) for i in range(3)))} for p, v in res[side].items()}
        for side in ("port", "jax")}
    print(json.dumps({"ckpt": sys.argv[1], "frames_per_ratio": n, "int8_minus_bf16_db": summary,
                      "per_frame": {s: {str(p): v for p, v in res[s].items()}
                                    for s in ("port", "jax")},
                      "scale_rel": {str(p): v for p, v in res["scale_rel"].items()}}))
