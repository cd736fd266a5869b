"""The last loose names of the JAX package and the eval tools and demos
(ROADMAP 1.17) against the JAX package, at a small size on the CPU.

* ``data/native.py::pack_crops`` / ``pack_s2d`` bit-identical to JAX's on
  one raw mosaic, and the same ``ValueError`` on a crop plan out of bounds.
* ``models/convert.py``: an ELD ``{'netG': ...}`` file unwrapped to the
  port's state dict equal to JAX's ``eld_checkpoint_to_flax`` carried
  across; ``load_tolerant`` equal to JAX's on the same trees, with its
  warnings. ``models/registry.py``: ``register`` and
  ``example_input_channels``.
* ``tools/validate_noise_model.py``: the oracle bit-identical to JAX's on
  the same ``default_rng``; both tools' ``main`` at 40000 samples, every
  row's ``kl_sym`` at most 5e-3 (measured at this size: port 3.6e-4 to
  2.0e-3, JAX 1.9e-4 to 2.4e-3).
* The inner loops of ``eval_fullres`` (default and host-packed) and
  ``bench_eval_loop`` (sync and pipelined) on a %16-misaligned small frame
  in f32, each frame's metrics held to JAX's ``make_eval_metrics_step`` on
  the same weights at the fused eval's f32 limits (PERF.md section 2): PSNR
  5e-3 dB, SSIM 1e-4. JAX's step serves bf16 by construction; the test runs
  it in f32 by handing it the f32 hybrid forward (the JAX package is not
  changed).
* ``eval_fullres``'s three steps (default, host-packed, int8) through its
  chained timing at nf=4 on a small frame; both demos' ``main`` for 2
  steps at ``--patch 32`` on the CPU.
"""

import functools
import json
import math
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnnp_tpu.data import native as jnative
from pnnp_tpu.models import UNetSeeInDark as FlaxUNet
from pnnp_tpu.models import convert as jconvert
from pnnp_tpu.models import registry as jregistry
from pnnp_tpu.models import unet_s2d as jus2d
from pnnp_tpu.train.steps import make_eval_metrics_step as jax_make_fused
from pnnp_tpu_torch.data import native
from pnnp_tpu_torch.data.loader import DataLoader
from pnnp_tpu_torch.models import (
    UNetSeeInDark,
    eld_checkpoint_state_dict,
    example_input_channels,
    load_tolerant,
    params_from_jax,
    register,
)
from pnnp_tpu_torch.models import registry
from pnnp_tpu_torch.tools import (
    bench_eval_loop,
    demo_pnnp_pipeline,
    demo_train,
    eval_fullres,
    validate_noise_model,
)
from pnnp_tpu_torch.train.steps import make_eval_metrics_step
from tests.test_torch_models import jax_unet_params

NF = 4
KL_BAR = 5e-3
PSNR_TOL, SSIM_TOL = 5e-3, 1e-4

needs_native = pytest.mark.skipif(not native.available(), reason="librawproc.so not built")


# ------------------------------------------------------------ native packers
@needs_native
@pytest.mark.parametrize("extras", [False, True])
def test_native_packers_match_jax(extras):
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 16383, (64, 96)).astype(np.float32)
    kw = {}
    if extras:
        kw = {"darkshading": rng.normal(0, 3, (64, 96)).astype(np.float32),
              "bias": np.array([0.5, -0.25, 0.0, 1.0], np.float32)}
    hs, ws = np.array([0, 5, 24, 3]), np.array([0, 40, 7, 31])
    aug = np.array([0, 3, 5, 7])
    for clip_mode, ratio_mul in ((0, 0.0), (2, 100.0)):
        got = native.pack_crops(raw, 16383.0, 512.0, hs, ws, aug, 8, clip_mode=clip_mode,
                                ratio_mul=ratio_mul, **kw)
        ref = jnative.pack_crops(raw, 16383.0, 512.0, hs, ws, aug, 8, clip_mode=clip_mode,
                                 ratio_mul=ratio_mul, **kw)
        assert got.shape == (4, 8, 8, 4) and np.array_equal(got, ref)
    for clip in (False, True):
        got = native.pack_s2d(raw, 16383.0, 512.0, clip=clip, **kw)
        assert got.shape == (16, 24, 16)
        assert np.array_equal(got, jnative.pack_s2d(raw, 16383.0, 512.0, clip=clip, **kw))


@needs_native
@pytest.mark.parametrize("hs,ws", [([25], [0]), ([0], [41]), ([-1], [0]), ([0], [-2])])
def test_pack_crops_bounds_check(hs, ws):
    raw = np.zeros((64, 96), np.float32)
    args = (raw, 16383.0, 512.0, np.array(hs), np.array(ws), np.zeros(1), 8)
    with pytest.raises(ValueError, match="out of bounds") as ours:
        native.pack_crops(*args)
    with pytest.raises(ValueError) as theirs:
        jnative.pack_crops(*args)
    assert str(ours.value) == str(theirs.value)


# ------------------------------------------------------ convert, registry
@pytest.fixture(scope="module")
def params():
    return jax_unet_params(NF, seed=5, head_bias=0.3)


@pytest.mark.parametrize("wrap", ["netG", "state_dict", "netG+state_dict"])
def test_eld_checkpoint_unwrap_matches_jax(tmp_path, params, wrap):
    state = {f"module.{k}": v for k, v in params_from_jax(params).items()}
    state["module.conv1_1.num_batches_tracked"] = torch.tensor(3)
    for key in reversed(wrap.split("+")):
        state = {key: state}
    path = str(tmp_path / "eld.pth")
    torch.save(state, path)
    got = eld_checkpoint_state_dict(path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = params_from_jax(jconvert.eld_checkpoint_to_flax(path))
    assert got.keys() == ref.keys()
    assert all(torch.equal(got[k], ref[k]) for k in ref)
    net = UNetSeeInDark(nf=NF)
    net.load_state_dict(got, strict=True)


def test_load_tolerant_matches_jax(params):
    target = UNetSeeInDark(nf=NF, generator=torch.Generator().manual_seed(1)).state_dict()
    loaded = dict(params_from_jax(params))
    del loaded["conv2_1.bias"]
    loaded["conv10_1.weight"] = torch.zeros(4, NF, 3, 3)  # another shape
    loaded["extra.weight"] = torch.ones(2)
    with pytest.warns(UserWarning) as rec:
        got = load_tolerant(target, loaded)
    msgs = sorted(str(w.message) for w in rec)
    assert msgs == ["missing conv2_1.bias in checkpoint; keeping init",
                    "shape mismatch for conv10_1.weight; keeping init"]
    to_flax = lambda sd: jconvert.torch_state_to_flax(
        {k: v.numpy() for k, v in sd.items() if k != "extra.weight"})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = params_from_jax(jconvert.load_tolerant(to_flax(target), to_flax(loaded)))
    assert got.keys() == target.keys() == ref.keys()
    assert all(torch.equal(got[k], ref[k]) for k in ref)
    assert torch.equal(got["conv2_1.bias"], target["conv2_1.bias"])
    assert torch.equal(got["conv1_1.weight"], loaded["conv1_1.weight"])
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # by_name=False: a mismatch is silent
        del loaded["conv2_1.weight"]
        loaded["conv2_1.weight"] = torch.zeros(1)
        with pytest.raises(UserWarning, match="missing conv2_1.bias"):
            load_tolerant(target, loaded, by_name=False)


@pytest.mark.parametrize("arch", [{"name": "UNetSeeInDark"}, {"in_nc": 4, "nframes": 3},
                                  {"in_nc": 1, "nframes": 2}])
def test_example_input_channels_and_register(arch):
    assert example_input_channels(arch) == jregistry.example_input_channels(arch)
    net = registry.build_model(dict({"name": "UNetSeeInDark", "nf": NF}, **arch))
    assert net.conv1_1.weight.shape[1] == example_input_channels(arch)
    register("MyUNet", UNetSeeInDark)
    try:
        assert isinstance(registry.build_model({"name": "MyUNet", "nf": NF}), UNetSeeInDark)
    finally:
        registry._REGISTRY.pop("MyUNet")


# ------------------------------------------------- validate_noise_model
def _jax_row_params(camera, iso):
    """The JAX tool's inline parameter dict."""
    from pnnp_tpu.physics import calibration as jcalib

    t = jcalib.ISO_TABLES[camera]
    i = int(np.where(t["iso"] == iso)[0][0])
    p = {k: float(np.asarray(t[k])[i] if np.ndim(t[k]) else t[k])
         for k in ("Kmax", "lam", "sigGs", "sigTL", "sigR", "q", "wp", "bl")}
    p["K"] = p.pop("Kmax")
    return p


@pytest.mark.parametrize("row", validate_noise_model.ROWS)
def test_oracle_is_bit_identical(row):
    from tools import validate_noise_model as jtool

    camera, iso, code, ratio = row
    p = validate_noise_model.row_params(camera, iso)
    assert p == _jax_row_params(camera, iso)
    y = np.full((1, 24, 24, 4), 0.002)
    got = validate_noise_model.oracle(np.random.default_rng(1), y, p, code, ratio)
    ref = jtool.oracle(np.random.default_rng(1), y, p, code, ratio)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)


def test_validate_noise_model_mains(capsys):
    """Both tools at 40000 samples: the same five rows, every ``kl_sym``
    within ``KL_BAR``."""
    from tools import validate_noise_model as jtool

    rows = validate_noise_model.main(["--samples", "40000", "--cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1])["rows"] == rows and len(rows) == 5
    assert [(r["camera"], r["iso"], r["code"], r["ratio"]) for r in rows] == list(
        validate_noise_model.ROWS)
    assert all(r["kl_sym"] <= KL_BAR for r in rows), rows
    jtool.main(["--samples", "40000"])
    jrows = capsys.readouterr().out.strip().splitlines()[1:]
    assert len(jrows) == 5 and all(float(line.split()[-1]) <= KL_BAR for line in jrows), jrows
    assert [line.split()[:4] for line in out[1:6]] == [line.split()[:4] for line in jrows]


# ------------------------------------------------------- the eval tools
H, W = 40, 56  # packed frame: %16-misaligned in both dims


@pytest.fixture(scope="module")
def jax_f32_step(params):
    """JAX's fused step, its hybrid forward in f32 (the step imports the
    forward by name when built: the f32 partial is handed in there)."""
    model = FlaxUNet(nf=NF)
    fwd = jus2d.unet_hybrid_forward_packed
    jus2d.unet_hybrid_forward_packed = functools.partial(fwd, dtype=jnp.float32)
    try:
        step = jax_make_fused(model)
    finally:
        jus2d.unet_hybrid_forward_packed = fwd
    tp = jus2d.transform_params_hybrid(params, jnp.float32)
    return lambda lr, hr: step(tp, jnp.asarray(lr), jnp.asarray(hr), jnp.float32(1.0),
                               ori=False, correct=True)[1]


def _port_f32_step(params):
    net = UNetSeeInDark(nf=NF, dtype=torch.float32)
    net.load_state_dict(params_from_jax(params), strict=True)
    return make_eval_metrics_step(net.eval())


def _close_metrics(got, ref):
    assert abs(float(got["psnr"]) - float(ref["psnr"])) < PSNR_TOL
    assert abs(float(got["ssim"]) - float(ref["ssim"])) < SSIM_TOL


@pytest.mark.parametrize("mode", ["default", "packed"])
def test_eval_fullres_loop_matches_jax(params, jax_f32_step, mode):
    frames, hr = eval_fullres.make_frames(H, W, 2, mode, torch.device("cpu"))
    assert frames[0].shape == ((1, H, W, 4) if mode == "default" else (1, 24, 32, 16))
    got = eval_fullres.run_frames(_port_f32_step(params), frames, hr)
    assert len(got) == 2
    for lr, m in zip(frames, got):
        _close_metrics(m, jax_f32_step(lr.numpy(), hr.numpy()))
    # the two modes serve the same frames: the same metrics
    if mode == "packed":
        plain, _ = eval_fullres.make_frames(H, W, 2, "default", torch.device("cpu"))
        ref = eval_fullres.run_frames(_port_f32_step(params), plain, hr)
        for a, b in zip(got, ref):
            _close_metrics(a, b)


@pytest.mark.parametrize("pipeline", [False, True])
def test_bench_eval_loop_matches_jax(params, jax_f32_step, pipeline):
    ds = bench_eval_loop.SyntheticEvalDataset(3, H, W)
    loader = DataLoader(ds, batch_size=1, shuffle=False, num_workers=2)
    dt, res = bench_eval_loop.run_loop(_port_f32_step(params), loader, pipeline,
                                       torch.device("cpu"))
    assert dt > 0 and [r[0] for r in res] == ["f000", "f001", "f002"]
    ref = jax_f32_step(ds.lr, ds.hr)
    for _, p, s in res:
        _close_metrics({"psnr": p, "ssim": s}, ref)


@pytest.mark.parametrize("mode", ["default", "packed", "int8"])
def test_eval_fullres_steps_and_timing_on_cpu(mode):
    """Each mode's step (int8 calibrated on the tool's U(0, 0.3)
    ``[1, 16, 712, 1064]`` frame) through the tool's chained timing, at
    nf=4 on a small frame."""
    net = UNetSeeInDark(nf=NF, dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(0)).eval()
    step = eval_fullres.build_step(net, mode, torch.Generator().manual_seed(eval_fullres.CAL_SEED))
    frames, hr = eval_fullres.make_frames(H, W, 2, mode, torch.device("cpu"))
    best, first_s, total = eval_fullres.time_frames(step, frames, hr, torch.device("cpu"),
                                                    repeats=1)
    ms = eval_fullres.run_frames(step, frames, hr)
    assert best > 0 and first_s > 0
    assert total == pytest.approx(sum(float(m["psnr"] + m["ssim"]) for m in ms), rel=1e-6)


# ------------------------------------------------------------- the demos
def test_demo_train_main_two_steps():
    res = demo_train.main(["--cpu", "--steps", "2", "--patch", "32", "--eval-every", "1"])
    assert res["steps"] == 2 and res["card"] == "cpu"
    assert all(math.isfinite(res[k]) for k in ("psnr_in", "psnr_init", "psnr", "gain_db"))
    assert res["gain_db"] == pytest.approx(res["psnr"] - res["psnr_in"])


def test_demo_pnnp_pipeline_main_two_steps():
    res = demo_pnnp_pipeline.main(["--cpu", "--proxy-steps", "2", "--unet-steps", "2",
                                   "--patch", "32"])
    assert all(math.isfinite(res[k]) for k in ("kld_before", "kld_after", "psnr_in", "psnr"))
    assert res["kld_before"] > 0 and res["card"] == "cpu"


def test_demo_scenes_match_jax():
    """The scene generator draws in the JAX tool's order: bit-identical."""
    from tools.demo_train import synthetic_scenes as jscenes

    a = demo_train.synthetic_scenes(np.random.default_rng(1997), 3, 24)
    b = jscenes(np.random.default_rng(1997), 3, 24)
    assert np.array_equal(a, b)
