"""The packed layout in training and eval, and ``--int8`` in the Trainer,
against the JAX package.

* ``generate_noisy_packed``: the row noise drawn per (full-resolution row,
  RGBG channel), constant along a row once unpacked, distinct between the
  two rows of a packed row; the dark bias tiled; the moments of the packed
  and the NCHW synth, and of JAX's packed synth on the same parameters,
  within sampling error.
* The packed train step (``identity_synth`` over fixed pairs, packed by
  ``pack_synth``) against the port's NCHW step and against JAX's
  ``make_train_step(fast="packed")`` in f32, after 1 and 3 steps, to
  tests/test_parity_and_sharding.py:159-162's bounds (loss 1e-5, psnr 1e-3,
  params atol 1e-5). JAX's packed step computes in bf16 only; the f32
  comparison runs it with its hybrid transform and forward given
  ``dtype=float32`` (module attributes patched for the test, the package
  untouched). In bf16 both packages' packed steps agree to the bars JAX
  holds its bf16 path to (loss 2e-3, params atol 5e-3 after one step).
* The fused eval step on a host pre-packed frame equals it on the unpacked
  frame, for the NCHW and the packed forward; the packed forward against
  the NCHW one in f32.
* ``Trainer --int8`` against JAX's ``test_trainer_int8_eval`` fixture and
  runfile on one checkpoint: the calibration spied (3 frames, pct 99.95),
  frames from the third on served int8 (the first two by the bf16 step),
  the metrics pickle within the bf16 eval bar (1e-2 dB / 1e-3 SSIM) of
  JAX's int8 pickle and within 0.5 dB / 0.05 of the port's own bf16 pickle
  (the bar of tests/test_unet_s2d_int8.py:137); the refusals.
* ``Trainer`` with ``packed_step``: a train run through the packed step;
  off by default. The steps' memory format: channels_last for bf16 compute,
  NCHW for f32, either computing the same.
"""

import functools
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import pnnp_tpu.models.unet_s2d as JS
import pnnp_tpu.trainer as jax_trainer
import pnnp_tpu_torch.models.unet_s2d_int8 as PI
from pnnp_tpu.models import UNetSeeInDark as FlaxUNet
from pnnp_tpu.physics.noise import generate_noisy_packed as jax_noisy_packed
from pnnp_tpu.train.schedules import build_lr_schedule as jax_build_lr_schedule
from pnnp_tpu.train.state import TrainState, make_adam_direction
from pnnp_tpu.train.steps import identity_synth as jax_identity_synth
from pnnp_tpu.train.steps import make_eval_metrics_step as jax_fused
from pnnp_tpu.train.steps import make_train_step as jax_make_train_step
from pnnp_tpu_torch.data.fixtures import make_sid_fixture, make_sid_runfile
from pnnp_tpu_torch.models import UNetSeeInDark, params_from_jax, params_to_jax
from pnnp_tpu_torch.models.unet_s2d import d2s, pack_frame_np, s2d
from pnnp_tpu_torch.physics.noise import generate_noisy, generate_noisy_packed
from pnnp_tpu_torch.train import (
    build_lr_schedule,
    identity_synth,
    make_adam,
    make_eval_metrics_step,
    make_raw_synth,
    make_raw_synth_packed,
    make_train_step,
    pack_synth,
)
from pnnp_tpu_torch.train.checkpoint import save_checkpoint
from pnnp_tpu_torch.trainer import Trainer, main
from tests.test_torch_models import jax_unet_params
from tests.test_torch_trainer import _shape_only_state

LR = 1e-3
N, H, W = 2, 32, 32


def _params(n, **extra):
    base = {"K": np.full(n, 2.0), "wp": np.full(n, 16383.0), "bl": np.full(n, 512.0),
            "ratio": np.full(n, 100.0), "sigGs": np.full(n, 3.0), "sigR": np.full(n, 1.5),
            "q": np.full(n, 1 / 15871.0), "lam": np.full(n, -0.2), "sigTL": np.full(n, 3.0),
            "bias": np.tile(np.array([[1.0, -2.0, 3.0, -4.0]]), (n, 1))}
    base.update(extra)
    return {k: np.asarray(v, np.float32) for k, v in base.items()}


def _t(params):
    return {k: torch.from_numpy(v) for k, v in params.items()}


# ------------------------------------------------------------ packed synth
def test_packed_row_noise_banding():
    """Row noise alone (no shot, no read): once unpacked, each RGBG
    channel's row is one constant, the two full-resolution rows inside a
    packed row differ; the dark bias comes out per RGBG channel."""
    n, h, w = 2, 8, 12
    p = _params(n, K=np.full(n, 1e-9), sigGs=np.zeros(n), ratio=np.ones(n))
    z = generate_noisy_packed(torch.Generator().manual_seed(0), torch.zeros(n, 16, h, w),
                              _t(p), "r", ori=True, clip=False)
    u = d2s(z) * float(p["wp"][0] - p["bl"][0])  # ADU, [n, 4, 2h, 2w]
    assert float((u - u[..., :1]).abs().max()) < 1e-6
    rows = u[..., 0]  # [n, 4, 2h]
    assert float((rows[..., 0::2] - rows[..., 1::2]).abs().min()) > 0
    assert 0.5 < float(rows.std()) / 1.5 < 1.5
    zb = generate_noisy_packed(torch.Generator().manual_seed(0), torch.zeros(n, 16, h, w),
                               _t(_params(n, K=np.full(n, 1e-9), sigGs=np.zeros(n),
                                          ratio=np.ones(n))), "d", ori=True, clip=False)
    ub = d2s(zb) * (16383.0 - 512.0)
    np.testing.assert_allclose(ub.mean(dim=(2, 3))[0].numpy(), [1.0, -2.0, 3.0, -4.0],
                               atol=1e-3)


def test_packed_synth_moments():
    """pgrq on one clean frame: the packed synth's mean and std against the
    NCHW synth's (one seed: the same parameter draw), and the packed noise
    on fixed parameters against JAX's packed synth, within sampling error."""
    hr = np.random.default_rng(0).uniform(0, 0.01, (2, 64, 64, 4)).astype(np.float32)
    hr_t = torch.from_numpy(hr).permute(0, 3, 1, 2).contiguous()
    lr_p, hr_p, r_p = make_raw_synth_packed("SonyA7S2", "pgrq", ori=False, clip=False)(
        torch.Generator().manual_seed(5), {"hr": hr_t})
    lr_u, _, r_u = make_raw_synth("SonyA7S2", "pgrq", ori=False, clip=False)(
        torch.Generator().manual_seed(5), {"hr": hr_t})
    assert lr_p.shape == hr_p.shape == (2, 16, 32, 32) and torch.equal(r_p, r_u)
    torch.testing.assert_close(hr_p, s2d(hr_t))
    assert abs(float(lr_p.mean()) - float(lr_u.mean())) < 0.02
    assert abs(float(lr_p.std()) / float(lr_u.std()) - 1.0) < 0.05

    p = _params(4)
    g = np.random.default_rng(1).uniform(0, 0.05, (4, 32, 32, 16)).astype(np.float32)
    ours = generate_noisy_packed(torch.Generator().manual_seed(2),
                                 torch.from_numpy(g).permute(0, 3, 1, 2), _t(p), "pgrqd")
    theirs = np.asarray(jax_noisy_packed(jax.random.key(2), jnp.asarray(g),
                                         {k: jnp.asarray(v) for k, v in p.items()}, "pgrqd"))
    d_ours = (ours.permute(0, 2, 3, 1).numpy() - g * 100.0)
    d_theirs = theirs - g * 100.0
    assert abs(d_ours.mean() - d_theirs.mean()) < 0.01 * d_theirs.std()
    assert abs(d_ours.std() / d_theirs.std() - 1.0) < 0.02
    # the row component: per-row means over the packed row's 16 channels
    assert abs(d_ours.mean(axis=2).std() / d_theirs.mean(axis=2).std() - 1.0) < 0.15


# ------------------------------------------------------------ packed train step
def _batches(k):
    rng = np.random.default_rng(3)
    out = []
    for _ in range(k):
        hr = rng.uniform(0, 0.5, (N, H, W, 4)).astype(np.float32)
        lr = (hr + rng.normal(0, 0.05, hr.shape)).astype(np.float32)
        out.append({"lr": lr, "hr": hr, "ratio": np.ones(N, np.float32)})
    return out


def _to_torch(b):
    return {k: (torch.from_numpy(v).permute(0, 3, 1, 2).contiguous() if v.ndim == 4
                else torch.from_numpy(v)) for k, v in b.items()}


def _port_run(params, steps, packed, bf16=False):
    net = UNetSeeInDark(nf=4)
    net.load_state_dict(params_from_jax(params), strict=True)
    opt = make_adam(net.parameters())
    step = make_train_step(build_lr_schedule({"lr_scheduler": "fixed", "learning_rate": LR,
                                              "stop_epoch": 10}),
                           pack_synth(identity_synth) if packed else identity_synth,
                           clip_mode=2, bf16=bf16, packed=packed)
    metrics, snaps = [], {}
    for i, b in enumerate(_batches(steps)):
        m = step(net, opt, _to_torch(b), torch.Generator().manual_seed(i), 1)
        metrics.append({k: float(v) for k, v in m.items()})
        snaps[i + 1] = params_to_jax(net.state_dict())
    return snaps, metrics


def _jax_run(params, steps, monkeypatch, f32):
    if f32:
        monkeypatch.setattr(JS, "transform_params_hybrid", functools.partial(
            JS.transform_params_hybrid, dtype=jnp.float32))
        monkeypatch.setattr(JS, "unet_hybrid_forward_packed", functools.partial(
            JS.unet_hybrid_forward_packed, dtype=jnp.float32))
    model = FlaxUNet(nf=4)
    sched = jax_build_lr_schedule({"lr_scheduler": "fixed", "learning_rate": LR,
                                   "stop_epoch": 10})
    step = jax_make_train_step(model, sched, jax_identity_synth, clip_mode=2,
                               donate=False, fast="packed")
    state = TrainState.create(apply_fn=model.apply, params=jax.tree.map(jnp.asarray, params),
                              tx=make_adam_direction())
    snaps, metrics = {}, []
    for i, b in enumerate(_batches(steps)):
        jb = {"lr": JS.s2d(jnp.asarray(b["lr"])), "hr": JS.s2d(jnp.asarray(b["hr"])),
              "ratio": jnp.asarray(b["ratio"])}
        state, m = step(state, jb, jax.random.key(i), 1)
        metrics.append({k: float(v) for k, v in m.items()})
        snaps[i + 1] = jax.tree.map(np.asarray, state.params)
    return snaps, metrics


def _close(a, b, atol):
    assert a.keys() == b.keys()
    for name in a:
        for leaf in a[name]:
            np.testing.assert_allclose(a[name][leaf], b[name][leaf], rtol=0, atol=atol,
                                       err_msg=f"{name}/{leaf}")


@pytest.fixture(scope="module")
def step_params():
    return jax_unet_params(4, seed=21, std=0.05, head_bias=0.2)


def _assert_bounds(got, ref):
    snaps, metrics = got
    ref_snaps, ref_metrics = ref
    for m, r in zip(metrics, ref_metrics):
        assert abs(m["loss"] - r["loss"]) < 1e-5, (m, r)
        assert abs(m["psnr"] - r["psnr"]) < 1e-3, (m, r)
    for k in (1, 3):
        _close(snaps[k], ref_snaps[k], 1e-5)


def test_packed_step_matches_nchw_step(step_params):
    _assert_bounds(_port_run(step_params, 3, packed=True),
                   _port_run(step_params, 3, packed=False))


def test_packed_step_matches_jax_packed_step(step_params, monkeypatch):
    got = _port_run(step_params, 3, packed=True)
    _assert_bounds(got, _jax_run(step_params, 3, monkeypatch, f32=True))
    moved = max(float(np.abs(got[0][1][n][leaf] - step_params[n][leaf]).max())
                for n in step_params for leaf in step_params[n])
    assert 0.5 * LR < moved < 2 * LR


def test_packed_bf16_step_matches_jax(step_params, monkeypatch):
    snaps, metrics = _port_run(step_params, 1, packed=True, bf16=True)
    ref_snaps, ref_metrics = _jax_run(step_params, 1, monkeypatch, f32=False)
    assert abs(metrics[0]["loss"] - ref_metrics[0]["loss"]) < 2e-3
    _close(snaps[1], ref_snaps[1], 5e-3)


# ------------------------------------------------------------ fused eval, packed input
@pytest.mark.parametrize("packed", [False, True])
def test_host_packed_eval_equals_unpacked(packed):
    """The fused step on a frame pre-packed by pack_frame_np (crop from hr)
    gives the unpacked frame's outputs exactly; with_inputs unpacks the
    input panel."""
    net = UNetSeeInDark(nf=4)
    net.load_state_dict(params_from_jax(jax_unet_params(4, seed=8, head_bias=0.3)))
    rng = np.random.default_rng(4)
    lr = rng.uniform(0, 0.4, (1, 40, 56, 4)).astype(np.float32)  # pads to 48 x 64
    hr = rng.uniform(0, 1, (1, 40, 56, 4)).astype(np.float32)
    step = make_eval_metrics_step(net, packed=packed)
    kw = dict(ori=True, correct=True, with_inputs=True)
    a = step(torch.from_numpy(lr), torch.from_numpy(hr), 2.0, **kw)
    b = step(torch.from_numpy(pack_frame_np(lr)), torch.from_numpy(hr), 2.0, **kw)
    assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
    for k in a[1]:
        assert float(a[1][k]) == float(b[1][k]), k


def test_packed_eval_forward_matches_nchw():
    """f32: the fused step through the hybrid packed forward against the
    NCHW forward (5e-3 dB / 1e-4 SSIM, the f32 eval bar) and against JAX's
    fused step, which runs the packed forward too."""
    params = jax_unet_params(4, seed=9, head_bias=0.3)
    net = UNetSeeInDark(nf=4)
    net.load_state_dict(params_from_jax(params))
    rng = np.random.default_rng(5)
    lr = rng.uniform(0, 0.4, (1, 40, 56, 4)).astype(np.float32)
    hr = rng.uniform(0, 1, (1, 40, 56, 4)).astype(np.float32)
    kw = dict(ori=False, correct=True)
    _, mp = make_eval_metrics_step(net, packed=True)(torch.from_numpy(lr), torch.from_numpy(hr), 1.0, **kw)
    _, mn = make_eval_metrics_step(net)(torch.from_numpy(lr), torch.from_numpy(hr), 1.0, **kw)
    jtp = JS.transform_params_hybrid(params, jnp.float32)
    fwd = functools.partial(JS.unet_hybrid_forward_packed, dtype=jnp.float32)
    with pytest.MonkeyPatch.context() as mp_:
        mp_.setattr(JS, "unet_hybrid_forward_packed", fwd)
        _, mj = jax_fused(FlaxUNet(nf=4))(jtp, jnp.asarray(lr), jnp.asarray(hr),
                                          jnp.float32(1.0), **kw)
    for ref in (mn, {k: float(v) for k, v in mj.items()}):
        assert abs(float(mp["psnr"]) - float(ref["psnr"])) < 5e-3
        assert abs(float(mp["ssim"]) - float(ref["ssim"])) < 1e-4


# ------------------------------------------------------------ Trainer --int8
def _int8_fixture(root):
    """tests/test_trainer_e2e.py::test_trainer_int8_eval's fixture and
    runfile: 2 scenes of 32x48 listed 120 times, ratio 100, nf=4."""
    make_sid_fixture(root, n_scenes=2, H=32, W=48)
    with open(root / "infos" / "SID_eval.info", "rb") as f:
        infos = pickle.load(f)
    big = []
    for k in range(120):
        e = dict(infos[k % len(infos)])
        e["short"], e["ratio"] = e["short"][0], e["ratio"][0]
        big.append(e)
    with open(root / "infos" / "SID_eval.info", "wb") as f:
        pickle.dump(big, f)
    run = {
        "mode": "eval", "checkpoint": str(root / "saved_model"),
        "fast_ckpt": str(root / "checkpoints"),
        "model_name": "I8_Unet", "num_workers": 0,
        "brightness_correct": True,
        "dst": {"dataset": "SID_Dataset", "dstname": "SID", "command": "",
                "camera_type": "SonyA7S2", "noise_code": "pr",
                "patch_size": 8, "H": 32, "W": 48, "crop_per_image": 1,
                "croptype": "random_crop", "wp": 16383, "bl": 512,
                "ori": False, "clip": 2, "infos_dir": str(root / "infos")},
        "arch": {"name": "UNetSeeInDark", "nf": 4, "nframes": 1},
        "hyper": {"lr_scheduler": "fixed", "learning_rate": 1e-4,
                  "batch_size": 1, "stop_epoch": 1, "last_epoch": 0,
                  "save_freq": 1, "plot_freq": 1, "best_psnr": 0},
    }
    run["dst_eval"] = dict(run["dst"], mode="eval")
    path = str(root / "i8.yml")
    with open(path, "w") as f:
        yaml.safe_dump(run, f)
    save_checkpoint(os.path.join(run["fast_ckpt"], "I8_Unet_best_model.ckpt"),
                    jax_unet_params(4, seed=13, std=0.05, head_bias=0.3), meta={"epoch": 1})
    return path


def _pickle(root, side):
    with open(root / side / "metrics" / "I8_Unet_metrics.pkl", "rb") as f:
        return pickle.load(f)


def test_trainer_int8_eval_matches_jax(tmp_path, monkeypatch):
    path = _int8_fixture(tmp_path)
    monkeypatch.setattr(jax_trainer, "create_train_state", _shape_only_state)

    def in_dir(side):
        os.makedirs(tmp_path / side, exist_ok=True)
        monkeypatch.chdir(tmp_path / side)

    in_dir("jax")
    j8 = jax_trainer.Trainer(path, mode="eval", nofig=True, debug=True, int8=True)
    j8.mesh_spatial = None  # one device (the conftest exposes 8)
    j8._fused_eval = jax_fused(j8.model)
    j8.dataset_eval.change_eval_ratio(100)
    j8.eval(-1)
    assert j8._int8_cache["step"] is not None

    cal_spy = {}
    real_cal = PI.calibrate_act_scales

    def spy(tp, frames, dtype=torch.bfloat16, pct=100.0, **kw):
        cal_spy["n"], cal_spy["pct"] = len(frames), pct
        return real_cal(tp, frames, dtype, pct=pct, **kw)

    monkeypatch.setattr(PI, "calibrate_act_scales", spy)
    served = {"int8": 0, "frames": 0}
    real_int8 = Trainer._int8_eval_step

    def counted(self, lr):
        out = real_int8(self, lr)
        served["frames"] += 1
        served["int8"] += out is not None
        return out

    monkeypatch.setattr(Trainer, "_int8_eval_step", counted)
    in_dir("torch")
    t8 = Trainer(path, mode="eval", nofig=True, debug=True, int8=True, device="cpu")
    assert t8.int8_cal_frames == 3
    t8.dataset_eval.change_eval_ratio(100)
    t8.eval(-1)
    assert t8._int8_cache["step"] is not None
    assert cal_spy == {"n": 3, "pct": 99.95}, cal_spy
    assert served["int8"] == served["frames"] - 2 >= 2, served
    got, ref = _pickle(tmp_path, "torch"), _pickle(tmp_path, "jax")

    in_dir("torch16")
    t16 = Trainer(path, mode="eval", nofig=True, debug=True, device="cpu")
    t16.dataset_eval.change_eval_ratio(100)
    t16.eval(-1)
    bf16 = _pickle(tmp_path, "torch16")
    assert got.keys() == ref.keys() == bf16.keys() and got
    for name in ref:
        # JAX's int8 sweep: the bf16 eval bar (measured 2.3e-4 dB, 3.1e-5)
        assert abs(got[name][0] - ref[name][0]) < 1e-2, (name, got[name], ref[name])
        assert abs(got[name][1] - ref[name][1]) < 1e-3, (name, got[name], ref[name])
        # the port's bf16 sweep: the int8 bar
        assert abs(got[name][0] - bf16[name][0]) < 0.5, (name, got[name], bf16[name])
        assert abs(got[name][1] - bf16[name][1]) < 0.05, (name, got[name], bf16[name])


@pytest.mark.parametrize("extra", [{"rgb_metrics": True}, {"disable_fused_eval": True},
                                   {"disable_fast_path": True}])
def test_trainer_int8_refusals(tmp_path, monkeypatch, extra):
    """--int8 needs the fused raw-domain bf16 path, as in JAX."""
    monkeypatch.chdir(tmp_path)
    make_sid_fixture(tmp_path, n_scenes=2, H=32, W=48)
    run = dict(make_sid_runfile(tmp_path), mode="eval", **extra)
    path = str(tmp_path / "run.yml")
    with open(path, "w") as f:
        yaml.safe_dump(run, f)
    t = Trainer(path, nofig=True, debug=True, int8=True, device="cpu")
    with pytest.raises(ValueError, match="--int8"):
        t.eval(-1)


# ------------------------------------------------------------ Trainer packed forms
def test_trainer_packed_step_trains(tmp_path, monkeypatch):
    """packed_step on: --mode trainonly on Raw_Dataset pgrq goes through the
    packed synth and step (packed [n, 16, h, w] pairs), params move; with
    packed_step off (the default) the same runfile trains unpacked."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(Trainer, "packed_step", True)
    make_sid_fixture(tmp_path, n_scenes=2, H=64, W=96)
    run = make_sid_runfile(tmp_path, "PK_Unet", nf=4, patch_size=32, H=64, W=96,
                           batch_size=1, noise_code="pgrq")
    run["mode"] = "trainonly"
    path = str(tmp_path / "run.yml")
    with open(path, "w") as f:
        yaml.safe_dump(run, f)
    shapes = []
    real = Trainer._train_batch

    def spy(self, batch):
        out = real(self, batch)
        shapes.append(tuple(self.train_step.make_pair(out, torch.Generator().manual_seed(0))[0].shape))
        return out

    monkeypatch.setattr(Trainer, "_train_batch", spy)
    t = main(["-f", path, "--mode", "trainonly", "--nofig", "--debug"], device="cpu")
    assert t._use_packed and t.train_step.packed
    assert shapes and all(s == (2, 16, 16, 16) for s in shapes), shapes
    init = UNetSeeInDark(nf=4, generator=torch.Generator().manual_seed(t.seed))
    moved = max(float((a - b).abs().max()) for a, b in
                zip(t.model.state_dict().values(), init.state_dict().values()))
    assert 0.5 * 1e-3 < moved
    monkeypatch.setattr(Trainer, "packed_step", False)
    t = Trainer(path, mode="trainonly", debug=True, device="cpu")
    assert not t._use_packed and not t.train_step.packed


@pytest.mark.parametrize("bf16", [False, True])
def test_step_memory_format(bf16):
    """The train step and the fused eval step move a module that computes in
    bf16 into channels_last memory (BF16_MEMORY_FORMAT) and leave an f32 one
    NCHW; an explicit memory_format wins. Either layout computes the same:
    eval metrics and the train loss to 1e-6 (f32) or 1e-3 (bf16) relative,
    the two layouts summing in another order."""
    from pnnp_tpu_torch.train.steps import BF16_MEMORY_FORMAT

    cl, nchw = BF16_MEMORY_FORMAT, torch.contiguous_format
    layout = lambda m: [m.conv1_1.weight.is_contiguous(memory_format=f) for f in (cl, nchw)]
    dtype = torch.bfloat16 if bf16 else torch.float32
    tol = 1e-3 if bf16 else 1e-6
    net = lambda dt: UNetSeeInDark(nf=4, dtype=dt, generator=torch.Generator().manual_seed(5))
    rng = np.random.default_rng(6)
    lr = torch.from_numpy(rng.uniform(0, 0.4, (1, 40, 56, 4)).astype(np.float32))
    hr = torch.from_numpy(rng.uniform(0, 1.0, (1, 40, 56, 4)).astype(np.float32))
    a, b = net(dtype), net(dtype)
    ma = make_eval_metrics_step(a)(lr, hr, 1.0)[1]
    mb = make_eval_metrics_step(b, memory_format=nchw if bf16 else cl)(lr, hr, 1.0)[1]
    assert layout(a) == ([True, False] if bf16 else [False, True])
    assert layout(b) == ([False, True] if bf16 else [True, False])
    for k in ma:
        assert abs(float(ma[k]) - float(mb[k])) <= tol * abs(float(mb[k])), (k, ma, mb)

    pair = {"lr": lr.permute(0, 3, 1, 2)[:, :, :32, :48].contiguous(),
            "hr": hr.permute(0, 3, 1, 2)[:, :, :32, :48].contiguous()}
    losses = []
    for fmt in (None, nchw if bf16 else cl):
        m = net(torch.float32)
        step = make_train_step(lambda e: 1e-3, identity_synth, bf16=bf16, memory_format=fmt)
        losses.append(float(step(m, make_adam(m.parameters()), pair,
                                 torch.Generator().manual_seed(0), 1)["loss"]))
        want = [True, False] if (fmt is None) == bf16 else [False, True]
        assert layout(m) == want and m.conv1_1.weight.grad.is_contiguous(
            memory_format=cl if want[0] else nchw)
    assert abs(losses[0] - losses[1]) <= tol * losses[1], losses
