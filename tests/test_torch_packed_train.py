"""The port's one UNet layout in training and eval against the JAX
package's packed (dense-s2d) forms, and ``--int8`` in the Trainer.

The port trains and evaluates UNetSeeInDark in the unpacked RGBG layout;
the 16-channel layout lives only inside its W8A8 serving forward. The JAX
package trains and serves the same network packed. Each packed form of
JAX's is held here against the port's unpacked counterpart on the same
data:

* ``generate_noisy``'s row banding: once the clean frame is zero, each RGBG
  channel's row is one constant, the two rows of a Bayer pair (one packed
  row) differ, the dark bias comes out per RGBG channel; JAX's
  ``generate_noisy_packed`` on the same parameters shows the same row law.
  The port's ``make_raw_synth`` against JAX's ``generate_noisy_packed`` on
  the synth's own parameter draw: mean, std and the per-row component
  within sampling error.
* The f32 NCHW ``TrainStep`` (``identity_synth`` over fixed pairs) against
  JAX's ``make_train_step(fast="packed")`` in f32, after 1 and 3 steps, to
  tests/test_parity_and_sharding.py:159-162's bounds (loss 1e-5, psnr 1e-3,
  params atol 1e-5). JAX's packed step computes in bf16 only; the f32
  comparison runs it with its hybrid transform and forward given
  ``dtype=float32`` (module attributes patched for the test, the package
  untouched). The bf16 ``channels_last`` step against the port's f32
  step and JAX's bf16 packed step: the loss, the whole gradient and the
  first Adam update.
* The fused eval step on the unpacked frame against JAX's fused step fed
  the host-packed frame of the same mosaic, f32 and bf16.
* ``Trainer --int8`` against JAX's ``test_trainer_int8_eval`` fixture and
  runfile on one checkpoint: the calibration spied (3 frames, pct 99.95),
  frames from the third on served int8 (the first two by the bf16 step),
  the metrics pickle within the bf16 eval bar (1e-2 dB / 1e-3 SSIM) of
  JAX's int8 pickle and within 0.5 dB / 0.05 of the port's own bf16 pickle
  (the bar of tests/test_unet_s2d_int8.py:137); the refusals.
* The steps' memory format: channels_last for bf16 compute, NCHW for f32,
  either computing the same.
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
from pnnp_tpu.train.losses import unet_loss as jax_unet_loss
from pnnp_tpu.train.schedules import build_lr_schedule as jax_build_lr_schedule
from pnnp_tpu.train.state import TrainState, make_adam_direction
from pnnp_tpu.train.steps import clip_lr_hr as jax_clip_lr_hr
from pnnp_tpu.train.steps import identity_synth as jax_identity_synth
from pnnp_tpu.train.steps import make_eval_metrics_step as jax_fused
from pnnp_tpu.train.steps import make_train_step as jax_make_train_step
from pnnp_tpu_torch.data.fixtures import make_sid_fixture, make_sid_runfile
from pnnp_tpu_torch.models import UNetSeeInDark, params_from_jax, params_to_jax
from pnnp_tpu_torch.models.unet_s2d import s2d_np
from pnnp_tpu_torch.physics.noise import generate_noisy
from pnnp_tpu_torch.train import (
    build_lr_schedule,
    identity_synth,
    make_adam,
    make_eval_metrics_step,
    make_raw_synth,
    make_train_step,
)
from pnnp_tpu_torch.train.checkpoint import save_checkpoint
from pnnp_tpu_torch.train.steps import _raw_synth_params
from pnnp_tpu_torch.trainer import Trainer
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


def _j(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


# ------------------------------------------------------------ physics synth
def test_packed_row_noise_banding():
    """Row noise alone (no shot, no read) on a zero frame: each RGBG
    channel's row is one constant, the two rows of a Bayer pair (those one
    packed row holds) differ, the row std is sigR = 1.5 ADU; JAX's packed
    generator on the same parameters gives the same row law (its rows'
    std within 15% of the port's). The dark bias comes out per RGBG
    channel in both."""
    n, h, w = 4, 64, 8
    quiet = dict(K=np.full(n, 1e-9), sigGs=np.zeros(n), ratio=np.ones(n))
    adu = 16383.0 - 512.0
    z = generate_noisy(torch.Generator().manual_seed(0), torch.zeros(n, 4, h, w),
                       _t(_params(n, **quiet)), "r", ori=True, clip=False)
    u = z * adu  # ADU, [n, 4, h, w]
    assert float((u - u[..., :1]).abs().max()) < 1e-6
    rows = u[..., 0]  # [n, 4, h]
    assert float((rows[..., 0::2] - rows[..., 1::2]).abs().min()) > 0
    assert 0.5 < float(rows.std()) / 1.5 < 1.5
    zj = np.asarray(jax_noisy_packed(jax.random.key(0), jnp.zeros((n, h // 2, w // 2, 16)),
                                     _j(_params(n, **quiet)), "r", ori=True)) * adu
    uj = JS.d2s_np(zj)  # [n, h, w, 4]
    assert np.abs(uj - uj[:, :, :1]).max() < 1e-6
    assert abs(float(rows.std()) / uj[:, :, 0].std() - 1.0) < 0.15
    zb = generate_noisy(torch.Generator().manual_seed(0), torch.zeros(n, 4, h, w),
                        _t(_params(n, **quiet)), "d", ori=True)
    zbj = JS.d2s_np(np.asarray(jax_noisy_packed(
        jax.random.key(0), jnp.zeros((n, h // 2, w // 2, 16)), _j(_params(n, **quiet)), "d",
        ori=True)))
    for bias in (zb.mean(dim=(2, 3))[0].numpy(), zbj.mean(axis=(1, 2))[0]):
        np.testing.assert_allclose(bias * adu, [1.0, -2.0, 3.0, -4.0], atol=1e-3)


def test_packed_synth_moments():
    """pgrq on one clean frame: the port's ``make_raw_synth`` against JAX's
    ``generate_noisy_packed`` on the synth's own parameter draw (the same
    generator seed, the draw that comes first), by the noise's mean and std
    and its per-row component (the std of each packed row's mean), within
    sampling error; and ``generate_noisy`` on fixed parameters against
    JAX's packed generator, by the same moments. The pairs have 32,768
    and 65,536 samples: the means within 0.01 std, the stds within 2%, the per-row
    component within 15%."""
    hr = np.random.default_rng(0).uniform(0, 0.01, (2, 64, 64, 4)).astype(np.float32)
    hr_t = torch.from_numpy(hr).permute(0, 3, 1, 2).contiguous()
    lr, hr_out, ratio = make_raw_synth("SonyA7S2", "pgrq", ori=False, clip=False)(
        torch.Generator().manual_seed(5), {"hr": hr_t})
    drawn = _raw_synth_params(torch.Generator().manual_seed(5), "SonyA7S2", 2, None, None,
                              False, False)
    assert lr.shape == hr_out.shape == (2, 4, 64, 64) and torch.equal(hr_out, hr_t)
    assert torch.equal(ratio, drawn["ratio"])
    p = {k: v.numpy() for k, v in drawn.items()}
    pairs = [(lr, hr, p, "pgrq", 7)]
    p4 = _params(4)
    g = np.random.default_rng(1).uniform(0, 0.05, (4, 64, 64, 4)).astype(np.float32)
    ours = generate_noisy(torch.Generator().manual_seed(2),
                          torch.from_numpy(g).permute(0, 3, 1, 2), _t(p4), "pgrqd")
    pairs.append((ours, g, p4, "pgrqd", 2))
    for got, clean, params, code, seed in pairs:
        theirs = np.asarray(jax_noisy_packed(jax.random.key(seed), jnp.asarray(s2d_np(clean)),
                                             _j(params), code))
        amp = params["ratio"].reshape(-1, 1, 1, 1)
        d_ours = s2d_np(got.permute(0, 2, 3, 1).numpy()) - s2d_np(clean) * amp
        d_theirs = theirs - s2d_np(clean) * amp
        assert abs(d_ours.mean() - d_theirs.mean()) < 0.01 * d_theirs.std()
        assert abs(d_ours.std() / d_theirs.std() - 1.0) < 0.02
        # the row component: per-row means over the packed row's 16 channels
        assert abs(d_ours.mean(axis=2).std() / d_theirs.mean(axis=2).std() - 1.0) < 0.15


# ------------------------------------------------------------ train step
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


def _port_step(bf16):
    return make_train_step(build_lr_schedule({"lr_scheduler": "fixed", "learning_rate": LR,
                                              "stop_epoch": 10}),
                           identity_synth, clip_mode=2, bf16=bf16)


def _port_net(params):
    net = UNetSeeInDark(nf=4)
    net.load_state_dict(params_from_jax(params), strict=True)
    return net


def _port_run(params, steps, bf16=False):
    net = _port_net(params)
    opt = make_adam(net.parameters())
    step = _port_step(bf16)
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
        state, m = step(state, _jax_packed_batch(b), jax.random.key(i), 1)
        metrics.append({k: float(v) for k, v in m.items()})
        snaps[i + 1] = jax.tree.map(np.asarray, state.params)
    return snaps, metrics


def _jax_packed_batch(b):
    return {"lr": JS.s2d(jnp.asarray(b["lr"])), "hr": JS.s2d(jnp.asarray(b["hr"])),
            "ratio": jnp.asarray(b["ratio"])}


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


def test_packed_step_matches_jax_packed_step(step_params, monkeypatch):
    got = _port_run(step_params, 3)
    _assert_bounds(got, _jax_run(step_params, 3, monkeypatch, f32=True))
    moved = max(float(np.abs(got[0][1][n][leaf] - step_params[n][leaf]).max())
                for n in step_params for leaf in step_params[n])
    assert 0.5 * LR < moved < 2 * LR


def _flat(tree):
    return np.concatenate([np.ravel(np.asarray(tree[n][k], np.float32))
                           for n in sorted(tree) for k in sorted(tree[n])])


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_packed_bf16_step_matches_jax(step_params, monkeypatch):
    """The port's bf16 step (autocast over f32 master params, the module in
    channels_last memory) against its own f32 step and JAX's bf16 packed
    step on one batch. The port's f32 step is held to JAX's f32 step by the
    test above, so it stands in for the exact gradient here.

    The bars come from the measured gaps, each with a margin of about 3x:
    * the whole gradient within 0.05 relative L2 of the f32 gradient
      (measured 0.015; a bf16 gradient off by more than rounding lands far
      outside it);
    * no farther from it than JAX's bf16 gradient is (measured 0.015
      against 0.32: JAX casts the weights after the s2d fold and runs level
      1 dense-s2d, so it rounds at other places);
    * the loss within 2e-6 of JAX's bf16 loss (measured 1.2e-7; the port's
      f32 loss sits 6.5e-6 away, so an f32 forward fails it);
    * the first Adam update within 0.04 relative L2 of JAX's (measured
      0.013; the first update is about LR times the gradient's sign, so
      this counts the parameters whose gradient sign differs).
    No per-leaf bar holds: under the L1 loss a leaf whose gradient nearly
    cancels (a bias: the mean of sign(pred - hr)) moves by a large share of
    its max when a few pixels change sign, in either bf16 step."""
    b = _batches(1)[0]
    step = _port_step(True)
    lr_t, hr_t = step.make_pair(_to_torch(b), torch.Generator().manual_seed(0))
    grads = {}
    for name, s in (("bf16", step), ("f32", _port_step(False))):
        net = _port_net(step_params)
        loss, _ = s.forward_backward(net, lr_t, hr_t)
        grads[name] = params_to_jax({k: p.grad for k, p in net.named_parameters()})
        if name == "bf16":
            port_loss = float(loss)

    jb = _jax_packed_batch(b)
    lr_j, hr_j = jax_clip_lr_hr(jb["lr"], jb["hr"], 2)
    loss_j, grads_j = jax.value_and_grad(lambda p: jax_unet_loss(JS.unet_hybrid_forward_packed(
        JS.transform_params_hybrid(p), lr_j, None), hr_j))(jax.tree.map(jnp.asarray, step_params))
    assert abs(port_loss - float(loss_j)) < 2e-6
    exact = _flat(grads["f32"])
    gap = _rel_l2(_flat(grads["bf16"]), exact)
    assert gap < 0.05
    assert gap <= _rel_l2(_flat(grads_j), exact)

    snaps, metrics = _port_run(step_params, 1, bf16=True)
    ref_snaps, ref_metrics = _jax_run(step_params, 1, monkeypatch, f32=False)
    assert abs(metrics[0]["loss"] - ref_metrics[0]["loss"]) < 2e-6
    start = _flat(step_params)
    assert _rel_l2(_flat(snaps[1]) - start, _flat(ref_snaps[1]) - start) < 0.04


# ------------------------------------------------------------ fused eval
@pytest.mark.parametrize("bf16", [False, True])
def test_host_packed_eval_equals_unpacked(bf16):
    """The port's fused step on the unpacked frame against JAX's fused step
    fed the same mosaic host-packed (its ``pack_frame_np``: %16 reflect pad
    and s2d; the crop taken from hr), ori and with_inputs, at the
    %16-misaligned 40x56: the input panel equal, the metrics within the eval
    bar of the dtype (f32: 5e-3 dB / 1e-4 SSIM, JAX's forward run in f32;
    bf16: 1e-2 dB / 1e-3), the output frame within 1e-4 (f32) or 2**-6
    (bf16, four ulps at the top binade)."""
    params = jax_unet_params(4, seed=8, head_bias=0.3)
    dtype = torch.bfloat16 if bf16 else torch.float32
    net = UNetSeeInDark(nf=4, dtype=dtype)
    net.load_state_dict(params_from_jax(params))
    rng = np.random.default_rng(4)
    lr = rng.uniform(0, 0.4, (1, 40, 56, 4)).astype(np.float32)  # pads to 48 x 64
    hr = rng.uniform(0, 1, (1, 40, 56, 4)).astype(np.float32)
    kw = dict(ori=True, correct=True, with_inputs=True)
    dn, m, panel = make_eval_metrics_step(net.eval())(torch.from_numpy(lr),
                                                      torch.from_numpy(hr), 2.0, **kw)
    g = JS.pack_frame_np(lr)
    assert g.shape == (1, 24, 32, 16)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JS, "unet_hybrid_forward_packed", functools.partial(
            JS.unet_hybrid_forward_packed, dtype=jdt))
        d_ref, m_ref, p_ref = jax_fused(FlaxUNet(nf=4))(
            JS.transform_params_hybrid(params, jdt), jnp.asarray(g), jnp.asarray(hr),
            jnp.float32(2.0), **kw)
    np.testing.assert_array_equal(panel.numpy(), np.asarray(p_ref))
    np.testing.assert_allclose(dn.numpy(), np.asarray(d_ref), rtol=0,
                               atol=2.0**-6 if bf16 else 1e-4)
    psnr_bar, ssim_bar = (1e-2, 1e-3) if bf16 else (5e-3, 1e-4)
    for k in m_ref:
        bar = psnr_bar if k.startswith("psnr") else ssim_bar
        assert abs(float(m[k]) - float(m_ref[k])) < bar, (k, float(m[k]), float(m_ref[k]))


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


# ------------------------------------------------------------ memory format
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
