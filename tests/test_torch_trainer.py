"""The slice end to end: the JAX Trainer and the port's Trainer on one
fixture, one runfile and one checkpoint pickle.

The JAX side runs single-device, the way a one-chip serving run selects
its path (as tests/test_eval_metrics_step.py forces it). Per frame the two
agree within PSNR 5e-3 dB / SSIM 1e-4 in f32 (``disable_fast_path: true``:
the same f32 math in another order) and within PSNR 1e-2 dB / SSIM 1e-3 in
bf16 (both serve bf16 but round at other places; see
tests/test_torch_eval_step.py for the measured gap). The metrics-pickle
keys and the 3-line log summary must match.
"""

import os
import pickle
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml

import pnnp_tpu.trainer as jax_trainer
import pnnp_tpu_torch.kernels.ssim as tssim
from pnnp_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from pnnp_tpu.train.state import TrainState, make_adam_direction
from pnnp_tpu.train.steps import make_eval_metrics_step as jax_make_fused
from pnnp_tpu_torch.data.fixtures import make_sid_fixture, make_sid_runfile
from pnnp_tpu_torch.train.checkpoint import save_checkpoint
from pnnp_tpu_torch.trainer import Trainer, eval_sweep
from tests.test_torch_models import jax_unet_params

MODEL = "E2E_Unet"
SUMMARY = re.compile(r"Epoch -1: PSNR=(\S+)\npsnrs_lr=(\S+), psnrs_dn=(\S+)\n"
                     r"ssims_lr=(\S+), ssims_dn=(\S+)")


def _shape_only_state(rng, model, example, **adam_kw):
    """create_train_state without running the flax init: shapes by tracing,
    zeros as values (the eager init costs tens of seconds on the CPU, and
    the checkpoint restore replaces these params anyway)."""
    shapes = jax.eval_shape(model.init, rng, example)["params"]
    params = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    return TrainState.create(apply_fn=model.apply, params=params,
                             tx=make_adam_direction(**adam_kw))


@pytest.fixture()
def slice_setup(tmp_path, monkeypatch):
    monkeypatch.setattr(jax_trainer, "create_train_state", _shape_only_state)
    make_sid_fixture(tmp_path, n_scenes=2, H=64, W=96)
    run = make_sid_runfile(tmp_path, MODEL, nf=4, H=64, W=96)
    run["mode"] = "eval"
    run["dst_eval"]["ratio_list"] = [100]
    return tmp_path, run


def _write_runfile(root, run, **extra):
    path = str(root / "run.yml")
    with open(path, "w") as f:
        yaml.safe_dump(dict(run, **extra), f)
    return path


def _run_jax(root, path, monkeypatch, nofig, fused):
    os.makedirs(root / "jax", exist_ok=True)
    monkeypatch.chdir(root / "jax")
    t = jax_trainer.Trainer(path, mode="eval", nofig=nofig, debug=True)
    t.mesh_spatial = None  # single device (the conftest exposes 8)
    if fused:
        t._fused_eval = jax_make_fused(t.model)
    jax_trainer.eval_sweep(t, t.dataset_eval, [100])
    return t


def _run_port(root, path, monkeypatch, nofig):
    os.makedirs(root / "torch", exist_ok=True)
    monkeypatch.chdir(root / "torch")
    t = Trainer(path, mode="eval", nofig=nofig, debug=True, device="cpu")
    eval_sweep(t, t.dataset_eval, [100])
    return t


def _compare_outputs(root, tol_psnr, tol_ssim, with_inputs):
    with open(root / "jax" / "metrics" / f"{MODEL}_metrics.pkl", "rb") as f:
        ref = pickle.load(f)
    with open(root / "torch" / "metrics" / f"{MODEL}_metrics.pkl", "rb") as f:
        got = pickle.load(f)
    assert got.keys() == ref.keys() and len(got) == 2
    for name in ref:
        assert abs(got[name][0] - ref[name][0]) < tol_psnr, (name, got[name], ref[name])
        assert abs(got[name][1] - ref[name][1]) < tol_ssim, (name, got[name], ref[name])
    logs = []
    for side in ("jax", "torch"):
        text = open(root / side / "logs" / f"log_{MODEL}.log").read()
        found = SUMMARY.findall(text)
        assert len(found) == 1, text
        logs.append([float(v) for v in found[0]])
    # PSNR/SSIM print at 2/4 decimals: allow the tolerance plus one rounding step
    steps = (0.01, 0.01, 0.01, 1e-4, 1e-4)
    tols = (tol_psnr, tol_psnr if with_inputs else 0, tol_psnr,
            tol_ssim if with_inputs else 0, tol_ssim)
    for a, b, step, tol in zip(*logs, steps, tols):
        assert abs(a - b) <= tol + step + 1e-9, logs
    if not with_inputs:
        assert logs[1][1] == logs[1][3] == 0.0


def test_eval_f32_matches_jax(slice_setup, monkeypatch):
    """f32 (disable_fast_path): a checkpoint written by the port, read by
    both; the JAX side takes its unfused f32 path."""
    root, run = slice_setup
    save_checkpoint(os.path.join(run["fast_ckpt"], f"{MODEL}_best_model.ckpt"),
                    jax_unet_params(4, seed=11, head_bias=0.3), meta={"epoch": 7})
    path = _write_runfile(root, run, disable_fast_path=True)
    jt = _run_jax(root, path, monkeypatch, nofig=True, fused=False)
    assert jt._fused_eval is None
    before = tssim.launches
    pt = _run_port(root, path, monkeypatch, nofig=True)
    assert pt.dtype == pt.model.conv1_1.weight.dtype and str(pt.dtype) == "torch.float32"
    assert tssim.launches == before  # CPU tensors: the plain version, no launch
    _compare_outputs(root, 5e-3, 1e-4, with_inputs=False)

    # dump mode on the same checkpoint: the denoised frames themselves
    jt.test(out_dir=str(root / "jax_dump"))
    pt.test(out_dir=str(root / "torch_dump"))
    names = sorted(os.listdir(root / "jax_dump"))
    assert names == sorted(os.listdir(root / "torch_dump")) and len(names) == 2
    for n in names:
        np.testing.assert_allclose(np.load(root / "torch_dump" / n),
                                   np.load(root / "jax_dump" / n),
                                   rtol=1e-4, atol=1e-5)


def test_eval_bf16_matches_jax(slice_setup, monkeypatch):
    """bf16 (the default): a checkpoint written by the JAX package, read by
    both; with figures on, so the input meters (with_inputs) run too."""
    root, run = slice_setup
    jax_save_checkpoint(os.path.join(run["fast_ckpt"], f"{MODEL}_best_model.ckpt"),
                        jax_unet_params(4, seed=12, head_bias=0.3), meta={"epoch": 3})
    path = _write_runfile(root, run)
    _run_jax(root, path, monkeypatch, nofig=False, fused=True)
    pt = _run_port(root, path, monkeypatch, nofig=False)
    assert str(pt.dtype) == "torch.bfloat16"
    _compare_outputs(root, 1e-2, 1e-3, with_inputs=True)
    log = open(root / "torch" / "logs" / f"log_{MODEL}.log").read()
    assert "Devices:\t1 (cpu, bfloat16)" in log


@pytest.mark.parametrize("extra,kw,item", [
    ({"mode": "train", "arch": {"name": "UNetSeeInDark", "nf": 4, "use_dpsv": True}},
     {}, "1.13"),
])
def test_unported_modes_raise(tmp_path, monkeypatch, extra, kw, item):
    monkeypatch.chdir(tmp_path)
    make_sid_fixture(tmp_path, n_scenes=2, H=32, W=48)
    run = dict(make_sid_runfile(tmp_path), mode="eval")
    path = _write_runfile(tmp_path, run, **extra)
    with pytest.raises(NotImplementedError, match=re.escape(f"ROADMAP {item}")):
        Trainer(path, device="cpu", **kw)


def test_predict_raises(tmp_path, monkeypatch):
    """A frame smaller than the tile stride (patch_size - base) raises, as
    the JAX ``eval_crop`` does; tests/test_torch_tiling.py holds predict
    itself against JAX."""
    monkeypatch.chdir(tmp_path)
    make_sid_fixture(tmp_path, n_scenes=2, H=32, W=48)
    path = _write_runfile(tmp_path, dict(make_sid_runfile(tmp_path), mode="eval"))
    t = Trainer(path, device="cpu", nofig=True)
    with pytest.raises(ValueError, match="smaller than the tile stride"):
        t.predict(np.zeros((32, 48), np.float32))
