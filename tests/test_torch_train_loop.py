"""The train modes end to end: the port's Trainer against the JAX Trainer,
and the loop's rules (restore order, eval legs, SGDR reload, recovery).

* ``trainonly`` on paired SID data (``identity_synth``), 2 epochs, f32
  (``disable_fast_path``): the JAX Trainer runs single-device (as
  tests/test_torch_trainer.py runs its eval); both resume from one shared
  ``last`` checkpoint and see identical host batches (seed 1997). Their
  ``last`` params agree to rtol 1e-4 / atol 1e-5 (f32 in another order, as
  tests/test_torch_train_step.py), the checkpoint file names are the same,
  the epoch log lines carry the same fields (train_psnr within 0.01 + one
  printed step, lr equal), and each package restores the other's checkpoint.
* ``--mode train`` on ``Raw_Dataset`` with ``pgrq`` runs on the CPU through
  ``main(..., device="cpu")`` into the ``evaltest`` sweep: every eval leg
  serves the fixture's frames (the 250 split is placed with
  ``place_eval_split``), and the metrics pickle holds every eval frame.
"""

import os
import pickle
import re

import jax
import numpy as np
import pytest
import torch
import yaml

import pnnp_tpu.trainer as jax_trainer
from pnnp_tpu.train.checkpoint import load_any as jax_load_any
from pnnp_tpu_torch.data.fixtures import make_sid_fixture, make_sid_runfile, place_eval_split
from pnnp_tpu_torch.models import UNetSeeInDark, params_from_jax, params_to_jax
from pnnp_tpu_torch.train.checkpoint import load_any, save_checkpoint
from pnnp_tpu_torch.trainer import Trainer, main
from tests.test_torch_models import jax_unet_params
from tests.test_torch_trainer import _shape_only_state

MODEL = "LOOP_Unet"
EPOCH_LINE = re.compile(r"Epoch (\d+): loss ok, train_psnr=(\S+), lr=(\S+), "
                        r"time=\S+s \[loader \d+% net \d+%\]")


def _write(path, run):
    with open(path, "w") as f:
        yaml.safe_dump(run, f)
    return str(path)


def _paired_run(root, side):
    """trainonly on SID pairs, checkpoints under ``root/side``."""
    run = make_sid_runfile(root, MODEL, nf=4, patch_size=32, H=64, W=96, batch_size=2,
                           stop_epoch=2)
    run.update(mode="trainonly", disable_fast_path=True,
               checkpoint=str(root / side / "saved_model"),
               fast_ckpt=str(root / side / "checkpoints"))
    run["dst_train"]["dataset"] = "SID_Dataset"
    return run


def _trees_close(a, b):
    assert a.keys() == b.keys()
    for name in a:
        for leaf in a[name]:
            np.testing.assert_allclose(np.asarray(a[name][leaf]), np.asarray(b[name][leaf]),
                                       rtol=1e-4, atol=1e-5, err_msg=f"{name}/{leaf}")


def test_trainonly_matches_jax(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(jax_trainer, "create_train_state", _shape_only_state)
    make_sid_fixture(tmp_path, n_scenes=3, H=64, W=96)
    start = jax_unet_params(4, seed=31, std=0.05, head_bias=0.2)
    lines = {}
    for side in ("jax", "torch"):
        run = _paired_run(tmp_path, side)
        save_checkpoint(os.path.join(run["fast_ckpt"], f"{MODEL}_last_model.ckpt"),
                        start, meta={"epoch": 0})
        path = _write(tmp_path / f"{side}.yml", run)
        os.makedirs(tmp_path / side, exist_ok=True)
        monkeypatch.chdir(tmp_path / side)
        if side == "jax":
            t = jax_trainer.Trainer(path, debug=True)
            t.n_data = 1  # single device (the conftest exposes 8)
            t.train_step = t._base_train_step
            t.state = jax.device_put(t.state, jax.devices()[0])
        else:
            t = Trainer(path, debug=True, device="cpu")
            assert t.model.conv1_1.weight.dtype == torch.float32
        t.train()
        out = capsys.readouterr().out
        assert "Restored checkpoint (epoch 0)" in out
        lines[side] = EPOCH_LINE.findall(out)

    assert [e for e, *_ in lines["torch"]] == [e for e, *_ in lines["jax"]] == ["1", "2"]
    for (e1, p1, lr1), (e2, p2, lr2) in zip(lines["jax"], lines["torch"]):
        assert e1 == e2 and lr1 == lr2 and abs(float(p1) - float(p2)) <= 0.01 + 0.005
    for d in ("checkpoints", "saved_model"):
        names = sorted(os.listdir(tmp_path / "jax" / d))
        assert names == sorted(os.listdir(tmp_path / "torch" / d)) and names
    last = f"checkpoints/{MODEL}_last_model.ckpt"
    ref = jax_load_any(str(tmp_path / "jax" / last))
    got = load_any(str(tmp_path / "torch" / last))
    assert got["meta"]["epoch"] == ref["meta"]["epoch"] == 2
    _trees_close(got["params"], ref["params"])
    # each package reads the other's file: the JAX loader the port's, and
    # the port's module the JAX file (strict)
    _trees_close(jax_load_any(str(tmp_path / "torch" / last))["params"], ref["params"])
    net = UNetSeeInDark(nf=4)
    net.load_state_dict(params_from_jax(got["params"]), strict=True)
    _trees_close(params_to_jax(net.state_dict()), ref["params"])
    moved = max(float(np.abs(np.asarray(ref["params"][n][k]) - start[n][k]).max())
                for n in start for k in start[n])
    assert moved > 1e-4


def _raw_run(root, mode="train", stop_epoch=2, T=2, plot_freq=1, **hyper):
    """Raw_Dataset + pgrq on the fixture, the 250 eval split placed."""
    run = make_sid_runfile(root, MODEL, nf=4, patch_size=16, H=64, W=96, batch_size=1,
                           stop_epoch=stop_epoch, noise_code="pgrq")
    run["mode"] = mode
    run["hyper"].update(T=T, plot_freq=plot_freq, **hyper)
    run["dst_eval"]["ratio_list"] = [250]
    return run


@pytest.fixture()
def raw_root(tmp_path, monkeypatch):
    infos = make_sid_fixture(tmp_path, n_scenes=2, H=64, W=96)
    place_eval_split(tmp_path, infos, 250)
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_train_mode_runs_into_evaltest(raw_root, capsys, monkeypatch):
    legs, evaluate = [], Trainer.eval

    def eval_leg(self, epoch=-1):
        evaluate(self, epoch)
        legs.append((self.eval_psnr.count, epoch))

    monkeypatch.setattr(Trainer, "eval", eval_leg)
    path = _write(raw_root / "run.yml", _raw_run(raw_root))
    t = main(["-f", path, "--mode", "train", "--nofig"], device="cpu")
    out = capsys.readouterr().out
    assert "aborted" not in out
    assert [e for e, *_ in EPOCH_LINE.findall(out)] == ["1", "2"]
    assert all(float(lr) > 0 for _, _, lr in EPOCH_LINE.findall(out))
    # three eval legs (epochs 1 and 2, then the evaltest sweep), 2 frames each
    assert legs == [(2, 1), (2, 2), (2, -1)]
    assert "Period boundary: reloaded best checkpoint" in out
    with open(raw_root / "metrics" / f"{MODEL}_metrics.pkl", "rb") as f:
        metrics = pickle.load(f)
    assert len(metrics) == 2 and all(np.isfinite(v).all() for v in metrics.values())
    assert t.model.conv1_1.weight.dtype == torch.float32
    assert t.eval_model.conv1_1.weight.dtype == torch.bfloat16
    # the eval model serves the master weights it was refreshed from (best)
    for a, b in zip(t.model.parameters(), t.eval_model.parameters()):
        assert torch.equal(a.to(torch.bfloat16), b)
    for name in ("last", "best"):
        ckpt = load_any(str(raw_root / "checkpoints" / f"{MODEL}_{name}_model.ckpt"))
        assert all(np.isfinite(v).all() for p in ckpt["params"].values() for v in p.values())


@pytest.mark.parametrize("mode,last_epoch,expect", [
    ("trainonly", 0, "last"), ("train", 0, "init"), ("train", 3, "last"), ("eval", 0, "best"),
])
def test_restore_rules(raw_root, mode, last_epoch, expect):
    """trainonly always resumes from last; train only when last_epoch > 0;
    the eval modes take best."""
    run = _raw_run(raw_root, mode=mode, stop_epoch=5, last_epoch=last_epoch)
    run["disable_fast_path"] = True  # an f32 model in every mode: exact compare
    trees = {k: jax_unet_params(4, seed=s) for k, s in (("last", 41), ("best", 42))}
    for k, tree in trees.items():
        save_checkpoint(os.path.join(run["fast_ckpt"], f"{MODEL}_{k}_model.ckpt"), tree,
                        meta={"epoch": 3})
    t = Trainer(_write(raw_root / "run.yml", run), device="cpu", nofig=True)
    got = params_to_jax(t.model.state_dict())
    if expect == "init":
        init = UNetSeeInDark(nf=4, generator=torch.Generator().manual_seed(1997))
        _trees_close(got, params_to_jax(init.state_dict()))
    else:
        _trees_close(got, trees[expect])


def _record_steps(t):
    """Wrap the train step: the params at each step's entry, by epoch."""
    seen, step = [], t.train_step

    def wrapped(model, opt, batch, gen, epoch):
        seen.append((epoch, params_to_jax(model.state_dict()), opt))
        return step(model, opt, batch, gen, epoch)

    t.train_step = wrapped
    return seen


def test_sgdr_reload_keeps_adam_state(raw_root, capsys):
    """T=2 over 2 epochs: epoch 1 ends a period, so best is reloaded into
    the params in place; the optimizer and its moments carry on."""
    t = Trainer(_write(raw_root / "run.yml", _raw_run(raw_root)), device="cpu",
                nofig=True, debug=True)
    seen = _record_steps(t)
    restored = []
    restore = t.ckpt.restore
    t.ckpt.restore = lambda prefer="best": restored.append(restore(prefer)) or restored[-1]
    opt = t.opt
    t.train()
    assert "Period boundary: reloaded best checkpoint" in capsys.readouterr().out
    first_e2 = next(p for e, p, _ in seen if e == 2)
    _trees_close(first_e2, restored[0]["params"])
    assert t.opt is opt and all(o is opt for *_, o in seen)
    steps = {int(s["step"]) for s in opt.state.values()}
    assert steps == {len(seen)} and len(seen) == 4


def test_recovers_from_runtime_error(raw_root, capsys):
    """A step that raises RuntimeError aborts its epoch: the params come
    back from the last checkpoint, the optimizer starts afresh, and the next
    epoch trains."""
    run = _raw_run(raw_root, mode="trainonly", stop_epoch=3, plot_freq=10)
    t = Trainer(_write(raw_root / "run.yml", run), device="cpu", nofig=True, debug=True)
    seen = _record_steps(t)
    step = t.train_step

    def failing(model, opt, batch, gen, epoch):
        if epoch == 2:
            raise RuntimeError("injected fault")
        return step(model, opt, batch, gen, epoch)

    t.train_step = failing
    opt = t.opt
    t.train()
    out = capsys.readouterr().out
    assert "Epoch 2 aborted by RuntimeError: injected fault" in out
    assert "Recovered params from last checkpoint (epoch 1)" in out
    assert [e for e, *_ in EPOCH_LINE.findall(out)] == ["1", "2", "3"]
    assert t.opt is not opt
    first_e3 = next(p for e, p, _ in seen if e == 3)
    ckpt_e1 = load_any(str(raw_root / "saved_model" / f"{MODEL}_e0001.ckpt"))
    _trees_close(first_e3, ckpt_e1["params"])
    assert {int(s["step"]) for s in t.opt.state.values()} == {2}


@pytest.mark.parametrize("dataset,item", [("dpsv", "1.13")])
def test_unported_train_families_raise(raw_root, dataset, item):
    run = _raw_run(raw_root, mode="train")
    run["arch"]["use_dpsv"] = True
    with pytest.raises(NotImplementedError, match=re.escape(f"ROADMAP {item}")):
        Trainer(_write(raw_root / "run.yml", run), device="cpu")


def test_train_modes_need_the_card(raw_root, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = _write(raw_root / "run.yml", _raw_run(raw_root))
    for mode in ("train", "trainonly"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["-f", path, "--mode", mode, "--nofig"])
