"""The train families of this slice through the port's Trainer: the synth
each train-dataset name gets (against the JAX Trainer's choice), the eight
runfiles of the IMX686 camera and of the paper's baselines end to end at a
tiny size, and the IMX686 evaltest chain against the JAX Trainer on one
shared checkpoint (f32: within 5e-3 dB / 1e-4 SSIM per frame)."""

import inspect
import math
import os
import pickle
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import pnnp_tpu.train.steps as jsteps
import pnnp_tpu.trainer as jax_trainer
import pnnp_tpu_torch.train.steps as tsteps
import pnnp_tpu_torch.trainer as T
from pnnp_tpu_torch.config import load_runfile
from pnnp_tpu_torch.data.fixtures import make_lrid_fixture, make_sid_fixture
from pnnp_tpu_torch.train import TrainStep, load_any, save_checkpoint
from tests.test_torch_models import jax_unet_params
from tests.test_torch_trainer import _shape_only_state

ROOT = os.path.join(os.path.dirname(__file__), "..")
FACTORIES = ("make_raw_synth", "make_raw_synth_packed", "make_mix_synth", "make_proxy_synth")
# the arguments a factory's choice is compared on; callables by presence
COMPARED = ("camera_type", "noise_code", "ori", "clip", "gtdn", "lrid", "iso", "ratio",
            "noiseparam", "command", "hbr_map", "host_amplified", "ratio_range",
            "ratio_ladder", "iso_from_batch")


def _spy(module, steps_module, calls, monkeypatch):
    """Replace the trainer module's synth factories by recorders of
    (factory, the compared arguments with their defaults bound)."""
    for name in FACTORIES:
        if not hasattr(module, name):
            continue
        sig = inspect.signature(getattr(steps_module, name))

        def rec(*a, _name=name, _sig=sig, **k):
            bound = _sig.bind(*a, **k)
            bound.apply_defaults()
            args = {key: (v is not None if key == "hbr_map" else v)
                    for key, v in bound.arguments.items() if key in COMPARED}
            if isinstance(args.get("ratio_ladder"), tuple):
                args["ratio_ladder"] = list(args["ratio_ladder"])
            calls.append((_name, args))
            return lambda *x: None
        monkeypatch.setattr(module, name, rec)


class _Dataset:
    noiseparam = {6400: {"K": 8.0, "lam": 0.02}}


def _bare_trainers(name, dst, command="", proxy=None):
    """Both Trainers with only what ``_make_synth`` reads: a train mode, the
    train dataset's name and command, the dst block, a proxy stand-in and a
    dataset holding a noiseparam calibration."""
    train = {"dataset": name, "command": command}
    jt = jax_trainer.Trainer.__new__(jax_trainer.Trainer)
    jt.args, jt.mode, jt.dst = {"dst_train": train}, "train", dst
    jt.proxy, jt.proxy_vars, jt._use_packed, jt.dataset_train = proxy, None, False, _Dataset()
    pt = T.Trainer.__new__(T.Trainer)
    pt.dst_train, pt.training, pt.dst = train, True, dst
    pt.proxy, pt.dataset_train = proxy, _Dataset()
    return jt, pt


# every train-dataset name the JAX Trainer's _make_synth knows, with the
# commands that change its choice
DISPATCH = [
    ("Raw_Dataset", ""), ("Raw_Dataset", "GTdn"), ("IMX686_Raw_Dataset", "alldg"),
    ("NF_Syn_Dataset", ""), ("IMX686_NF_Syn_Dataset", "alldg"),
    ("Proxy_Dataset", ""), ("IMX686_Proxy_Dataset", "alldg, HB"),
    ("Mix_Dataset", "augv2, idremap, darkshading2++, HB"), ("Mix_Dataset", ""),
    ("IMX686_Mix_Dataset", "alldg, darkshading2++, augv2, HB"),
    ("IMX686_Mix_Dataset", "alldg, augv2"),
    ("SFRN_Dataset", "HB, lr10"), ("IMX686_SFRN_Raw_Dataset", "alldg, HB"),
    ("PMNNP_Dataset", "idremap, preHB, augv2"), ("IMX686_PMNNP_Dataset", "alldg, HB"),
    ("SID_Dataset", ""),
]


@pytest.mark.parametrize("name,command", DISPATCH)
def test_synth_dispatch_matches_jax(monkeypatch, name, command):
    cam = "IMX686" if name.startswith("IMX686") else "SonyA7S2"
    dst = {"camera_type": cam, "noise_code": "pgrq" if cam == "SonyA7S2" else "p",
           "ori": cam == "IMX686", "clip": 2 if cam == "SonyA7S2" else False,
           "command": command}
    jcalls, tcalls = [], []
    _spy(jax_trainer, jsteps, jcalls, monkeypatch)
    _spy(T, tsteps, tcalls, monkeypatch)
    jt, pt = _bare_trainers(name, dst, command, proxy=object())
    jsynth = jt._make_synth()
    tsynth = pt._make_synth()
    assert tcalls == jcalls
    assert (tsynth is T.identity_synth) == (jsynth is jax_trainer.identity_synth)
    family = tcalls[0][0] if tcalls else "identity"
    want = {"make_mix_synth": {"hr", "lr", "ratio", "iso", "wb", "black_lr"},
            "make_proxy_synth": {"hr", "iso"}, "identity": {"lr", "hr", "ratio"},
            "make_raw_synth": {"hr", "lr"} if "SFRN" in name else {"hr"}}[family]
    assert set(pt.synth_keys) == want




@pytest.mark.parametrize("name,camera,code,clip", [
    ("SFRN_Dataset", "SonyA7S2", "pgrq", 2), ("IMX686_SFRN_Raw_Dataset", "IMX686", "p", False)])
def test_sfrn_synth_law_matches_jax(name, camera, code, clip):
    """The Trainers' SFRN synths (shot-only '<code>b' raw synth plus the read
    layer, amplified alike) on 4096 crops of 8x8: the ratio law, and the
    moments of lr / ratio minus the read layer (the shot noise)."""
    n = 4096
    rng = np.random.default_rng(21)
    hr = rng.uniform(0.0, 0.05, (n, 8, 8, 4)).astype(np.float32)
    read = rng.normal(0, 4e-4, hr.shape).astype(np.float32)
    jt, pt = _bare_trainers(name, {"camera_type": camera, "noise_code": code,
                                   "ori": False, "clip": clip})
    jsynth, tsynth = jt._make_synth(), pt._make_synth()
    lr_j, hr_j, r_j = jsynth(jax.random.key(0), {"hr": jnp.asarray(hr), "lr": jnp.asarray(read)})
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))
    lr_t, hr_t, r_t = tsynth(torch.Generator().manual_seed(0), {"hr": to(hr), "lr": to(read)})
    np.testing.assert_array_equal(hr_t.permute(0, 2, 3, 1).numpy(), np.asarray(hr_j))
    r_t, r_j = r_t.numpy(), np.asarray(r_j)
    for a, b in ((r_t, r_j), (lr_t.permute(0, 2, 3, 1).numpy() / r_t[:, None, None, None] - read,
                              np.asarray(lr_j) / r_j[:, None, None, None] - read)):
        a, b = a.astype(np.float64).ravel(), b.astype(np.float64).ravel()
        se = np.sqrt(a.var() / a.size + b.var() / b.size)
        assert abs(a.mean() - b.mean()) <= max(5 * se, 0.02 * b.std()), (a.mean(), b.mean())
        assert abs(a.std() / b.std() - 1.0) <= 0.02, (a.std(), b.std())


# -- the eight runfiles, end to end -------------------------------------------------

RUNFILES = [("IMX686/PNNP", "train"), ("IMX686/PMN", "train"), ("IMX686/PMNNP", "trainonly"),
            ("IMX686/SFRN", "trainonly"), ("SonyA7S2/PMN", "trainonly"),
            ("SonyA7S2/PMN_MM", "trainonly"), ("SonyA7S2/PMNNP", "trainonly"),
            ("SonyA7S2/SFRN", "trainonly")]


def tiny_runfile(rel, root):
    """A recipe at nf=4 on the tiny fixtures: its datasets, commands, noise
    code, camera and synth family kept; paths, frame sizes, crops and one
    epoch at a fixed lr cut; the IMX686 train sets to their 'small' quarter."""
    run = load_runfile(os.path.join(ROOT, "runfiles", rel + ".yml"))
    lrid = rel.startswith("IMX686")
    fx = os.path.join(root, "lrid" if lrid else "sid")
    for k in ("dst", "dst_train", "dst_eval", "dst_test"):
        if run.get(k):
            run[k] = dict(run[k], root_dir=fx, infos_dir=os.path.join(fx, "infos"),
                          bias_dir=os.path.join(fx, "bias"), ds_dir=None,
                          H=32 if lrid else 64, W=48 if lrid else 96, patch_size=16,
                          crop_per_image=2)
    if lrid:
        run["dst_train"]["command"] += ", small"
    run["arch"]["nf"] = 4
    if run.get("arch_proxy"):
        run["arch_proxy"].update(d=32, nf=8)
    run["hyper"].update(stop_epoch=1, lr_scheduler="fixed", plot_freq=1)
    name = rel.replace("/", "_")
    run.update(checkpoint=os.path.join(root, name, "sm"), fast_ckpt=os.path.join(root, name, "ck"),
               result_dir=os.path.join(root, name, "img"), num_workers=0)
    path = os.path.join(root, name + ".yml")
    with open(path, "w") as f:
        yaml.safe_dump(run, f)
    return path, run


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    root = tmp_path_factory.mktemp("families")
    make_lrid_fixture(root / "lrid", H=32, W=48)
    make_sid_fixture(root / "sid", n_scenes=3, H=64, W=96, bias_isos=(1600,))
    return root


@pytest.mark.parametrize("rel,mode", RUNFILES)
def test_runfile_end_to_end(fixtures, monkeypatch, rel, mode):
    monkeypatch.chdir(fixtures)
    path, run = tiny_runfile(rel, str(fixtures))
    losses, call = [], TrainStep.__call__

    def counted(self, *a):
        m = call(self, *a)
        losses.append(float(m["loss"]))
        return m
    monkeypatch.setattr(TrainStep, "__call__", counted)
    t = T.main(["-f", path, "--mode", mode, "--nofig"], device="cpu")
    assert len(losses) == len(t.dataset_train) and all(math.isfinite(x) for x in losses)
    assert load_any(t.ckpt.last_path())["meta"]["epoch"] == 1
    log = open(os.path.join("logs", f"log_{run['model_name']}.log")).read()
    assert "aborted" not in log
    if mode == "train":  # the IMX686 eval legs: fast-eval scenes, then the dgain ladder
        assert len(re.findall(r"Epoch -1: PSNR=", log)) == 10


# -- IMX686 evaltest against the JAX Trainer ----------------------------------------

def test_imx686_evaltest_chain_matches_jax(tmp_path, monkeypatch):
    """tests/test_evaltest_harness.py::test_evaltest_lrid_chain's sweep (the
    indoor_x5 eval scenes x the dgain ladder, no illuminance correction) in
    both Trainers on one f32 checkpoint."""
    monkeypatch.setattr(jax_trainer, "create_train_state", _shape_only_state)
    make_lrid_fixture(tmp_path, H=64, W=96, n_frames=3)
    model = "LRID_E2E_Unet"
    dst = {"dstname": "indoor_x5", "command": "", "camera_type": "IMX686",
           "GT_type": "GT_align_ours", "noise_code": "p", "patch_size": 16,
           "H": 64, "W": 96, "crop_per_image": 1, "croptype": "random_crop",
           "wp": 1023, "bl": 64, "ori": False, "clip": False,
           "infos_dir": str(tmp_path / "infos")}
    run = {"mode": "evaltest", "checkpoint": str(tmp_path / "sm"),
           "fast_ckpt": str(tmp_path / "ck"), "model_name": model, "num_workers": 0,
           "brightness_correct": True, "disable_fast_path": True, "dst": dst,
           "dst_eval": dict(dst, mode="eval", dataset="IMX686_Dataset",
                            ratio_list=[1, 2, 4, 8, 16]),
           "arch": {"name": "UNetSeeInDark", "in_nc": 4, "out_nc": 4, "nf": 4,
                    "nframes": 1, "res": False},
           "hyper": {"lr_scheduler": "fixed", "learning_rate": 1e-4, "batch_size": 1,
                     "last_epoch": 0, "stop_epoch": 1, "save_freq": 1, "plot_freq": 1,
                     "best_psnr": 0}}
    path = str(tmp_path / "run.yml")
    with open(path, "w") as f:
        yaml.safe_dump(run, f)
    save_checkpoint(str(tmp_path / "ck" / f"{model}_best_model.ckpt"),
                    jax_unet_params(4, seed=13, head_bias=0.3), meta={"epoch": 2})
    ratios = [1, 2, 4, 8, 16]
    for side in ("jax", "torch"):
        os.makedirs(tmp_path / side)
        monkeypatch.chdir(tmp_path / side)
        if side == "jax":
            t = jax_trainer.Trainer(path, mode="evaltest", nofig=True, debug=True)
            t.mesh_spatial = None  # single device (the conftest exposes 8)
            assert t._fused_eval is None
            jax_trainer.eval_sweep(t, t.dataset_eval, ratios)
        else:
            monkeypatch.setattr(tsteps, "illuminance_correct", None)  # never called
            t = T.Trainer(path, mode="evaltest", nofig=True, debug=True, device="cpu")
            T.eval_sweep(t, t.dataset_eval, ratios)
    metrics = []
    for side in ("jax", "torch"):
        with open(tmp_path / side / "metrics" / f"{model}_metrics.pkl", "rb") as f:
            metrics.append(pickle.load(f))
    ref, got = metrics
    assert got.keys() == ref.keys() and len(got) == 9 * 5
    for name in ref:
        assert abs(got[name][0] - ref[name][0]) < 5e-3, (name, got[name], ref[name])
        assert abs(got[name][1] - ref[name][1]) < 1e-4, (name, got[name], ref[name])
    log = open(tmp_path / "torch" / "logs" / f"log_{model}.log").read()
    assert len(re.findall(r"Epoch -1: PSNR=", log)) == 5
