"""The port's real-data CLIs (``pnnp_tpu_torch/tools/get_dataset_infos.py``,
``golden_parity.py``) on the synthetic trees of
tests/test_evaltest_harness.py.

* ``get_dataset_infos``: the port's ``.info`` pickles equal the JAX CLI's
  (loaded objects, exactly) on the SID evaltest, ELD and LRID trees, and
  LRID with no ``--subset`` indexes every subset directory it finds.
* ``golden_parity``, modelled on tests/test_golden_parity_tool.py, with
  random weights in the reference's ``.pth`` layout on the CPU: exit 2 and
  ``prereq_missing`` for a missing index and for a missing checkpoint;
  exit 1, ``status: fail`` and 5 sweeps against ``CONFIGS`` (the diff is
  live); exit 0 and ``status: pass`` with ``CONFIGS`` replaced by that
  run's own parsed numbers. The per-sweep numbers of the parsed log agree
  with the JAX tool's parsing of the same log, and with the JAX
  ``golden_parity`` run on the same trees and ``.pth`` (both in f32) to
  the summary's printed quantum: 0.01 dB PSNR and 1e-4 SSIM (two f32
  sweeps that agree to far less can round to neighbouring quanta).
"""

import json
import os
import pickle
import re

import numpy as np
import pytest
import yaml

from test_evaltest_harness import (H, NF, W, make_eld_tree, make_lrid_tree, make_sid_tree,
                                   make_torch_state)


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _assert_same(got, ref, where):
    """Equal structure, types and values; arrays equal in dtype and content."""
    assert type(got) is type(ref), (where, type(got), type(ref))
    if isinstance(ref, dict):
        assert list(got) == list(ref), where
        for k in ref:
            _assert_same(got[k], ref[k], f"{where}[{k!r}]")
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), where
        for i, (g, r) in enumerate(zip(got, ref)):
            _assert_same(g, r, f"{where}[{i}]")
    elif isinstance(ref, np.ndarray):
        assert got.dtype == ref.dtype and np.array_equal(got, ref), where
    else:
        assert got == ref, where


@pytest.mark.parametrize("dst", ["SID", "ELD", "LRID"])
def test_infos_equal_jax_cli(tmp_path, dst):
    from tools.get_dataset_infos import main as jax_cli

    from pnnp_tpu_torch.tools.get_dataset_infos import main as port_cli

    rng = np.random.default_rng(5)
    root = str(tmp_path / dst)
    if dst == "SID":
        make_sid_tree(root, rng)
        extra, names = ["--mode", "evaltest"], ["SID_evaltest.info"]
    elif dst == "ELD":
        make_eld_tree(root, rng)
        extra, names = [], ["ELD_SonyA7S2.info"]
    else:
        make_lrid_tree(root, rng, n_scenes=6)
        os.makedirs(os.path.join(root, "outdoor_x3"))  # an empty subset: no scenes
        extra = []
        names = [f"{s}_{k}.info" for s in ("indoor_x5", "outdoor_x3")
                 for k in ("GT_align_ours", "short")]
    for cli, out in ((jax_cli, "jax"), (port_cli, "port")):
        cli(["--dstname", dst, "--root_dir", root, "--out_dir", str(tmp_path / out), *extra])
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    for name in names:
        got, ref = _load(tmp_path / "port" / name), _load(tmp_path / "jax" / name)
        _assert_same(got, ref, name)
    if dst == "SID":
        assert len(got) == 86
    if dst == "LRID":
        assert len(_load(tmp_path / "port" / "indoor_x5_GT_align_ours.info")) == 6


def _harness_runfile(path):
    """tests/test_golden_parity_tool.py's stand-in for
    runfiles/SonyA7S2/PNNP.yml."""
    dst = {
        "dstname": "SID", "command": "", "camera_type": "SonyA7S2",
        "noise_code": "p", "patch_size": 8, "H": H, "W": W,
        "crop_per_image": 1, "croptype": "random_crop", "wp": 16383,
        "bl": 512, "ori": False, "clip": 2,
    }
    runfile = {
        "mode": "evaltest", "checkpoint": "saved_model/T",
        "fast_ckpt": "checkpoints/T", "model_name": "GPTOOL_Unet",
        "num_workers": 0, "brightness_correct": True,
        "dst": dst,
        "dst_eval": dict(dst, mode="eval", dataset="ELD_Dataset",
                         iso_list=[800, 1600, 3200], ratio_list=[100, 200]),
        "arch": {"name": "UNetSeeInDark", "in_nc": 4, "out_nc": 4, "nf": NF,
                 "nframes": 1, "res": False},
        "hyper": {"lr_scheduler": "fixed", "learning_rate": 1e-4,
                  "batch_size": 1, "last_epoch": 0, "stop_epoch": 1,
                  "save_freq": 1, "plot_freq": 1, "best_psnr": 0},
    }
    with open(path, "w") as f:
        yaml.safe_dump(runfile, f)


def test_golden_parity_exit_codes(tmp_path, monkeypatch, capsys):
    import torch

    import tools.golden_parity as jgp
    from pnnp_tpu_torch.tools import golden_parity as gp
    from pnnp_tpu_torch.tools.get_dataset_infos import main as build_infos

    assert gp.CONFIGS == jgp.CONFIGS  # the port's own copy of BASELINE.md's numbers
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(5)
    make_sid_tree(str(tmp_path / "SID"), rng)
    make_eld_tree(str(tmp_path / "ELD"), rng)
    infos = str(tmp_path / "infos")
    build_infos(["--dstname", "ELD", "--root_dir", str(tmp_path / "ELD"), "--out_dir", infos])
    ckpt = str(tmp_path / "released.pth")
    torch.save(make_torch_state(np.random.default_rng(9)), ckpt)
    rpath = str(tmp_path / "gp_run.yml")
    _harness_runfile(rpath)
    monkeypatch.setitem(gp.CONFIGS, "TEST_PNNP", dict(gp.CONFIGS["SonyA7S2_PNNP"], runfile=rpath))
    base = ["--config", "TEST_PNNP", "--infos_dir", infos, "--cpu"]

    # a missing index, then a missing checkpoint: exit 2 with what to do
    rc = gp.main(base + ["--ckpt", ckpt, "--workdir", str(tmp_path / "wd0")])
    out = capsys.readouterr().out
    assert rc == 2 and "prereq_missing" in out and "SID_evaltest.info" in out
    build_infos(["--dstname", "SID", "--root_dir", str(tmp_path / "SID"),
                 "--mode", "evaltest", "--out_dir", infos])
    rc = gp.main(base + ["--ckpt", str(tmp_path / "no.pth"), "--workdir", str(tmp_path / "wd0")])
    out = capsys.readouterr().out
    assert rc == 2 and "prereq_missing" in out and "--ckpt" in out

    # the whole drive against BASELINE.md's numbers: random weights fail
    rc = gp.main(base + ["--ckpt", ckpt, "--workdir", str(tmp_path / "wd1")])
    out = capsys.readouterr().out
    assert rc == 1
    tail = json.loads(out.strip().splitlines()[-1])
    assert tail == {"config": "TEST_PNNP", "status": "fail", "sweeps": 5, "failed": 5}
    table = re.findall(r"^(.+?)  PSNR +([\d.]+) vs .*SSIM ([-\d.]+) vs", out, re.M)
    assert [t[0].strip() for t in table] == [s[0] for s in gp.CONFIGS["TEST_PNNP"]["sweeps"]]
    with open("logs/log_GPTOOL_Unet.log") as f:
        logtext = f.read()
    jax_pairs = re.findall(r"psnrs_lr=-?[\d.]+, psnrs_dn=(-?[\d.]+)\nssims_lr=-?[\d.]+, "
                           r"ssims_dn=(-?[\d.]+)", logtext)
    assert gp.parse_summaries(logtext) == [(float(p), float(s)) for p, s in jax_pairs]
    assert len(jax_pairs) == 5
    assert os.path.exists(tmp_path / "wd1" / "checkpoints" / "GPTOOL_Unet_best_model.ckpt")

    # the JAX tool on the same trees and checkpoint: the same five sweeps
    monkeypatch.setitem(jgp.CONFIGS, "TEST_PNNP", dict(jgp.CONFIGS["SonyA7S2_PNNP"],
                                                       runfile=rpath))
    rc = jgp.main(["--config", "TEST_PNNP", "--infos_dir", infos, "--ckpt", ckpt,
                   "--workdir", str(tmp_path / "wd_jax")])
    capsys.readouterr()
    assert rc == 1
    with open("logs/log_GPTOOL_Unet.log") as f:
        jax_sweeps = gp.parse_summaries(f.read())
    assert len(jax_sweeps) == 5
    for (p, s), (jp, js) in zip(gp.parse_summaries(logtext), jax_sweeps):
        assert abs(p - jp) <= 0.01 + 1e-9 and abs(s - js) <= 1e-4 + 1e-9, (p, s, jp, js)

    # the pass path: the run's own numbers as the reference
    own = [(label, float(p), float(s)) for label, p, s in
           ((t[0].strip(), t[1], t[2]) for t in table)]
    monkeypatch.setitem(gp.CONFIGS, "TEST_PNNP", dict(gp.CONFIGS["TEST_PNNP"], sweeps=own))
    rc = gp.main(base + ["--ckpt", ckpt, "--workdir", str(tmp_path / "wd2")])
    tail = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and tail == {"config": "TEST_PNNP", "status": "pass", "sweeps": 5,
                                "failed": 0}
