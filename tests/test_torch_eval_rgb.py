"""The eval's unfused branch in the port against the JAX package: the RGB
metrics, ``disable_fused_eval``, ``LEDTrainer`` and the sample figures.

Each case runs the JAX Trainer and the port's on one ``make_sid_fixture``
runfile and one checkpoint pickle, and compares the metrics pickles and the
3-line log summaries (tests/test_torch_trainer.py's harness):
  * ``rgb_metrics`` with figures on (f32, ``disable_fast_path``): the pickle
    holds the sRGB scores of the device ISP, within 0.01 dB / 1e-4 SSIM
    (a uint8 floor bin may flip);
  * ``disable_fused_eval`` (bf16 serving) within the bf16 eval limits,
    1e-2 dB / 1e-3;
  * ``LEDTrainer`` (no denoiser) within 5e-3 dB / 1e-4 (f32 inputs), its
    PSNR the input's;
and the figures: both packages write the same file names, and the denoised
PNGs differ by at most one level.
"""

import os
import types

import matplotlib.image as mpimg
import numpy as np
import pytest

import pnnp_tpu.trainer as jax_trainer
import pnnp_tpu.trainer_led as jax_led
import pnnp_tpu_torch.kernels.ssim as tssim
from pnnp_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from pnnp_tpu_torch.train.checkpoint import save_checkpoint
from pnnp_tpu_torch.trainer import Trainer, eval_sweep
from pnnp_tpu_torch.trainer_led import LEDTrainer
from pnnp_tpu_torch.trainer_led import main as led_main
from tests.test_torch_models import jax_unet_params
from tests.test_torch_trainer import (
    MODEL,
    _compare_outputs,
    _run_jax,
    _run_port,
    _write_runfile,
    slice_setup,  # noqa: F401  (fixture)
)


@pytest.fixture(scope="module")
def rgb_runs(tmp_path_factory):
    """rgb_metrics with figures on, f32, through both packages once."""
    root = tmp_path_factory.mktemp("rgb")
    with pytest.MonkeyPatch.context() as mp:
        from pnnp_tpu_torch.data.fixtures import make_sid_fixture, make_sid_runfile
        from tests.test_torch_trainer import _shape_only_state

        mp.setattr(jax_trainer, "create_train_state", _shape_only_state)
        make_sid_fixture(root, n_scenes=2, H=64, W=96)
        run = make_sid_runfile(root, MODEL, nf=4, H=64, W=96)
        run["mode"] = "eval"
        run["dst_eval"]["ratio_list"] = [100]
        save_checkpoint(os.path.join(run["fast_ckpt"], f"{MODEL}_best_model.ckpt"),
                        jax_unet_params(4, seed=13, head_bias=0.3), meta={"epoch": 2})
        extra = dict(disable_fast_path=True, rgb_metrics=True)
        jt = _run_jax(root, _write_runfile(root, run, result_dir=str(root / "jax" / "images"),
                                           **extra), mp, nofig=False, fused=False)
        pt = _run_port(root, _write_runfile(root, run, result_dir=str(root / "torch" / "images"),
                                            **extra), mp, nofig=False)
    return root, run, jt, pt


def test_eval_rgb_metrics_matches_jax(rgb_runs):
    root, _, jt, pt = rgb_runs
    assert jt._fused_eval is None and jt.rgb_metrics and pt.rgb_metrics
    _compare_outputs(root, 0.01, 1e-4, with_inputs=True)


def test_eval_rgb_metrics_scores_srgb(rgb_runs):
    """The pickle holds the sRGB scores, not the raw ones: recompute one
    frame through the port's ISP and the raw meters."""
    import pickle

    import torch

    from pnnp_tpu_torch.ops import illuminance_correct, psnr
    from pnnp_tpu_torch.ops.metrics import rgb_quality

    root, _, _, pt = rgb_runs
    with open(root / "torch" / "metrics" / f"{MODEL}_metrics.pkl", "rb") as f:
        got = pickle.load(f)
    batch = pt.dataset_eval[0]
    lr, hr = torch.from_numpy(batch["lr"]), torch.from_numpy(batch["hr"])
    dn = illuminance_correct(pt.eval_step(lr).clamp(0, 1), hr)
    wb, ccm = batch["wb"], batch["ccm"]
    p, s = rgb_quality(dn[0], hr[0].clamp(0, 1), wb, ccm)
    assert got[batch["name"]] == pytest.approx([float(p), float(s)], abs=1e-6)
    raw_p = float(psnr(dn[0] * 255, hr[0].clamp(0, 1) * 255))
    assert abs(raw_p - float(p)) > 0.05


def test_figures_match_jax(rgb_runs):
    """Both packages write the same figure files (a 3-panel JPG and the
    denoised PNG per frame), and the PNGs differ by at most one level."""
    root = rgb_runs[0]
    dirs = {side: root / side / "images" / f"samples-{MODEL}" for side in ("jax", "torch")}
    names = sorted(os.listdir(dirs["jax"]))
    assert names == sorted(os.listdir(dirs["torch"]))
    frames = rgb_runs[3].dataset_eval
    assert names == sorted(f"{frames[i]['name']}_{k}" for i in range(2)
                           for k in ("denoised.png", "epoch-1.jpg"))
    for n in names:
        if n.endswith(".png"):
            a, b = (mpimg.imread(dirs[side] / n) for side in ("jax", "torch"))
            assert a.shape == b.shape == (64, 96, 4)  # RGBA, the mosaic's size
            assert np.abs(a.astype(np.float64) - b).max() <= 1.0 / 255 + 1e-6, n


def test_eval_disable_fused_matches_jax(slice_setup, monkeypatch):
    """bf16 serving through the unfused branch (JAX takes it too)."""
    root, run = slice_setup
    jax_save_checkpoint(os.path.join(run["fast_ckpt"], f"{MODEL}_best_model.ckpt"),
                        jax_unet_params(4, seed=15, head_bias=0.3), meta={"epoch": 3})
    path = _write_runfile(root, run, disable_fused_eval=True)
    jt = _run_jax(root, path, monkeypatch, nofig=True, fused=False)
    assert jt._fused_eval is None
    before = tssim.launches
    pt = _run_port(root, path, monkeypatch, nofig=True)
    assert pt._fused_eval is None and str(pt.dtype) == "torch.bfloat16"
    assert tssim.launches == before
    _compare_outputs(root, 1e-2, 1e-3, with_inputs=False)


def test_led_eval_matches_jax(slice_setup, monkeypatch):
    """The identity harness: no checkpoint is read by the metrics, the PSNR
    is the (corrected) input's."""
    root, run = slice_setup
    path = _write_runfile(root, run)
    os.makedirs(root / "jax", exist_ok=True)
    monkeypatch.chdir(root / "jax")
    jt = jax_led.LEDTrainer(path, mode="eval", nofig=True, debug=True)
    jt.mesh_spatial = None
    jax_trainer.eval_sweep(jt, jt.dataset_eval, [100])
    os.makedirs(root / "torch", exist_ok=True)
    monkeypatch.chdir(root / "torch")
    pt = LEDTrainer(path, mode="eval", nofig=True, debug=True, device="cpu")
    assert pt._fused_eval is None and pt._phone_eval_corrects
    eval_sweep(pt, pt.dataset_eval, [100])
    _compare_outputs(root, 5e-3, 1e-4, with_inputs=False)


def test_led_main_runs(slice_setup, monkeypatch):
    """The CLI entry with figures on: each frame's PSNR is the plain PSNR of
    its corrected, clipped input."""
    import pickle

    import torch

    from pnnp_tpu_torch.ops import illuminance_correct, psnr

    root, run = slice_setup
    path = _write_runfile(root, run)
    monkeypatch.chdir(root)
    t = led_main(["-f", path], device="cpu")
    assert t.eval_psnr_lr.count == 2
    with open(root / "metrics" / f"{MODEL}_metrics.pkl", "rb") as f:
        got = pickle.load(f)
    for i in range(2):
        batch = t.dataset_eval[i]
        lr, hr = torch.from_numpy(batch["lr"]), torch.from_numpy(batch["hr"])
        dn = illuminance_correct(lr.clamp(0, 1), hr)
        ref = float(psnr(dn * 255, hr.clamp(0, 1) * 255))
        assert got[batch["name"]][0] == pytest.approx(ref, abs=1e-5)
        assert ref != pytest.approx(float(psnr(lr.clamp(0, 1) * 255, hr.clamp(0, 1) * 255)),
                                    abs=1e-3)  # the correction moved it


@pytest.mark.parametrize("dataset,led,expect", [
    ("SID_Dataset", False, True), ("IMX686_Dataset", False, False),
    ("IMX686_Dataset", True, True), ("SID_Dataset", True, True)])
def test_phone_eval_correction_gate(dataset, led, expect):
    """The LRID trainer never corrects IMX686 evals; trainer_LED does."""
    cls = LEDTrainer if led else Trainer
    stub = types.SimpleNamespace(args={"brightness_correct": True},
                                 _phone_eval_corrects=cls._phone_eval_corrects)
    assert cls._brightness_correct(stub, {"dataset": dataset}) is expect
