"""The port's ISP, RGB metrics and tiled predict on the card against the
same functions on the CPU.

These tests need an NVIDIA GPU (``cuda`` marker) and skip on a host without
one. This file imports no JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda_isp.py -m cuda --noconftest -q

* ``fast_isp`` at an sRGB frame of 256x384: within 1e-6 of the CPU's (both
  float32 elementwise, no TF32 path) under the card's default TF32 flags
  and a bf16 autocast.
* ``rgb_quality``: the SSIM of the ``[2h, 2w, 3]`` pair launches the
  kernel's ``generic`` route once; PSNR within 1e-3 dB and SSIM within 1e-4
  of the CPU's (a uint8 floor bin may flip).
* ``Trainer.predict`` in f32 (``disable_fast_path``) on a 1024x1536 mosaic
  (6 tiles of 512^2 at the default patch and halo): within 1e-4 of the
  output's largest magnitude of the CPU's.
"""

import numpy as np
import pytest
import torch
import yaml

import pnnp_tpu_torch.kernels.ssim as K
from pnnp_tpu_torch.ops import fast_isp
from pnnp_tpu_torch.ops.metrics import rgb_quality


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ISP's card check")
    return torch.device("cuda")


def _frames(seed=0, h=128, w=192):
    rng = np.random.default_rng(seed)
    tgt = rng.uniform(0, 0.4, (h, w, 4)).astype(np.float32)
    out = np.clip(tgt + rng.normal(0, 0.02, tgt.shape), 0, 1).astype(np.float32)
    return torch.from_numpy(out), torch.from_numpy(tgt)


@pytest.mark.cuda
def test_fast_isp_card_matches_cpu(card, monkeypatch):
    x, _ = _frames()
    wb, ccm = np.array([2.1, 1.0, 1.7, 1.0], np.float32), None
    ref = fast_isp(x, wb=wb, ccm=ccm)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with torch.autocast("cuda", dtype=torch.bfloat16):
        got = fast_isp(x.to(card), wb=wb, ccm=ccm)
    assert got.dtype == torch.float32 and got.shape == (256, 384, 3)
    assert float((got.cpu() - ref).abs().max()) < 1e-6


@pytest.mark.cuda
def test_rgb_quality_card_matches_cpu(card):
    out, tgt = _frames(1)
    wb, ccm = np.array([2.0, 1.0, 1.5, 1.0], np.float32), np.eye(3, dtype=np.float32)
    p_ref, s_ref = rgb_quality(out, tgt, wb, ccm)
    before = dict(K.launches_by_route)
    p, s = rgb_quality(out.to(card), tgt.to(card), wb, ccm)
    torch.cuda.synchronize()
    assert K.launches_by_route["generic"] == before["generic"] + 1
    assert K.launches_by_route["hopper"] == before["hopper"]
    assert abs(float(p) - float(p_ref)) < 1e-3
    assert abs(float(s) - float(s_ref)) < 1e-4


@pytest.mark.cuda
def test_predict_card_matches_cpu(card, tmp_path, monkeypatch):
    from pnnp_tpu_torch.data.fixtures import make_sid_fixture, make_sid_runfile
    from pnnp_tpu_torch.trainer import Trainer

    monkeypatch.chdir(tmp_path)
    make_sid_fixture(tmp_path, n_scenes=2, H=32, W=48)
    path = str(tmp_path / "run.yml")
    with open(path, "w") as f:
        yaml.safe_dump(dict(make_sid_runfile(tmp_path, nf=8), mode="eval",
                            disable_fast_path=True), f)
    raw = np.random.default_rng(2).uniform(0, 3000, (1024, 1536)).astype(np.float32)
    outs = {}
    for dev in ("cpu", "cuda"):
        t = Trainer(path, mode="eval", nofig=True, debug=True, device=dev)
        outs[dev] = t.predict(raw, name=None)
    assert outs["cuda"].shape == (512, 768, 4)
    scale = float(np.abs(outs["cpu"]).max())
    assert float(np.abs(outs["cuda"] - outs["cpu"]).max()) <= 1e-4 * scale
