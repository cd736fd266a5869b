"""The plain reference against hand-worked cases and, at small sizes on the
CPU, against the port it judges."""

import math

import numpy as np
import pytest
import torch

from portbench import data
from portbench.reference import eld, metrics, proxy, train, unet


def test_pad16_splits_evenly():
    assert unet.pad16(1424) == (0, 0)
    assert unet.pad16(1736) == (4, 4)
    assert unet.pad16(7) == (4, 5)


def test_layer_shapes_are_the_sid_unet():
    shapes = unet.layer_shapes(32)
    assert len(shapes) == 23
    assert shapes["conv5_2"] == ("conv", 512, 512, 3)
    assert shapes["upv6"] == ("up", 512, 256, 2)
    assert shapes["conv9_1"] == ("conv", 64, 32, 3)
    assert shapes["conv10_1"] == ("conv", 32, 4, 1)
    n = sum(math.prod(s) for s in unet.param_shapes(32).values())
    assert n == 7_760_484  # the 7.8 M parameters of SID's network at nf = 32


def test_unet_with_zero_kernels_gives_the_head_bias():
    params = {k: torch.zeros(s) for k, s in unet.param_shapes(2).items()}
    params["conv10_1.bias"] = torch.tensor([0.1, -0.2, 0.3, 0.4])
    y = unet.forward_frame(params, torch.rand(1, 4, 20, 36))
    assert y.shape == (1, 4, 20, 36)
    assert torch.equal(y[0, :, 5, 7], params["conv10_1.bias"])


def test_unet_matches_the_port():
    from pnnp_tpu_torch.models import build_model

    params = data.unet_weights(unet.param_shapes(4), data.generator(3, "cpu"), "cpu")
    model = build_model({"name": "UNetSeeInDark", "nf": 4})
    model.load_state_dict(params)
    x = torch.rand(2, 4, 32, 48)
    with torch.no_grad():
        assert torch.allclose(unet.forward(params, x), model(x), rtol=1e-5, atol=1e-6)


def test_psnr_and_ssim_by_hand():
    x = torch.zeros(8, 8, 1)
    assert metrics.psnr(x, x + 1.0) == pytest.approx(10 * math.log10(255.0**2))
    y = torch.rand(9, 9, 2) * 255
    assert metrics.ssim(y, y) == pytest.approx(1.0)
    # one 7x7 window: the SSIM formula on its means and sample moments
    a = torch.arange(49.0, dtype=torch.float64).reshape(7, 7, 1)
    b = 2.0 * a + 3.0
    ma, mb = a.mean().item(), b.mean().item()
    va, vb = a.var().item(), b.var().item()
    cov = (((a - ma) * (b - mb)).sum() / 48.0).item()
    c1, c2 = (0.01 * 255) ** 2, (0.03 * 255) ** 2
    want = (2 * ma * mb + c1) * (2 * cov + c2) / ((ma**2 + mb**2 + c1) * (va + vb + c2))
    assert metrics.ssim(a, b) == pytest.approx(want, rel=1e-9)


def test_ssim_matches_the_port():
    from pnnp_tpu_torch.ops.metrics import ssim

    x, y = torch.rand(40, 30, 4) * 255, torch.rand(40, 30, 4) * 255
    assert metrics.ssim(x, y) == pytest.approx(float(ssim(x, y)), abs=1e-6)


def test_illuminance_correction_by_hand():
    src = torch.tensor([[[0.2, 0.4], [1.0, 0.6]]])
    pred = 0.5 * src
    pred[0, 1, 0] = 0.9  # a saturated source pixel: left out of the fit
    out = metrics.illuminance_correct(pred, src)
    assert torch.allclose(out, 2.0 * pred)
    assert torch.equal(metrics.illuminance_correct(torch.zeros(1, 2, 2), src), torch.zeros(1, 2, 2))


def test_pack_and_eld_preparation_by_hand(tmp_path):
    raw = np.array([[10, 20, 30, 40], [50, 60, 70, 80]], np.uint16)
    p = eld.pack(raw, wp=110.0, bl=10.0)
    assert p.shape == (1, 2, 4)
    # (R, G1, B, G2) of the 2x2 cell at the left: raw (0,0), (0,1), (1,1), (1,0)
    assert np.allclose(p[0, 0], (np.array([10, 20, 60, 50]) - 10) / 100.0)
    lr = np.full((2, 4), 60, np.uint16)
    hr = np.full((2, 4), 200, np.uint16)
    np.save(tmp_path / "lr.npy", lr)
    np.save(tmp_path / "hr.npy", hr)
    a, b = eld.prepare(str(tmp_path / "lr.npy"), str(tmp_path / "hr.npy"), 800, 100, None,
                       110.0, 10.0, clip=2)
    assert np.allclose(a, 1.0) and np.allclose(b, 1.0)  # 0.5 x 100 clipped at 1; hr clipped
    a, _ = eld.prepare(str(tmp_path / "lr.npy"), str(tmp_path / "hr.npy"), 800, 1, None,
                       110.0, 10.0, clip=0)
    assert np.allclose(a, 0.5)


def test_uniform_bin_law_by_hand():
    """One bin on [-1, 1] (d = 1), the tail at its floor: the N(0, s^2)
    convolution of U(-1, 1) at x is (Phi((1-x)/s) - Phi((-1-x)/s)) / 2."""
    law = {"knots": torch.tensor([[-1.0, 1.0]], dtype=torch.float64),
           "pi": torch.tensor([[0.0]], dtype=torch.float64),
           "b": torch.tensor([[1.0]], dtype=torch.float64),
           "mu": torch.tensor([[0.0]], dtype=torch.float64)}
    x = torch.tensor([0.0, 0.5, 0.9], dtype=torch.float64)
    s = torch.tensor(0.3, dtype=torch.float64)
    Phi = lambda z: 0.5 * math.erfc(-z / math.sqrt(2))
    want = [math.log((1 - 1e-5) * (Phi((1 - v) / 0.3) - Phi((-1 - v) / 0.3)) / 2)
            for v in x.tolist()]
    got = proxy.log_prob_conv(law, 0, x, s)
    # the tail's share (pi at its 1e-5 floor) moves each log by under 1e-4
    assert torch.allclose(got, torch.tensor(want, dtype=torch.float64), atol=1e-4)
    assert float(got[0]) == pytest.approx(math.log(0.5), abs=1e-3)


def test_mixture_variance_by_hand():
    """U(-1, 1) has variance 1/3; a Laplace(0, b) tail of weight pi adds
    pi (2 b^2 - 1/3)."""
    law = {"knots": torch.tensor([[-1.0, 0.0, 1.0]], dtype=torch.float64),
           "pi": torch.tensor([[0.25]], dtype=torch.float64),
           "b": torch.tensor([[2.0]], dtype=torch.float64),
           "mu": torch.tensor([[0.0]], dtype=torch.float64)}
    assert float(proxy.variance(law)) == pytest.approx(0.75 / 3 + 0.25 * 8.0)


@pytest.mark.parametrize("d", [16, 64])
def test_proxy_nll_matches_the_port(d):
    from pnnp_tpu_torch.models import build_proxy

    params = data.proxy_weights(proxy.param_shapes(d), data.generator(5, "cpu"), "cpu")
    module = build_proxy({"name": "pw_iso_2stage", "d": d}, wp=16383, bl=512)
    module.load_state_dict(params)
    noise = data.dark_noise(2, 4, 16, 24, 3.5, 0.6, 15871.0, data.generator(6, "cpu"), "cpu")
    hr, ratio, iso = torch.zeros_like(noise), torch.ones(2), torch.tensor([800.0, 800.0])
    want, _ = module.loss(noise, iso, weight=torch.ones_like(noise))
    p64 = {k: v.double() for k, v in params.items()}
    got = proxy.nll(p64, noise, hr, ratio, iso, (0.0009546, -0.00193), 16383.0, 512.0)
    assert float(got) == pytest.approx(float(want), rel=1e-6)


def test_adam_one_step_by_hand():
    p = {"w": torch.tensor([1.0])}
    opt = train.Adam(p)
    opt.step(p, {"w": torch.tensor([2.0])}, 0.1)
    # m = 0.2, v = 0.004; bias-corrected 2 and 4; 1 - 0.1 * 2 / (2 + 1e-8)
    assert float(p["w"]) == pytest.approx(0.9, abs=1e-7)


def test_adam_matches_torch():
    w = torch.randn(5)
    p, q = {"w": w.clone()}, w.clone().requires_grad_(True)
    ref, opt = train.Adam(p), torch.optim.Adam([q], lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    for _ in range(3):
        g = torch.randn(5)
        ref.step(p, {"w": g}, 1e-3)
        q.grad = g.clone()
        opt.step()
    assert torch.allclose(p["w"], q.detach(), atol=1e-7)


@pytest.mark.parametrize("epoch", [0, 1, 9, 10, 11, 599, 600, 601, 700, 1199])
def test_warmup_cosine_matches_the_port(epoch):
    from pnnp_tpu_torch.train import build_lr_schedule

    hyper = {"lr_scheduler": "WarmupCosine", "learning_rate": 1e-4, "last_epoch": 0,
             "step_size": 10, "stop_epoch": 1200, "T": 2}
    assert train.warmup_cosine(epoch, hyper) == pytest.approx(build_lr_schedule(hyper)(epoch))
