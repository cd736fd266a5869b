"""The packed forms and the W8A8 path on the card against the CPU.

These tests need an NVIDIA GPU (``cuda`` marker) and skip on a host without
one. This file imports no JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda_int8.py -m cuda --noconftest -q

* The int8 convolutions (im2col + ``torch._int_mm``, cuBLASLt on the card):
  int32 accumulators bit-equal to the CPU's at every quantized layer's
  channel counts of UNetSeeInDark nf=32 (conv9_1's up half: K = 585, padded
  to 592), the optional transposed convs, a row count under 17 and a
  row-chunked im2col.
* The hybrid packed forward in f32 (TF32 off) on the card against the CPU,
  and against the NCHW UNet on the card: within 1e-5 of the output's
  largest magnitude (f32 convolutions summed in another order).
* The int8 forward on the card against the CPU with the same qparams, in
  f32: a code flips only where the convolutions ahead of a quantization
  round an activation across a rounding boundary; the flipped share is held
  to 1e-3 and the output to 1e-3 of its norm.
"""

import numpy as np
import pytest
import torch

import pnnp_tpu_torch.ops.int8conv as IC
from pnnp_tpu_torch.models import UNetSeeInDark
from pnnp_tpu_torch.models import unet_s2d_int8 as PI
from pnnp_tpu_torch.models.unet_s2d import d2s, s2d, transform_params_hybrid, unet_hybrid_forward_packed

NF = 32
# (name, input channels, output channels) of every quantizable conv at nf=32
LAYERS = [
    ("conv1_1", 16, 4 * NF), ("conv1_2", 4 * NF, 4 * NF),
    ("conv2_1", NF, 2 * NF), ("conv2_2", 2 * NF, 2 * NF),
    ("conv3_1", 2 * NF, 4 * NF), ("conv3_2", 4 * NF, 4 * NF),
    ("conv4_1", 4 * NF, 8 * NF), ("conv4_2", 8 * NF, 8 * NF),
    ("conv5_1", 8 * NF, 16 * NF), ("conv5_2", 16 * NF, 16 * NF),
    ("conv6_1u", 8 * NF, 8 * NF), ("conv6_1s", 8 * NF, 8 * NF), ("conv6_2", 8 * NF, 8 * NF),
    ("conv7_1u", 4 * NF, 4 * NF), ("conv7_1s", 4 * NF, 4 * NF), ("conv7_2", 4 * NF, 4 * NF),
    ("conv8_1u", 2 * NF, 2 * NF), ("conv8_1s", 2 * NF, 2 * NF), ("conv8_2", 2 * NF, 2 * NF),
    ("conv9_1u", 2 * NF + 1, 4 * NF), ("conv9_1s", 4 * NF, 4 * NF), ("conv9_2", 4 * NF, 4 * NF),
]
TRANSPOSES = [("upv6", 16 * NF, 8 * NF), ("upv7", 8 * NF, 4 * NF), ("upv8", 4 * NF, 2 * NF)]


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the int8 path's card check")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _codes(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)


@pytest.mark.cuda
@pytest.mark.parametrize("name,c,d", LAYERS, ids=[n for n, _, _ in LAYERS])
def test_int8_conv_card_equals_cpu(card, name, c, d):
    x = _codes((1, c, 24, 40), c).contiguous(memory_format=torch.channels_last)
    k = _codes((d, c, 3, 3), d)
    want = IC.conv3x3_int8(x, k)
    got = IC.conv3x3_int8(x.to(card), k.to(card))
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("name,c,d", TRANSPOSES, ids=[n for n, _, _ in TRANSPOSES])
def test_int8_transpose_card_equals_cpu(card, name, c, d):
    x = _codes((1, c, 6, 10), c)
    k = _codes((c, d, 2, 2), d)
    assert torch.equal(IC.conv_transpose2x2_int8(x.to(card), k.to(card)).cpu(),
                       IC.conv_transpose2x2_int8(x, k))


@pytest.mark.cuda
def test_int8_conv_padded_rows_and_chunks(card, monkeypatch):
    x = _codes((2, 17, 3, 2), 1)  # M = 12 rows, K = 153
    k = _codes((24, 17, 3, 3), 2)
    want = IC.conv3x3_int8(x, k)
    assert torch.equal(IC.conv3x3_int8(x.to(card), k.to(card)).cpu(), want)
    x = _codes((1, 2 * NF + 1, 40, 24), 3)
    k = _codes((4 * NF, 2 * NF + 1, 3, 3), 4)
    want = IC.conv3x3_int8(x, k)
    monkeypatch.setattr(IC, "CHUNK_BYTES", 24 * 592 * 7)  # 7 rows per GEMM
    assert torch.equal(IC.conv3x3_int8(x.to(card), k.to(card)).cpu(), want)


def _net(seed=0):
    net = UNetSeeInDark(nf=NF, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for p in net.parameters():
            p.mul_(5.0)  # off the tiny init, as the JAX tests
    return net


def _frame(seed=1, h=64, w=96):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((1, 4, h, w), generator=g) * 0.5


@pytest.mark.cuda
def test_hybrid_forward_card_equals_cpu(card):
    net = _net()
    g1 = s2d(_frame())
    with torch.no_grad():
        want = unet_hybrid_forward_packed(transform_params_hybrid(net, torch.float32), g1,
                                          dtype=torch.float32)
        net_c = net.to(card)
        got = unet_hybrid_forward_packed(transform_params_hybrid(net_c, torch.float32),
                                         g1.to(card), dtype=torch.float32)
        nchw = net_c(d2s(g1).to(card))
    scale = float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) <= 1e-5 * scale
    assert float((d2s(got) - nchw).abs().max()) <= 1e-5 * scale


@pytest.mark.cuda
def test_int8_forward_card_matches_cpu(card):
    net = _net()
    g1 = s2d(_frame())
    tp = transform_params_hybrid(net, torch.float32)
    qp = PI.quantize_params_int8(tp, PI.calibrate_act_scales(tp, [g1], torch.float32, pct=99.95))
    trace_c, trace_g = [], []
    with torch.no_grad():
        want = PI._walk(tp, g1, torch.float32, qparams=qp, trace=trace_c)
        tp_g = {n: {k: v.to(card) for k, v in leaf.items()} for n, leaf in tp.items()}
        qp_g = {"act_scale": qp["act_scale"],
                "layers": {n: {k: v.to(card) for k, v in leaf.items()}
                           for n, leaf in qp["layers"].items()}}
        got = PI._walk(tp_g, g1.to(card), torch.float32, qparams=qp_g, trace=trace_g)
    flipped = sum(int((a.cpu() != b).sum()) for (_, a), (_, b) in zip(trace_g, trace_c))
    total = sum(b.numel() for _, b in trace_c)
    err = float((got.cpu() - want).norm() / want.norm())
    assert flipped <= 1e-3 * total, f"{flipped} of {total} codes flipped"
    assert err <= 1e-3, f"int8 forward card vs cpu {err:.3e} ({flipped}/{total} flipped)"
