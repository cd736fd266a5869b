"""The SSIM kernel on the width-sharded eval's slabs, on the card.

These tests need an NVIDIA GPU (``cuda`` marker) and skip on a host without
one: a CUDA kernel has no CPU mode. This file imports no JAX, so it also
runs on a machine without it:

    python -m pytest tests/test_torch_cuda_parallel.py -m cuda --noconftest -q

At nsp = 2 each rank of ``make_eval_metrics_step_sharded`` scores a slab of
its own ``Wp / 2`` columns plus 6 of its right neighbour's: ``[1424, 4312]``
at the Sony frame, ``[1736, 4696]`` at the IMX686 frame, C = 4. There the
kernel takes the ``hopper`` route, and its sum is held to the plain version
(1e-4 of the mean, as tests/test_torch_cuda_kernels.py); and the two
ranks' sums, less the border corrections of the pad and ring-wrapped
windows, give the whole padded frame's valid windows over the original
columns (1e-5 of the mean).
"""

import numpy as np
import pytest
import torch

import pnnp_tpu_torch.kernels.ssim as K
from pnnp_tpu_torch.train.steps import pad_split

TOL = 1e-4
NSP = 2
FRAMES = {"sony": (1424, 2128), "imx686": (1736, 2312)}


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the SSIM kernel has no CPU mode")
    return torch.device("cuda")


def _frame_pair(H, W, seed):
    """A padded-frame pair [H, Wp, 4] on [0, 255], reflect-padded in W as
    the sharded step pads it, with the geometry ``(pl, pr, wloc)``."""
    rng = np.random.default_rng(seed)
    pl, pr = pad_split(W, 16 * NSP)
    x = rng.uniform(0, 255, (H, W, 4)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 12, x.shape), 0, 255).astype(np.float32)
    pad = lambda a: np.pad(a, ((0, 0), (pl, pr), (0, 0)), mode="reflect")
    return pad(x), pad(y), (pl, pr, (W + pl + pr) // NSP)


def _slabs(t, wloc):
    """Each rank's slab: its columns plus 6 of the right neighbour's (the
    last rank's ring-wrapped from the first)."""
    out = []
    for i in range(NSP):
        own = t[:, i * wloc:(i + 1) * wloc]
        right = t[:, ((i + 1) % NSP) * wloc:((i + 1) % NSP) * wloc + 6]
        out.append(torch.cat([own, right], dim=1).contiguous())
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_slab_sum_matches_plain(card, frame):
    H, W = FRAMES[frame]
    x, y, (pl, pr, wloc) = _frame_pair(H, W, 0)
    xs, ys = (_slabs(torch.from_numpy(a).to(card), wloc) for a in (x, y))
    for a, b in zip(xs, ys):
        L = a.shape[1] * 4
        assert K._route(H, L, 4, a.data_ptr(), b.data_ptr()) == "hopper"
        before = K.launches_by_route["hopper"]
        got = float(K.ssim_flat_sum(a.reshape(H, L), b.reshape(H, L)))
        torch.cuda.synchronize()
        assert K.launches_by_route["hopper"] == before + 1
        ref = float(K.ssim_sum_plain(a, b))
        n = 4 * (H - 6) * (a.shape[1] - 6)
        assert abs(got - ref) / n < TOL, (frame, got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_shard_sums_give_the_frame(card, frame):
    H, W = FRAMES[frame]
    x, y, (pl, pr, wloc) = _frame_pair(H, W, 1)
    tx, ty = torch.from_numpy(x).to(card), torch.from_numpy(y).to(card)
    total = 0.0
    for i, (a, b) in enumerate(zip(_slabs(tx, wloc), _slabs(ty, wloc))):
        s = float(K.ssim_flat_sum(a.reshape(H, -1), b.reshape(H, -1)))
        if i == 0 and pl > 0:
            s -= float(K.ssim_sum_plain(a[:, :pl + 6], b[:, :pl + 6]))
        if i == NSP - 1:
            s -= float(K.ssim_sum_plain(a[:, wloc - pr - 6:], b[:, wloc - pr - 6:]))
        total += s
    whole = tx[:, pl:pl + W].contiguous(), ty[:, pl:pl + W].contiguous()
    ref = float(K.ssim_flat_sum(whole[0].reshape(H, -1), whole[1].reshape(H, -1)))
    n = 4 * (H - 6) * (W - 6)
    assert abs(total - ref) / n < 1e-5, (frame, total, ref)
