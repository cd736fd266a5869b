"""SSIM in the PyTorch port against the JAX package.

The port's plain-torch SSIM (the kernel's plain version and the CPU path of
every ``pnnp_tpu_torch.kernels.ssim`` entry) must agree with
``pnnp_tpu.ops.metrics`` and with the Pallas kernel run in interpret mode,
within 1e-4 of the mean (the JAX kernel tests' tolerance: f32 sums taken in
another order). The CUDA kernel itself is held against the plain version on
the card in tests/test_torch_cuda_kernels.py.
"""

import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pnnp_tpu_torch.kernels.ssim as tssim
from pnnp_tpu.ops.metrics import ssim as jax_ssim
from pnnp_tpu.ops.metrics import ssim_sum as jax_ssim_sum
from pnnp_tpu_torch.ops.metrics import ssim as torch_ssim
from tests.test_torch_cuda_kernels import DRIFT, bright, ssim_f64
from tests.test_torch_cuda_kernels import structured as _structured

SHAPES = [(70, 96, 4), (96, 131, 3), (201, 140, 4), (71, 96, 4)]
TOL = 1e-4


@pytest.fixture()
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def interp(*a, **k):
        k.setdefault("interpret", True)
        return orig(*a, **k)

    import pnnp_tpu.kernels.ssim as mod

    monkeypatch.setattr(mod.pl, "pallas_call", interp)
    return mod


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_ssim_matches_jax_metrics(shape):
    x, y = _structured(shape, 0)
    H, W, C = shape
    ref = float(jax_ssim(jnp.asarray(x), jnp.asarray(y)))
    ref_sum = float(jax_ssim_sum(jnp.asarray(x), jnp.asarray(y)))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    n = (H - 6) * (W - 6) * C
    assert abs(float(torch_ssim(tx, ty)) - ref) < TOL
    flat = lambda t: t.reshape(H, W * C)
    assert abs(float(tssim.ssim_flat(flat(tx), flat(ty), C)) - ref) < TOL
    assert abs(float(tssim.ssim_flat_sum(flat(tx), flat(ty), C)) - ref_sum) < TOL * n
    assert abs(float(tssim.ssim_kernel(tx, ty)) - ref) < TOL
    assert abs(float(tssim.ssim_fast(tx, ty)) - ref) < TOL


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_ssim_matches_pallas_interpret(interpret_pallas, shape):
    """Flat and banded entries against the Pallas kernel itself."""
    mod = interpret_pallas
    x, y = _structured(shape, 3)
    H, W, C = shape
    ref_flat = float(mod._ssim_flat_kernel(jnp.asarray(x.reshape(H, W * C)),
                                           jnp.asarray(y.reshape(H, W * C)), C))
    ref_band = float(mod.ssim_kernel(jnp.asarray(x), jnp.asarray(y)))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    got_flat = float(tssim.ssim_flat(tx.reshape(H, W * C), ty.reshape(H, W * C), C))
    band = lambda t: t.permute(2, 0, 1).reshape(C * H, W)
    got_band = float(tssim.ssim_banded(band(tx), band(ty), C))
    assert abs(got_flat - ref_flat) < TOL, (got_flat, ref_flat)
    assert abs(got_band - ref_band) < TOL, (got_band, ref_band)


def test_cpu_entries_are_the_plain_version_bit_for_bit():
    """On a CPU tensor every entry point IS the plain version."""
    x, y = _structured((40, 52, 4), 1)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    ref = torch_ssim(tx, ty)
    band = lambda t: t.permute(2, 0, 1).reshape(4 * 40, 52)
    before = tssim.launches
    for got in (tssim.ssim_flat(tx.reshape(40, -1), ty.reshape(40, -1)),
                tssim.ssim_kernel(tx, ty), tssim.ssim_fast(tx, ty),
                tssim.ssim_banded(band(tx), band(ty)),
                tssim.ssim_flat_plain(tx.reshape(40, -1), ty.reshape(40, -1))):
        assert torch.equal(got, ref)
    assert tssim.launches == before  # no kernel launch on the CPU


def test_kernel_launch_refuses_cpu_tensors():
    """The launch wrapper takes CUDA tensors only: no silent host path."""
    x = torch.zeros(16, 64)
    with pytest.raises(ValueError, match="CUDA"):
        tssim._ssim_call_sum(x, x, 4)


@pytest.mark.parametrize("case,shape,route", [
    ("sony frame", (1424, 8512, 4), "hopper"),
    ("imx686 frame", (1736, 9248, 4), "hopper"),
    ("narrow C=4", (7, 28, 4), "hopper"),
    ("C=3", (96, 393, 3), "generic"),
    ("C=4, ragged L", (70, 386, 4), "generic"),
    ("C=1", (70, 96, 1), "generic"),
    # the channel-banded layout [C*H, W] as the TPU kernel reads it: one
    # channel per band, a lane stride of 1 (the port permutes it to the flat
    # layout first, which then takes the route of its own shape)
    ("banded [4*201, 140]", (4 * 201, 140, 1), "generic"),
])
def test_route_is_hopper_for_the_main_path_case_only(case, shape, route):
    assert tssim._route(*shape) == route, case
    assert tssim._route(*shape, 256, 4096) == route, case  # aligned data


@pytest.mark.parametrize("offset", [4, 8, 12])
def test_route_needs_16_byte_aligned_data(offset):
    assert tssim._route(1424, 8512, 4, 256, 256 + offset) == "generic"
    assert tssim._route(1424, 8512, 4, 256 + offset) == "generic"


def test_plain_ssim_drift_frame_is_within_tolerance_of_float64():
    """The CUDA tests hold both kernel routes within 1e-4 of a float64
    evaluation on a tall bright low-variance frame. The plain f32 version
    itself lands far inside that (a few 1e-7 here), so the tolerance leaves
    room for the kernels' own f32 rounding but not for drifting sums."""
    x, y = bright(DRIFT, 0)
    H, W, C = DRIFT
    ref = ssim_f64(x, y)
    got = float(tssim.ssim_flat(torch.from_numpy(x.reshape(H, W * C)),
                                torch.from_numpy(y.reshape(H, W * C)), C))
    assert abs(got - ref) < TOL / 10, (got, ref)


def test_packed_to_banded_layout_contract():
    """Same contract as tests/test_eval_metrics_step.py's JAX test, against
    the JAX function on the same input."""
    from pnnp_tpu.kernels.ssim import packed_to_banded as jax_p2b
    from pnnp_tpu.models.unet_s2d import s2d

    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (1, 12, 16, 4)).astype(np.float32)
    g = np.asarray(s2d(jnp.asarray(x))[0])
    got = tssim.packed_to_banded(torch.from_numpy(g.copy())).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_p2b(jnp.asarray(g))))
    np.testing.assert_array_equal(got, x[0].transpose(2, 0, 1).reshape(48, 16))
