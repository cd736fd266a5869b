"""NoiseFlow on the card against the same flow on the CPU.

These tests need an NVIDIA GPU (``cuda`` marker) and skip on a host without
one. This file imports no JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda_flow.py -m cuda --noconftest -q

They run the flow check of ``chip_smoke.py`` (one implementation, there):
the production arch string on 8 x 4 x 64 x 64 with off-init weights shared
by both devices. Forward z within 1e-5 of its largest magnitude, the
log-det 1e-5 relative, the inverse within 1e-4 of its largest, the
train-mode NLL 1e-5 relative and its gradients within 1e-4 of the largest
gradient. The flow library (``chip_smoke.py::bijector_card_check``): every
bijector no runfile reaches, and ``SdnModelScale``, on one seeded 4 x 4 x
64 x 64 batch with off-init weights, its forward output, log-det and
inverse within 1e-5 of the largest magnitude of the CPU's.
"""

import pytest
import torch


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flow's card check")
    return torch.device("cuda")


@pytest.mark.cuda
def test_flow_on_the_card_matches_the_cpu(card):
    from chip_smoke import flow_card_check

    errs = flow_card_check(card)
    assert set(errs) == {"z", "logdet", "inverse", "nll", "grad_of_max"}


@pytest.mark.cuda
def test_flow_samples_on_the_card(card):
    """A draw at the NF_Syn synth's shape is finite, and its latent under
    the same flow is N(0, 1) by moments (2%)."""
    from chip_smoke import _flow_off_init

    nf = _flow_off_init().to(card)
    gen = torch.Generator(device=card).manual_seed(0)
    clean = torch.rand((8, 4, 512, 512), generator=gen, device=card) * 0.02
    iso = torch.full((1,), 3200.0, device=card)
    with torch.no_grad():
        noise = nf.sample(clean, iso, gen)
        z, _ = nf.forward(noise, clean, iso)
    assert torch.isfinite(noise).all() and noise.shape == clean.shape
    assert abs(float(z.mean())) < 0.02 and abs(float(z.std()) - 1.0) < 0.02


@pytest.mark.cuda
def test_flow_library_on_the_card_matches_the_cpu(card):
    from chip_smoke import BIJECTOR_TOL, bijector_card_check

    errs = bijector_card_check(card)
    assert len(errs) == 13 and max(max(e.values()) for e in errs.values()) <= BIJECTOR_TOL
