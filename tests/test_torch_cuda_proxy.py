"""The proxy on the card against the same proxy on the CPU.

These tests need an NVIDIA GPU (``cuda`` marker) and skip on a host without
one. This file imports no JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda_proxy.py -m cuda --noconftest -q

They are the proxy checks of ``chip_smoke.py`` (one implementation, there),
at PNNP.yml's width d=1024:

* ``quantile`` and ``quantile_dot`` on the same heads, u and c: the core
  within 1e-6 of the knot span, tail draws within 1e-6 of the largest draw.
* The loss (``nll``, ``nll_px``, ``nll_row``) within 1e-5 relative, the
  gradients within 1e-4 of each gradient's largest magnitude.
* At the recipe shape 8 x 4 x 512 x 512, the sample's variance within 2% of
  the closed form (pixel + s0^2 + row + mean shot) and its mean within 3
  standard errors of 0.
"""

import pytest
import torch


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the proxy's card check")
    return torch.device("cuda")


@pytest.mark.cuda
def test_quantiles_on_the_card_match_the_cpu(card):
    from chip_smoke import proxy_quantile_check

    errs = proxy_quantile_check(card)
    assert set(errs) == {"quantile", "quantile_tail", "quantile_dot", "quantile_dot_tail"}


@pytest.mark.cuda
def test_loss_and_grads_on_the_card_match_the_cpu(card):
    from chip_smoke import proxy_loss_check

    assert proxy_loss_check(card)["grad_rel_of_max"] <= 1e-4


@pytest.mark.cuda
def test_recipe_shape_sample_moments(card):
    from chip_smoke import proxy_sample_check

    assert proxy_sample_check(card)["shape"] == [8, 4, 512, 512]
