"""The cells at their own size on the card: a sound run is correct and the
control is not. Marked ``cuda``; they skip on a host without a card.

    python -m pytest portbench/tests -m cuda --noconftest -q
"""

import time

import pytest

from portbench import harness
from portbench.tests import tiny

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda:0")


def _run(name, card, control=False):
    cell = harness.Cell(tiny.REPO / "BENCHMARK.json", name)
    return harness.run(cell, 2**31 + 991, 1.0, False, card, time.perf_counter(),
                       control=control)


@pytest.mark.parametrize("name", tiny.CELLS)
def test_a_sound_run_is_correct(card, name):
    line, _ = _run(name, card)
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"


@pytest.mark.parametrize("name", tiny.CELLS)
def test_the_control_is_not_correct(card, name):
    line, _ = _run(name, card, control=True)
    assert not line["correct"], line["checks"]
