"""The comparison that decides ``correct`` sees the faults a cell can have,
and its control, at tiny sizes on the CPU: the run drives the harness as a
real run does (past the look for a card), with the timed path broken
underneath, and ``correct`` must come out false."""

import pytest

from portbench import faults
from portbench.tests import tiny

EVAL = ("sony_eval_sweep", "imx686_eval_resident")
TRAIN = ("imx686_train_proxy", "sony_proxy_nll")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny.tiny_tree(tmp_path_factory.mktemp("faults"))


def _incorrect(tree, name, **kw):
    line, checks = tiny.run(*tree, name, **kw)
    assert not line["correct"], line["checks"]
    return {n: v for n, v, _ in checks}


@pytest.mark.parametrize("name", tiny.CELLS)
def test_the_control_is_not_correct(tree, name):
    """The reference in the next lower precision in the program's place (for
    the eval cells the port's int8 serving path, scored in bfloat16)."""
    _incorrect(tree, name, control=True)


@pytest.mark.parametrize("name", EVAL)
@pytest.mark.parametrize("fault", ["ssim", "frame"])
def test_an_answer_altered_where_it_is_produced(tree, name, fault):
    with faults.FAULTS[fault]():
        _incorrect(tree, name)


@pytest.mark.parametrize("name", TRAIN)
def test_a_step_that_leaves_its_state_unchanged(tree, name):
    with faults.unchanged():
        assert _incorrect(tree, name)["delta_gap"] > 0.9


@pytest.mark.parametrize("name", TRAIN)
def test_half_the_batch_left_out(tree, name):
    with faults.half():
        _incorrect(tree, name)
