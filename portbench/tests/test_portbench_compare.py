"""The parameters' change, taken by the worst leaf, on made-up leaves."""

import pytest
import torch

from portbench import compare
from portbench.reference.dpivae import Followed

START = {"a": torch.zeros(4), "b": torch.zeros(9), "c": torch.zeros(1),
         "dead": torch.zeros(3)}
# the reference moves a by 2, b by 3, c by 0.1 (norms); dead by 1
MOVED = {"a": torch.tensor([2.0, 0, 0, 0]), "b": torch.ones(9),
         "c": torch.tensor([0.1]), "dead": torch.tensor([1.0, 0, 0])}
GRAD0 = {"a": 1.0, "b": 2.0, "c": 0.5, "dead": 1e-4}


def _followed():
    return Followed(torch.zeros(1, 9), torch.zeros(1, 8), MOVED, GRAD0)


def test_the_same_change_reads_nought():
    assert compare.change_gap(START, MOVED, _followed()) == 0.0


def test_a_leaf_left_unmoved_reads_one():
    after = dict(MOVED, b=torch.zeros(9))
    assert compare.change_gap(START, after, _followed()) == pytest.approx(1.0)


def test_a_small_leaf_is_measured_against_the_median_leaf():
    # c moves 0.2 instead of 0.1: a gap of 0.1 over the median change, 2
    after = dict(MOVED, c=torch.tensor([0.2]))
    assert compare.change_gap(START, after, _followed()) == pytest.approx(0.05)


def test_a_leaf_whose_first_gradient_is_nought_is_left_out():
    after = dict(MOVED, dead=torch.zeros(3))
    assert compare.change_gap(START, after, _followed()) == 0.0


@pytest.mark.parametrize("doubled", ["a", "b"])
def test_a_leaf_moved_double_reads_one(doubled):
    after = dict(MOVED, **{doubled: 2 * MOVED[doubled]})
    assert compare.change_gap(START, after, _followed()) == pytest.approx(1.0)
