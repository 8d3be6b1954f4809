"""``test_chipbench_check.py``'s cases on the LM cell (a file of its own,
so that the two cells' CPU runs go to different test workers)."""

import pytest

from chipbench import faults
from chipbench.test_chipbench_check import (
    a_broken_timed_path_is_not_correct, reference_follows_the_port,
    the_control_fails)

CELL = "stablelm2.fedtrain_4k"


def test_reference_follows_the_port():
    reference_follows_the_port(CELL)


def test_the_control_fails():
    the_control_fails(CELL)


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_broken_timed_path_is_not_correct(fault):
    a_broken_timed_path_is_not_correct(CELL, fault)
