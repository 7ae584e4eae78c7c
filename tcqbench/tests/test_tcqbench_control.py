"""The control (the reference peeling at most two rounds a cell, short of
the fixpoint) fails the comparison that sound runs pass, on three seeds,
in every cell's traffic at a size a test run holds."""

import pytest

from tcqbench import cell
from tcqbench.control import control_numbers
from tcqbench.tests import tiny
from tcqbench.tests.tiny import one_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("kind", sorted(tiny.PARAMS))
def test_control_fails_on_three_seeds(kind):
    edges = cell.edges(tiny.CONFIG)
    for seed in (5, 2**31 + 6, 7):
        out = control_numbers(tiny.workload(kind), tiny.CONFIG, seed, "cpu",
                              max_iters=2, edges=edges)
        assert out["queries_checked"] == tiny.PARAMS[kind]["check_queries"]
        assert out["cores_differing"] > 0, (kind, seed)


def test_uncapped_control_is_the_reference():
    edges = cell.edges(tiny.CONFIG)
    out = control_numbers(tiny.workload("batch"), tiny.CONFIG, 5, "cpu",
                          max_iters=0, edges=edges)
    assert out["cores_differing"] == 0
