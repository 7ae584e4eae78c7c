"""A run with the timed path broken underneath comes out not correct.

Each test drives the whole of a tiny run on the CPU (``run.run_cell``,
the harness's look for a card left out) with one fault planted in the
program, and sees ``correct`` false: a wave step that returns its lanes'
state unchanged, half of a batch's answers left out, and an answer
altered where it is produced.  The cells run on one chip, so there is no
exchange between chips to leave out.  A run with no fault is correct.
"""


import pytest

from tcqbench.tests import tiny
from tcqbench.tests.tiny import one_thread  # noqa: F401  (autouse)
from tcqbench.tests.faults import FAULTS


@pytest.mark.parametrize("kind", ['batch', 'shifted'])
def test_sound_run_is_correct(kind):
    out = tiny.run(kind)
    assert out["correct"], out["checks"]
    assert out["checks"]["cores_differing"]["value"] == 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("kind", ['batch', 'shifted'])
def test_fault_makes_run_incorrect(kind, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = tiny.run(kind)
    assert not out["correct"], out["checks"]
    assert out["checks"]["cores_differing"]["value"] > 0
