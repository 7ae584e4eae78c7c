"""The reader of the program's counters, ``hp_kept_pct.batch``: the share
of phase A's walk that some lane kept, and ``None`` where there is nothing
to read (no recorder, a recorder without counters, nothing scanned)."""

import sys
import types

import pytest

import repro_torch.core
from tcqbench.run import HERE, load_module
from tcqbench.tests.tiny import one_thread  # noqa: F401  (autouse)

REC = {"trace": {"window_s": 10.0, "busy_s": 3.0}}


def reader():
    return load_module(HERE / "metrics" / "hp_kept_pct.batch.py").read


def stub(monkeypatch, **attrs):
    mod = types.SimpleNamespace(spans=lambda: [], dropped=lambda: 0, **attrs)
    monkeypatch.setattr(repro_torch.core, "trace", mod, raising=False)


def test_share_of_the_walk_kept(monkeypatch):
    stub(monkeypatch, counters=lambda: {"wave.hp_scanned": 8000,
                                        "wave.hp_kept": 250})
    assert reader()(REC) == pytest.approx(100.0 * 250 / 8000)
    stub(monkeypatch, counters=lambda: {"wave.hp_scanned": 8000})
    assert reader()(REC) == 0.0


@pytest.mark.parametrize("counts", [{}, {"wave.hp_scanned": 0,
                                         "wave.hp_kept": 0},
                                    {"wave.hp_kept": 3}])
def test_none_where_nothing_was_scanned(monkeypatch, counts):
    stub(monkeypatch, counters=lambda: counts)
    assert reader()(REC) is None


def test_none_without_counters_or_a_trace(monkeypatch):
    stub(monkeypatch)               # the parent: spans, no counters
    assert reader()(REC) is None
    stub(monkeypatch, counters=lambda: {"wave.hp_scanned": 10,
                                        "wave.hp_kept": 1})
    assert reader()({"trace": None}) is None


def test_none_without_the_recorder(monkeypatch):
    monkeypatch.delattr(repro_torch.core, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.core.trace", None)
    assert reader()(REC) is None


def test_reads_the_program_recorder(monkeypatch):
    """An armed CPU ``query_batch`` whose steps report the global tier's
    counts: the reader gives the kept share the recorder summed; with the
    plain steps alone, None."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import TCQEngine, otcd, trace
    from repro_torch.graphs import powerlaw_temporal

    g = powerlaw_temporal(40, 400, 48, seed=3)
    reqs = [{"k": 2, "ts": 0, "te": 30}, {"k": 3, "ts": 5, "te": 40}]

    def armed_read():
        trace.clear()
        try:
            with profile(activities=[ProfilerActivity.CPU]):
                TCQEngine(g, device="cpu").query_batch(reqs)
            return reader()(REC)
        finally:
            trace.clear()

    assert armed_read() is None
    real = otcd.make_wave_step_fn

    def counting(*a, **kw):
        inner = real(*a, **kw)

        def step(alive, *args):
            return inner(alive, *args)._replace(
                hp_kept=torch.full((alive.shape[0],), 3, dtype=torch.int32),
                hp_scanned=40)

        step.backend = inner.backend
        return step

    monkeypatch.setattr(otcd, "make_wave_step_fn", counting)
    assert armed_read() == pytest.approx(100.0 * 3 / 40)
