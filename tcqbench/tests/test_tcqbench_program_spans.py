"""The readers of the program's spans on stub spans and stub records:
their values, ``pool.run``'s self time, and ``None`` where there is
nothing to read (no recorder, no span, spans dropped past the cap)."""

import sys
import types

import pytest

import repro_torch.core
from tcqbench.run import HERE, load_module
from tcqbench.tests.tiny import one_thread  # noqa: F401  (autouse)

READERS = ("window_tel_pct.batch", "decode_pct.batch",
           "scheduler_us_per_step.batch", "pool_host_us_per_step.batch",
           "pool_wait_pct.batch")


def reader(name):
    return load_module(HERE / "metrics" / f"{name}.py").read


def span(name, start, end, parent=-1, root=0):
    return types.SimpleNamespace(name=name, start=start, end=end,
                                 parent=parent, root=root)


# two batches on a 10-s window, 5 device steps in all
SPANS = [
    span("engine.query_batch", 0.0, 4.0),                    # 0
    span("engine.window_tel", 0.0, 0.5, 0),                  # 1
    span("pool.run", 0.5, 3.0, 0),                           # 2
    span("pool.wait", 0.6, 0.8, 2),                          # 3
    span("scheduler.retire", 0.8, 0.9, 2),                   # 4
    span("pool.wait", 1.0, 1.5, 2),                          # 5
    span("scheduler.retire", 1.5, 1.75, 2),                  # 6
    span("scheduler.decode", 3.0, 3.5, 0),                   # 7
    span("engine.query_batch", 5.0, 9.0, root=1),            # 8
    span("engine.window_tel", 5.0, 5.25, 8, 1),              # 9
    span("pool.run", 5.25, 8.0, 8, 1),                       # 10
    span("pool.wait", 5.5, 6.0, 10, 1),                      # 11
    span("scheduler.retire", 6.0, 6.5, 10, 1),               # 12
    span("scheduler.decode", 8.0, 9.0, 8, 1),                # 13
]
REC = {"window_s": 9.9, "trace": {"window_s": 10.0, "busy_s": 3.0},
       "batches": [{"device_steps": 2}, {"device_steps": 3}]}
WANT = {
    "window_tel_pct.batch": 100.0 * (0.5 + 0.25) / 10.0,
    "decode_pct.batch": 100.0 * (0.5 + 1.0) / 10.0,
    "scheduler_us_per_step.batch": 1e6 * (0.1 + 0.25 + 0.5) / 5,
    # pool.run 2.5 s less 0.2 + 0.1 + 0.5 + 0.25; 2.75 s less 0.5 + 0.5
    "pool_host_us_per_step.batch": 1e6 * ((2.5 - 1.05) + (2.75 - 1.0)) / 5,
    "pool_wait_pct.batch": 100.0 * (0.2 + 0.5 + 0.5) / 10.0,
}


def stub(monkeypatch, spans, dropped=0):
    mod = types.SimpleNamespace(spans=lambda: spans, dropped=lambda: dropped)
    monkeypatch.setattr(repro_torch.core, "trace", mod, raising=False)


@pytest.mark.parametrize("name", READERS)
def test_reader_values(name, monkeypatch):
    stub(monkeypatch, SPANS)
    assert reader(name)(REC) == pytest.approx(WANT[name])


def test_self_time_leaves_out_only_direct_children(monkeypatch):
    # a wait nested under a retire is the retire's, not pool.run's
    spans = [span("pool.run", 0.0, 1.0), span("scheduler.retire", 0.1, 0.5, 0),
             span("pool.wait", 0.2, 0.3, 1)]
    stub(monkeypatch, spans)
    got = reader("pool_host_us_per_step.batch")(
        {"batches": [{"device_steps": 2}]})
    assert got == pytest.approx(1e6 * 0.6 / 2)


@pytest.mark.parametrize("name", READERS)
def test_none_without_the_recorder(name, monkeypatch):
    # the parent commit: repro_torch.core has no trace module
    monkeypatch.delattr(repro_torch.core, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.core.trace", None)
    assert reader(name)(REC) is None


@pytest.mark.parametrize("name", READERS)
def test_none_without_its_spans(name, monkeypatch):
    stub(monkeypatch, [])
    assert reader(name)(REC) is None
    stub(monkeypatch, [s for s in SPANS if s.name == "engine.query_batch"])
    assert reader(name)(REC) is None


@pytest.mark.parametrize("name", READERS)
def test_none_when_spans_were_dropped(name, monkeypatch):
    stub(monkeypatch, SPANS, dropped=1)
    assert reader(name)(REC) is None


def test_readers_read_the_program_recorder():
    """A tiny armed ``query_batch`` on the CPU: every reader but the card's
    wait gives a number from the real recorder."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import TCQEngine, trace
    from repro_torch.graphs import powerlaw_temporal

    eng = TCQEngine(powerlaw_temporal(40, 400, 48, seed=3), device="cpu")
    trace.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            res = eng.query_batch([{"k": 2, "ts": 0, "te": 30},
                                   {"k": 3, "ts": 5, "te": 40}])
        rec = {"trace": {"window_s": 1.0},
               "batches": [{"device_steps": res[0].stats.device_steps}]}
        got = {n: reader(n)(rec) for n in READERS}
    finally:
        trace.clear()
    assert got.pop("pool_wait_pct.batch") is None       # no card
    assert all(v is not None and v > 0 for v in got.values()), got
