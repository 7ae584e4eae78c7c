"""The port's span recorder (``repro_torch.core.trace``) on the TCQ path.

Spans are recorded exactly while a ``torch.profiler`` session records:
here a CPU session around a small ``query_batch`` on the CPU, checked for
nesting, root ids, the documented names, one ``scheduler.retire`` per
device step, one ``engine.window_tel`` per LRU miss, times on the
caller's ``time.perf_counter()`` clock, and answers untouched by the
recorder.  The card's ``pool.wait`` span is checked by the test marked
``cuda``.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.core import TCQEngine, TCQService, trace  # noqa: E402
from repro_torch.graphs import powerlaw_temporal  # noqa: E402

NAMES = {"engine.query_batch", "engine.window_tel", "pool.run", "pool.wait",
         "scheduler.retire", "scheduler.decode", "service.pump",
         "service.form", "service.ingest"}
COUNTERS = ("cells_evaluated", "device_steps", "duplicates", "peel_iters",
            "host_syncs", "bytes_synced", "lane_refills", "por_triggers",
            "pou_triggers", "pol_triggers")
REQS = [{"k": 2, "ts": 0, "te": 30}, {"k": 3, "ts": 5, "te": 40},
        {"k": 2, "ts": 12, "te": 26, "h": 2}]


@pytest.fixture(autouse=True)
def fresh():
    trace.clear()
    yield
    trace.clear()


def _graph():
    return powerlaw_temporal(40, 400, 48, seed=3)


def _armed(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.armed()
        return fn()


def _digest(results):
    return [({c.tti: (c.vertices.tolist(), c.n_edges) for c in r.cores},
             tuple(getattr(r.stats, f) for f in COUNTERS))
            for r in results]


def _by_name(spans, name):
    return [s for s in spans if s.name == name]


def test_disarmed_query_batch_records_nothing():
    assert not trace.armed()
    TCQEngine(_graph(), device="cpu").query_batch(REQS)
    assert trace.spans() == [] and trace.dropped() == 0


def test_armed_spans_nest_share_their_root_and_keep_to_the_names():
    eng = TCQEngine(_graph(), device="cpu")
    t_before = time.perf_counter()
    res = _armed(lambda: eng.query_batch(REQS))
    t_after = time.perf_counter()
    sp = trace.spans()
    assert {s.name for s in sp} <= NAMES
    assert trace.dropped() == 0
    roots = [s for s in sp if s.parent == -1]
    assert [s.name for s in roots] == ["engine.query_batch"]
    for i, s in enumerate(sp):
        assert s.index == i and s.end is not None
        assert t_before <= s.start <= s.end <= t_after
        assert s.root == roots[0].root
        if s.parent >= 0:
            p = sp[s.parent]
            assert p.start <= s.start and s.end <= p.end, (s.name, p.name)
    parent = {s.name: sp[s.parent].name for s in sp if s.parent >= 0}
    assert parent == {"engine.window_tel": "engine.query_batch",
                      "pool.run": "engine.query_batch",
                      "scheduler.retire": "pool.run",
                      "scheduler.decode": "engine.query_batch"}
    # one retire a device step, one decode a query; no wait off the card
    assert len(_by_name(sp, "scheduler.retire")) == res[0].stats.device_steps
    assert len(_by_name(sp, "scheduler.decode")) == len(REQS)
    assert len(_by_name(sp, "pool.run")) == 1
    assert not _by_name(sp, "pool.wait")


def test_window_tel_span_on_a_miss_only():
    eng = TCQEngine(_graph(), device="cpu")
    _armed(lambda: eng.query_batch(REQS))
    assert len(_by_name(trace.spans(), "engine.window_tel")) == 1
    trace.clear()
    _armed(lambda: eng.query_batch(REQS))       # the same union window
    assert eng.stats()["window_tel"]["hits"] == 1
    assert not _by_name(trace.spans(), "engine.window_tel")
    assert len(_by_name(trace.spans(), "engine.query_batch")) == 1


def test_each_call_gets_its_own_root_id():
    eng = TCQEngine(_graph(), device="cpu")
    _armed(lambda: [eng.query_batch(REQS[:2]), eng.query_batch(REQS[2:])])
    sp = trace.spans()
    roots = _by_name(sp, "engine.query_batch")
    assert len(roots) == 2 and roots[0].root != roots[1].root
    for r in roots:
        under = [s for s in sp if r.start <= s.start and s.end <= r.end]
        assert {s.root for s in under} == {r.root}


def test_answers_and_counters_are_untouched_when_armed():
    g = _graph()
    want = _digest(TCQEngine(g, device="cpu").query_batch(REQS, wave=4))
    got = _digest(_armed(
        lambda: TCQEngine(g, device="cpu").query_batch(REQS, wave=4)))
    assert got == want


def test_service_pool_is_a_root_of_its_own():
    """Each pool's spans share a root of their own: the pump's."""
    svc = TCQService(_graph(), device="cpu")
    for r in REQS:
        svc.submit(r)
    _armed(svc.run_until_idle)
    sp = trace.spans()
    assert {s.name for s in sp} <= NAMES
    runs = _by_name(sp, "pool.run")
    assert runs and all(sp[s.parent].name == "service.pump" for s in runs)
    assert len({s.root for s in runs}) == len(runs)
    for s in _by_name(sp, "scheduler.retire"):
        assert sp[s.parent].name == "pool.run"


def test_spans_past_the_cap_are_dropped(monkeypatch):
    monkeypatch.setattr(trace, "CAP", 5)
    eng = TCQEngine(_graph(), device="cpu")
    _armed(lambda: eng.query_batch(REQS))
    assert len(trace.spans()) == 5
    assert trace.dropped() > 0
    trace.clear()
    assert trace.spans() == [] and trace.dropped() == 0


def test_an_exception_closes_the_spans_left_open_inside():
    with pytest.raises(RuntimeError):
        with profile(activities=[ProfilerActivity.CPU]):
            with trace.span("engine.query_batch"):
                trace.begin("pool.run")
                raise RuntimeError("boom")
    sp = trace.spans()
    assert [s.name for s in sp] == ["engine.query_batch", "pool.run"]
    assert all(s.end is not None for s in sp)
    # the thread's stack is empty again: the next span is a root
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("engine.query_batch"):
            pass
    assert trace.spans()[-1].parent == -1


def test_a_second_thread_does_not_nest_into_the_first():
    opened, release = threading.Event(), threading.Event()

    def other():
        opened.wait()
        with trace.span("pool.run"):
            pass
        release.set()

    th = threading.Thread(target=other)
    with profile(activities=[ProfilerActivity.CPU]):
        th.start()
        with trace.span("engine.query_batch"):
            opened.set()
            release.wait(10)
        th.join()
    qb, run = trace.spans()
    assert (qb.name, run.name) == ("engine.query_batch", "pool.run")
    assert run.parent == -1 and run.root != qb.root
    assert qb.start <= run.start and run.end <= qb.end


def test_threads_keep_their_own_stacks_under_contention():
    """More threads than cores open nested spans at a short switch
    interval: no span is lost, every index is its place in the list, and
    every child's parent is its own thread's span of its own root."""
    import sys

    n_threads, n_roots = 16, 200
    interval = sys.getswitchinterval()

    def work(tid):
        for _ in range(n_roots):
            outer = trace.begin(f"{tid}.outer")
            inner = trace.begin(f"{tid}.inner")
            trace.end(inner)
            trace.end(outer)

    threads = [threading.Thread(target=work, args=(t,))
               for t in range(n_threads)]
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for th in threads:
                th.start()
            for th in threads:
                th.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    sp = trace.spans()
    assert len(sp) == 2 * n_threads * n_roots and trace.dropped() == 0
    assert [s.index for s in sp] == list(range(len(sp)))
    outers = [s for s in sp if s.name.endswith(".outer")]
    assert all(s.parent == -1 for s in outers)
    assert len({s.root for s in outers}) == len(outers)
    for s in sp:
        if s.name.endswith(".inner"):
            p = sp[s.parent]
            assert p.name == s.name.replace(".inner", ".outer")
            assert p.root == s.root and p.start <= s.start <= s.end <= p.end


@pytest.mark.cuda
def test_pool_wait_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch sees no CUDA device")
    g = _graph()
    eng = TCQEngine(g)
    res = _armed(lambda: eng.query_batch(REQS))
    sp = trace.spans()
    waits = _by_name(sp, "pool.wait")
    assert len(waits) == res[0].stats.device_steps
    assert all(sp[s.parent].name == "pool.run" for s in waits)
    want = TCQEngine(g, device="cpu").query_batch(REQS)
    assert [d[0] for d in _digest(res)] == [d[0] for d in _digest(want)]
    assert np.isfinite([s.end - s.start for s in sp]).all()
