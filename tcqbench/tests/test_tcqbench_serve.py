"""The open-loop serving driver (``tcqbench/traffic/serve.py``) on a tiny
live graph on the CPU: one seed gives one schedule, latency counts from
the due time, ``tcq_qps`` counts as defined, the check uses each epoch's
edge prefix, and a program that answers on a stale epoch or skips a push
reads ``correct`` false.  Also the readers of the cell's four per-layer
metrics, on stub spans and records."""

import types

import numpy as np
import pytest

import repro_torch.core
from tcqbench.run import HERE, load_module
from tcqbench.tests.tiny import bench, one_thread  # noqa: F401  (autouse)
from tcqbench.trace import Spans

CELL = "sx-mathoverflow-live.serve"
CONFIG = {"name": "tiny-live",
          "graph": {"num_vertices": 800, "num_edges": 20_000,
                    "time_span": 300, "burst_periods": 14, "seed": 11},
          "live": {"stream_from": 240, "pushes": 4,
                   "push_due": [0.1, 0.2, 0.3, 0.4]}}
# a rate a loaded CPU keeps up with, and early pushes: most answers lie
# past a push, and half of them end at the frontier
PARAMS = {"rate_qps": 6.0, "span": 20, "k": 3, "h": 1,
          "frontier_share": 0.5, "warmup_requests": 4,
          "check_queries": 1000}
SEED = 2**31 + 77
SECONDS = 2.5


def driver_module():
    return load_module(HERE / "traffic" / "serve.py")


def workload():
    return {"name": CELL, "config": CONFIG["name"], "driver": "serve",
            "params": PARAMS}


def run(seed=SEED, seconds=SECONDS):
    from tcqbench import run as runmod

    b = bench()
    entry = next(w for w in b["workloads"] if w["name"] == CELL)
    return runmod.run_cell(b, entry, workload(), CONFIG, seed, seconds,
                           False, "cpu")


def windowed(seed=SEED):
    """A driver after its set-up and window (the program not released)."""
    drv = driver_module().Driver(workload(), CONFIG, seed, "cpu")
    drv.setup()
    e2e = drv.window(SECONDS, Spans())
    return drv, e2e


def test_one_seed_gives_one_schedule():
    mod = driver_module()
    live = CONFIG["live"]
    frontiers = [239, 254, 269, 284, 300]
    one = mod.schedule(PARAMS, live, SEED, 10.0, frontiers)
    assert one == mod.schedule(PARAMS, live, SEED, 10.0, frontiers)
    assert one != mod.schedule(PARAMS, live, SEED + 1, 10.0, frontiers)
    pushes = [ev for ev in one if ev.req is None]
    assert [ev.due for ev in pushes] == [1.0, 2.0, 3.0, 4.0]
    assert [ev.push for ev in pushes] == [0, 1, 2, 3]
    arrivals = [ev for ev in one if ev.req is not None]
    assert 35 <= len(arrivals) <= 90            # 6/s over 10 s
    assert [ev.due for ev in one] == sorted(ev.due for ev in one)
    assert all(0 <= ev.due < 10.0 for ev in one)
    at_front = 0
    for ev in arrivals:
        f = frontiers[ev.epoch]
        assert ev.epoch == sum(p.due <= ev.due for p in pushes)
        assert ev.req["te"] - ev.req["ts"] == PARAMS["span"]
        assert 1 <= ev.req["ts"] and ev.req["te"] <= f
        at_front += ev.req["te"] == f
    assert abs(at_front - 0.5 * len(arrivals)) <= 1


def test_split_days_cuts_whole_days_in_time_order():
    mod = driver_module()
    t = np.array([5, 239, 240, 241, 250, 262, 270, 280, 300, 300, 1])
    loaded, pushes, frontiers = mod.split_days(t, CONFIG["live"])
    assert sorted(t[loaded].tolist()) == [1, 5, 239]
    assert sum(len(p) for p in pushes) + len(loaded) == len(t)
    days = [sorted(set(t[p].tolist())) for p in pushes]
    assert all(a[-1] < b[0] for a, b in zip(days, days[1:]) if a and b)
    assert frontiers[0] == 239 and frontiers[-1] == 300
    assert frontiers == sorted(frontiers)


def test_latency_counts_from_the_due_time():
    drv, _ = windowed()
    tk0, ev0, _ = drv.tickets[0]
    for tk, ev, _ in drv.tickets:
        assert tk.due_s - tk0.due_s == pytest.approx(ev.due - ev0.due,
                                                     abs=1e-9)
        assert tk.due_s <= tk.submit_s
        if tk.done_s is not None:
            assert tk.latency_s == tk.done_s - tk.due_s
    lat = [tk.latency_s for tk, _, _ in drv.tickets if tk.status == "done"]
    assert drv.summary["latency_p50_ms"] == pytest.approx(
        1e3 * float(np.quantile(lat, 0.5)))


def test_tcq_qps_counts_as_defined():
    drv, e2e = windowed()
    answered = sum(tk.status == "done" for tk, _, _ in drv.tickets)
    assert answered == drv.summary["answered"] > 0
    assert drv.window_s >= SECONDS
    assert e2e["tcq_qps"] == pytest.approx(answered / drv.window_s)
    assert drv.attempted == len(drv.tickets) == drv.summary["arrivals"]
    # the backlog left at the end is never answered, nor counted
    assert answered + drv.summary["pending_end"] <= drv.attempted
    assert drv.summary["pushes"] == 4


def test_check_uses_each_epochs_edge_prefix():
    drv, _ = windowed()
    for e, f in enumerate(drv.frontiers):
        u, v, t = drv.epoch_edges(e)
        keep = drv.t <= f
        assert np.array_equal(np.sort(t), np.sort(drv.t[keep]))
        assert len(u) == len(v) == int(keep.sum())
    for tk, _, epoch in drv.tickets:
        assert tk.epoch == epoch
    epochs = {epoch for _, epoch, _ in drv.sample.items}
    assert len(epochs) >= 2 and epochs <= set(range(5))


def test_sound_run_is_correct():
    out = run()
    assert out["correct"], out["checks"]
    assert out["checks"]["cores_differing"]["value"] == 0
    assert out["checks"]["queries_checked"]["value"] > 0


def stale_epoch(monkeypatch):
    """Each ticket pinned to the snapshot one push older than its own."""
    from repro_torch.core import service

    graphs = {}
    real_push, real_submit = (service.TCQService.push_edges,
                              service.TCQService.submit)

    def push_edges(self, u, v, t):
        graphs[self.epoch] = self.graph
        return real_push(self, u, v, t)

    def submit(self, request):
        tk = real_submit(self, request)
        old = graphs.get(tk.epoch - 1)
        if old is not None:
            uts = old.unique_ts
            uts = uts[(uts >= tk.ts) & (uts <= tk.te)].astype(np.int64)
            if uts.size:
                tk.graph, tk.epoch, tk.uts = old, tk.epoch - 1, uts
        return tk

    monkeypatch.setattr(service.TCQService, "push_edges", push_edges)
    monkeypatch.setattr(service.TCQService, "submit", submit)


def push_skipped(monkeypatch):
    """Every push returns without installing its edges."""
    from repro_torch.core import service

    monkeypatch.setattr(service.TCQService, "push_edges",
                        lambda self, u, v, t: self.epoch)


@pytest.mark.parametrize("fault", [stale_epoch, push_skipped],
                         ids=["stale_epoch", "push_skipped"])
def test_fault_makes_run_incorrect(fault, monkeypatch):
    fault(monkeypatch)
    out = run()
    assert not out["correct"], out["checks"]
    assert out["checks"]["cores_differing"]["value"] > 0


# ---------------------------------------------------------------- readers
def reader(name):
    return load_module(HERE / "metrics" / f"{name}.py").read


def span(name, start, end, parent=-1):
    return types.SimpleNamespace(name=name, start=start, end=end,
                                 parent=parent, root=0)


SPANS = [span("service.pump", 0.0, 3.0), span("service.ingest", 0.1, 0.3, 0),
         span("service.form", 0.3, 0.8, 0), span("pool.run", 0.8, 3.0, 0),
         span("service.ingest", 1.0, 1.5, 3),
         span("service.pump", 4.0, 5.0),
         span("service.form", 4.0, 4.25, 5)]
REC = {"window_s": 9.9, "trace": {"window_s": 10.0, "busy_s": 3.0},
       "serve": {"pools": 4, "pool_members": 26, "cells_cached": 30,
                 "cells_needed": 120, "resolved_at_admission": 2}}


def stub(monkeypatch, spans, dropped=0):
    mod = types.SimpleNamespace(spans=lambda: spans, dropped=lambda: dropped)
    monkeypatch.setattr(repro_torch.core, "trace", mod, raising=False)


@pytest.mark.parametrize("name,want", [
    ("ingest_pct.serve", 100.0 * (0.2 + 0.5) / 10.0),
    ("form_pct.serve", 100.0 * (0.5 + 0.25) / 10.0),
    ("members_per_pool.serve", 26 / 4),
    ("cache_resolved_pct.serve", 100.0 * 30 / 120)])
def test_readers_read_their_spans_and_counters(name, want, monkeypatch):
    stub(monkeypatch, SPANS)
    assert reader(name)(REC) == pytest.approx(want)


@pytest.mark.parametrize("name", ["ingest_pct.serve", "form_pct.serve"])
def test_span_readers_give_none_without_spans(name, monkeypatch):
    stub(monkeypatch, [s for s in SPANS if not s.name.startswith("serv")])
    assert reader(name)(REC) is None
    stub(monkeypatch, SPANS, dropped=1)
    assert reader(name)(REC) is None
    stub(monkeypatch, SPANS)
    assert reader(name)(dict(REC, trace=None)) is None


@pytest.mark.parametrize("name", ["members_per_pool.serve",
                                  "cache_resolved_pct.serve"])
def test_counter_readers_give_none_without_counters(name):
    # a service without the counters (the parent's) records none
    assert reader(name)(dict(REC, serve={})) is None
    assert reader(name)({"trace": None}) is None
    assert reader(name)(dict(REC, serve={"pools": 0, "pool_members": 0,
                                         "cells_cached": 0,
                                         "cells_needed": 0})) is None
