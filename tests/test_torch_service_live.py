"""The port's streaming service serving a graph whose last days stream in,
on the CPU: answers held to the benchmark's plain reference
(``tcqbench/reference/otcd.py``, plain PyTorch, no JAX) on the raw edges
of each ticket's epoch, pool formation that repeats at two host speeds,
and the service's spans and counters.

The service's clock is injected (``svc._clock``), and every poll moves it
on by a fixed step, so a run is a function of the schedule and of that
step: the two speeds see the same arrivals at different points of the
pools' progress.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.core import TCQService, TemporalGraph, trace  # noqa: E402
from repro_torch.core import service as svcmod  # noqa: E402
from tcqbench.check import differing, program_cores  # noqa: E402
from tcqbench.gen import powerlaw_edges  # noqa: E402
from tcqbench.reference.otcd import EdgeList, otcd  # noqa: E402

V, SPAN = 300, 120
STREAM_FROM = 100
PUSH_DAYS = [(100, 109), (110, SPAN)]


@pytest.fixture(autouse=True)
def fresh():
    """An empty span recorder, and one torch thread: the suite runs in
    several worker processes, and more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.clear()
    yield
    trace.clear()
    torch.set_num_threads(n)


def raw_edges(seed=5):
    return powerlaw_edges(V, 6_000, SPAN, alpha=1.1, burst_periods=4,
                          seed=seed)


def loaded_graph(u, v, t):
    keep = t < STREAM_FROM
    return TemporalGraph.from_edges(u[keep], v[keep], t[keep], V)


def push_index(t, i):
    lo, hi = PUSH_DAYS[i]
    return np.flatnonzero((t >= lo) & (t <= hi))


def epoch_edges(u, v, t, epoch):
    """Raw edges of the epoch after ``epoch`` pushes: a prefix in time."""
    last = STREAM_FROM - 1 if epoch == 0 else PUSH_DAYS[epoch - 1][1]
    keep = t <= last
    return u[keep], v[keep], t[keep]


class FakeClock:
    """The service's clock: moves on by ``step`` seconds at every poll."""

    def __init__(self, step):
        self.now = 0.0
        self.step = step

    def __call__(self):
        return self.now


def schedule(seed, n_burst, n_spread, until, k=3, span=12):
    """Arrivals ``(due, request)``: ``n_burst`` due at 0, ``n_spread``
    spread over ``(0, until)``; a quarter end at day 109 (the frontier
    after the first push), the rest start uniformly."""
    rng = np.random.default_rng(seed)
    dues = np.concatenate([np.zeros(n_burst),
                           np.sort(rng.uniform(0, until, n_spread))])
    out = []
    for d in dues.tolist():
        if rng.random() < 0.25:
            ts = PUSH_DAYS[0][1] - span
        else:
            ts = int(rng.integers(1, STREAM_FROM - span))
        out.append((d, {"k": k, "h": 1, "ts": ts, "te": ts + span}))
    return out


def serve(arrivals, pushes, step, cache=True):
    """Serve ``arrivals`` and ``pushes`` (``(due, index)``) in due order
    from the polls of a service on the injected clock; returns the
    service and ``[(ticket, pushes applied before it)]``."""
    u, v, t = raw_edges()
    svc = TCQService(loaded_graph(u, v, t), device="cpu", cache=cache)
    clock = FakeClock(step)
    svc._clock = clock
    events = sorted([(d, 0, i) for d, i in pushes] +
                    [(d, 1, r) for d, r in arrivals],
                    key=lambda e: (e[0], e[1]))
    st = {"next": 0, "epoch": 0}
    tickets = []

    def poll(s):
        clock.now += clock.step
        while st["next"] < len(events) and \
                events[st["next"]][0] <= clock.now:
            d, kind, what = events[st["next"]]
            st["next"] += 1
            if kind == 0:
                idx = push_index(t, what)
                s.push_edges(u[idx], v[idx], t[idx])
                st["epoch"] += 1
            else:
                tickets.append((s.submit(dict(what, due_s=d)),
                                st["epoch"]))

    while st["next"] < len(events) or svc.pending:
        svc.pump(poll)
    return svc, tickets


def held_to_reference(tickets):
    u, v, t = raw_edges()
    lists = {}
    for tk, epoch in tickets:
        assert tk.status == "done"
        assert tk.epoch == epoch
        el = lists.setdefault(epoch, EdgeList(*epoch_edges(u, v, t, epoch)))
        want = otcd(el, tk.k, tk.ts, tk.te, h=tk.h)
        assert differing(program_cores(tk.result), want) == 0, tk.id


def digest(tickets):
    return [(tk.id, tk.epoch, sorted((key, c[0].tolist(), c[1]) for key, c
                                     in program_cores(tk.result).items()))
            for tk, _ in tickets]


@pytest.mark.parametrize("cache", [True, False], ids=["cache", "no_cache"])
def test_live_tickets_equal_reference_on_their_epoch(cache):
    arrivals = schedule(3, 6, 30, 0.3)
    svc, tickets = serve(arrivals, [(0.1, 0), (0.2, 1)], 0.002, cache)
    assert svc.epoch == 2 and len(tickets) == len(arrivals)
    assert {e for _, e in tickets} == {0, 1, 2}
    held_to_reference(tickets)


def test_cache_on_and_off_give_equal_answers():
    arrivals = schedule(4, 8, 24, 0.3)
    pushes = [(0.1, 0), (0.2, 1)]
    on = serve(arrivals, pushes, 0.002, True)
    off = serve(arrivals, pushes, 0.002, False)
    assert on[0].stats["core_cache"]["hits"] + \
        on[0].stats["core_cache"]["dominance_hits"] > 0
    assert digest(on[1]) == digest(off[1])


def test_a_ticket_submitted_after_a_push_sees_it():
    u, v, t = raw_edges()
    svc = TCQService(loaded_graph(u, v, t), device="cpu")
    req = {"k": 3, "ts": 97, "te": 109}
    before = svc.submit(req)
    idx = push_index(t, 0)
    assert svc.push_edges(u[idx], v[idx], t[idx]) == 1
    after = svc.submit(req)
    svc.run_until_idle()
    assert (before.epoch, after.epoch) == (0, 1)
    # the pushed days hold cores the loaded edges lack
    assert max(c.tti[1] for c in after.result.cores) >= STREAM_FROM
    assert all(c.tti[1] < STREAM_FROM for c in before.result.cores)
    held_to_reference([(before, 0), (after, 1)])


def test_latency_counts_from_the_due_time():
    arrivals = schedule(6, 2, 6, 0.05)
    _, tickets = serve(arrivals, [], 0.01)
    for (tk, _), (due, _) in zip(tickets, arrivals):
        assert tk.due_s == due
        assert tk.latency_s == tk.done_s - due
        assert tk.submit_s >= due


def formation(step, pushes, cache, check=False):
    """Pool log of one schedule, a backlog deeper than a pool from its
    first poll on, polled at host speed ``step``."""
    arrivals = schedule(11, 2 * svcmod.FORM_HORIZON, 200, 0.2)
    svc, tickets = serve(arrivals, pushes, step, cache)
    if check:
        held_to_reference(tickets)
    return [(p["epoch"], p["window"], p["ids"]) for p in svc.pool_log]


@pytest.mark.parametrize("pushes,cache", [
    ([(0.05, 0), (0.15, 1)], False), ([], True)],
    ids=["pushes", "cache"])
def test_formation_repeats_at_two_host_speeds(pushes, cache):
    """The members and union windows of every pool repeat at two host
    speeds.  Not with both the cache and pushes: a push re-keys the
    cache to the new epoch, so which older tickets the cache answers
    whole depends on how far the pools had got when it landed."""
    fast = formation(0.01, pushes, cache, check=True)
    slow = formation(0.03, pushes, cache)
    assert fast == slow
    assert max(len(ids) for _, _, ids in fast) >= svcmod.POOL_MEMBERS
    assert len(fast) >= 2 and \
        len({e for e, _, _ in fast}) == len(pushes) + 1


def test_formation_takes_the_front_in_edf_order_up_to_the_limit():
    u, v, t = raw_edges()
    svc = TCQService(loaded_graph(u, v, t), device="cpu", cache=False)
    n = svcmod.FORM_HORIZON + 10
    # every window overlaps the next: one cluster over the whole backlog
    tks = [svc.submit({"k": 3, "ts": 10 + i % 40, "te": 30 + i % 40})
           for i in range(n)]
    members = svc._form()
    assert sorted(tk.id for tk in members) == \
        [tk.id for tk in tks[:svcmod.POOL_MEMBERS]]
    assert svc.pending == n - svcmod.POOL_MEMBERS


def test_stats_count_pools_members_cells_and_cache_answers():
    arrivals = schedule(8, 10, 20, 0.2)
    # repeats, due once the service has drained: the cache answers them
    arrivals += [(2.0, dict(arrivals[-1][1]))] * 3
    svc, tickets = serve(arrivals, [(0.1, 0)], 0.004)
    st = svc.stats
    assert st["pools"] == len(svc.pool_log)
    assert st["pool_members"] + st["resolved_at_admission"] >= len(tickets)
    assert st["pool_members"] <= sum(p["members"] for p in svc.pool_log)
    assert st["resolved_at_admission"] >= 1
    cached = sum(tk.result.stats.cells_cached for tk, _ in tickets)
    needed = sum(tk.result.stats.cells_cached
                 + tk.result.stats.cells_evaluated for tk, _ in tickets)
    assert (st["cells_cached"], st["cells_needed"]) == (cached, needed)


def _by_name(spans, name):
    return [s for s in spans if s.name == name]


def test_service_spans_nest_and_record_only_while_armed():
    arrivals = schedule(9, 4, 8, 0.1)
    serve(arrivals, [(0.05, 0)], 0.004)
    assert trace.spans() == []
    with profile(activities=[ProfilerActivity.CPU]):
        svc, tickets = serve(arrivals, [(0.05, 0)], 0.004)
    sp = trace.spans()
    assert trace.dropped() == 0
    pumps = _by_name(sp, "service.pump")
    assert pumps and all(s.parent == -1 for s in pumps)
    assert len({s.root for s in pumps}) == len(pumps)
    forms = _by_name(sp, "service.form")
    assert len(forms) == len(pumps)
    assert all(sp[s.parent].name == "service.pump" for s in forms)
    ingests = _by_name(sp, "service.ingest")
    assert len(ingests) == 1
    assert sp[ingests[0].parent].name in ("service.pump", "pool.run")
    for s in _by_name(sp, "pool.run") + _by_name(sp, "engine.window_tel"):
        assert sp[s.parent].name == "service.pump"
    for s in sp:
        if s.parent >= 0:
            p = sp[s.parent]
            assert p.root == s.root
            assert p.start <= s.start and s.end <= p.end, (s.name, p.name)
    assert len(_by_name(sp, "pool.run")) == len(svc.pool_log)
