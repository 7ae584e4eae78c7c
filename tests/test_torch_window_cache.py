"""The engine's window-TEL LRU, bounded by its entries and by the bytes they
pin, and the global tier's half-pair counters as the lane pool keeps them.

On the CPU an entry pins its edge columns (the plain step holds no band
tables).  With a small budget the LRU evicts least-recent entries until
what stays fits it, keeps the newest whatever its size, and answers every
query as an unbounded engine does, bit for bit.  The pool's counters are
driven by a step that reports a fixed count, since the global tier runs on
the card only (tests/test_torch_cuda.py holds the kernel's count).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.core import TCQEngine, trace  # noqa: E402
from repro_torch.core import otcd  # noqa: E402
from repro_torch.graphs import powerlaw_temporal  # noqa: E402

COUNTERS = ("cells_evaluated", "device_steps", "duplicates", "peel_iters",
            "host_syncs", "bytes_synced", "lane_refills", "hp_scanned",
            "hp_kept")


def _graph():
    return powerlaw_temporal(60, 900, 120, burst_periods=4, seed=5)


def _windows(n, span=20):
    """``n`` distinct windows of ``span`` days, spread over the range."""
    return [(1 + (7 * i) % 95, 1 + (7 * i) % 95 + span + i % 3)
            for i in range(n)]


def _digest(res):
    return ({c.tti: (c.vertices.tolist(), c.n_edges) for c in res.cores},
            tuple(getattr(res.stats, f) for f in COUNTERS))


def _edge_bytes(eng, ts, te):
    g = eng.graph
    e = int(np.count_nonzero((g.t >= ts) & (g.t <= te)))
    return 4 * 4 * otcd.pow2_capacity(e)


@pytest.mark.parametrize("mode", ["serial", "wave"])
@pytest.mark.parametrize("entries", [0, 1, 3])
def test_byte_budget_bounds_the_lru_and_changes_no_answer(mode, entries,
                                                           monkeypatch):
    """A budget of ``entries`` entries' bytes: after every miss the LRU
    holds at most that (at least the newest entry), evictions count every
    entry that left, and every answer equals the unbounded engine's."""
    g = _graph()
    wins = _windows(12)
    free = TCQEngine(g, device="cpu")
    want = [free.query(3, ts, te, mode=mode) for ts, te in wins]
    one = max(_edge_bytes(free, ts, te) for ts, te in wins)
    monkeypatch.setattr(otcd, "_WINDOW_CACHE_BYTES", entries * one)
    eng = TCQEngine(g, device="cpu")
    for i, (ts, te) in enumerate(wins):
        got = eng.query(3, ts, te, mode=mode)
        assert _digest(got) == _digest(want[i]), (ts, te)
        st = eng.stats()["window_tel"]
        assert st["misses"] == i + 1 and st["hits"] == 0
        assert st["size"] >= 1
        assert st["size"] == 1 or st["bytes"] <= entries * one
        assert st["evictions"] == st["misses"] - st["size"]
        assert st["bytes"] == sum(w.nbytes for w in eng._win_cache.values())
    assert eng.stats()["window_tel"]["evictions"] > 0
    assert free.stats()["window_tel"]["evictions"] == 0
    assert free.stats()["window_tel"]["size"] == len(wins)


def test_newest_entry_stays_and_hits_as_before(monkeypatch):
    """At a budget of 0 the LRU keeps its newest entry alone, which the
    same window then hits; the entry's bytes are its edge columns."""
    g = _graph()
    monkeypatch.setattr(otcd, "_WINDOW_CACHE_BYTES", 0)
    eng = TCQEngine(g, device="cpu")
    (a, b), (c, d) = _windows(2)
    eng.query(3, a, b)
    eng.query(3, c, d)
    uts = g.unique_ts
    lo, hi = (int(x) for x in uts[(uts >= c) & (uts <= d)][[0, -1]])
    st = eng.stats()["window_tel"]
    assert (st["size"], st["evictions"]) == (1, 1)
    assert st["bytes"] == _edge_bytes(eng, lo, hi)
    eng.query(4, c, d)
    st = eng.stats()["window_tel"]
    assert (st["hits"], st["misses"], st["size"]) == (1, 2, 1)


def test_whole_window_pins_no_bytes():
    """A window that holds every edge is the engine's whole TEL: its entry
    pins nothing more."""
    g = _graph()
    eng = TCQEngine(g, device="cpu")
    eng.query(3, *g.span)
    st = eng.stats()["window_tel"]
    assert (st["size"], st["bytes"]) == (1, 0)


def test_entry_cap_still_holds_under_the_byte_budget(monkeypatch):
    """A budget no entry reaches leaves the entry cap to evict."""
    monkeypatch.setattr(otcd, "_WINDOW_CACHE_MAX", 5)
    monkeypatch.setattr(otcd, "_WINDOW_CACHE_BYTES", 1 << 40)
    g = _graph()
    eng = TCQEngine(g, device="cpu")
    for ts, te in _windows(8):
        eng.query(3, ts, te)
    st = eng.stats()["window_tel"]
    assert (st["size"], st["evictions"], st["misses"]) == (5, 3, 8)


def test_default_budget_keeps_sx_sized_entries():
    """2 GiB holds the entry cap's 64 windows at sx-mathoverflow's size
    (at most 2^19 edges, 240,310 pairs, 24,818 vertices) and one at
    sx-stackoverflow's (2^26 edges, 36,275,040 pairs, 2,601,977 vertices,
    1,229,249,900 bytes on the card)."""
    def entry(edges, pairs, verts):
        return 16 * edges + 4 * (pairs + 1 + verts + 1)

    assert otcd._WINDOW_CACHE_BYTES == 2 << 30
    assert entry(2**26, 36_275_040, 2_601_977) == 1_229_249_900
    assert 64 * entry(2**19, 240_310, 24_818) < otcd._WINDOW_CACHE_BYTES \
        < 2 * entry(2**26, 36_275_040, 2_601_977)


# ------------------------------------------- the half-pair counters
def _counting_steps(monkeypatch, scanned, kept):
    """Every window step built from here on reports ``kept`` half-pairs
    kept in each lane of ``scanned`` walked, as the global tier does."""
    real = otcd.make_wave_step_fn

    def build(*a, **kw):
        inner = real(*a, **kw)

        def step(alive, *args):
            r = inner(alive, *args)
            return r._replace(hp_kept=torch.full((alive.shape[0],), kept,
                                                 dtype=torch.int32),
                              hp_scanned=scanned)

        step.backend = inner.backend
        return step

    monkeypatch.setattr(otcd, "make_wave_step_fn", build)


REQS = [{"k": 3, "ts": 5, "te": 40}, {"k": 2, "ts": 30, "te": 70},
        {"k": 4, "ts": 60, "te": 110, "h": 2}]


def test_pool_counts_each_lane_for_its_query(monkeypatch):
    """Each lane a query's cell took adds the step's walk to the query's
    ``hp_scanned`` and the lane's count to its ``hp_kept``; answers and
    every other counter are the uncounted engine's."""
    g = _graph()
    want = TCQEngine(g, device="cpu").query_batch(REQS, wave=4)
    _counting_steps(monkeypatch, scanned=1000, kept=7)
    got = TCQEngine(g, device="cpu").query_batch(REQS, wave=4)
    same = [i for i, f in enumerate(COUNTERS)
            if f not in ("bytes_synced", "hp_scanned", "hp_kept")]
    for a, b in zip(got, want):
        assert _digest(a)[0] == _digest(b)[0]
        assert [_digest(a)[1][i] for i in same] == \
            [_digest(b)[1][i] for i in same]
        # the counts come back with the step's other scalars
        assert a.stats.bytes_synced == \
            b.stats.bytes_synced + 4 * 4 * a.stats.device_steps
        cells = a.stats.cells_evaluated
        assert cells > 0
        assert a.stats.hp_scanned == 1000 * cells
        assert a.stats.hp_kept == 7 * cells
        assert b.stats.hp_scanned == b.stats.hp_kept == 0


def test_recorder_counts_every_lane_while_armed(monkeypatch):
    """Armed, the recorder adds the whole wave's walk and every lane's
    count each step; disarmed, it counts nothing."""
    g = _graph()
    _counting_steps(monkeypatch, scanned=1000, kept=7)
    trace.clear()
    try:
        TCQEngine(g, device="cpu").query_batch(REQS)
        assert trace.counters() == {}
        eng = TCQEngine(g, device="cpu")
        with profile(activities=[ProfilerActivity.CPU]):
            res = eng.query_batch(REQS, wave=4)
        steps = res[0].stats.device_steps
        assert trace.counters() == {"wave.hp_scanned": 4 * 1000 * steps,
                                    "wave.hp_kept": 4 * 7 * steps}
    finally:
        trace.clear()
