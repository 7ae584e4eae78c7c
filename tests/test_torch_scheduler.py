"""The port's pruning state (``scheduler.PrunedRows``) and its counters.

``PrunedRows`` keeps the cells Rules 1–3 prune as runs of rows that share
one interval set.  Here it is held to a per-row ``IntervalSet`` oracle
over seeded sequences of rule applications (each application's newly
covered count, the cursor query at every row and column, the total
covered), its pruning counters are held to the JAX package's on the
engine's paths, and a long window shows that a rule costs runs, not rows.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import TCQEngine as JEngine  # noqa: E402
from repro_torch.core import TCQEngine, TemporalGraph  # noqa: E402
from repro_torch.core.intervals import IntervalSet  # noqa: E402
from repro_torch.core.results import QueryStats  # noqa: E402
from repro_torch.core.scheduler import PrunedRows, QueryState  # noqa: E402
from test_torch_engine import GRAPHS  # noqa: E402

PRUNE_COUNTERS = ("pruned_por", "pruned_pou", "pruned_pol", "por_triggers",
                  "pou_triggers", "pol_triggers", "duplicates",
                  "cells_evaluated")


# ------------------------------------------------------------------ oracle
class RowOracle:
    """One ``IntervalSet`` a row, each rule applied row by row (the
    scheduler's pruning state before it kept runs)."""

    def __init__(self, n):
        self.n = n
        self.rows = [IntervalSet() for _ in range(n)]

    def prune(self, p, q, lo, hi):
        new = sum(self.rows[r].add(max(lo, r), hi) for r in range(p, q + 1))
        return new, q - p + 1

    def highest_uncovered_leq(self, r, x):
        y = self.rows[r].highest_uncovered_leq(x)
        return r - 1 if y is None or y < r else y

    def total(self):
        return sum(s.total_covered(0, self.n - 1) for s in self.rows)


def map_total(pr):
    """Cells the map holds, summed row by row from its runs."""
    ends = pr._starts[1:] + [pr.n]
    total = 0
    for s, e, bounds in zip(pr._starts, ends, pr._sets):
        for r in range(s, e):
            total += sum(max(0, b - max(a, r))
                         for a, b in zip(bounds[::2], bounds[1::2]))
    return total


def check_same(pr, oracle):
    n = pr.n
    for r in range(n):
        for x in range(r - 1, n):
            assert pr.highest_uncovered_leq(r, x) == \
                oracle.highest_uncovered_leq(r, x), (r, x)
    assert map_total(pr) == oracle.total()
    # runs are maximal: no two neighbours share a set
    assert all(a != b for a, b in zip(pr._sets, pr._sets[1:]))
    assert pr._starts[0] == 0 and pr._starts == sorted(set(pr._starts))


def apply_both(pr, oracle, p, q, lo, hi):
    got, runs = pr.prune(p, q, lo, hi)
    want, _ = oracle.prune(p, q, lo, hi)
    assert got == want, (p, q, lo, hi)
    assert 1 <= runs <= q - p + 1
    check_same(pr, oracle)
    return runs


def apply_rules(pr, oracle, i, j, a, b):
    """Rules 1-3 of cell (i, j) whose core's TTI is [a, b]
    (i <= a <= b <= j), in ``QueryState._feedback``'s order."""
    if b < j:
        apply_both(pr, oracle, i, i, b, j - 1)
    if a > i:
        apply_both(pr, oracle, i + 1, a, i + 1, j)
    if a > i and b < j and b > a:
        apply_both(pr, oracle, a + 1, b, b + 1, j)


# --------------------------------------------------------- structure tests
@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("n", [1, 2, 7, 23])
def test_random_rule_sequences_match_per_row_sets(n, seed):
    rng = np.random.default_rng(1000 * n + seed)
    pr, oracle = PrunedRows(n), RowOracle(n)
    check_same(pr, oracle)
    for _ in range(40):
        i, j = sorted(rng.integers(0, n, 2).tolist())
        a, b = sorted(rng.integers(i, j + 1, 2).tolist())
        apply_rules(pr, oracle, i, j, a, b)


@pytest.mark.parametrize("seed", range(4))
def test_random_ranges_of_each_shape(seed):
    """Prefix ranges (lo <= p, Rule 2 from row 0 included) and plain ones
    (lo >= q, one-row ranges and ranges ending at n - 1 included)."""
    n = 19
    rng = np.random.default_rng(seed)
    pr, oracle = PrunedRows(n), RowOracle(n)
    for _ in range(60):
        p, q = sorted(rng.integers(0, n, 2).tolist())
        if rng.random() < 0.3:
            q = n - 1
        if rng.random() < 0.3:
            q = p
        if rng.random() < 0.5:
            lo, hi = int(rng.integers(0, p + 1)), int(rng.integers(q, n))
        else:
            lo = int(rng.integers(q, n))
            hi = int(rng.integers(lo, n))
        apply_both(pr, oracle, p, q, lo, hi)


def test_rule_two_from_row_zero_and_one_row_ranges():
    n = 9
    pr, oracle = PrunedRows(n), RowOracle(n)
    apply_both(pr, oracle, 0, 4, 0, 6)             # rows 0..4 prefix to 6
    assert pr._starts == [0, 5]
    apply_both(pr, oracle, 3, 3, 3, 8)             # one-row prefix
    apply_both(pr, oracle, 7, 7, 7, 7)             # one row, one cell
    apply_both(pr, oracle, 8, 8, 8, 8)             # the last row
    apply_both(pr, oracle, 5, 5, 6, 8)             # one-row plain interval


def test_ranges_ending_at_the_last_row():
    n = 12
    pr, oracle = PrunedRows(n), RowOracle(n)
    apply_both(pr, oracle, 4, n - 1, 4, n - 1)
    assert pr.highest_uncovered_leq(n - 1, n - 1) == n - 2
    apply_both(pr, oracle, 0, n - 1, 0, n - 1)      # every cell
    assert pr._starts == [0] and map_total(pr) == n * (n + 1) // 2
    assert apply_both(pr, oracle, 2, n - 1, 2, n - 1) == 1


def test_runs_re_merge():
    n = 16
    pr, oracle = PrunedRows(n), RowOracle(n)
    apply_both(pr, oracle, 3, 6, 9, 11)
    assert pr._starts == [0, 3, 7]
    apply_both(pr, oracle, 0, 2, 9, 11)
    assert pr._starts == [0, 7]
    apply_both(pr, oracle, 7, 8, 9, 11)
    assert pr._starts == [0, 9]
    # a prefix that reaches past the plain interval gives one set again
    apply_both(pr, oracle, 0, 8, 0, 12)
    assert pr._starts == [0, 9] and pr._sets[0] == (0, 13)


def test_one_row():
    pr, oracle = PrunedRows(1), RowOracle(1)
    assert pr.highest_uncovered_leq(0, 0) == 0
    assert apply_both(pr, oracle, 0, 0, 0, 0) == 1
    assert pr.highest_uncovered_leq(0, 0) == -1
    assert pr.prune(0, 0, 0, 0) == (0, 1)


def test_a_shared_set_that_one_run_then_changes():
    """A split leaves the pieces of a run holding one set; a change to the
    middle piece leaves the outer pieces' cells as they were."""
    n = 20
    pr, oracle = PrunedRows(n), RowOracle(n)
    apply_both(pr, oracle, 2, 12, 13, 15)
    shared = pr._sets[1]
    apply_both(pr, oracle, 6, 8, 9, 17)              # inside the run
    assert pr._starts == [0, 2, 6, 9, 13]
    assert pr._sets[1] is shared and pr._sets[3] is shared
    assert pr._sets[1] == (13, 16) and pr._sets[2] == (9, 18)
    apply_both(pr, oracle, 9, 12, 14, 19)            # the right piece
    assert pr._sets[1] == (13, 16)


# ------------------------------------- counters against the JAX package
_engines = {}


def _engines_for(name, **kw):
    key = (name, tuple(sorted(kw)))
    if key not in _engines:
        g = GRAPHS[name]()
        _engines[key] = (JEngine(g, **kw), TCQEngine(
            TemporalGraph.from_state(g.state_dict()), device="cpu", **kw))
    return _engines[key]


def assert_same_pruning(got, want, ctx=""):
    for f in PRUNE_COUNTERS:
        assert getattr(got.stats, f) == getattr(want.stats, f), (ctx, f)
    assert got.by_tti().keys() == want.by_tti().keys(), ctx


@pytest.mark.parametrize("mode", ["serial", "wave"])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_pruning_counters_match_reference(name, mode):
    je, te = _engines_for(name)
    Ts, Te = je.graph.span
    for k, h in ((2, 1), (3, 2)):
        want = je.query(k, Ts, Te, h=h, mode=mode)
        got = te.query(k, Ts, Te, h=h, mode=mode)
        assert_same_pruning(got, want, f"{name} {mode} k={k} h={h}")
        if mode == "wave":
            assert got.stats.rule_runs <= got.stats.rule_rows


@pytest.mark.parametrize("wave,depth", [(1, 1), (3, 2), (5, 3), (16, 1),
                                        ("auto", 2), ("auto", 3)])
def test_wave_pruning_counters_match_reference(wave, depth):
    je, te = _engines_for("planted")
    want = je.query(3, 1, 40, mode="wave", wave=wave, depth=depth)
    got = te.query(3, 1, 40, mode="wave", wave=wave, depth=depth)
    assert_same_pruning(got, want, f"wave={wave} depth={depth}")
    assert want.stats.pruned_total > 0


def _mixed_requests(graph):
    Ts, Te = graph.span
    mid = (Ts + Te) // 2
    return [{"k": 2, "ts": Ts, "te": Te}, {"k": 3, "ts": Ts + 2, "te": mid},
            {"k": 2, "ts": mid, "te": Te, "h": 2},
            {"k": 4, "ts": Te + 5, "te": Te + 9}]     # empty window


@pytest.mark.parametrize("name", ["planted", "powerlaw"])
def test_query_batch_pruning_counters_match_reference(name):
    je, te = _engines_for(name)
    reqs = _mixed_requests(je.graph)
    for i, (got, want) in enumerate(zip(te.query_batch(reqs, depth=3),
                                        je.query_batch(reqs, depth=3))):
        assert_same_pruning(got, want, f"request {i}")


@pytest.mark.parametrize("name", ["planted", "powerlaw"])
def test_cached_second_pass_pruning_counters_match_reference(name):
    """With a core cache attached, the pool's second pass feeds cache hits
    through the same feedback: the same pruning as the JAX package's."""
    je, te = _engines_for(name, cache=True)
    reqs = _mixed_requests(je.graph)[:3]
    for rnd in range(2):
        wants = je.query_batch(reqs)
        gots = te.query_batch(reqs)
        for i, (got, want) in enumerate(zip(gots, wants)):
            assert_same_pruning(got, want, f"pass {rnd} request {i}")
            assert got.stats.cells_cached == want.stats.cells_cached
    assert sum(g.stats.cells_cached for g in gots) > 0


# ---------------------------------------------------------------- engagement
def _planted_tti(starts, ends, i, j):
    """TTI of window [i, j]: the hull of the planted intervals inside it,
    or None (an empty cell).  Nested windows give nested TTIs, as OTCD's
    cores do."""
    inside = (starts >= i) & (ends <= j)
    if not inside.any():
        return None
    return int(starts[inside].min()), int(ends[inside].max())


def _drive(state, starts, ends, lanes=4):
    """Claim and retire cells as a pool of ``lanes`` lanes would; returns
    the cells evaluated in order."""
    live, cells = [], []
    while True:
        while len(live) < lanes:
            row = state.claim()
            if row is None:
                break
            live.append(row)
        if not live:
            return cells
        row = live.pop(0)
        cells.append((row.i, row.j))
        tti = _planted_tti(starts, ends, row.i, row.j)
        if tti is None:
            keep = state.retire(row, 0, 0, 0, None, lambda: None)
        else:
            keep = state.retire(row, tti[0], tti[1], 1,
                                np.zeros(1, np.uint32), lambda: None)
        if keep:
            live.append(row)


def test_long_window_prunes_runs_not_rows():
    """A window of 4,096 rows whose cores span hundreds to thousands of
    timestamps (tcq-youtube's shape): Rules 2 and 3 cover long row
    ranges, which the map prunes in few runs, with the per-row oracle's
    cells, counters and cursors."""
    n = 4096
    rng = np.random.default_rng(30)
    lens = rng.integers(200, 3000, 40)
    starts = rng.integers(0, n - lens)
    ends = starts + lens
    uts = np.arange(n, dtype=np.int64)

    got = QueryState(uts, 10, 1, True, QueryStats())
    want = QueryState(uts, 10, 1, True, QueryStats())
    want.pruned = RowOracle(n)
    cells = _drive(got, starts, ends)
    assert cells == _drive(want, starts, ends)
    for f in PRUNE_COUNTERS:
        assert getattr(got.stats, f) == getattr(want.stats, f), f
    assert got.collected.keys() == want.collected.keys()
    st = got.stats
    # the oracle's runs are its rows
    assert st.rule_rows == want.stats.rule_runs
    assert st.rule_rows > 10 * n
    assert st.rule_runs <= st.rule_rows / 50, (st.rule_rows, st.rule_runs)
