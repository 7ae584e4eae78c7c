"""The reference OTCD against a brute force over every subinterval, and
against the program on the CPU."""

import numpy as np
import pytest

from tcqbench.gen import powerlaw_edges
from tcqbench.reference.otcd import EdgeList, _Cover, otcd
from tcqbench.tests.tiny import one_thread  # noqa: F401  (autouse)


def brute(u, v, t, k, ts, te, h=1):
    """Every window [a, b] of the range's timestamps peeled from scratch,
    the cores keyed by TTI (numpy, written apart from the reference)."""
    keep = u != v
    u, v, t = u[keep], v[keep], t[keep]
    lo, hi = np.minimum(u, v), np.maximum(u, v)
    nv = int(max(lo.max(), hi.max())) + 1
    _, pid = np.unique(lo * nv + hi, return_inverse=True)
    uts = np.unique(t[(t >= ts) & (t <= te)])
    out = {}
    for i, a in enumerate(uts):
        for b in uts[i:]:
            win = (t >= a) & (t <= b)
            alive = np.ones(nv, bool)
            while True:
                ea = win & alive[lo] & alive[hi]
                cnt = np.bincount(pid[ea], minlength=pid.max() + 1)
                act = cnt >= h
                pu = np.zeros(pid.max() + 1, np.int64)
                pv = np.zeros(pid.max() + 1, np.int64)
                pu[pid], pv[pid] = lo, hi
                deg = (np.bincount(pu[act], minlength=nv)
                       + np.bincount(pv[act], minlength=nv))
                new = alive & (deg >= k)
                if np.array_equal(new, alive):
                    break
                alive = new
            ea = win & alive[lo] & alive[hi]
            if ea.any():
                key = (int(t[ea].min()), int(t[ea].max()))
                verts = np.flatnonzero(alive)
                if key in out:
                    assert np.array_equal(out[key][0], verts)
                out[key] = (verts, int(ea.sum()))
    return out


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("k,h", [(2, 1), (3, 1), (4, 1), (2, 2)])
def test_reference_equals_brute_force(seed, k, h):
    u, v, t = powerlaw_edges(50, 500, 30, burst_periods=3, seed=seed)
    el = EdgeList(u, v, t)
    for ts, te in ((1, 30), (4, 21)):
        want = brute(u, v, t, k, ts, te, h)
        got = otcd(el, k, ts, te, h=h)
        assert got.keys() == want.keys()
        for key, (verts, ne) in want.items():
            assert np.array_equal(got[key][0], verts)
            assert got[key][1] == ne


def test_reference_equals_program_on_cpu():
    from repro_torch.core import TCQEngine, TemporalGraph

    u, v, t = powerlaw_edges(600, 12_000, 200, burst_periods=14, seed=3)
    eng = TCQEngine(TemporalGraph.from_edges(u, v, t, 600), device="cpu")
    el = EdgeList(u, v, t)
    reqs = [{"k": 3, "ts": 10, "te": 40}, {"k": 4, "ts": 90, "te": 120}]
    for r, res in zip(reqs, eng.query_batch(reqs)):
        want = otcd(el, r["k"], r["ts"], r["te"])
        assert {c.tti: (list(c.vertices), c.n_edges) for c in res.cores} \
            == {key: (list(vs), ne) for key, (vs, ne) in want.items()}
        assert want


def test_capped_peel_differs():
    u, v, t = powerlaw_edges(600, 12_000, 200, burst_periods=14, seed=3)
    el = EdgeList(u, v, t)
    assert otcd(el, 4, 10, 60, max_iters=2).keys() != \
        otcd(el, 4, 10, 60).keys() or any(
            not np.array_equal(a[0], b[0]) for a, b in zip(
                otcd(el, 4, 10, 60, max_iters=2).values(),
                otcd(el, 4, 10, 60).values()))


def test_cover_merges_and_finds_free_columns():
    c = _Cover()
    c.add(5, 7)
    c.add(9, 12)
    c.add(8, 8)
    assert (c.lo, c.hi) == ([5], [12])
    assert c.free_at_or_below(10) == 4
    assert c.free_at_or_below(13) == 13
    c.add(1, 2)
    assert c.free_at_or_below(2) == 0
