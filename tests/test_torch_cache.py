"""The port's TTI core cache against the JAX package's.

Each case of tests/test_cache.py runs through both packages on the same
graph (the port's built with ``from_state`` from the reference's
``state_dict``; the port on the CPU, ``device="cpu"``): every result
must equal the same package's cache-free engine, the two packages must
return the same cores, and their cache counters (hits, dominance hits,
misses, inserts, invalidations, evictions, sizes) must be equal — the
port's cache makes the same decisions, not merely the same answers.
Snapshots carry the cache across packages in both directions.
"""

import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as J  # noqa: E402
import repro_torch.core as P  # noqa: E402

SEEDS = list(range(3))
PKGS = ("jax", "torch")


def random_graph(seed, n_v=20, n_e=140, max_t=16):
    rng = np.random.default_rng(seed)
    return J.TemporalGraph.from_edges(rng.integers(0, n_v, n_e),
                                      rng.integers(0, n_v, n_e),
                                      rng.integers(1, max_t + 1, n_e), n_v)


def random_windows(rng, uts, n):
    """Overlapping windows with deliberate repeats and sub-windows
    (tests/test_cache.py's draws)."""
    lo, hi = int(uts[0]), int(uts[-1])
    wins = []
    while len(wins) < n:
        a, b = sorted(rng.integers(lo, hi + 1, size=2).tolist())
        wins.append((int(a), int(b)))
        if len(wins) < n and rng.random() < 0.4:
            wins.append((int(a), int(b)))
        if len(wins) < n and b - a > 2 and rng.random() < 0.4:
            m = int(rng.integers(a, b))
            wins.append((int(m), int(b)))
    return wins[:n]


def graph_for(pkg, g):
    return g if pkg == "jax" else P.TemporalGraph.from_state(g.state_dict())


def engine(pkg, g, **kw):
    if pkg == "jax":
        return J.TCQEngine(g, use_kernel=False, **kw)
    return P.TCQEngine(graph_for(pkg, g), device="cpu", use_kernel=False,
                       **kw)


def service(pkg, g, **kw):
    if pkg == "jax":
        return J.TCQService(g, use_kernel=False, **kw)
    return P.TCQService(graph_for(pkg, g), device="cpu", use_kernel=False,
                        **kw)


def load_snapshot(pkg, buf, **kw):
    if pkg == "jax":
        return J.TCQService.load_snapshot(buf, use_kernel=False, **kw)
    return P.TCQService.load_snapshot(buf, device="cpu", use_kernel=False,
                                      **kw)


def digest(res):
    return sorted((k, tuple(c.vertices.tolist()), int(c.n_edges))
                  for k, c in res.by_tti().items())


def assert_same(got, want, ctx=""):
    assert digest(got) == digest(want), ctx


def cache_counters(stats):
    return {k: v for k, v in stats.items() if k != "hit_rate"}


# ------------------------------------------------ cached == recomputed fuzz
def _cached_vs_recomputed(pkg, seed):
    g = random_graph(seed)
    rng = np.random.default_rng(100 + seed)
    cached = engine(pkg, g, cache=True)
    plain = engine(pkg, g)
    k = int(rng.integers(2, 4))
    out = []
    for a, b in random_windows(rng, g.unique_ts, 14):
        got = cached.query(k, a, b, mode="wave")
        want = plain.query(k, a, b, mode="wave")
        assert_same(got, want, f"{pkg} seed={seed} k={k} [{a},{b}]")
        out.append((digest(got), got.stats.cells_cached,
                    got.stats.cells_evaluated))
    st = cached.core_cache.stats()
    assert st["hits"] + st["dominance_hits"] > 0
    assert plain.core_cache is None                # bare default stays off
    return out, cache_counters(st)


@pytest.mark.parametrize("seed", SEEDS)
def test_cached_matches_recomputed(seed):
    ref, port = (_cached_vs_recomputed(pkg, seed) for pkg in PKGS)
    assert port == ref


# ------------------------------------- ingest invalidation == cold rebuild
def _ingest(pkg, seed):
    g = random_graph(seed, n_e=120)
    rng = np.random.default_rng(200 + seed)
    svc = service(pkg, g, cache=True)
    uts = g.unique_ts
    wins = random_windows(rng, uts, 6)
    k = int(rng.integers(2, 4))
    out = []
    for epoch in range(3):
        tks = [svc.submit({"k": k, "ts": a, "te": b}) for a, b in wins]
        svc.run_until_idle()
        cold = engine(pkg, J.TemporalGraph.from_state(
            svc.graph.state_dict()))
        for tk, (a, b) in zip(tks, wins):
            assert_same(tk.result, cold.query(k, a, b, mode="wave"),
                        f"{pkg} seed={seed} epoch={epoch} [{a},{b}]")
            out.append((tk.id, tk.epoch, digest(tk.result),
                        tk.result.stats.cells_cached,
                        tk.result.stats.cells_evaluated))
        n = 18
        svc.push_edges(rng.integers(0, g.num_vertices, n),
                       rng.integers(0, g.num_vertices, n),
                       rng.integers(int(uts[0]), int(uts[-1]) + 1, n))
    cc = svc.stats["core_cache"]
    assert cc["invalidated"] > 0
    assert svc.epoch == 3
    return out, cache_counters(cc)


@pytest.mark.parametrize("seed", SEEDS)
def test_ingest_invalidation_matches_cold_rebuild(seed):
    ref, port = (_ingest(pkg, seed) for pkg in PKGS)
    assert port == ref


# ------------------------------------------------------- oracle cross-check
@pytest.mark.parametrize("seed", SEEDS)
def test_cached_ttis_match_oracle(seed):
    g = random_graph(seed, n_v=12, n_e=60, max_t=8)
    eng = engine("torch", g, cache=True)
    uts = g.unique_ts
    a, b = int(uts[0]), int(uts[-1])
    want = J.brute_force_query(g, 2, a, b)
    for _ in range(2):                             # second pass: cache-served
        got = eng.query(2, a, b, mode="wave")
        assert got.by_tti().keys() == want.keys()
        for key, core in got.by_tti().items():
            assert frozenset(core.vertices.tolist()) == \
                want[key]["vertices"], key
            assert core.n_edges == want[key]["n_edges"], key
    assert got.stats.cells_evaluated == 0 and got.stats.cells_cached > 0
    st = eng.core_cache.stats()
    assert st["hits"] + st["dominance_hits"] > 0


# ------------------------------------------------- eviction under pressure
def _eviction(pkg, seed):
    g = random_graph(seed)
    rng = np.random.default_rng(300 + seed)
    tiny = (J if pkg == "jax" else P).CoreCache(max_bytes=256, max_cells=6)
    cached = engine(pkg, g, cache=tiny)
    plain = engine(pkg, g)
    out = []
    for a, b in random_windows(rng, g.unique_ts, 16):
        got = cached.query(2, a, b, mode="wave")
        assert_same(got, plain.query(2, a, b, mode="wave"),
                    f"{pkg} seed={seed} [{a},{b}]")
        out.append(digest(got))
    st = tiny.stats()
    assert st["evicted_cores"] + st["evicted_cells"] > 0
    assert st["bytes"] <= 256 and st["n_cells"] <= 6
    return out, cache_counters(st)


@pytest.mark.parametrize("seed", SEEDS)
def test_eviction_under_pressure_stays_correct(seed):
    ref, port = (_eviction(pkg, seed) for pkg in PKGS)
    assert port == ref


# ------------------------------------------------ snapshot/restore round-trip
@pytest.mark.parametrize("src,dst", [("torch", "torch"), ("jax", "torch"),
                                     ("torch", "jax")])
def test_snapshot_restores_warm_cache(src, dst):
    """A warm cache survives save_snapshot/load_snapshot, also from one
    package to the other: restored repeats are cache-served, equal."""
    g = random_graph(7)
    rng = np.random.default_rng(7)
    svc = service(src, g, cache=True)
    wins = random_windows(rng, g.unique_ts, 6)
    tks = [svc.submit({"k": 2, "ts": a, "te": b}) for a, b in wins]
    svc.run_until_idle()
    n_cores = svc.stats["core_cache"]["n_cores"]
    assert n_cores > 0

    buf = io.BytesIO()
    svc.save_snapshot(buf)
    buf.seek(0)
    svc2 = load_snapshot(dst, buf, cache=True)
    cc2 = svc2.engine.core_cache
    assert cc2.stats()["n_cores"] == n_cores
    assert cc2.stats()["n_cells"] == svc.stats["core_cache"]["n_cells"]
    tks2 = [svc2.submit({"k": 2, "ts": a, "te": b}) for a, b in wins]
    svc2.run_until_idle()
    for tk, tk2 in zip(tks, tks2):
        assert_same(tk2.result, tk.result, f"[{tk.ts},{tk.te}]")
        assert tk2.result.stats.cells_cached > 0
        assert tk2.result.stats.cells_evaluated == 0


@pytest.mark.parametrize("src", PKGS)
def test_snapshot_restore_without_cache_drops_cleanly(src):
    g = random_graph(9)
    span = {"k": 2, "ts": int(g.unique_ts[0]), "te": int(g.unique_ts[-1])}
    svc = service(src, g, cache=True)
    svc.submit(span)
    svc.run_until_idle()
    buf = io.BytesIO()
    svc.save_snapshot(buf)
    buf.seek(0)
    svc2 = load_snapshot("torch", buf, cache=False)
    assert svc2.engine.core_cache is None          # state dropped, no error
    tk = svc2.submit(span)
    svc2.run_until_idle()
    want = J.TCQEngine(g, use_kernel=False).query(
        2, span["ts"], span["te"], mode="wave")
    assert_same(tk.result, want)


# ----------------------------------------------------- CoreCache unit seams
def _dominance(cc):
    row = np.asarray([0b101], dtype=np.uint32)
    cc.insert(0, 2, 1, ts=2, te=12, lo=5, hi=9, n_edges=4, packed=row)
    hit = cc.lookup(0, 2, 1, 4, 10)
    assert hit is not None and (hit.tti_lo, hit.tti_hi) == (5, 9)
    assert np.array_equal(hit.packed, row)
    assert cc.lookup(0, 2, 1, 6, 10) is None       # a > lo: not dominated
    cc.insert_empty(0, 2, 1, 20, 30)
    empty = cc.lookup(0, 2, 1, 22, 28)             # sub-window of empty
    assert empty is not None and empty.n_edges == 0 and empty.packed is None
    assert cc.lookup(0, 3, 1, 4, 10) is None       # other k: separate group
    return cc.stats(), cc.state_dict()


def test_dominance_and_empty_cells():
    (s_ref, d_ref), (s_port, d_port) = (_dominance(J.CoreCache()),
                                        _dominance(P.CoreCache()))
    assert s_port == s_ref
    assert d_port.keys() == d_ref.keys()
    for name in d_ref:
        assert d_port[name].dtype == d_ref[name].dtype, name
        assert np.array_equal(d_port[name], d_ref[name]), name


def _advance(cc):
    row = np.asarray([0b11], dtype=np.uint32)
    cc.insert(0, 2, 1, ts=0, te=10, lo=2, hi=8, n_edges=3, packed=row)
    cc.insert(0, 2, 1, ts=40, te=50, lo=42, hi=48, n_edges=3, packed=row)
    inv, rek = cc.advance_epoch(0, 1, batch_lo=5, batch_hi=6)
    assert inv > 0 and rek > 0
    assert cc.lookup(1, 2, 1, 0, 10) is None       # window hit batch: gone
    hit = cc.lookup(1, 2, 1, 40, 50)               # disjoint: re-keyed
    assert hit is not None and (hit.tti_lo, hit.tti_hi) == (42, 48)
    assert cc.lookup(0, 2, 1, 40, 50) is None      # moved, not copied
    return (inv, rek), cc.stats()


def test_advance_epoch_window_vs_tti_invalidation():
    assert _advance(P.CoreCache()) == _advance(J.CoreCache())


def _fuzz_ops(seed, n=3000):
    """A seeded stream of cache operations whose outcomes obey Property 2
    (each window's core is a fixed function of the window): inserts of
    both kinds, lookups of windows and sub-windows, epoch advances and
    retirements, under byte and cell caps that force evictions."""
    rng = np.random.default_rng(seed)
    span = 60

    def core_of(epoch, k, ts, te):
        # a deterministic TTI inside the window, empty for some windows
        r = np.random.default_rng([seed, epoch, k, ts, te])
        if te - ts < 3 or r.random() < 0.2:
            return None
        lo = ts + int(r.integers(0, (te - ts) // 2 + 1))
        hi = te - int(r.integers(0, (te - lo) // 2 + 1))
        return lo, hi

    ops, epoch = [], 0
    for _ in range(n):
        x = rng.random()
        k = int(rng.integers(2, 4))
        ts, te = sorted(rng.integers(0, span, 2).tolist())
        if x < 0.45:
            tti = core_of(epoch, k, ts, te)
            if tti is None:
                ops.append(("insert_empty", epoch, k, 1, ts, te))
            else:
                # the core over [ts, te] is the core over its TTI
                lo, hi = tti
                row = np.asarray([lo * 64 + hi], dtype=np.uint32)
                ops.append(("insert", epoch, k, 1, ts, te, lo, hi,
                            hi - lo + 1, row))
        elif x < 0.97:
            ops.append(("lookup", epoch, k, 1, ts, te))
        elif x < 0.99:
            lo = int(rng.integers(0, span))
            ops.append(("advance", epoch, epoch + 1, lo, lo + 3))
            epoch += 1
        else:
            ops.append(("retire", [epoch]))
    return ops


def _apply(cache, ops):
    out = []
    for op in ops:
        if op[0] == "insert":
            cache.insert(*op[1:6], lo=op[6], hi=op[7], n_edges=op[8],
                         packed=op[9])
        elif op[0] == "insert_empty":
            cache.insert_empty(*op[1:])
        elif op[0] == "lookup":
            hit = cache.lookup(*op[1:])
            out.append(None if hit is None else
                       (hit.tti_lo, hit.tti_hi, hit.n_edges,
                        None if hit.packed is None
                        else hit.packed.tolist()))
        elif op[0] == "advance":
            out.append(cache.advance_epoch(*op[1:]))
        else:
            cache.retire_epochs(op[1])
    return out, cache.stats(), cache.state_dict()


@pytest.mark.parametrize("caps", [(1 << 20, 1 << 16), (96, 40)],
                         ids=["roomy", "tight"])
@pytest.mark.parametrize("seed", SEEDS)
def test_cache_operation_stream_matches_reference(seed, caps):
    """The port's cache (numpy dominance index) against the JAX package's
    (Python scan) on one stream of operations: every lookup, every
    advance, the counters and the persisted state equal."""
    ops = _fuzz_ops(seed)
    (o_ref, s_ref, d_ref), (o_port, s_port, d_port) = (
        _apply(pkg.CoreCache(*caps), ops) for pkg in (J, P))
    assert o_port == o_ref
    assert s_port == s_ref
    assert s_ref["dominance_hits"] > 0
    for name in d_ref:
        assert np.array_equal(d_port[name], d_ref[name]), name
