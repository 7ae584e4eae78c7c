"""The port's streaming service and degradation ladder against the JAX
package's.

The service cases of tests/test_streaming.py and the ladder and service
cases of tests/test_resilience.py run through both packages on the same
graphs (the port's built with ``from_state``; the port on the CPU, where
its kernels run their plain versions).  Rungs carry the port's names:
the JAX package's ``"pallas"``/``"xla"``/``"oracle"`` are ``"fused"``/
``"composite"``/``"oracle"`` here.  Beyond each case's own assertions,
the two packages' drains must be equal ticket for ticket: ids, statuses,
pinned epochs, every core's vertex set, TTI and edge count, and the
schedule counters.  Tapes are poll-driven and deadline-free (or set
deadlines explicitly), so nothing compares wall-clock outcomes.
"""

import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as J  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro.core import faultinject as jfault  # noqa: E402
from repro.core import wave as jwave  # noqa: E402
from repro_torch.core import faultinject as pfault  # noqa: E402
from repro_torch.core import wave as pwave  # noqa: E402

PKGS = ("jax", "torch")
COUNTERS = ("cells_evaluated", "cells_cached", "duplicates", "peel_iters",
            "device_steps", "lane_refills")
RUNG = {"pallas": "fused", "xla": "composite", "oracle": "oracle"}


def random_graph(seed, n_v=20, n_e=140, max_t=16):
    rng = np.random.default_rng(seed)
    return J.TemporalGraph.from_edges(rng.integers(0, n_v, n_e),
                                      rng.integers(0, n_v, n_e),
                                      rng.integers(1, max_t + 1, n_e), n_v)


def port_graph(g):
    return P.TemporalGraph.from_state(g.state_dict())


def service(pkg, g, **kw):
    if pkg == "jax":
        return J.TCQService(g, **kw)
    return P.TCQService(port_graph(g), device="cpu", **kw)


def engine(pkg, g, **kw):
    if pkg == "jax":
        return J.TCQEngine(g, **kw)
    return P.TCQEngine(port_graph(g), device="cpu", **kw)


def digest(res):
    return sorted((k, tuple(c.vertices.tolist()), int(c.n_edges))
                  for k, c in res.by_tti().items())


def assert_same(got, want, ctx=""):
    assert digest(got) == digest(want), ctx


def drain(tickets):
    """What a drain returned, ticket by ticket, in id order."""
    out = []
    for tk in sorted(tickets, key=lambda t: t.id):
        st = tk.result.stats
        out.append((tk.id, tk.status, tk.epoch, (tk.k, tk.h, tk.ts, tk.te),
                    digest(tk.result),
                    tuple(getattr(st, f) for f in COUNTERS)))
    return out


def both(scenario, *args):
    """Run ``scenario(pkg, *args)`` in both packages; their returns must
    be equal.  Returns the port's."""
    ref, port = (scenario(pkg, *args) for pkg in PKGS)
    assert port == ref
    return port


# ------------------------------------------------------ service: mid-flight
def _midflight(pkg, seed):
    g = random_graph(seed, n_v=22, n_e=200, max_t=20)
    Ts, Te = g.span
    mid = (Ts + Te) // 2
    svc = service(pkg, g, wave=4)
    first = svc.submit({"k": 2, "ts": Ts, "te": Te})
    late_reqs = [{"k": 3, "ts": Ts, "te": mid},
                 {"k": 2, "ts": mid, "te": Te, "h": 2},
                 {"k": 4, "ts": Ts + 1, "te": Te - 1}]
    injected = []

    def poll(s):
        if late_reqs:
            injected.append(s.submit(late_reqs.pop()))

    served = svc.run_until_idle(poll)
    assert first.done and all(tk.done for tk in injected)
    assert len(served) == 4
    assert sum(p["admitted_midflight"] for p in svc.pool_log) >= 1
    eng = engine(pkg, g)
    for tk in [first] + injected:
        assert_same(tk.result, eng.query(tk.k, tk.ts, tk.te, h=tk.h),
                    f"{pkg} ticket {tk.id}")
    return drain(served), [p["admitted_midflight"] for p in svc.pool_log]


@pytest.mark.parametrize("seed", [0, 4])
def test_midflight_admission_equals_isolated(seed):
    both(_midflight, seed)


def _pinning(pkg):
    g0 = random_graph(13, n_v=20, n_e=160, max_t=18)
    Ts, Te = g0.span
    svc = service(pkg, g0, wave=4)
    pinned = svc.submit({"k": 2, "ts": Ts, "te": Te})
    fired = {}

    def poll(s):
        if "late" not in fired:
            s.push_edges([0, 0, 0, 1, 1, 2], [1, 2, 3, 2, 3, 3],
                         [Ts + 1] * 6)
            fired["late"] = s.submit({"k": 2, "ts": Ts, "te": Te})

    svc.run_until_idle(poll)
    late = fired["late"]
    assert pinned.epoch == 0 and late.epoch == 1
    assert_same(pinned.result, engine(pkg, g0).query(2, Ts, Te), "pinned")
    g1 = J.TemporalGraph.from_state(svc.graph.state_dict())
    assert_same(late.result, engine(pkg, g1).query(2, Ts, Te), "late")
    assert digest(late.result) != digest(pinned.result)
    return drain([pinned, late])


def test_epoch_pinning_no_future_edges():
    both(_pinning)


def _service_vs_batch(pkg):
    g = random_graph(17, n_v=24, n_e=220, max_t=24)
    Ts, Te = g.span
    third = (Te - Ts) // 3
    reqs = [{"k": 2, "ts": Ts, "te": Ts + third},
            {"k": 3, "ts": Ts, "te": Ts + third // 2},
            {"k": 2, "ts": Te - third, "te": Te},
            {"k": 2, "ts": Te - third // 2, "te": Te, "h": 2}]
    eng = engine(pkg, g)
    batch = eng.query_batch(reqs)
    svc = (J if pkg == "jax" else P).TCQService(graph=None, engine=eng)
    tickets = [svc.submit(r) for r in reqs]
    svc.run_until_idle()
    assert len(svc.pool_log) == 2
    for tk, want in zip(tickets, batch):
        assert_same(tk.result, want, f"{pkg} ticket {tk.id}")
    return drain(tickets)


def test_service_batch_equals_query_batch():
    both(_service_vs_batch)


def _retention(pkg):
    g = random_graph(19)
    Ts, Te = g.span
    svc = service(pkg, g)
    empty = svc.submit({"k": 2, "ts": Te + 10, "te": Te + 20})
    real = svc.submit({"k": 2, "ts": Ts, "te": Te})
    served = svc.run_until_idle()
    assert empty in served and real in served
    assert empty.done and len(empty.result) == 0
    assert real.state is None
    assert real.graph is svc.graph      # snapshots retained by default
    svc2 = service(pkg, g, retain_snapshots=False)
    tk = svc2.submit({"k": 2, "ts": Ts, "te": Te})
    out = svc2.run_until_idle()
    assert out == [tk] and tk.done and tk.graph is None
    return drain(served) + drain(out)


def test_empty_window_and_snapshot_retention():
    both(_retention)


@pytest.mark.parametrize("windows,gap", [
    ([], 0), ([(3, 9)], 0), ([(0, 5), (4, 9), (20, 30), (8, 10)], 0),
    ([(10, 12), (0, 2), (3, 5)], 0), ([(10, 12), (0, 2), (3, 5)], 1),
    ([(0, 4), (3, 8), (7, 11)], 0)])
def test_cluster_windows(windows, gap):
    assert P.cluster_windows(windows, gap) == \
        J.cluster_windows(windows, gap)


def _cancel_queued(pkg):
    g = random_graph(21, n_v=22, n_e=200, max_t=20)
    Ts, Te = g.span
    svc = service(pkg, g, wave=4)
    keep = svc.submit({"k": 2, "ts": Ts, "te": Te})
    gone = svc.submit({"k": 3, "ts": Ts, "te": Te})
    assert svc.cancel(gone)
    assert gone.status == "cancelled" and gone.done
    assert gone.result is not None and len(gone.result) == 0
    served = svc.run_until_idle()
    assert keep.status == "done"
    assert {tk.id for tk in served} == {keep.id, gone.id}
    assert_same(keep.result, engine(pkg, g).query(2, Ts, Te), "survivor")
    return drain(served)


def test_cancel_before_first_slot():
    both(_cancel_queued)


def _deadline_mid_pool(pkg):
    g = random_graph(22, n_v=22, n_e=200, max_t=20)
    Ts, Te = g.span
    svc = service(pkg, g, wave=4)
    keep = svc.submit({"k": 2, "ts": Ts, "te": Te})
    doomed = svc.submit({"k": 3, "ts": Ts, "te": Te, "deadline_s": 3600.0})
    state = {"polls": 0}

    def poll(s):
        state["polls"] += 1
        if state["polls"] == 2:         # inside the live pool's admit hook
            doomed.deadline = 1.0       # long past (perf_counter scale)

    served = svc.run_until_idle(poll)
    assert doomed.status == "timeout" and doomed.done
    assert doomed.result is not None
    assert keep.status == "done"
    assert_same(keep.result, engine(pkg, g).query(2, Ts, Te), "survivor")
    assert any(p["timeouts"] for p in svc.pool_log)
    return drain(served)


def test_deadline_expires_mid_pool():
    both(_deadline_mid_pool)


def _empty_races_ingest(pkg):
    g = random_graph(23, n_v=18, n_e=120, max_t=10)
    Ts, Te = g.span
    svc = service(pkg, g, wave=4)
    empty = svc.submit({"k": 2, "ts": Te + 5, "te": Te + 9})
    assert empty.done and empty.status == "done" and len(empty.result) == 0
    svc.push_edges([0, 0, 1], [1, 2, 2], [Te + 6, Te + 7, Te + 8])
    fresh = svc.submit({"k": 2, "ts": Te + 5, "te": Te + 9})
    served = svc.run_until_idle()
    assert {tk.id for tk in served} == {empty.id, fresh.id}
    assert len(empty.result) == 0
    g1 = J.TemporalGraph.from_state(svc.graph.state_dict())
    assert_same(fresh.result, engine(pkg, g1).query(2, Te + 5, Te + 9),
                "post-ingest")
    return drain(served)


def test_empty_result_query_races_ingest():
    both(_empty_races_ingest)


def test_window_cache_retires_dead_epochs():
    g = random_graph(24, n_v=18, n_e=120, max_t=10)
    Ts, Te = g.span
    svc = service("torch", g, wave=4)
    svc.submit({"k": 2, "ts": Ts, "te": Te})
    svc.push_edges([0, 1], [2, 3], [Ts + 1, Ts + 2])
    svc.submit({"k": 2, "ts": Ts, "te": Te})
    svc.push_edges([2, 3], [4, 5], [Ts + 1, Ts + 2])
    svc.submit({"k": 2, "ts": Ts, "te": Te})
    svc.run_until_idle()
    live = {svc.engine.epoch}
    assert set(svc.engine._epoch_aux) <= live
    assert {key[0] for key in svc.engine._win_cache} <= live
    cc = svc.engine.core_cache.stats()
    assert cc["n_cores"] > 0 and cc["evicted_cores"] > 0


# --------------------------------------------- drains on a seeded tape
def _tape(g, seed):
    """Poll-driven tape: admissions (repeats, so the cache has work), a
    cancel, two mid-tape ingest batches inside the last fifth of the live
    time span (windows before it keep their cached cores, later ones are
    invalidated)."""
    rng = np.random.default_rng(seed)
    uts = g.unique_ts
    n = int(uts.size)
    reqs = []
    for _ in range(6):
        a, b = sorted(rng.integers(0, n, 2).tolist())
        reqs.append({"k": int(rng.integers(2, 4)), "ts": int(uts[a]),
                     "te": int(uts[min(b + 1, n - 1)]),
                     "h": int(rng.integers(1, 3))})
    V = int(g.num_vertices)

    def batch(m):
        u = rng.integers(0, V, m)
        return (u, (u + 1 + rng.integers(0, V - 1, m)) % V,
                rng.integers(int(uts[4 * n // 5]), int(uts[-1]) + 1, m))

    return ([("submit", r) for r in reqs[:3]] + [("edges", batch(12))]
            + [("submit", reqs[0]), ("submit_cancel", reqs[3])]
            + [("submit", r) for r in reqs[3:]] + [("edges", batch(8))]
            + [("submit", reqs[1]), ("submit", reqs[4])])


def drive(svc, ops):
    tickets = {}
    state = {"i": 0}

    def poll(s):
        if state["i"] >= len(ops):
            return
        op = ops[state["i"]]
        state["i"] += 1
        if op[0] in ("submit", "submit_cancel"):
            tk = s.submit(dict(op[1]))
            tickets[tk.id] = tk
            if op[0] == "submit_cancel":
                s.cancel(tk)
        elif op[0] == "edges":
            s.push_edges(*op[1])

    while state["i"] < len(ops) or svc.pending:
        svc.run_until_idle(poll)
    return tickets


def _tape_drain(pkg, seed, cache):
    g = powerlaw_graph(seed)
    svc = service(pkg, g, cache=cache, wave=4)
    tickets = drive(svc, _tape(g, seed))
    assert len(tickets) == 10
    assert (svc.engine.core_cache is not None) == cache
    return drain(tickets.values())


def powerlaw_graph(seed):
    from repro.graphs import powerlaw_temporal

    return powerlaw_temporal(60, 400, 40, seed=seed)


@pytest.mark.parametrize("cache", [True, False], ids=["cache", "no_cache"])
@pytest.mark.parametrize("seed", [3, 7])
def test_tape_drains_match_reference(seed, cache):
    out = both(_tape_drain, seed, cache)
    assert sum(len(d[4]) for d in out) > 0
    if cache:
        assert any(d[5][1] > 0 for d in out)       # some cells from cache


# ------------------------------------------------------ ladder transitions
def random_lanes(seed, g, w=4):
    rng = np.random.default_rng(seed + 1000)
    lo, hi = g.span
    ts = rng.integers(lo, hi + 1, w).astype(np.int32)
    te = np.minimum(ts + rng.integers(1, hi - lo + 1, w), hi).astype(np.int32)
    k = rng.integers(1, 4, w).astype(np.int32)
    h = rng.integers(1, 3, w).astype(np.int32)
    return ts, te, k, h


def step_numpy(res):
    return {f: np.asarray(getattr(res, f).cpu().numpy()
                          if torch.is_tensor(getattr(res, f))
                          else getattr(res, f)).astype(np.int64)
            for f in ("alive", "packed", "tti_lo", "tti_hi", "n_edges",
                      "iters")}


def _ladder_call(pkg, seed, use_kernel=False, plans=None, **cfg_kw):
    """One ladder call on the random lanes of ``seed``: (step fields,
    final rung, [(rung, reason)] of its events), rungs in port names."""
    g = random_graph(seed)
    ts, te, k, h = random_lanes(seed, g)
    if pkg == "jax":
        plans = {r: p for r, p in (plans or {}).items()}
        jplans = {next(j for j, t in RUNG.items() if t == r):
                  jfault.FaultPlan(**p) for r, p in plans.items()}
        cfg = J.ResilienceConfig(seed=seed, rung_wrapper=jfault.rung_faults(
            jplans) if jplans else None, **cfg_kw)
        step = jwave.make_wave_step_fn(g.device_tel(), g.num_vertices,
                                       use_kernel=use_kernel, resilience=cfg)
        alive = np.ones((4, g.num_vertices), bool)
    else:
        pplans = {r: pfault.FaultPlan(**p) for r, p in (plans or {}).items()}
        cfg = P.ResilienceConfig(seed=seed, rung_wrapper=pfault.rung_faults(
            pplans) if pplans else None, **cfg_kw)
        pg = port_graph(g)
        step = pwave.make_wave_step_fn(pg.device_tel(device="cpu"),
                                       pg.num_vertices,
                                       use_kernel=use_kernel, resilience=cfg)
        alive = torch.ones((4, pg.num_vertices), dtype=torch.bool)
    res = step(alive, ts, te, k, h)
    events = [(RUNG.get(e["rung"], e["rung"]), e["reason"])
              for e in step.events]
    return step_numpy(res), RUNG.get(step.backend, step.backend), events


def _plain_step(seed):
    g = port_graph(random_graph(seed))
    tel = g.device_tel(device="cpu")
    alive = torch.ones((4, g.num_vertices), dtype=torch.bool)
    return step_numpy(pwave.make_composite_step(tel, g.num_vertices)(
        alive, *random_lanes(seed, random_graph(seed))))


def assert_fields_equal(got, want):
    for f in want:
        assert np.array_equal(got[f], want[f]), f


@pytest.mark.parametrize("use_kernel", [False, True])
def test_ladder_invisible_when_healthy(use_kernel):
    got, rung, events = _ladder_call("torch", 7, use_kernel=use_kernel)
    assert_fields_equal(got, _plain_step(7))
    assert rung == ("fused" if use_kernel else "composite")
    assert events == []
    ref, _, ref_events = _ladder_call("jax", 7)
    assert_fields_equal(got, ref) and ref_events == []


def test_ladder_demotes_on_error_and_replays():
    plans = {"composite": {"fail_at": (0,)}}
    ref, port = (_ladder_call(pkg, 8, plans=plans) for pkg in PKGS)
    assert_fields_equal(port[0], _plain_step(8))
    assert port[1:] == ref[1:] == ("oracle", [("composite", "error")])
    assert_fields_equal(port[0], ref[0])


def test_ladder_fused_fault_demotes_to_composite():
    got, rung, events = _ladder_call("torch", 8, use_kernel=True,
                                     plans={"fused": {"fail_at": (0,)}})
    assert_fields_equal(got, _plain_step(8))
    assert (rung, events) == ("composite", [("fused", "error")])


def _card_ladder(monkeypatch, seed, use_kernel, plans, every=0):
    """A ladder with the card's rules (one rung, failures logged and
    raised), built over CPU tensors by turning demotion off."""
    monkeypatch.setattr(pwave, "_demotes", lambda tel: False)
    g = port_graph(random_graph(seed))
    cfg = P.ResilienceConfig(tripwire_every=every, rung_wrapper=(
        pfault.rung_faults({r: pfault.FaultPlan(**p)
                            for r, p in plans.items()}) if plans else None))
    step = pwave.make_wave_step_fn(g.device_tel(device="cpu"),
                                   g.num_vertices, use_kernel=use_kernel,
                                   resilience=cfg)
    alive = torch.ones((4, g.num_vertices), dtype=torch.bool)
    return step, (alive, *random_lanes(seed, random_graph(seed)))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_ladder_on_card_logs_and_raises_a_fault(monkeypatch, use_kernel):
    """On the card the ladder holds the bare step alone: a failed call is
    logged and raised, never replayed on another rung."""
    rung = "fused" if use_kernel else "composite"
    step, args = _card_ladder(monkeypatch, 8, use_kernel,
                              {rung: {"fail_at": (1,)}})
    assert [name for name, _ in step.rungs] == [rung]
    assert_fields_equal(step_numpy(step(*args)), _plain_step(8))
    with pytest.raises(pfault.KernelFault):
        step(*args)
    assert [(e["rung"], e["reason"], e["call"]) for e in step.events] == \
        [(rung, "error", 2)]
    assert step.backend == rung and step.oracle_calls == 0


def test_ladder_on_card_raises_on_divergence(monkeypatch):
    step, args = _card_ladder(monkeypatch, 10, True,
                              {"fused": {"corrupt_at": (0,),
                                         "corrupt_vertex": 3}}, every=1)
    with pytest.raises(pwave.StepDivergence):
        step(*args)
    assert [(e["rung"], e["reason"]) for e in step.events] == \
        [("fused", "divergence")]
    assert step.oracle_calls == 1
    # the next call is healthy: the rung stays, the tripwire passes
    assert_fields_equal(step_numpy(step(*args)), _plain_step(10))
    assert step.backend == "fused" and step.oracle_calls == 2


def test_service_on_card_rules_raise_and_report(monkeypatch):
    """A service whose ladder follows the card's rules: the injected
    fault leaves ``run_until_idle`` and is the one event reported."""
    monkeypatch.setattr(pwave, "_demotes", lambda tel: False)
    g = powerlaw_graph(4)
    Ts, Te = g.span
    cfg = P.ResilienceConfig(tripwire_every=0, rung_wrapper=pfault.rung_faults(
        {"fused": pfault.FaultPlan(fail_at=(0,))}))
    svc = P.TCQService(port_graph(g), device="cpu", use_kernel=True,
                       resilience=cfg, cache=False)
    svc.submit({"k": 2, "ts": Ts, "te": Te})
    with pytest.raises(pfault.KernelFault):
        svc.run_until_idle()
    assert [(e["rung"], e["reason"]) for e in
            svc.engine.resilience_events()] == [("fused", "error")]


def test_ladder_tripwire_catches_silent_corruption():
    plans = {"composite": {"corrupt_at": (0,), "corrupt_vertex": 3}}
    ref, port = (_ladder_call(pkg, 10, plans=plans, tripwire_every=1)
                 for pkg in PKGS)
    assert_fields_equal(port[0], _plain_step(10))
    assert port[1:] == ref[1:] == ("oracle",
                                   [("composite", "divergence")])


def test_ladder_last_rung_failure_raises():
    plans = {"composite": pfault.FaultPlan(fail_at=(0,)),
             "oracle": pfault.FaultPlan(fail_at=(0,))}
    g = port_graph(random_graph(11))
    step = pwave.make_wave_step_fn(
        g.device_tel(device="cpu"), g.num_vertices, use_kernel=False,
        resilience=P.ResilienceConfig(rung_wrapper=pfault.rung_faults(plans)))
    with pytest.raises(pfault.KernelFault):
        step(torch.ones((4, g.num_vertices), dtype=torch.bool),
             *random_lanes(11, random_graph(11)))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_ladder_pool_counters_match_plain_pool(use_kernel):
    """Ladder rungs do not donate: the pool adopts each step's returned
    mask, so its lanes warm-start exactly as the donating plain pool's
    do — same cores and the same schedule counters, peel_iters too."""
    g = powerlaw_graph(4)
    Ts, Te = g.span
    reqs = [{"k": 2, "ts": Ts, "te": Te}, {"k": 3, "ts": Ts + 3, "te": Te},
            {"k": 2, "ts": Ts, "te": (Ts + Te) // 2, "h": 2}]
    plain = engine("torch", g, use_kernel=use_kernel)
    ladder = engine("torch", g, use_kernel=use_kernel,
                    resilience=P.ResilienceConfig(tripwire_every=3))
    ref = engine("jax", g)
    for got, want, also in zip(ladder.query_batch(reqs, wave=4),
                               plain.query_batch(reqs, wave=4),
                               ref.query_batch(reqs, wave=4)):
        for other in (want, also):
            assert_same(got, other)
            for f in COUNTERS:
                assert getattr(got.stats, f) == getattr(other.stats, f), f
    assert ladder.resilience_events() == []
    assert all(getattr(wt.step_fn, "calls", 0) > 0
               for wt in ladder._win_cache.values())


# -------------------------------------------------- deadlines / EDF
def _requests(g, n=4, seed=0):
    rng = np.random.default_rng(seed)
    uts = np.asarray(g.unique_ts)
    reqs = []
    for _ in range(n):
        i, j = sorted(rng.integers(0, uts.size, 2))
        reqs.append({"k": int(rng.integers(1, 4)), "ts": int(uts[i]),
                     "te": int(uts[min(j + 1, uts.size - 1)])})
    return reqs


def _edf(pkg):
    g = random_graph(3)
    lo, hi = g.span
    mid = (lo + hi) // 2
    svc = service(pkg, g)
    slack = svc.submit({"k": 2, "ts": lo, "te": mid})
    tight = svc.submit({"k": 2, "ts": mid + 1, "te": hi,
                        "deadline_s": 60.0})
    first = svc.pump()
    assert tight.done and tight.status == "done"
    assert not slack.done
    rest = svc.run_until_idle()
    assert slack.status == "done"
    return drain(first), drain(rest)


def test_edf_serves_tight_deadline_first():
    both(_edf)


def _cancel_timeout(pkg):
    g = random_graph(4)
    lo, hi = g.span
    svc = service(pkg, g)
    a = svc.submit({"k": 2, "ts": lo, "te": hi})
    b = svc.submit({"k": 2, "ts": lo, "te": hi, "deadline_s": -1.0})
    assert svc.cancel(a) and a.status == "cancelled" and a.done
    assert a.result is not None and not svc.cancel(a)
    out = svc.run_until_idle()
    assert b.status == "timeout" and b.done and b.result is not None
    assert svc.pending == 0
    return drain(out)


def test_cancel_and_timeout_are_terminal_with_partial_results():
    both(_cancel_timeout)


# ----------------------------------------------------------- crash recovery
def _restore(seed, crash_pkg, restore_pkg):
    rng = np.random.default_rng(seed + 50)
    g = random_graph(seed)
    reqs = _requests(g, n=4, seed=seed)
    extra = (rng.integers(0, g.num_vertices, 12),
             rng.integers(0, g.num_vertices, 12), rng.integers(20, 30, 12))
    ref = service(crash_pkg, g)
    ref_tks = [ref.submit(r) for r in reqs[:2]]
    ref.push_edges(*extra)
    ref_tks += [ref.submit(r) for r in reqs[2:]]
    ref.run_until_idle()

    svc = service(crash_pkg, g)
    [svc.submit(r) for r in reqs[:2]]
    svc.push_edges(*extra)
    [svc.submit(r) for r in reqs[2:]]
    early = svc.pump()
    buf = io.BytesIO()
    svc.save_snapshot(buf)
    buf.seek(0)
    if restore_pkg == "jax":
        svc2 = J.TCQService.load_snapshot(buf)
    else:
        svc2 = P.TCQService.load_snapshot(buf, device="cpu")
    assert svc2.epoch == svc.epoch
    late = svc2.run_until_idle()
    by_id = {tk.id: tk for tk in early + late}
    assert sorted(by_id) == sorted(tk.id for tk in ref_tks)
    for want in ref_tks:
        got = by_id[want.id]
        assert got.epoch == want.epoch
        assert_same(got.result, want.result, f"ticket {want.id}")
    return [(tk.id, tk.epoch, digest(tk.result))
            for tk in sorted(by_id.values(), key=lambda t: t.id)]


@pytest.mark.parametrize("seed", [0, 1])
def test_snapshot_restore_equals_uninterrupted(seed):
    """Crash, snapshot, restore, drain: in the port alone, and with the
    snapshot crossing packages both ways — all equal the JAX run."""
    want = _restore(seed, "jax", "jax")
    for crash, rest in (("torch", "torch"), ("jax", "torch"),
                        ("torch", "jax")):
        assert _restore(seed, crash, rest) == want, (crash, rest)


def test_restore_preserves_deadlines_and_ids():
    g = random_graph(6)
    lo, hi = g.span
    svc = J.TCQService(g)           # a snapshot dict of the JAX service
    svc.submit({"k": 2, "ts": lo, "te": hi, "deadline_s": 120.0,
                "priority": -3})
    snap = svc.snapshot()
    assert snap["tickets"][0]["deadline_rem_s"] == pytest.approx(120.0,
                                                                 abs=5.0)
    svc2 = P.TCQService.restore(snap, device="cpu")
    (tk,) = svc2.pending_tickets
    assert tk.id == 0 and tk.priority == -3 and tk.deadline is not None
    nxt = svc2.submit({"k": 2, "ts": lo, "te": hi})
    assert nxt.id == 1
    out = svc2.run_until_idle()
    want = J.TCQEngine(g).query(2, lo, hi)
    for t in out:
        assert_same(t.result, want)


# ------------------------------------------- resilient service end-to-end
def _faulty_service(pkg):
    g = random_graph(12, n_v=24, n_e=200)
    reqs = _requests(g, n=3, seed=12)
    plain = service(pkg, g)
    want = [plain.submit(r) for r in reqs]
    plain.run_until_idle()
    if pkg == "jax":
        cfg = J.ResilienceConfig(seed=12, tripwire_every=1,
                                 rung_wrapper=jfault.rung_faults(
                                     {"xla": jfault.FaultPlan(
                                         fail_at=(1,), corrupt_at=(0,))}))
    else:
        cfg = P.ResilienceConfig(seed=12, tripwire_every=1,
                                 rung_wrapper=pfault.rung_faults(
                                     {"composite": pfault.FaultPlan(
                                         fail_at=(1,), corrupt_at=(0,))}))
    svc = service(pkg, g, resilience=cfg)
    got = [svc.submit(r) for r in reqs]
    svc.run_until_idle()
    events = svc.engine.resilience_events()
    assert events, "faults never fired"
    for a, b in zip(got, want):
        assert_same(a.result, b.result, f"ticket {a.id}")
    return ([(e["epoch"], e["window"], RUNG.get(e["rung"], e["rung"]), e["reason"],
              e["call"]) for e in events],
            [(tk.id, digest(tk.result)) for tk in got])


def test_service_with_injected_faults_matches_fault_free():
    both(_faulty_service)


# ------------------------------------------------------- the card default
def test_service_defaults_to_cuda_and_refuses_mesh():
    g = port_graph(random_graph(1))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            P.TCQService(g)
        with pytest.raises(RuntimeError, match="CUDA"):
            P.TCQEngine(g, cache=True)
        with pytest.raises(RuntimeError, match="CUDA"):
            P.TCQEngine(g, resilience=True)
    # the sharded pipeline is ported (tests/test_torch_distributed.py):
    # a mesh must be a launch.mesh.Mesh; combine without one is unused
    with pytest.raises(TypeError, match="launch.mesh.Mesh"):
        P.TCQService(g, device="cpu", mesh=object())
    assert "distributed" not in P.TCQService(g, device="cpu",
                                             combine="psum").stats
    eng = P.TCQEngine(g, device="cpu", cache=True, resilience=True)
    assert isinstance(eng.core_cache, P.CoreCache)
    assert eng._resilience == P.ResilienceConfig()


def test_malformed_batches_rejected_before_mutation():
    batches = pfault.malformed_batches(0)
    ref = jfault.malformed_batches(0)
    assert len(batches) == len(ref)
    for (u, v, t), (ju, jv, jt) in zip(batches, ref):
        for a, b in ((u, ju), (v, jv), (t, jt)):      # NaN compares as text
            assert a.dtype == b.dtype
            assert [str(x) for x in a.tolist()] == \
                [str(x) for x in b.tolist()]
    g = port_graph(random_graph(0))
    want = {f: getattr(g, f).copy() for f in ("src", "dst", "t", "pair_id")}
    for u, v, t in batches:
        with pytest.raises(P.GraphIngestError):
            g.add_edges(u, v, t)
    for f, arr in want.items():
        assert np.array_equal(getattr(g, f), arr), f
