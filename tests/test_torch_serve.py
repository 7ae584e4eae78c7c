"""The port's serving launcher (``repro_torch.launch.serve``) at small size
on the CPU (``device="cpu"``): admission control, the closed and open
loops, and the command line with ``--wal-dir`` recovery on
start.  Every served ticket is held to the JAX engine on the snapshot it
was pinned to.  The open loop runs on the wall clock, so which
epoch a ticket pins may differ from run to run; each ticket is checked
against its own epoch's snapshot, never against another run's outcome.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as J  # noqa: E402
import repro.data as jdata  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro.graphs import powerlaw_temporal  # noqa: E402
from repro_torch.data import TCQRequestStream  # noqa: E402
from repro_torch.graphs import EdgeStream  # noqa: E402
from repro_torch.launch import serve  # noqa: E402


def port_graph(g):
    return P.TemporalGraph.from_state(g.state_dict())


def digest(res):
    return sorted((k, tuple(c.vertices.tolist()), int(c.n_edges))
                  for k, c in res.by_tti().items())


def random_graph(seed, n_v=20, n_e=140, max_t=16):
    rng = np.random.default_rng(seed)
    return J.TemporalGraph.from_edges(rng.integers(0, n_v, n_e),
                                      rng.integers(0, n_v, n_e),
                                      rng.integers(1, max_t + 1, n_e), n_v)


def test_backpressure_bounded_queue_and_qps_ceiling():
    g = port_graph(random_graph(5))
    lo, hi = g.span
    req = {"k": 2, "ts": lo, "te": hi}
    svc = P.TCQService(g, device="cpu")
    bp = serve.Backpressure(svc, queue_cap=2, deadline_s=30.0)
    t1, t2 = bp.offer(req), bp.offer(req)
    assert t1 is not None and t2 is not None
    assert t1.deadline is not None          # stamped by the gate
    assert bp.offer(req) is None            # queue full -> shed
    assert bp.shed == 1 and bp.offered == 3
    t1.deadline = 0.0                       # past its deadline: yields
    t4 = bp.offer(req)
    assert t4 is not None and t1.status == "timeout"

    svc2 = P.TCQService(g, device="cpu")
    bp2 = serve.Backpressure(svc2, queue_cap=1, qps_ceiling=1e-6)
    assert bp2.offer(req) is not None       # initial burst allowance
    assert bp2.offer(req) is None and bp2.shed_rate == pytest.approx(0.5)


@pytest.mark.parametrize("open_loop", [False, True])
def test_request_stream_matches_reference(open_loop):
    args = dict(t_min=3, t_max=900, k=4, span=64, seed=11)
    mine, ref = TCQRequestStream(**args), jdata.TCQRequestStream(**args)
    if open_loop:
        assert list(mine.open_loop(12, qps=40)) == \
            list(ref.open_loop(12, qps=40))
    else:
        assert list(mine.requests(12, start=5)) == \
            list(ref.requests(12, start=5))


def _graph():
    return powerlaw_temporal(120, 1_200, 512, seed=3)


@pytest.mark.parametrize("cache", [True, False], ids=["cache", "no_cache"])
def test_serve_closed_loop_matches_reference(cache):
    g = _graph()
    lo, hi = g.span
    reqs = list(TCQRequestStream(lo, hi, k=3, span=64, seed=0).requests(10))
    reqs += reqs[:4]                        # repeats: cache hits
    svc, tickets, rep = serve.serve_closed_loop(
        port_graph(g), reqs, concurrency=3, queue_cap=16, device="cpu",
        cache=cache)
    assert svc.engine.device.type == "cpu"
    assert rep["offered"] == len(reqs) and rep["shed"] == 0
    assert rep["completed"] == len(tickets) == len(reqs)
    assert rep["p50_ms"] <= rep["p95_ms"] <= rep["p99_ms"]
    want = J.TCQEngine(g).query_batch(
        [{k: r[k] for k in ("k", "ts", "te")} for r in reqs])
    for tk, w in zip(sorted(tickets, key=lambda t: t.id), want):
        assert tk.status == "done" and digest(tk.result) == digest(w)
    # latency counts from when the ticket's slot freed: the loop's start
    # for the first `concurrency`, else the completion that freed it
    done = sorted(tk.done_s for tk in tickets)
    for i, tk in enumerate(sorted(tickets, key=lambda t: t.id)):
        assert tk.due_s <= tk.submit_s
        assert tk.latency_s == tk.done_s - tk.due_s
        if i >= 3:
            assert tk.due_s in done[:i - 2]
    cc = rep["cache"].get("core_cache")
    assert (cc is not None) == cache
    if cache:
        assert cc["hits"] + cc["dominance_hits"] > 0


def test_serve_stream_ingest_wal_and_recover(tmp_path):
    g = _graph()
    lo, hi = g.span
    reqs = list(TCQRequestStream(lo, hi, k=3, span=64, seed=1)
                .open_loop(8, qps=200))
    future = powerlaw_temporal(120, 300, 128, seed=5)
    batches = [(u, v, t + lo + 100) for u, v, t in
               EdgeStream.replay(future, 2)]    # inside the live span
    d = str(tmp_path / "wal")
    svc, served, wall = serve.serve_stream(
        port_graph(g), reqs, qps=200, ingest=iter(batches), wal_dir=d,
        fsync="batch", device="cpu")
    assert wall > 0 and len(served) == len(reqs)
    assert svc.epoch == len(batches)
    # latency counts from each request's scheduled arrival: the dues lie
    # as far apart as the schedule's arrivals, and before submission
    by_id = sorted(served, key=lambda t: t.id)
    arrive = sorted(r["arrive_s"] for r in reqs)
    for tk, a in zip(by_id, arrive):
        assert tk.due_s <= tk.submit_s
        assert tk.latency_s == tk.done_s - tk.due_s
        assert tk.due_s - by_id[0].due_s == pytest.approx(a - arrive[0],
                                                          abs=1e-9)
    snaps = [g]
    for u, v, t in batches:
        snaps.append(snaps[-1].add_edges(u, v, t))
    engines = {}
    for tk in served:
        eng = engines.setdefault(tk.epoch, J.TCQEngine(snaps[tk.epoch]))
        assert tk.status == "done"
        assert digest(tk.result) == digest(eng.query(tk.k, tk.ts, tk.te))
    ck = svc.checkpoint()
    svc.wal.close()
    rec = P.TCQService.recover(d, device="cpu")
    assert rec.recovery_report["snapshot_seq"] == ck["wal_seq"]
    assert rec.epoch == svc.epoch and rec.pending == 0
    assert rec.graph.fingerprint() == snaps[-1].fingerprint()
    more = [{k: r[k] for k in ("k", "ts", "te")} for r in reqs[:3]]
    got = [rec.submit(r) for r in more]
    rec.run_until_idle()
    eng = J.TCQEngine(snaps[-1])
    for tk in got:
        assert digest(tk.result) == digest(eng.query(tk.k, tk.ts, tk.te))
    rec.wal.close()


def test_serve_main_recovers_on_start(tmp_path, monkeypatch, capsys):
    d = str(tmp_path / "wal")
    argv = ["serve", "--device", "cpu", "--vertices", "200", "--edges",
            "1500", "--span", "1024", "--requests", "4", "--qps", "50",
            "--ingest-batches", "2", "--wal-dir", d]
    monkeypatch.setattr("sys.argv", argv)
    serve.main()
    first = capsys.readouterr().out
    assert "4 requests" in first and "recovered" not in first
    assert "journal:" in first
    serve.main()
    second = capsys.readouterr().out
    assert "recovered from" in second and "4 requests" in second
    assert "over 4 ingested epochs" in second


def test_serve_main_closed_loop(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", [
        "serve", "--device", "cpu", "--vertices", "200", "--edges", "1500",
        "--span", "1024", "--requests", "5", "--closed-loop",
        "--concurrency", "2"])
    serve.main()
    out = capsys.readouterr().out
    assert "closed loop: 5 offered, 5 completed" in out


def test_serve_defaults_to_cuda():
    g = port_graph(random_graph(2))
    reqs = [{"k": 2, "ts": g.span[0], "te": g.span[1], "arrive_s": 0.0}]
    if torch.cuda.is_available():
        svc, served, _ = serve.serve_stream(g, reqs, qps=1)
        assert svc.engine.device.type == "cuda" and served
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.serve_stream(g, reqs, qps=1)
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.serve_closed_loop(g, reqs)
