"""TCQ serving launcher (PyTorch port of ``repro.launch.serve``): the
paper's system as a *streaming service* — open-loop query arrivals over a
temporal graph that keeps growing while queries run, served by
``TCQService`` (window-clustered lane pools, mid-flight admission,
epoch-pinned snapshots) on one CUDA device.

    PYTHONPATH=src python -m repro_torch.launch.serve --vertices 2000 \
        --edges 30000 --requests 16 --qps 4 [--ingest-batches 4] \
        [--wal-dir DIR] [--device cuda|cpu]

The loop is open: request arrival times come from a seeded
exponential inter-arrival process at ``--qps`` and are injected by the
service's ``poll`` hook whenever lanes free up — arrivals during a pool
run are admitted mid-flight when their window fits, otherwise they queue
for the next pool.  Edge ingestion batches land on their own schedule
(between arrivals), each producing a new TEL epoch; queries always
answer over the snapshot current at their admission.  Reported: p50 /
p95 / p99 latency from each request's scheduled arrival to its
completion, sustained qps, mean pool
occupancy, and the epoch count ingested while serving.

``--device`` defaults to ``cuda`` (the service raises without a card);
``--device cpu`` runs the plain versions of the kernels.

``--distributed`` serves through the sharded pipeline
(:func:`serve_distributed`, ``--model-shards``, ``--combine``,
``--controllers``) on a mesh of every rank of the world:

* under ``torchrun --nproc-per-node=<cards>``, one rank per card over
  NCCL; with no launcher, a world of one rank (the unit mesh);
* ``--fake-devices N``: N gloo ranks spawned by this script, the
  counterpart of XLA's host devices: on the CPU with ``--device cpu``,
  or sharing one card through host memory with ``--device cuda``.

Every rank serves the same traffic; rank 0 prints, and the ranks' tickets
must agree.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --distributed --fake-devices 4 --model-shards 2
"""

from __future__ import annotations

import argparse
import time

import numpy as np


# -------------------------------------------------------------- backpressure
class Backpressure:
    """Admission control in front of ``TCQService.submit``: a bounded
    request queue with a qps ceiling and a shed-oldest-past-deadline
    policy.

    ``offer`` is the only entry point — it either admits the request
    (returning its ticket) or sheds it (returning None, counted).  Three
    gates, in order:

    1. **qps ceiling** — a token bucket refilled at ``qps_ceiling``
       (burst = ``queue_cap``); an empty bucket sheds the arrival
       outright (the HTTP-429 analogue).
    2. **deadline stamping** — admitted requests without their own
       ``deadline_s`` inherit ``deadline_s`` (None = best-effort).
    3. **bounded queue** — when the service backlog is at ``queue_cap``,
       queued tickets already past their deadline are timed out first
       (shed-oldest-past-deadline: they could never answer in time, so
       they yield their slot); if the backlog is still full, the arrival
       itself is shed.

    Shed rate = ``shed / offered`` — the closed loop reports it
    alongside latency percentiles, because under overload a low p99 is
    meaningless without the fraction of traffic it was bought with.
    """

    def __init__(self, svc, *, queue_cap: int = 64,
                 qps_ceiling: float = 0.0, deadline_s: float = 0.0):
        self.svc = svc
        self.queue_cap = int(queue_cap)
        self.qps_ceiling = float(qps_ceiling or 0.0)
        self.deadline_s = float(deadline_s or 0.0)
        self.offered = 0
        self.shed = 0
        self.timeouts_swept = 0
        self._tokens = float(queue_cap)
        self._last = svc.now()

    def offer(self, request):
        """Admit ``request`` or shed it; returns the ticket or None."""
        self.offered += 1
        now = self.svc.now()     # rank 0's clock on a mesh
        if self.qps_ceiling > 0.0:
            self._tokens = min(float(self.queue_cap), self._tokens
                               + (now - self._last) * self.qps_ceiling)
            self._last = now
            if self._tokens < 1.0:
                self.shed += 1
                return None
            self._tokens -= 1.0
        if self.svc.pending >= self.queue_cap:
            self.timeouts_swept += len(self.svc.expire(now))
            if self.svc.pending >= self.queue_cap:
                self.shed += 1
                return None
        r = dict(request)
        if self.deadline_s > 0.0:
            r.setdefault("deadline_s", self.deadline_s)
        return self.svc.submit(r)

    @property
    def shed_rate(self) -> float:
        return self.shed / max(1, self.offered)


def _cache_report(stats) -> str:
    """One report line from ``TCQService.stats``: window-TEL LRU counters
    plus (when result caching is on) TTI core-cache hit rate and size."""
    wt = stats["window_tel"]
    line = (f"[serve] window-TEL LRU: {wt['hits']} hits / "
            f"{wt['misses']} misses / {wt['evictions']} evictions "
            f"({wt['size']} live)")
    cc = stats.get("core_cache")
    if cc is None:
        return line + " | core cache: off"
    return line + (f" | core cache: {cc['hits'] + cc['dominance_hits']} "
                   f"hits ({cc['hit_rate']:.1%}, {cc['dominance_hits']} by "
                   f"dominance), {cc['invalidated']} invalidated, "
                   f"{cc['rekeyed']} re-keyed, "
                   f"{cc['n_cores']} cores / {cc['bytes'] / 1024:.1f} KiB"
                   + (f", {stats['prewarmed']} prewarmed"
                      if stats.get("prewarmed") else ""))


def serve_closed_loop(graph, requests, *, concurrency: int = 8,
                      queue_cap: int = 16, qps_ceiling: float = 0.0,
                      deadline_s: float = 0.0, wave="auto", depth: int = 2,
                      cluster_gap: int = 0, resilience=None, cache=True,
                      device=None):
    """Closed loop: keep ``concurrency`` requests outstanding,
    offering the next one the moment a slot frees — the standard way to
    overload a service deterministically (offered load = concurrency /
    service time, no arrival clock to race).  Requests flow through a
    :class:`Backpressure` gate, so overload shows up as shed traffic and
    deadline timeouts rather than an unbounded queue.

    Returns ``(svc, tickets, report)`` where ``report`` carries offered /
    shed / timeout counts, shed rate, completed-qps and p50/p95/p99
    latency of *completed* requests.  ``device`` is the service's (CUDA
    unless told otherwise).
    """
    from repro_torch.core import TCQService

    svc = TCQService(graph, device=device, wave=wave, depth=depth,
                     cluster_gap=cluster_gap, retain_snapshots=False,
                     resilience=resilience, cache=cache)
    bp = Backpressure(svc, queue_cap=queue_cap, qps_ceiling=qps_ceiling,
                      deadline_s=deadline_s)
    queue = list(requests)
    tickets = []
    state = {"i": 0, "t0": svc.now()}

    def outstanding() -> int:
        return sum(1 for tk in tickets if not tk.done)

    def due() -> float:
        """When the slot the next request takes freed: the loop's start
        for the first ``concurrency`` tickets, else the completion that
        left fewer than ``concurrency`` outstanding."""
        n = len(tickets) - concurrency
        if n < 0:
            return state["t0"]
        return sorted(tk.done_s for tk in tickets if tk.done)[n]

    def poll(s):
        # at most one offer per poll tick (pool formation / lanes
        # freeing): the closed loop reacts to service progress instead
        # of dumping its whole queue into the shedder in one burst; the
        # request's latency counts from when its slot freed
        if state["i"] < len(queue) and outstanding() < concurrency:
            tk = bp.offer(dict(queue[state["i"]], due_s=due()))
            state["i"] += 1
            if tk is not None:
                tickets.append(tk)

    t0 = time.perf_counter()
    while True:
        svc.run_until_idle(poll)
        if state["i"] >= len(queue) and not svc.pending:
            break
        # shed-everything stall guard: let the token bucket refill
        time.sleep(0.002)
    wall = time.perf_counter() - t0

    done = [tk for tk in tickets if tk.status == "done"]
    lat = np.array([tk.latency_s for tk in done]) if done else np.array([0.0])
    report = {
        "offered": bp.offered,
        "admitted": len(tickets),
        "shed": bp.shed,
        "shed_rate": bp.shed_rate,
        "timeouts": sum(tk.status == "timeout" for tk in tickets),
        "completed": len(done),
        "qps": len(done) / wall if wall > 0 else 0.0,
        "p50_ms": 1e3 * float(np.quantile(lat, .50)),
        "p95_ms": 1e3 * float(np.quantile(lat, .95)),
        "p99_ms": 1e3 * float(np.quantile(lat, .99)),
        "wall_s": wall,
        "cache": svc.stats,     # window-TEL LRU + TTI core-cache counters
    }
    return svc, tickets, report


def serve_stream(graph, requests, *, qps: float, ingest=None,
                 wave="auto", depth: int = 2, cluster_gap: int = 0,
                 warm: bool = True, cache=True, prewarm: int = 0,
                 wal_dir=None, fsync: str = "batch", svc=None,
                 device=None):
    """Drive a TCQService with an open-loop arrival schedule.

    ``requests`` is a list of dicts with an ``arrive_s`` offset
    (``TCQRequestStream.open_loop`` format); ``ingest`` is an optional
    iterator of (u, v, t) arrival batches pushed one per poll interval.
    ``prewarm`` > 0 peels up to that many of the hottest observed windows
    into the TTI core cache whenever the loop goes idle between
    arrivals (``TCQService.prewarm``) — idle lanes buy warm hits for the
    recurring traffic.  ``wal_dir``/``fsync`` attach a write-ahead
    journal so every admission and ingest batch survives a crash
    (``TCQService.recover``); pass a pre-built ``svc`` (e.g. one that
    was just recovered) to drive it instead of constructing a fresh
    service.  ``device`` is the service's (CUDA unless told otherwise).
    Returns (service, served tickets, wall seconds).
    """
    from repro_torch.core import TCQService

    if svc is None:
        # retain_snapshots=False: a long-lived server must not keep one
        # O(E) graph snapshot alive per ingested epoch through its
        # ticket history
        svc = TCQService(graph, device=device, wave=wave, depth=depth,
                         cluster_gap=cluster_gap, retain_snapshots=False,
                         cache=cache, wal_dir=wal_dir, fsync=fsync)
    if warm and requests:
        # one request first, so latency percentiles measure the steady
        # state, not the kernels' first build and launch
        r0 = requests[0]
        svc.submit({k: r0[k] for k in ("k", "ts", "te")})
        svc.run_until_idle()
        svc.completed.clear()
        svc.pool_log.clear()
    queue = sorted(requests, key=lambda r: r["arrive_s"])
    ingest = iter(ingest) if ingest is not None else None
    state = {"i": 0, "epochs": 0, "t0": svc.now()}

    def poll(s):
        now = s.now() - state["t0"]
        while state["i"] < len(queue) and queue[state["i"]]["arrive_s"] <= now:
            # latency counts from the schedule's arrival, not from this
            # poll, which may come a whole pool later
            r = queue[state["i"]]
            s.submit(dict(r, due_s=state["t0"] + r["arrive_s"]))
            state["i"] += 1
        if ingest is not None and state["epochs"] < state["i"]:
            # one ingestion batch per served arrival tranche: edges land
            # continuously while queries are in flight
            try:
                u, v, t = next(ingest)
                s.push_edges(u, v, t)
                state["epochs"] += 1
            except StopIteration:
                pass

    served = []
    while state["i"] < len(queue) or svc.pending:
        out = svc.run_until_idle(poll)
        served.extend(out)
        if state["i"] < len(queue):
            # idle before the next arrival: spend the gap prewarming the
            # hottest windows, then sleep to the arrival time
            if prewarm > 0:
                svc.prewarm(prewarm)
            nxt = queue[state["i"]]["arrive_s"] - (svc.now() - state["t0"])
            if nxt > 0:
                time.sleep(min(nxt, 0.05))
    wall = svc.now() - state["t0"]
    return svc, served, wall


def serve_distributed(graph, requests, *, mesh, combine="auto",
                      controllers: int = 1, wave="auto", depth: int = 2,
                      cache: bool = False, warm: bool = True):
    """Multi-controller open-loop driver over the sharded engine.

    ``controllers`` independent arrival processes (the open-loop request
    list partitioned round-robin, each keeping its own arrival clock) are
    interleaved into one pump loop: ``TCQService`` is single-writer, so
    the controllers multiplex submissions rather than run threads.  Every
    rank of ``mesh`` runs this same loop; arrivals are read off
    ``TCQService.now`` (rank 0's clock on every rank), so every rank
    admits the same requests at the same pump.

    Returns ``(svc, served, report)``; ``report`` carries aggregate and
    per-controller qps / p50 / p95 / p99 plus the mesh shape, combine,
    per-shard lane occupancy and combine-collective bytes.
    """
    from repro_torch.core import TCQService

    svc = TCQService(graph, wave=wave, depth=depth, retain_snapshots=False,
                     cache=cache, mesh=mesh, combine=combine)
    if warm and requests:
        r0 = requests[0]
        svc.submit({k: r0[k] for k in ("k", "ts", "te")})
        svc.run_until_idle()
        svc.completed.clear()
        svc.pool_log.clear()
    n = max(1, int(controllers))
    lanes = [sorted((r for j, r in enumerate(requests) if j % n == c),
                    key=lambda r: r["arrive_s"]) for c in range(n)]
    owner = {}
    state = {"i": [0] * n, "t0": svc.now()}

    def poll(s):
        now = s.now() - state["t0"]
        for c in range(n):
            q, i = lanes[c], state["i"][c]
            while i < len(q) and q[i]["arrive_s"] <= now:
                tk = s.submit(dict(q[i],
                                   due_s=state["t0"] + q[i]["arrive_s"]))
                owner[tk.id] = c
                i += 1
            state["i"][c] = i

    served = []
    while any(state["i"][c] < len(lanes[c]) for c in range(n)) or svc.pending:
        served.extend(svc.run_until_idle(poll))
        nxt = min((lanes[c][state["i"][c]]["arrive_s"]
                   for c in range(n) if state["i"][c] < len(lanes[c])),
                  default=None)
        if nxt is not None:
            gap = nxt - (svc.now() - state["t0"])
            if gap > 0:
                time.sleep(min(gap, 0.05))
    wall = svc.now() - state["t0"]

    def _pcts(tks):
        lat = (np.array([tk.latency_s for tk in tks]) if tks
               else np.array([0.0]))
        return {"completed": len(tks),
                "qps": len(tks) / wall if wall > 0 else 0.0,
                "p50_ms": 1e3 * float(np.quantile(lat, .50)),
                "p95_ms": 1e3 * float(np.quantile(lat, .95)),
                "p99_ms": 1e3 * float(np.quantile(lat, .99))}

    per = [dict(controller=c,
                **_pcts([tk for tk in served if owner.get(tk.id) == c]))
           for c in range(n)]
    dist = svc.stats["distributed"]
    occ = [p["shard_occupancy"] for p in svc.pool_log
           if p.get("shard_occupancy")]
    report = dict(_pcts(served))
    report.update({
        "controllers": per,
        "wall_s": wall,
        "mesh": dist["mesh"],
        "combine": dist["combine"],
        "backend": dist["backend"],
        "collective_bytes": dist["collective_bytes"],
        "shard_occupancy": ([float(x) for x in np.mean(occ, axis=0)]
                            if occ else []),
    })
    return svc, served, report


def tickets_digest(tickets) -> str:
    """sha256 over every ticket's id, status and cores (TTI, vertices,
    edge count): equal digests mean equal answers."""
    import hashlib

    h = hashlib.sha256()
    for tk in sorted(tickets, key=lambda tk: tk.id):
        cores = sorted((key, c.vertices.tolist(), c.n_edges)
                       for key, c in tk.result.by_tti().items())
        h.update(repr((tk.id, tk.status, cores)).encode())
    return h.hexdigest()


def _distributed_run(args: dict, mesh=None) -> dict:
    """One rank of ``--distributed``: the graph and requests ``main``
    would serve, through :func:`serve_distributed`.  Returns the report
    and the tickets' digest.  Run in each spawned rank of
    ``--fake-devices`` (which passes no mesh), or in-process."""
    from repro_torch.data import TCQRequestStream
    from repro_torch.graphs import powerlaw_temporal
    from repro_torch.launch.mesh import Mesh

    if mesh is None:
        import torch.distributed as dist

        world = dist.get_world_size()
        if world % args["model_shards"]:
            raise ValueError(f"--model-shards {args['model_shards']} does "
                             f"not divide {world} ranks")
        mesh = Mesh((world // args["model_shards"], args["model_shards"]),
                    device=args["device"])
    g = powerlaw_temporal(args["vertices"], args["edges"], args["span"],
                          seed=3)
    lo, hi = g.span
    reqs = list(TCQRequestStream(lo, hi, k=args["k"],
                                 span=max(64, args["span"] // 20),
                                 seed=0).open_loop(args["requests"],
                                                   args["qps"]))
    wave = args["wave"] if args["wave"] == "auto" else int(args["wave"])
    svc, served, rep = serve_distributed(
        g, reqs, mesh=mesh, combine=args["combine"],
        controllers=args["controllers"], wave=wave, depth=args["depth"],
        cache=not args["no_cache"])
    return {"report": rep, "digest": tickets_digest(served),
            "rank": mesh.rank}


def _print_distributed(rep: dict) -> None:
    print(f"[serve] distributed: {rep['completed']} requests in "
          f"{rep['wall_s']:.2f}s ({rep['qps']:.2f} qps aggregate) on "
          f"mesh {rep['mesh']} over {rep['backend']} "
          f"(combine={rep['combine']})")
    print(f"[serve] latency p50 {rep['p50_ms']:.1f} ms | "
          f"p95 {rep['p95_ms']:.1f} ms | p99 {rep['p99_ms']:.1f} ms")
    for c in rep["controllers"]:
        print(f"[serve]   controller#{c['controller']}: "
              f"{c['completed']} done, {c['qps']:.2f} qps, "
              f"p50 {c['p50_ms']:.1f} / p95 {c['p95_ms']:.1f} / "
              f"p99 {c['p99_ms']:.1f} ms")
    occ = ", ".join(f"{x:.2f}" for x in rep["shard_occupancy"])
    print(f"[serve] per-shard lane occupancy [{occ}], "
          f"{rep['collective_bytes']} combine-collective bytes")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--vertices", type=int, default=2_000)
    ap.add_argument("--edges", type=int, default=30_000)
    ap.add_argument("--span", type=int, default=16_384)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--qps", type=float, default=4.0,
                    help="open-loop arrival rate (requests/sec)")
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--wave", default="auto")
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--ingest-batches", type=int, default=4,
                    help="edge arrival batches streamed during serving")
    ap.add_argument("--deadline-s", type=float, default=0.0,
                    help="per-request deadline in seconds from submission; "
                         "requests past it are timed out mid-pool with "
                         "partial results (0 = best-effort, no deadline)")
    ap.add_argument("--queue-cap", type=int, default=64,
                    help="bounded admission queue depth; at capacity, "
                         "queued requests past their deadline are shed "
                         "first, then new arrivals are shed")
    ap.add_argument("--qps-ceiling", type=float, default=0.0,
                    help="admission rate ceiling (token bucket); arrivals "
                         "above it are shed outright (0 = unlimited)")
    ap.add_argument("--closed-loop", action="store_true",
                    help="closed loop: keep --concurrency requests "
                         "outstanding (deterministic overload) instead of "
                         "the open-loop arrival clock; reports shed rate "
                         "alongside latency percentiles")
    ap.add_argument("--concurrency", type=int, default=8,
                    help="outstanding requests in --closed-loop mode")
    ap.add_argument("--no-cache", action="store_true",
                    help="disable the TTI-keyed core-result cache "
                         "(every request recomputes from scratch)")
    ap.add_argument("--prewarm", type=int, default=0,
                    help="open-loop mode: peel up to N of the hottest "
                         "observed windows into the core cache whenever "
                         "the loop idles between arrivals (0 = off)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the service's engine: 'cuda' "
                         "(default; raises without a card) or 'cpu' (the "
                         "plain versions of the kernels)")
    ap.add_argument("--distributed", action="store_true",
                    help="serve through the sharded pipeline on a mesh of "
                         "every rank of the world")
    ap.add_argument("--combine", default="auto",
                    choices=["auto", "psum", "rs_ag"])
    ap.add_argument("--fake-devices", type=int, default=0,
                    help="--distributed: spawn N gloo ranks (on the CPU "
                         "with --device cpu; sharing the card through host "
                         "memory with --device cuda)")
    ap.add_argument("--model-shards", type=int, default=1,
                    help="ranks along the model (edge-sharding) axis; the "
                         "rest go to the lane axis")
    ap.add_argument("--controllers", type=int, default=1,
                    help="interleaved open-loop arrival processes in "
                         "--distributed mode")
    ap.add_argument("--wal-dir", default=None,
                    help="write-ahead journal directory: every admission "
                         "and ingest batch is logged before it is applied; "
                         "on start, an existing journal is recovered "
                         "(newest valid snapshot + tail replay) and served "
                         "from, and a checkpoint is written on clean exit")
    ap.add_argument("--fsync", default="batch",
                    choices=["always", "batch", "off"],
                    help="journal flush policy: 'always' fsyncs every "
                         "record (no acknowledged op can be lost), "
                         "'batch' fsyncs at pump boundaries (bounded loss "
                         "on power failure only), 'off' leaves flushing "
                         "to the OS")
    args = ap.parse_args()

    if args.distributed:
        opts = {k: getattr(args, k) for k in (
            "vertices", "edges", "span", "requests", "qps", "k", "wave",
            "depth", "combine", "controllers", "model_shards", "no_cache",
            "device")}
        if args.fake_devices:
            from repro_torch.launch.world import run_world

            outs = run_world("repro_torch.launch.serve:_distributed_run",
                             args.fake_devices, args=(opts,),
                             backend="gloo", timeout_s=1800)
        else:
            from repro_torch.launch.mesh import make_host_mesh

            mesh = make_host_mesh(args.model_shards, device=args.device)
            outs = [_distributed_run(opts, mesh)]
            if mesh.rank:
                return
        _print_distributed(outs[0]["report"])
        digests = {o["digest"] for o in outs}
        if len(digests) != 1:
            raise SystemExit(f"[serve] ranks disagree: {len(digests)} "
                             "different ticket digests")
        print(f"[serve] {len(outs)} spawned ranks agree on every ticket "
              f"(digest {outs[0]['digest'][:16]})" if len(outs) > 1 else
              f"[serve] ticket digest {outs[0]['digest'][:16]}")
        return

    from repro_torch.data import TCQRequestStream
    from repro_torch.graphs import EdgeStream, powerlaw_temporal

    g = powerlaw_temporal(args.vertices, args.edges, args.span, seed=3)
    lo, hi = g.span

    wave = args.wave if args.wave == "auto" else int(args.wave)

    if args.closed_loop:
        reqs = list(TCQRequestStream(lo, hi, k=args.k,
                                     span=max(64, args.span // 20),
                                     seed=0).requests(args.requests))
        svc, tickets, rep = serve_closed_loop(
            g, reqs, concurrency=args.concurrency,
            queue_cap=args.queue_cap, qps_ceiling=args.qps_ceiling,
            deadline_s=args.deadline_s, wave=wave, depth=args.depth,
            cache=not args.no_cache, device=args.device)
        print(f"[serve] closed loop: {rep['offered']} offered, "
              f"{rep['completed']} completed in {rep['wall_s']:.2f}s "
              f"({rep['qps']:.2f} qps), {rep['shed']} shed "
              f"(rate {rep['shed_rate']:.2%}), {rep['timeouts']} timeouts")
        print(f"[serve] latency p50 {rep['p50_ms']:.1f} ms | "
              f"p95 {rep['p95_ms']:.1f} ms | p99 {rep['p99_ms']:.1f} ms")
        print(_cache_report(rep["cache"]))
        return

    reqs = list(TCQRequestStream(lo, hi, k=args.k,
                                 span=max(64, args.span // 20),
                                 seed=0).open_loop(args.requests, args.qps))
    if args.deadline_s > 0.0:
        for r in reqs:
            r["deadline_s"] = args.deadline_s
    future = powerlaw_temporal(args.vertices, max(args.edges // 8, 64),
                               args.span // 4, seed=5)
    arrivals = ((u, v, t + hi) for u, v, t in
                EdgeStream.replay(future, max(1, args.ingest_batches)))

    svc = None
    if args.wal_dir is not None:
        from repro_torch.core import TCQService
        from repro_torch.core.wal import list_snapshots

        if list_snapshots(args.wal_dir):
            # recovery-on-start: pick up exactly where the previous
            # process died — queued tickets drain first, then new traffic
            svc = TCQService.recover(args.wal_dir, fsync=args.fsync,
                                     device=args.device, wave=wave,
                                     depth=args.depth,
                                     retain_snapshots=False,
                                     cache=not args.no_cache)
            rr = svc.recovery_report
            print(f"[serve] recovered from {rr['snapshot']} + "
                  f"{rr['wal_records']} journal records in "
                  f"{1e3 * rr['recover_s']:.1f} ms "
                  f"({rr['pending_after']} tickets re-queued, epoch "
                  f"{rr['epoch_after']}"
                  + (f", {len(rr['tail_events'])} torn/corrupt tail "
                     f"records cut" if rr["tail_events"] else "")
                  + (f", {len(rr['snapshots_skipped'])} corrupt "
                     f"snapshots skipped" if rr["snapshots_skipped"]
                     else "") + ")")

    svc, served, wall = serve_stream(g, reqs, qps=args.qps, ingest=arrivals,
                                     wave=wave, depth=args.depth,
                                     cache=not args.no_cache,
                                     prewarm=args.prewarm,
                                     wal_dir=args.wal_dir, fsync=args.fsync,
                                     svc=svc, device=args.device)
    lat = np.array([tk.latency_s for tk in served])
    occ = [p["occupancy"] for p in svc.pool_log if p["device_steps"]]
    mid = sum(p["admitted_midflight"] for p in svc.pool_log)
    for tk in sorted(served, key=lambda tk: tk.id)[:8]:
        print(f"req#{tk.id:03d} k={tk.k} window=[{tk.ts},{tk.te}] "
              f"epoch={tk.epoch} -> {len(tk.result)} cores "
              f"({1e3 * tk.latency_s:.1f} ms)")
    print(f"\n[serve] {len(served)} requests in {wall:.2f}s "
          f"({len(served) / wall:.2f} qps sustained, target {args.qps}) "
          f"over {svc.epoch} ingested epochs")
    print(f"[serve] latency p50 {1e3 * np.quantile(lat, .5):.1f} ms | "
          f"p95 {1e3 * np.quantile(lat, .95):.1f} ms | "
          f"p99 {1e3 * np.quantile(lat, .99):.1f} ms")
    print(f"[serve] {len(svc.pool_log)} pools, "
          f"mean occupancy {np.mean(occ) if occ else 0:.1f} cells/step, "
          f"{mid} mid-flight admissions, "
          f"{sum(tk.status == 'timeout' for tk in served)} deadline timeouts")
    print(_cache_report(svc.stats))
    if svc.wal is not None:
        ck = svc.checkpoint()
        ws = svc.wal.stats()
        print(f"[serve] journal: {ws['records_appended']} records / "
              f"{ws['bytes_appended']} bytes appended "
              f"(fsync={ws['fsync']}, {ws['syncs']} syncs); clean-exit "
              f"checkpoint seq {ck['wal_seq']} in "
              f"{1e3 * ck['checkpoint_s']:.1f} ms "
              f"({ck['gc_removed']} files GC'd)")


if __name__ == "__main__":
    main()
