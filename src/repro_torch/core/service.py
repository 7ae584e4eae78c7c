"""Streaming TCQ service runtime: continuous query traffic over a living
temporal graph (PyTorch port of ``repro.core.service``).

The service is host-side bookkeeping over the port's :class:`TCQEngine`,
which runs on CUDA unless ``device=`` names another device: every pool
it forms peels through the engine's wave step — the wave_peel kernel on
the card.  Snapshots, journals and tickets are the JAX package's formats,
so a snapshot dict or a journal directory written by either package
restores and recovers in the other.

``TCQEngine.query_batch`` answers a *fixed* request set behind a drain
barrier — admit, run, return.  A serving system sees neither fixed sets
nor a frozen graph: requests arrive while earlier ones are still peeling,
and `EdgeStream.push` batches land between (and during) waves.  This
module owns that continuous loop:

* **Tickets and epoch pinning** — :meth:`TCQService.submit` stamps each
  request with the engine epoch *and the graph snapshot* current at
  admission.  Snapshots are immutable (``add_edges`` returns a new
  ``TemporalGraph``), so pinning is a reference, not a copy; a query
  admitted at epoch e is answered exactly over epoch e's edges no matter
  how many ingestion batches land while it runs (snapshot consistency —
  results are bit-identical to querying the pinned snapshot alone).

* **Window-clustered lane pools** — co-admitted requests are grouped by
  window overlap (:func:`cluster_windows`), and each cluster peels
  against a TEL truncated to *its own* union window instead of one
  bloated global union.  Disjoint far-apart windows — the worst case for
  ``query_batch``'s single union TEL, whose per-iteration peel cost
  scales with the union's edge count — become separate tight pools.

* **Mid-flight admission** — each pool runs through
  ``WavePipeline.run_pool(..., admit=...)``: whenever lanes free up, the
  service's admit hook (optionally after polling the caller for new
  arrivals/ingestion) admits every pending ticket whose epoch matches
  the pool and whose window fits inside the pool's TEL.  Lanes freed by
  a draining query's tail are refilled by *newly arrived* queries with
  no barrier in between; tickets that don't fit the live pool are served
  by the next ``pump``.

The serving loop is deliberately synchronous; ``poll`` callbacks are the
seam where a real frontend — or the open and closed loops in
``launch/serve.py`` — injects arrivals and edge ingestion mid-flight.

* **On a mesh** (``mesh=``, ``core/distributed.py``) every rank runs this
  same loop over the same inputs, and each pool peels through the
  sharded pipeline.  Every clock read that steers the loop (deadlines,
  timeouts, the frontends' arrivals and sheds) goes through
  :meth:`TCQService.now`, which is rank 0's clock on every rank: ranks
  that read their own clocks could take different decisions, and then
  one would enter a collective the others never reach.  A journal
  there is rank 0's alone (``core/wal.py::MeshJournal``): it writes the
  records and the snapshots, and every rank keeps its sequence numbers;
  :meth:`TCQService.recover` reads the directory on rank 0 and replays
  the same records on every rank.
"""

from __future__ import annotations

import dataclasses
import json
import time
from collections import Counter, deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import wal as walmod
from repro_torch.core.graph import TemporalGraph
from repro_torch.core.otcd import TCQEngine
from repro_torch.core.results import QueryStats, TCQResult
from repro_torch.core.scheduler import QueryState


# ---------------------------------------------------------------- clustering
def cluster_windows(windows: Sequence[Tuple[int, int]],
                    gap: int = 0) -> List[List[int]]:
    """Group window indices by overlap (union-find via interval sweep).

    Windows whose intervals overlap — or sit within ``gap`` of each other
    — land in one cluster; the result is a partition of ``range(len)``
    ordered by cluster start.  O(n log n).  A cluster's union window is
    exactly the union of its members, so each cluster's TEL truncation
    is tight: no member pays for edges only another cluster needs.
    """
    if not windows:
        return []
    order = sorted(range(len(windows)), key=lambda i: windows[i])
    clusters: List[List[int]] = [[order[0]]]
    hi = windows[order[0]][1]
    for i in order[1:]:
        lo_i, hi_i = windows[i]
        if lo_i <= hi + gap:
            clusters[-1].append(i)
            hi = max(hi, hi_i)
        else:
            clusters.append([i])
            hi = hi_i
    return clusters


# -------------------------------------------------------------------- ticket
#: terminal ticket statuses — ``done`` (full result), ``timeout`` (deadline
#: passed; partial result of whatever cells completed), ``cancelled``
#: (client withdrawal, same partial-result contract), ``shed`` (dropped by
#: the frontend's load shedder before admission).
TERMINAL_STATUSES = ("done", "timeout", "cancelled", "shed")


@dataclasses.dataclass
class TCQTicket:
    """One in-flight (or completed) service request.

    ``epoch``/``graph`` pin the TEL snapshot current at admission: the
    result is computed over exactly those edges, regardless of ingestion
    that lands later.  ``uts`` is the snapshot's unique-timestamp slice
    for the window (the schedule's column space), fixed at submit time.

    ``deadline`` is an *absolute* ``TCQService.now()`` instant (None =
    best-effort); ``priority`` breaks deadline ties, lower first.  The
    pair drives both pool formation (EDF head-of-line) and in-pool lane
    claiming (:class:`~repro_torch.core.scheduler.QueryState`'s EDF key).
    Lifecycle: ``queued`` → ``running`` → one of
    :data:`TERMINAL_STATUSES`.
    """

    id: int
    k: int
    h: int
    ts: int
    te: int
    epoch: int
    graph: TemporalGraph
    uts: np.ndarray
    submit_s: float
    priority: int = 0
    deadline: Optional[float] = None
    status: str = "queued"
    admit_s: Optional[float] = None
    done_s: Optional[float] = None
    result: Optional[TCQResult] = None
    state: Optional[QueryState] = None

    @property
    def done(self) -> bool:
        return self.status in TERMINAL_STATUSES

    @property
    def edf_key(self) -> Tuple[float, int, int]:
        """Earliest-deadline-first ordering key (ties: priority, then
        arrival order — (inf, 0, id) degenerates to exact FIFO)."""
        d = self.deadline if self.deadline is not None else float("inf")
        return (d, self.priority, self.id)

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline

    @property
    def latency_s(self) -> Optional[float]:
        """Submit-to-completion latency (the serving metric)."""
        if self.done_s is None:
            return None
        return self.done_s - self.submit_s

    @property
    def window(self) -> Tuple[int, int]:
        """Schedule-tight window: the snapshot timestamps actually swept."""
        return int(self.uts[0]), int(self.uts[-1])


# ------------------------------------------------------------------- service
class TCQService:
    """Continuous multi-tenant TCQ serving over a streaming graph.

    Parameters
    ----------
    graph:
        Initial snapshot (or pass ``engine=`` to wrap an existing one).
    device:
        Device of the engine the service builds: CUDA by default (raising
        without it); ``"cpu"`` runs the plain versions of the kernels.
        Ignored with ``engine=``.
    wave:
        Lane count per pool, or ``"auto"`` (default) — autotuned per pool
        from the cluster's union-window edge count, member count and ring
        depth.
    depth:
        Slot-ring depth D of each pool's pipeline.
    cluster_gap:
        Two windows whose gap is <= this many time units still share a
        cluster (0 = pure overlap).  Small positive values trade a
        slightly looser TEL for fewer, fuller pools.
    cache:
        TTI-keyed core-result caching (``corecache.CoreCache``) for
        engines the service builds itself: True (default) builds one,
        False disables it, an instance is used as-is.  Ignored when an
        external ``engine=`` is passed — its own ``cache`` setting wins
        (wrapping a shared engine must not change its semantics).
        Admission probes the cache before pool formation, so a request
        whose every cell resolves never joins a pool (and never widens a
        cluster's union window); peeled cells are inserted as they
        retire; ingest invalidates incrementally (see ``update_graph``).
    wal_dir / fsync / wal:
        Durability (``core.wal``).  ``wal_dir`` attaches a write-ahead
        journal: every accepted mutation — edge batch, ticket admission,
        cancellation, external snapshot install — is logged *before* it
        is applied, so :meth:`recover` can rebuild the exact pre-crash
        state from the newest valid snapshot plus the journal tail.
        ``fsync`` picks the flush policy (``always``/``batch``/``off``,
        see :class:`~repro_torch.core.wal.WriteAheadLog`).  ``wal=`` accepts a
        pre-built (or fault-injecting) log instance directly and wins
        over ``wal_dir``.  If the directory holds no snapshot yet, a
        genesis checkpoint of the initial graph is written so recovery
        is always total.  Default (all None): no journal — only explicit
        snapshots (:meth:`save_snapshot`) persist state.
    resilience:
        Degradation ladder for the engine the service builds (see
        ``TCQEngine``).  On the card a kernel failure raises with or
        without it; with it the failure is also logged.
    mesh / combine:
        Shard every pool over a ``launch.mesh.Mesh`` (see ``TCQEngine``);
        the pool log then carries ``shard_occupancy`` and
        ``collective_bytes``, and ``stats["distributed"]`` the mesh's
        counters.  On a mesh of several ranks the journal is rank 0's
        (``core/wal.py::MeshJournal``): every rank passes ``wal_dir`` (or
        ``wal=``, on rank 0 alone), rank 0 writes the records and every
        snapshot, the other ranks write nothing and keep the same
        sequence numbers, and ``svc.wal.stats()`` and ``checkpoint()``
        return rank 0's values on every rank.

    Usage::

        svc = TCQService(graph)
        t1 = svc.submit({"k": 3, "ts": 10, "te": 500})
        svc.push_edges(u, v, t)                  # new epoch; t1 unaffected
        t2 = svc.submit({"k": 2, "ts": 40, "te": 90})   # sees new edges
        svc.run_until_idle()
        t1.result, t1.latency_s

    ``pump(poll=...)`` serves one cluster-pool; ``poll`` is invoked
    between waves (whenever lanes free) so the caller can submit new
    requests or push edges *mid-flight* — compatible arrivals join the
    running pool immediately.
    """

    def __init__(self, graph: Optional[TemporalGraph] = None, *,
                 engine: Optional[TCQEngine] = None, device=None,
                 wave="auto", depth: int = 2, cluster_gap: int = 0,
                 use_kernel: Optional[bool] = None,
                 retain_snapshots: bool = True,
                 resilience=None, cache=True,
                 mesh=None, combine: str = "auto",
                 wal_dir: Optional[str] = None, fsync: str = "batch",
                 wal=None):
        if engine is None:
            if graph is None:
                raise ValueError("need a graph or an engine")
            engine = TCQEngine(graph, device=device, use_kernel=use_kernel,
                               resilience=resilience, cache=cache,
                               mesh=mesh, combine=combine)
        self.engine = engine
        mesh = engine.mesh
        self._clock = time.perf_counter if mesh is None else mesh.clock
        self.wave = wave
        self.depth = int(depth)
        self.cluster_gap = int(cluster_gap)
        # --- durability: write-ahead journal (core.wal).  _replaying
        # suppresses the hooks while recover() feeds journal records back
        # through the very paths that wrote them.
        self._replaying = False
        self.recovery_report: Optional[Dict] = None
        if mesh is not None and mesh.size > 1:
            self.wal = walmod.MeshJournal.attach(mesh, wal=wal,
                                                 wal_dir=wal_dir,
                                                 fsync=fsync)
        elif wal is not None:
            self.wal = wal
        elif wal_dir is not None:
            self.wal = walmod.WriteAheadLog(wal_dir, fsync=fsync)
        else:
            self.wal = None
        self.retained_checkpoints = 2   # corrupt-newest fallback stays lossless
        # arrival-process window histogram: (k, h, ts, te) -> count.
        # prewarm() peels the hottest uncached windows during idle time so
        # recurring traffic hits a warm cache.
        self._hist: Counter = Counter()
        self._prewarmed = 0
        # False drops each ticket's pinned graph reference once it
        # completes, so a long-running service does not hold one O(E)
        # snapshot per epoch alive through its history (the caller owns
        # trimming ``completed``/``pool_log`` themselves)
        self.retain_snapshots = bool(retain_snapshots)
        self._pending: Deque[TCQTicket] = deque()
        self._fresh: List[TCQTicket] = []   # resolved-at-submit tickets
        # live pool members (pump removes them from _pending while lanes
        # run) — snapshot() must still see the unresolved ones, or a
        # checkpoint taken from a mid-pool poll/admit hook would drop them
        self._inflight: List[TCQTicket] = []
        self.completed: List[TCQTicket] = []
        self._next_id = 0
        self.pool_log: List[Dict] = []      # one record per pool run
        if self.wal is not None and not self._on_writer(
                lambda log: bool(walmod.list_snapshots(log.dir))):
            # genesis checkpoint: a directory with no snapshot would make
            # recover() partial (nothing to replay the tail onto), so the
            # initial graph is persisted at the active sequence number —
            # every later journal record lands in a segment >= it
            self._write_snapshot_file(self.wal.active_seq)

    def now(self) -> float:
        """The service's clock, ``time.perf_counter()``; on a mesh, rank
        0's reading on every rank (``Mesh.clock``), so that every clock
        decision is the same on every rank."""
        return self._clock()

    def _on_writer(self, fn, *, barrier: bool = False):
        """``fn(log)`` on the rank that writes the journal; on a mesh of
        several ranks, rank 0's value on every rank
        (``MeshJournal.share``)."""
        if isinstance(self.wal, walmod.MeshJournal):
            return self.wal.share(fn, barrier=barrier)
        return fn(self.wal)

    def _journal(self, kind: str, meta: Dict, arrays=None) -> None:
        """Append one write-ahead record (no-op without a journal, and
        during :meth:`recover`'s replay of the very records being read)."""
        if self.wal is not None and not self._replaying:
            self.wal.append(kind, meta, arrays)

    # ------------------------------------------------------------- ingestion
    @property
    def epoch(self) -> int:
        return self.engine.epoch

    @property
    def graph(self) -> TemporalGraph:
        return self.engine.graph

    def push_edges(self, u, v, t) -> int:
        """Merge-append an arrival batch; returns the new epoch.  O(E+B)
        host work; in-flight/pending tickets keep their pinned snapshot.

        With a journal attached, the batch is logged *after* validation
        (``add_edges`` raising means the batch was never accepted — a
        rejected batch must not be replayed) but *before* the engine
        installs the new epoch, together with the post-state the replay
        must reproduce (edge/pair/vertex counts and the canonical-array
        fingerprint — the lineage check, since ``uid`` is process-local).
        """
        g = self.engine.graph.add_edges(u, v, t)
        if g is self.engine.graph:          # empty/self-loop-only batch
            return self.engine.epoch
        if self.wal is not None and not self._replaying:
            self._journal("edges", {
                "graph_epoch": int(g.epoch),
                "num_edges": g.num_edges, "num_pairs": g.num_pairs,
                "num_vertices": int(g.num_vertices),
                "fingerprint": g.fingerprint(),
            }, {"u": np.asarray(u), "v": np.asarray(v),
                "t": np.asarray(t)})
        return self.engine.update_graph(g)

    def ingest_graph(self, graph: TemporalGraph) -> int:
        """Install an externally built snapshot (``EdgeStream`` subscriber
        form: ``stream.subscribe(svc.ingest_graph)``).  Journaled as the
        graph's full canonical state (there is no batch to re-derive it
        from), fingerprint-checked on replay like :meth:`push_edges`."""
        if self.wal is not None and not self._replaying:
            self._journal("install", {
                "graph_epoch": int(graph.epoch),
                "num_vertices": int(graph.num_vertices),
                "fingerprint": graph.fingerprint(),
            }, graph.state_dict())
        return self.engine.update_graph(graph)

    def connect(self, stream) -> None:
        """Subscribe to an ``EdgeStream`` so pushes land as new epochs."""
        stream.subscribe(self.ingest_graph)

    # ------------------------------------------------------------ submission
    def submit(self, request) -> TCQTicket:
        """Admit one request; returns its ticket (resolved immediately for
        windows containing no snapshot timestamps).

        ``request`` is a mapping with ``k``, ``ts``, ``te`` and optional
        ``h``, ``priority`` (lower runs first) and ``deadline_s``
        (seconds from submission; the ticket is cancelled — with partial
        results — once it passes) — the ``TCQRequestStream`` format.
        """
        r = dict(request)
        now = self.now()
        g = self.engine.graph
        uts = g.unique_ts
        uts = uts[(uts >= int(r["ts"])) & (uts <= int(r["te"]))]
        uts = uts.astype(np.int64)
        dl = r.get("deadline_s")
        # write-ahead: the admission record precedes the enqueue, so a
        # crash between the two replays the admission (at-least-once;
        # results are deterministic in the request + pinned epoch).
        # ids are sequential and every admission is journaled, so replay
        # reproduces them exactly (recover() asserts this).
        self._journal("submit", {
            "id": int(self._next_id), "k": int(r["k"]),
            "h": int(r.get("h", 1)), "ts": int(r["ts"]),
            "te": int(r["te"]), "priority": int(r.get("priority", 0)),
            "deadline_s": None if dl is None else float(dl),
            "submit_unix_s": time.time(),
        })
        tk = TCQTicket(id=self._next_id, k=int(r["k"]),
                       h=int(r.get("h", 1)), ts=int(r["ts"]),
                       te=int(r["te"]), epoch=self.engine.epoch, graph=g,
                       uts=uts, submit_s=now,
                       priority=int(r.get("priority", 0)),
                       deadline=None if dl is None else now + float(dl))
        self._next_id += 1
        n = int(uts.size)
        if n == 0:
            tk.result = TCQResult([], QueryStats(n_timestamps=0))
            tk.status = "done"
            tk.admit_s = tk.done_s = now
            tk.result.stats.wall_time_s = 0.0
            self._retire(tk)
            self._fresh.append(tk)      # handed back by the next pump()
            return tk
        self._hist[(tk.k, tk.h, tk.ts, tk.te)] += 1
        self._pending.append(tk)
        return tk

    @property
    def pending(self) -> int:
        return len(self._pending)

    @property
    def pending_tickets(self) -> Tuple[TCQTicket, ...]:
        return tuple(self._pending)

    # ------------------------------------------------- cancellation/deadlines
    def cancel(self, tk: TCQTicket, *, status: str = "cancelled") -> bool:
        """Withdraw a ticket (client cancel / deadline timeout / shed).

        Queued tickets resolve immediately with an empty partial result;
        a *running* ticket is flagged so the live pool reclaims its lanes
        at the next wave and finalizes it with whatever cells already
        completed.  False if the ticket had already resolved.
        """
        if tk.done:
            return False
        self._journal("cancel", {"id": int(tk.id), "status": str(status)})
        now = self.now()
        tk.status = status
        if tk.state is not None:
            tk.state.cancel()           # pool frees its lanes mid-flight
        if tk in self._pending:         # queued: resolve on the spot
            self._pending.remove(tk)
            self._resolve_unrun(tk, now)
        return True

    def _resolve_unrun(self, tk: TCQTicket, now: float) -> None:
        """Terminal bookkeeping for a ticket cancelled before it ever
        held a lane (no state to decode — empty partial result)."""
        st = QueryStats(n_timestamps=int(tk.uts.size))
        st.wall_time_s = now - tk.submit_s
        tk.result = TCQResult([], st)
        tk.done_s = now
        self._retire(tk)
        self._fresh.append(tk)          # handed back by the next pump()

    def expire(self, now: Optional[float] = None) -> List[TCQTicket]:
        """Time out every *queued* ticket past its deadline (running
        tickets are swept by the live pool's admit hook).  Returns the
        newly timed-out tickets."""
        now = self.now() if now is None else now
        hit = [tk for tk in self._pending if tk.expired(now)]
        for tk in hit:
            self.cancel(tk, status="timeout")
        return hit

    # --------------------------------------------------------------- serving
    def _build_state(self, tk: TCQTicket) -> QueryState:
        """The ticket's QueryState, created on first need.  An existing
        state (from an admission-time cache probe) is reused so cells it
        already resolved are never re-probed or re-peeled."""
        if tk.state is None:
            n = int(tk.uts.size)
            stats = QueryStats(n_timestamps=n,
                               cells_total=n * (n + 1) // 2)
            dl = float("inf") if tk.deadline is None else tk.deadline
            tk.state = QueryState(
                tk.uts, tk.k, tk.h, True, stats, qid=tk.id,
                deadline=dl, priority=tk.priority,
                cache=self.engine._cache_view(tk.k, tk.h, tk.epoch))
        return tk.state

    def _make_state(self, tk: TCQTicket) -> QueryState:
        st = self._build_state(tk)
        tk.status = "running"
        tk.admit_s = self.now()
        return st

    def _try_cache_resolve(self, tk: TCQTicket, now: float) -> bool:
        """Admission-time cache lookup: resolve the ticket's schedule as
        far as the TTI cache reaches; True iff it completed entirely from
        cache (the ticket never joins a pool).  Each ticket is probed
        once — partial progress is kept on its state, and the lane pool's
        claim path re-probes naturally as new entries land."""
        st = self._build_state(tk)
        st.resolve_cached()
        if not st.done:
            return False
        tk.status = "running"
        tk.admit_s = now
        self._finalize(tk, self.engine.num_vertices, self.now())
        return True

    def _retire(self, tk: TCQTicket) -> None:
        """Bookkeeping for a ticket that just resolved."""
        tk.state = None             # drop packed rows + pruning state
        if not self.retain_snapshots:
            tk.graph = None
        self.completed.append(tk)

    def _finalize(self, tk: TCQTicket, num_vertices: int,
                  done_s: float) -> None:
        cores = tk.state.decode_results(num_vertices)
        st = tk.state.stats
        tk.result = TCQResult(list(cores.values()), st)
        tk.done_s = done_s
        st.wall_time_s = done_s - tk.submit_s
        if tk.status not in TERMINAL_STATUSES:   # cancel/timeout keep theirs
            tk.status = "done"
        self._retire(tk)

    def pump(self, poll: Optional[Callable[["TCQService"], None]] = None
             ) -> List[TCQTicket]:
        """Serve one window-clustered pool to completion; returns every
        ticket resolved along the way (including requests resolved at
        submit time for empty windows).  ``poll`` is called before pool
        formation and again every time lanes free up, so the caller can
        inject arrivals and ingestion mid-flight; arrivals that match
        the live pool's epoch and fit its union window are admitted into
        it, the rest wait for the next pump.  Tickets resolve *as their
        own schedule drains* — a query admitted early is not held open
        by queries admitted after it, so per-ticket latency is honest
        even when sustained arrivals keep one pool alive.  Returns []
        when nothing resolved and nothing is pending.
        """
        if poll is not None:
            poll(self)
        self.expire()
        if self.wal is not None:
            # batch fsync barrier: everything journaled since the last
            # pump (arrivals, ingest from the poll hook) becomes durable
            # before the pool claims the device
            self.wal.sync()
        if self.engine.core_cache is not None:
            # admission-time lookup: tickets served entirely by the TTI
            # cache resolve here — they never join a pool, never widen a
            # cluster's union window, and never touch the device
            now = self.now()
            for tk in [t for t in self._pending if t.state is None]:
                if self._try_cache_resolve(tk, now):
                    self._pending.remove(tk)
                    self._fresh.append(tk)
        if not self._pending:
            fresh, self._fresh = self._fresh, []
            return fresh
        # EDF head-of-line: the most urgent (deadline, priority) ticket
        # picks the pool; with no deadlines/priorities the key degenerates
        # to arrival order, i.e. the old FIFO head — older snapshots drain
        # first so pinned epochs (and their cached TELs) retire quickly
        head = min(self._pending, key=lambda t: t.edf_key)
        epoch = head.epoch
        cand = [tk for tk in self._pending if tk.epoch == epoch]
        clusters = cluster_windows([tk.window for tk in cand],
                                   self.cluster_gap)
        members = next(
            [cand[i] for i in c] for c in clusters
            if any(cand[i] is head for i in c))
        for tk in members:
            self._pending.remove(tk)
        self._inflight = members    # same list object: grows with admits
        pool_lo = min(tk.window[0] for tk in members)
        pool_hi = max(tk.window[1] for tk in members)
        pipe, wt, wave = self.engine.make_pool(
            pool_lo, pool_hi, graph=head.graph, epoch=epoch,
            num_queries=len(members), wave=self.wave, depth=self.depth)
        states = [self._make_state(tk) for tk in members]
        pool_stats = QueryStats()
        t0 = self.now()

        def admit() -> List[QueryState]:
            if poll is not None:
                poll(self)
            now = self.now()
            self.expire(now)
            for tk in members:
                # deadline sweep over *running* members: flag the state so
                # run_pool reclaims its lanes at this very wave boundary
                if (tk.done_s is None and tk.status == "running"
                        and tk.expired(now)):
                    tk.status = "timeout"
                    tk.state.cancel()
                # resolve members whose own schedule has fully drained —
                # their latency must not absorb later admissions' work
                if tk.done_s is None and tk.state.done:
                    self._finalize(tk, wt.num_vertices, now)
            newly = []
            for tk in list(self._pending):
                if (tk.epoch == epoch and tk.window[0] >= pool_lo
                        and tk.window[1] <= pool_hi):
                    self._pending.remove(tk)
                    members.append(tk)
                    st = self._make_state(tk)
                    # a mid-flight arrival fully served by the cache
                    # resolves on the spot instead of taking lanes
                    st.resolve_cached()
                    if st.done:
                        self._finalize(tk, wt.num_vertices, now)
                        continue
                    newly.append(st)
            return newly

        pipe.run_pool(states, pool_stats, admit=admit)
        done_s = self.now()
        for tk in members:
            if tk.done_s is None:
                self._finalize(tk, wt.num_vertices, done_s)
            # pool-wide counters land once the pool's totals are known
            # (the stats object is shared with the ticket's TCQResult)
            tk.result.stats.absorb_pool(pool_stats,
                                        window_edges=wt.window_edges,
                                        batch_size=len(members))
        self._inflight = []
        # drop window TELs / pair tables of epochs no ticket pins anymore
        self.engine.retire_epochs({t.epoch for t in self._pending})
        fresh, self._fresh = self._fresh, []
        self.pool_log.append({
            "epoch": epoch, "window": (pool_lo, pool_hi),
            "members": len(members), "wave": wave,
            "admitted_midflight": pool_stats.admissions,
            "window_edges": wt.window_edges,
            "device_steps": pool_stats.device_steps,
            "occupancy": pool_stats.occupancy,
            "timeouts": sum(tk.status == "timeout" for tk in members),
            "cancelled": sum(tk.status == "cancelled" for tk in members),
            "cache_hits": sum(tk.result.stats.cells_cached
                              for tk in members),
            "backend": getattr(wt.step_fn, "backend", "?"),
            "wall_s": done_s - t0,
        })
        if pool_stats.shard_occupancy is not None:
            self.pool_log[-1]["shard_occupancy"] = \
                pool_stats.shard_occupancy
            self.pool_log[-1]["collective_bytes"] = \
                pool_stats.collective_bytes
        return members + fresh

    def run_until_idle(self, poll: Optional[Callable] = None
                       ) -> List[TCQTicket]:
        """Pump until no work is pending and ``poll`` (if any) stops
        producing new arrivals; returns every ticket resolved along the
        way (mid-flight admissions and resolved-at-submit empty windows
        included)."""
        served: List[TCQTicket] = []
        while True:
            out = self.pump(poll)
            served.extend(out)
            if not out and not self._pending:
                return served

    # ------------------------------------------------------------ prewarming
    def prewarm(self, max_windows: int = 1) -> int:
        """Speculatively peel the hottest request windows into the core
        cache while the service is idle.

        The arrival histogram (every submitted ``(k, h, ts, te)``) ranks
        windows by observed demand; the hottest whose schedule is not
        already fully cached at the *current* epoch are peeled through
        ``engine.query`` (wave mode), which inserts every cell on retire.
        Serving loops call this from their idle branch (``launch.serve``'s
        open loop does, between arrival gaps) so recurring traffic
        lands on a warm cache after ingest invalidation.  No-op when
        caching is off or work is pending (serving always wins the
        device).  Returns the number of windows peeled.
        """
        if self.engine.core_cache is None or self._pending:
            return 0
        peeled = 0
        for (k, h, ts, te), _ in sorted(self._hist.items(),
                                        key=lambda kv: (-kv[1], kv[0])):
            if peeled >= int(max_windows):
                break
            uts = self.engine.graph.unique_ts
            uts = uts[(uts >= ts) & (uts <= te)].astype(np.int64)
            if uts.size == 0:
                continue
            probe = QueryState(uts, k, h, True, QueryStats(),
                               cache=self.engine._cache_view(k, h))
            probe.resolve_cached()
            if probe.done:
                continue                    # already fully cached
            self.engine.query(k, int(ts), int(te), h=h, mode="wave",
                              wave=self.wave, depth=self.depth)
            self._prewarmed += 1
            peeled += 1
        return peeled

    @property
    def stats(self) -> Dict:
        """Service observability: engine cache counters (window-TEL LRU +
        TTI core cache, see ``TCQEngine.stats``) plus queue/prewarm
        gauges."""
        out = self.engine.stats()
        out["pending"] = len(self._pending)
        out["completed"] = len(self.completed)
        out["prewarmed"] = self._prewarmed
        if self.wal is not None:
            out["wal"] = self.wal.stats()
        return out

    # ------------------------------------------------------- crash recovery
    def snapshot(self) -> Dict:
        """Serializable service state: engine epoch, every epoch snapshot
        still pinned by a queued ticket, and the queued tickets themselves
        (deadlines stored as *remaining* seconds — wall-clock restarts).

        Pools run synchronously inside :meth:`pump`, so between pumps the
        queue is the complete in-flight set; a snapshot taken from a
        mid-pool ``poll``/admit hook additionally records the live pool's
        unresolved members (``_inflight``) as queued again — on restore
        they re-run from scratch, which is bit-identical because results
        are deterministic in (k, h, window, pinned epoch).  Restoring a
        snapshot and draining it therefore yields the same results as
        never having stopped (resolved tickets are the caller's to
        persist — they are not part of service state).
        """
        now = self.now()
        live = [tk for tk in self._inflight if not tk.done]
        graphs: Dict[int, Dict] = {self.engine.epoch:
                                   self.engine.graph.state_dict()}
        for tk in list(self._pending) + live:
            if tk.epoch not in graphs:
                graphs[tk.epoch] = tk.graph.state_dict()
        snap = {
            "version": 1,
            "epoch": int(self.engine.epoch),
            "next_id": int(self._next_id),
            "wave": self.wave,
            "depth": self.depth,
            "cluster_gap": self.cluster_gap,
            "graphs": graphs,
            "tickets": [{
                "id": tk.id, "k": tk.k, "h": tk.h,
                "ts": tk.ts, "te": tk.te,
                "epoch": tk.epoch, "priority": tk.priority,
                "deadline_rem_s": (None if tk.deadline is None
                                   else tk.deadline - now),
            } for tk in list(self._pending) + live],
        }
        if self.engine.core_cache is not None:
            # additive field (format stays version 1): a restoring service
            # without a cache simply drops it
            snap["cache"] = self.engine.core_cache.state_dict()
        return snap

    @classmethod
    def restore(cls, snap: Dict, **kwargs) -> "TCQService":
        """Rebuild a service from :meth:`snapshot`: replays the pinned
        epoch snapshots oldest-first (re-keying the engine to the original
        epoch numbers) and re-admits every queued ticket under its
        original id, epoch pin, priority and remaining deadline.  The
        snapshot may come from either package's service; ``kwargs`` go to
        the constructor (``device=`` among them)."""
        if int(snap.get("version", -1)) != 1:
            raise ValueError(f"unknown snapshot version: "
                             f"{snap.get('version')!r}")
        graphs = {int(e): TemporalGraph.from_state(s)
                  for e, s in snap["graphs"].items()}
        epochs = sorted(graphs)
        kwargs.setdefault("wave", snap["wave"])
        kwargs.setdefault("depth", int(snap["depth"]))
        kwargs.setdefault("cluster_gap", int(snap["cluster_gap"]))
        svc = cls(graphs[epochs[0]], **kwargs)
        svc.engine.rebase_epoch(epochs[0])
        for e in epochs[1:]:
            svc.engine.update_graph(graphs[e])
            svc.engine.rebase_epoch(e)
        now = svc.now()
        for rec in snap["tickets"]:
            ep = int(rec["epoch"])
            g = graphs[ep]
            uts = g.unique_ts
            uts = uts[(uts >= int(rec["ts"])) & (uts <= int(rec["te"]))]
            rem = rec.get("deadline_rem_s")
            svc._pending.append(TCQTicket(
                id=int(rec["id"]), k=int(rec["k"]), h=int(rec["h"]),
                ts=int(rec["ts"]), te=int(rec["te"]), epoch=ep, graph=g,
                uts=uts.astype(np.int64), submit_s=now,
                priority=int(rec.get("priority", 0)),
                deadline=None if rem is None else now + float(rem)))
        svc._next_id = int(snap["next_id"])
        cache_state = snap.get("cache")
        if cache_state is not None and svc.engine.core_cache is not None:
            # persisted entries carry the pre-crash epoch numbering, which
            # the rebase replay above restored — keys line up exactly
            svc.engine.core_cache.load_state(cache_state)
        return svc

    def save_snapshot(self, path_or_file, *,
                      wal_seq: Optional[int] = None) -> None:
        """Persist :meth:`snapshot` as a single ``.npz`` (graph arrays +
        a JSON metadata record) — no pickle, loadable anywhere.

        The write is *atomic and self-verifying*: file-path targets go
        through a sibling ``.tmp`` + ``os.replace`` (a crash mid-save
        leaves any previous snapshot at that path untouched), and a
        whole-file CRC32 is embedded in the metadata record so
        :meth:`load_snapshot` / :meth:`recover` detect a damaged file
        instead of restoring from it.  ``wal_seq`` stamps the journal
        segment this snapshot seals (set by :meth:`checkpoint`)."""
        self._save(path_or_file, self.snapshot(), wal_seq)

    @staticmethod
    def _save(path_or_file, snap: Dict, wal_seq: Optional[int]) -> None:
        if wal_seq is not None:
            snap["wal_seq"] = int(wal_seq)
        arrays = {}
        for e, sd in snap.pop("graphs").items():
            for name, arr in sd.items():
                arrays[f"g{int(e)}__{name}"] = np.asarray(arr)
        for name, arr in snap.pop("cache", {}).items():
            arrays[f"cache__{name}"] = np.asarray(arr)
        walmod.write_snapshot_atomic(path_or_file, snap, arrays)

    @staticmethod
    def _parse_snapshot_file(path_or_file) -> Dict:
        """Read + checksum-verify one snapshot file back into the
        :meth:`snapshot` dict form (raises
        :class:`~repro_torch.core.wal.SnapshotCorruption` on damage)."""
        snap, flat = walmod.read_snapshot(path_or_file)
        graphs: Dict[int, Dict] = {}
        cache: Dict[str, np.ndarray] = {}
        for key, arr in flat.items():
            tag, name = key.split("__", 1)
            if tag == "cache":
                cache[name] = arr
            else:
                graphs.setdefault(int(tag[1:]), {})[name] = arr
        snap["graphs"] = graphs
        if cache:
            snap["cache"] = cache
        return snap

    @classmethod
    def load_snapshot(cls, path_or_file, **kwargs) -> "TCQService":
        """Inverse of :meth:`save_snapshot` (checksum-verified)."""
        return cls.restore(cls._parse_snapshot_file(path_or_file),
                           **kwargs)

    # ------------------------------------------------------------ durability
    def _write_snapshot_file(self, seq: int) -> str:
        path = walmod.snapshot_path(self.wal.dir, seq)
        snap = self.snapshot()      # every rank: it reads the mesh's clock
        self._on_writer(lambda log: self._save(path, snap, seq))
        return path

    def checkpoint(self) -> Dict:
        """Durable checkpoint: seal the active journal segment, persist
        the current service state under the *new* segment's sequence
        number, then garbage-collect history older than the oldest
        retained checkpoint.

        Crash-ordering: a crash after the rotation but before the
        snapshot lands simply means recovery uses the previous snapshot
        and replays one segment more; a crash mid-snapshot-write leaves
        only a ``.tmp`` (swept by GC).  Retaining
        ``retained_checkpoints`` (default 2) snapshots — and every
        segment at or above the *oldest* retained one — makes the
        corrupt-newest-snapshot fallback lossless: the older snapshot's
        whole tail is still on disk.

        On a mesh of several ranks rank 0 does the writing, every rank
        returns rank 0's record, and a barrier closes the call.
        """
        if self.wal is None:
            raise walmod.WALError("checkpoint() needs a wal_dir")
        t0 = time.perf_counter()
        seq = self.wal.rotate()
        path = self._write_snapshot_file(seq)

        def collect(log):
            snaps = walmod.list_snapshots(log.dir)
            keep = [s for s, _ in snaps][
                -max(1, int(self.retained_checkpoints)):]
            return {"path": path, "wal_seq": seq,
                    "gc_removed": len(log.gc(keep[0])),
                    "checkpoint_s": time.perf_counter() - t0}

        return self._on_writer(collect, barrier=True)

    @classmethod
    def recover(cls, wal_dir: str, *, fsync: str = "batch", mesh=None,
                **kwargs) -> "TCQService":
        """Point-in-time crash recovery: newest valid snapshot + journal
        tail replay.

        Walks the directory's snapshots newest-first, skipping any that
        fail their checksum or parse (satellite contract: fall back, do
        not die mid-recovery), restores the first valid one, then
        replays every sealed journal segment at or after its ``wal_seq``
        through the real :meth:`submit` / ``add_edges`` /
        :meth:`cancel` paths — so the recovered queue, epoch numbering
        and pinned snapshots are exactly what an uninterrupted run would
        hold, and a subsequent drain is bit-identical.  A torn or
        corrupted record ends the replay at the last acknowledged
        operation (it is detected via CRC, reported in
        ``recovery_report["tail_events"]``, and physically truncated —
        never silently replayed).  Replay *verifies* as it goes: every
        re-ingested graph must match its record's fingerprint/counts and
        every re-admitted ticket its recorded id, else
        :class:`~repro_torch.core.wal.WALReplayError`.

        ``kwargs`` go to the restored service's constructor (``device=``
        among them: CUDA unless told otherwise).  On a ``mesh`` of several
        ranks every rank calls ``recover``: rank 0 reads the snapshots and
        the journal (its ``wal_dir``; the others' is not touched) and
        broadcasts the chosen snapshot and the records, every rank replays
        them through the same paths and checks, and every rank's
        ``recovery_report`` is rank 0's.  The returned service has
        a fresh active segment and journals new mutations immediately; ``recovery_report`` carries the snapshot
        used, snapshots skipped, records replayed, tail events, and
        wall-clock recovery time (the drill's curve datum).
        """
        t0 = time.perf_counter()
        if mesh is not None:
            kwargs["mesh"] = mesh
        snaps = walmod.share(mesh, lambda: walmod.list_snapshots(wal_dir))
        if not snaps:
            raise walmod.WALError(f"no snapshot in {wal_dir!r} — nothing "
                                  "to recover (genesis missing?)")
        svc = None
        skipped = []
        kwargs.pop("wal", None)         # the journal is attached after
        kwargs.pop("wal_dir", None)     # replay, never during restore
        for seq, path in reversed(snaps):
            try:
                snap = walmod.share(
                    mesh, lambda: cls._parse_snapshot_file(path))
                svc = cls.restore(snap, **kwargs)
                snap_seq, snap_path = seq, path
                break
            except (walmod.SnapshotCorruption, ValueError, KeyError) as e:
                skipped.append({"path": path, "error": repr(e)})
        if svc is None:
            raise walmod.WALError(
                f"every snapshot in {wal_dir!r} is corrupt: {skipped}")
        from_seq = int(snap.get("wal_seq", snap_seq))
        if mesh is not None and mesh.size > 1:
            wal = walmod.MeshJournal.attach(mesh, wal_dir=wal_dir,
                                            fsync=fsync)
        else:
            wal = walmod.WriteAheadLog(wal_dir, fsync=fsync)
        svc._replaying = True
        replayed = 0
        try:
            for rec in wal.replay(from_seq):
                svc._replay_record(rec)
                replayed += 1
        finally:
            svc._replaying = False
        svc.wal = wal
        report = {
            "snapshot": snap_path,
            "snapshot_seq": int(snap_seq),
            "snapshots_skipped": skipped,
            "wal_records": replayed,
            "tail_events": list(wal.tail_events),
            "pending_after": len(svc._pending),
            "epoch_after": int(svc.epoch),
            "recover_s": time.perf_counter() - t0,
        }
        svc.recovery_report = svc._on_writer(lambda log: report)
        return svc

    def _replay_record(self, rec) -> None:
        """Apply one journal record through the live mutation paths."""
        kind, meta = rec.kind, rec.meta
        if kind == "submit":
            req = {"k": meta["k"], "h": meta["h"], "ts": meta["ts"],
                   "te": meta["te"], "priority": meta["priority"]}
            if meta.get("deadline_s") is not None:
                req["deadline_s"] = meta["deadline_s"]
            tk = self.submit(req)
            if tk.id != int(meta["id"]):
                raise walmod.WALReplayError(
                    f"replayed admission got id {tk.id}, journal "
                    f"recorded {meta['id']} — admission history is "
                    "incomplete or reordered")
        elif kind == "cancel":
            want = int(meta["id"])
            for tk in list(self._pending):
                if tk.id == want:
                    self.cancel(tk, status=meta["status"])
                    break
            # absent ids resolved before ever queueing (empty windows) —
            # the original cancel was a no-op on service state too
        elif kind == "edges":
            g = self.engine.graph.add_edges(
                rec.arrays["u"], rec.arrays["v"], rec.arrays["t"])
            self._check_lineage(g, meta)
            self.engine.update_graph(g)
        elif kind == "install":
            g = TemporalGraph.from_state(rec.arrays)
            self._check_lineage(g, meta)
            self.engine.update_graph(g)
        else:
            raise walmod.WALReplayError(f"unknown journal record kind "
                                        f"{kind!r}")

    @staticmethod
    def _check_lineage(g: TemporalGraph, meta: Dict) -> None:
        """Lineage check: the replayed graph must be byte-identical to
        the one the journal acknowledged (``uid`` lineage is
        process-local, so identity across restarts rests on the
        canonical-array fingerprint)."""
        got = {"graph_epoch": int(g.epoch),
               "num_vertices": int(g.num_vertices),
               "fingerprint": g.fingerprint()}
        if "num_edges" in meta:
            got["num_edges"] = g.num_edges
            got["num_pairs"] = g.num_pairs
        want = {k: meta[k] for k in got}
        if got != want:
            raise walmod.WALReplayError(
                f"replayed graph diverged from journal: got {got}, "
                f"recorded {want}")
