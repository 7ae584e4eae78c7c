"""An open loop into ``TCQService`` while the graph's last days stream in.

Set-up builds the program's graph from the configuration's edges before
its ``live.stream_from`` day, wraps it in a ``TCQService`` at the
service's defaults (core cache on, no journal) and answers
``warmup_requests`` requests drawn apart from the window's.  The window
then follows one seeded schedule (:func:`schedule`): Poisson arrivals at
``rate_qps``, and the streamed days in ``live.pushes`` batches of whole
days, pushed at the fractions ``live.push_due`` of the window.  The
schedule's events are applied in due order at every poll of the
service, so a request due after a push is submitted after it.  A share
``frontier_share`` of the requests, evenly interleaved, ends at the
frontier (the newest day ingested by its due time); the others start
uniformly over day ``t_min`` to the frontier less ``span``, on a
golden-ratio rotation, as the batch cells' windows do.

At the window's end the driver stops submitting and lets the running
pump finish; it does not drain the backlog.  ``tcq_qps`` is every
request answered, over the time from the window's start to the end of
the last pump begun in it (or to the window's end, when the service
idled there).  Latency counts from each request's due time.  The
reference checks a seeded sample of the answered requests, each on the
raw edges of the epoch it was submitted in: the loaded edges and the
pushes the driver had applied before it.

Cell parameters: ``rate_qps``, ``span``, ``k``, ``h``,
``frontier_share``, ``warmup_requests`` and ``check_queries``; the
configuration's ``live`` entry gives ``stream_from``, ``pushes`` and
``push_due``.
"""

from __future__ import annotations

import hashlib
import json
import time
from typing import Dict, List, NamedTuple

import numpy as np

from tcqbench import cell
from tcqbench.check import differing, program_cores

_GOLDEN = (5 ** 0.5 - 1) / 2


class Event(NamedTuple):
    """One event of the schedule: a push (``push`` its index, ``req``
    None) or an arrival (``push`` -1) due ``due`` seconds into the
    window; ``epoch`` is the number of pushes due before it."""

    due: float
    push: int
    epoch: int
    req: dict


def split_days(t: np.ndarray, live: dict):
    """(index of the loaded edges, [index of each push's edges], the
    frontier after 0, 1, ... pushes): the days from ``stream_from`` on,
    cut into ``pushes`` runs of whole days."""
    start = int(live["stream_from"])
    loaded = np.flatnonzero(t < start)
    days = np.arange(start, int(t.max()) + 1)
    runs = np.array_split(days, int(live["pushes"]))
    pushes = [np.flatnonzero((t >= r[0]) & (t <= r[-1])) for r in runs]
    frontiers = [int(t[loaded].max())]
    for idx in pushes:
        frontiers.append(max(frontiers[-1], int(t[idx].max())))
    return loaded, pushes, frontiers


def _request(p: dict, frontier: int, at_frontier: bool, x: float,
             t_min: int) -> dict:
    span = int(p["span"])
    if at_frontier:
        ts = frontier - span
    else:
        ts = t_min + int(x * (frontier - span - t_min + 1))
    return {"k": int(p["k"]), "h": int(p.get("h", 1)), "ts": int(ts),
            "te": int(ts) + span}


def schedule(p: dict, live: dict, seed: int, seconds: float,
             frontiers: List[int], t_min: int = 1) -> List[Event]:
    """The window's events in due order, drawn from ``seed`` alone:
    ``frontiers[e]`` is the frontier after ``e`` pushes."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 27]))
    rate = float(p["rate_qps"])
    dues: List[float] = []
    at = 0.0
    while True:
        gaps = np.cumsum(rng.exponential(1.0 / rate, 4096)) + at
        dues.extend(g for g in gaps.tolist() if g < seconds)
        if gaps[-1] >= seconds:
            break
        at = float(gaps[-1])
    # the share at the frontier evenly interleaved, and the others'
    # starts on a golden-ratio rotation, each with a seeded phase: every
    # seed asks for the same mix of work, spread evenly over the days
    n = len(dues)
    share = float(p["frontier_share"])
    j = np.arange(n, dtype=np.float64)
    ph_front, ph_start = rng.random(2).tolist()
    front = np.floor((j + 1) * share + ph_front) > np.floor(j * share
                                                            + ph_front)
    xs = np.mod(ph_start + j * _GOLDEN, 1.0)
    push_at = [float(f) * seconds for f in live["push_due"]]
    events = [Event(d, i, i + 1, None) for i, d in enumerate(push_at)]
    for d, f, x in zip(dues, front.tolist(), xs.tolist()):
        e = sum(pd <= d for pd in push_at)
        events.append(Event(d, -1, e, _request(p, frontiers[e], f, x,
                                               t_min)))
    # a push due at an arrival's instant lands first
    events.sort(key=lambda ev: (ev.due, ev.push < 0))
    return events


def warmup_requests(p: dict, seed: int, frontier: int,
                    t_min: int = 1) -> List[dict]:
    """``warmup_requests`` windows away from the frontier, drawn from
    ``seed`` apart from the window's schedule."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 28]))
    return [_request(p, frontier, False, x, t_min)
            for x in rng.random(int(p["warmup_requests"])).tolist()]


class Driver:
    def __init__(self, workload: dict, config: dict, seed: int, device):
        self.p = workload["params"]
        self.config = config
        self.live = config["live"]
        self.seed = int(seed)
        self.device = device
        self.sample = cell.Reservoir(self.p["check_queries"], seed)
        self.tickets: List[tuple] = []
        self.attempted = 0

    def setup(self) -> None:
        from repro_torch.core import TCQService

        clock = cell.Stages()
        self.u, self.v, self.t = cell.edges(self.config)
        self.loaded, self.pushes, self.frontiers = split_days(self.t,
                                                              self.live)
        self.t_min = int(self.t.min())
        clock("edges")
        i = self.loaded
        g = cell.program_graph(self.u[i], self.v[i], self.t[i],
                               self.config["graph"]["num_vertices"])
        clock("graph")
        self.svc = TCQService(g, device=self.device)
        clock("service")
        for r in warmup_requests(self.p, self.seed, self.frontiers[0],
                                 self.t_min):
            self.svc.submit(r)
        self.svc.run_until_idle()
        self.svc.completed.clear()
        self.svc.pool_log.clear()
        clock("warmup")
        self.stages = clock.seconds

    def window(self, seconds: float, spans) -> dict:
        svc = self.svc
        events = schedule(self.p, self.live, self.seed, seconds,
                          self.frontiers, self.t_min)
        before = svc.stats
        st = {"next": 0, "epoch": 0, "mid": None}
        t0 = svc.now()

        def poll(s) -> None:
            rel = s.now() - t0
            if rel >= seconds:
                return                  # the window is over: no more events
            if st["mid"] is None and rel >= 0.5 * seconds:
                st["mid"] = s.pending
            while st["next"] < len(events) and \
                    events[st["next"]].due <= rel:
                ev = events[st["next"]]
                st["next"] += 1
                if ev.req is None:
                    idx = self.pushes[ev.push]
                    s.push_edges(self.u[idx], self.v[idx], self.t[idx])
                    st["epoch"] = ev.epoch
                else:
                    tk = s.submit(dict(ev.req, due_s=t0 + ev.due))
                    self.tickets.append((tk, ev, st["epoch"]))

        t_last = t0
        while svc.now() - t0 < seconds:
            with spans("pump"):
                svc.pump(poll)
            t_last = svc.now()
            if not svc.pending:
                nxt = events[st["next"]].due if st["next"] < len(events) \
                    else seconds
                gap = nxt - (svc.now() - t0)
                if gap > 0:
                    time.sleep(min(gap, 0.001))
        t1 = max(t_last, t0 + seconds)
        answered = [x for x in self.tickets if x[0].status == "done"]
        self.attempted = len(self.tickets)
        self.window_s = t1 - t0
        after = svc.stats
        self.counts = {k: after[k] - before[k] for k in
                       ("pools", "pool_members", "cells_cached",
                        "cells_needed", "resolved_at_admission")
                       if k in after and k in before}
        self.summary = self._summary(answered, st, t0)
        for tk, ev, epoch in answered:
            slot = self.sample.wants()
            if slot >= 0:
                self.sample.put(slot, (ev.req, epoch,
                                       program_cores(tk.result)))
        return {"tcq_qps": len(answered) / (t1 - t0)}

    def _summary(self, answered, st, t0) -> Dict:
        lat = np.array([tk.done_s - (t0 + ev.due)
                        for tk, ev, _ in answered]) if answered else \
            np.zeros(1)
        log = [(p["epoch"], list(p["window"]), p["members"],
                p.get("ids")) for p in self.svc.pool_log]
        return {
            "arrivals": len(self.tickets),
            "answered": len(answered),
            "pushes": st["epoch"],
            "pending_mid": st["mid"],
            "pending_end": self.svc.pending,
            "pools": len(log),
            "pool_log_sha": hashlib.sha256(
                json.dumps(log).encode()).hexdigest()[:16],
            "latency_p50_ms": 1e3 * float(np.quantile(lat, 0.5)),
            "latency_p95_ms": 1e3 * float(np.quantile(lat, 0.95)),
        }

    def record(self) -> dict:
        return {"serve": self.counts, "edges": (self.u, self.v, self.t)}

    def failed(self) -> int:
        return sum(tk.status in ("timeout", "cancelled", "shed")
                   for tk, _, _ in self.tickets)

    def release(self) -> None:
        self.svc = None
        self.tickets = []

    def epoch_edges(self, epoch: int):
        """The raw edges of the epoch after ``epoch`` pushes."""
        idx = np.concatenate([self.loaded] + self.pushes[:epoch])
        return self.u[idx], self.v[idx], self.t[idx]

    def check(self) -> dict:
        from tcqbench.reference.otcd import EdgeList, otcd

        ref_device = "cuda" if str(self.device).startswith("cuda") else "cpu"
        bad = 0
        lists = {}
        for req, epoch, got in sorted(self.sample.items,
                                      key=lambda s: s[1]):
            if epoch not in lists:
                lists = {epoch: EdgeList(*self.epoch_edges(epoch),
                                         device=ref_device)}
            want = otcd(lists[epoch], req["k"], req["ts"], req["te"],
                        h=req.get("h", 1))
            bad += differing(got, want)
        return {"cores_differing": {"value": bad, "limit": 0},
                "queries_checked": {"value": len(self.sample.items),
                                    "at_least": 1}}

    def info(self) -> dict:
        """Counts for the run's log: the backlog at mid-window and at the
        end, the pools and a digest of their members, the latencies."""
        return {"setup_stages_s": self.stages, **self.summary,
                "counters": self.counts}
