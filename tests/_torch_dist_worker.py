"""Rank programs for the gloo worlds of ``tests/test_torch_distributed.py``
(run by ``repro_torch.launch.world.run_world``; each returns plain Python
and numpy values, the same on every rank when the ranks agree)."""

from __future__ import annotations

import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import ResilienceConfig, TCQEngine, TCQService
from repro_torch.core.distributed import (DistributedTCQ,
                                          combine_bytes_per_lane_iter,
                                          make_sharded_step_fn, plan_arrays,
                                          rank_arrays)
from repro_torch.core.faultinject import FaultPlan, rung_faults
from repro_torch.graphs import planted_cores, powerlaw_temporal
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.serve import (Backpressure, serve_distributed,
                                      tickets_digest)

REQS = [dict(k=2, ts=5, te=30), dict(k=3, ts=10, te=36, h=2),
        dict(k=2, ts=1, te=20), dict(k=3, ts=20, te=48),
        dict(k=2, ts=30, te=52, h=1)]
CELLS = [(1, 40), (5, 30), (10, 20), (1, 15)]
SVC_REQS = [dict(k=2, ts=5, te=55), dict(k=3, ts=8, te=60),
            dict(k=2, ts=12, te=64, h=2), dict(k=3, ts=3, te=50)]
LATE = [dict(k=2, ts=6, te=58), dict(k=4, ts=10, te=62)]


def digest(results) -> list:
    """Cores of each TCQResult as sorted (tti, vertices, n_edges)."""
    return [sorted((key, c.vertices.tolist(), int(c.n_edges))
                   for key, c in r.by_tti().items()) for r in results]


def append(g, seed: int = 3, n: int = 50):
    rng = np.random.default_rng(seed)
    u, v = rng.integers(0, 100, n), rng.integers(0, 100, n)
    keep = u != v
    return g.add_edges(u[keep], v[keep], rng.integers(1, 90, n)[keep])


def _step_case(mesh, combine: str) -> dict:
    """DistributedTCQ.query_wave and make_sharded_step_fn on planted
    cores, k = 3, over the four CELLS."""
    g = planted_cores(seed=3)
    eng = DistributedTCQ(g, mesh, combine=combine)
    ts, te = [c[0] for c in CELLS], [c[1] for c in CELLS]
    out = {"query_wave": [np.asarray(x.cpu()) for x in
                          eng.query_wave(ts, te, 3)[:4]]}
    plan = eng.plan
    step = make_sharded_step_fn(
        mesh, rank_arrays(plan_arrays(plan), mesh),
        num_vertices=plan.num_vertices, p_cap=plan.p_cap, combine=combine,
        donate=False)
    w_loc = len(CELLS) // mesh.lane_shards
    alive = torch.ones((w_loc, plan.num_vertices), dtype=torch.bool)
    before = dict(mesh.sent_bytes)
    r = step(alive, np.array(ts, np.int32), np.array(te, np.int32), 3, 1)
    out["step_sent"] = {k: mesh.sent_bytes[k] - before[k] for k in before}
    out["step_iters"] = int(r.iters)
    out["step_partial_bytes"] = 4 * plan.num_vertices * w_loc
    out["step"] = [np.asarray(x) for x in (r.packed, r.tti_lo, r.tti_hi,
                                           r.n_edges)]
    out["step_alive_rows"] = np.asarray(r.alive)
    out["step_rows_from"] = mesh.lane_index * w_loc
    return out


def _engine_case(mesh, combine: str, extras: bool) -> dict:
    """query_batch over REQS, then again after an ingest epoch at W = 8
    (collective bytes = bytes per lane-iteration x 8 x iterations); with
    ``extras`` also the ladder, the kernel rung (the composite on a
    model-sharded mesh) and, on the kernel rung, one injected failure at
    which every rank demotes together."""
    g = powerlaw_temporal(100, 900, 80, seed=7)
    eng = TCQEngine(g, device=mesh.device, mesh=mesh, combine=combine)
    first = eng.query_batch(REQS)
    eng.update_graph(append(g))
    second = eng.query_batch(REQS, wave=8)
    d = eng.stats()["distributed"]
    per = combine_bytes_per_lane_iter(d["combine"], eng.num_vertices,
                                      mesh.model_shards)
    out = {"plain": {"before": digest(first), "after": digest(second),
                     "bytes": [r.stats.collective_bytes for r in second],
                     "want_bytes": [per * 8 * r.stats.peel_iters
                                    for r in second],
                     "distributed": d,
                     "whole_tel": [eng._tel is not None] + [
                         wt.tel is not None
                         for wt in eng._win_cache.values()],
                     "serial": digest([eng.query(3, 20, 36,
                                                 mode="serial")])}}
    configs = {"ladder": {"resilience": ResilienceConfig()},
               "kernel": {"use_kernel": True},
               "fault": {"use_kernel": True, "resilience": ResilienceConfig(
                   rung_wrapper=rung_faults(
                       {"fused": FaultPlan(fail_at=(2,))}))}}
    for name, kw in configs.items() if extras else ():
        eng = TCQEngine(g, device=mesh.device, mesh=mesh, combine=combine,
                        **kw)
        out[name] = {"before": digest(eng.query_batch(REQS[:3])),
                     "events": [e["reason"] for e in
                                eng.resilience_events()]}
    return out


def _service_case(mesh, combine: str) -> dict:
    g = powerlaw_temporal(100, 900, 80, seed=7)
    rng = np.random.default_rng(0)
    u, v = rng.integers(0, 100, 40), rng.integers(0, 100, 40)
    keep = u != v
    extra = (u[keep], v[keep], rng.integers(1, 90, 40)[keep])
    svc = TCQService(g, cache=False, mesh=mesh, combine=combine)
    for r in SVC_REQS:
        svc.submit(r)
    fired = []

    def poll(s):
        if not fired:
            fired.append(1)
            s.push_edges(*extra)      # a new epoch lands mid-serve
            for r in LATE:            # arrivals while the pool runs
                s.submit(r)

    out = svc.run_until_idle(poll)
    while svc.pending:
        out += svc.run_until_idle()
    tickets = sorted(out, key=lambda t: t.id)
    return {"tickets": {t.id: digest([t.result])[0] for t in tickets},
            "epoch": svc.epoch,
            "shard_occupancy": [p.get("shard_occupancy")
                                for p in svc.pool_log],
            "collective_bytes": [p.get("collective_bytes")
                                 for p in svc.pool_log],
            "distributed": svc.stats["distributed"]}


def _serve_case(mesh, combine: str) -> dict:
    from repro_torch.data import TCQRequestStream

    g = powerlaw_temporal(100, 900, 80, seed=7)
    lo, hi = g.span
    reqs = list(TCQRequestStream(lo, hi, k=2, span=30, seed=0)
                .open_loop(6, 200.0))
    svc, served, rep = serve_distributed(g, reqs, mesh=mesh,
                                         combine=combine, controllers=2)
    return {"tickets": {(t.k, t.h, t.ts, t.te): digest([t.result])[0]
                        for t in served},
            "digest": tickets_digest(served),
            "completed": rep["completed"],
            "controllers": len(rep["controllers"])}


def _deadline_case(mesh) -> dict:
    """Deadlines and shedding on rank 0's clock: a bounded queue sheds,
    queued tickets time out, and every rank takes the same decisions."""
    g = powerlaw_temporal(100, 900, 80, seed=7)
    svc = TCQService(g, cache=False, mesh=mesh)
    bp = Backpressure(svc, queue_cap=3, deadline_s=0.05)
    offered = [dict(k=2, ts=1 + i, te=60 + i % 7) for i in range(8)]
    tickets = [bp.offer(r) for r in offered]
    time.sleep(0.1)                   # rank 0's clock passes the deadlines
    served = svc.run_until_idle()
    late = [bp.offer(dict(k=3, ts=5, te=50 + i)) for i in range(3)]
    served += svc.run_until_idle()
    try:
        TCQService(g, mesh=mesh, wal_dir=tempfile.mkdtemp())
        refused = False
    except ValueError:
        refused = True
    return {"journal_refused": refused,
            "statuses": [None if t is None else t.status
                         for t in tickets + late],
            "shed": bp.shed, "swept": bp.timeouts_swept,
            "served": len(served), "digest": tickets_digest(served)}


def world_checks(cases, device: str = "cpu") -> dict:
    """Run each ``(shape, combine, parts)`` case on this world's mesh of
    that shape: ``parts`` names what to run of "step" (the one-shot
    engine and the sharded step), "engine", "extras" (the engine's
    ladder, kernel rung and fault), "service" (mid-flight admission and
    an ingest), "serve" (serve_distributed) and "deadline" (deadlines and
    shedding).  Results are keyed "<data>x<model>-<combine>"."""
    out = {"rank": dist.get_rank()}
    meshes = {}
    for shape, combine, parts in cases:
        shape = tuple(shape)
        if shape not in meshes:
            meshes[shape] = Mesh(shape, device=device)
        mesh = meshes[shape]
        got = {}
        if "step" in parts:
            got["step"] = _step_case(mesh, combine)
        if "engine" in parts:
            got["engine"] = _engine_case(mesh, combine, "extras" in parts)
        if "service" in parts:
            got["service"] = _service_case(mesh, combine)
        if "serve" in parts:
            got["serve"] = _serve_case(mesh, combine)
        if "deadline" in parts:
            got["deadline"] = _deadline_case(mesh)
        out[f"{shape[0]}x{shape[1]}-{combine}"] = got
    return out


def fail_on_rank(rank: int) -> None:
    """Raise on one rank; the others wait in a collective."""
    if dist.get_rank() == rank:
        raise RuntimeError(f"rank {rank} fails on purpose")
    dist.barrier()
