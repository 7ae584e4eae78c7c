"""Rank programs for the gloo worlds of ``tests/test_torch_distributed.py``
(run by ``repro_torch.launch.world.run_world``; each returns plain Python
and numpy values, the same on every rank when the ranks agree)."""

from __future__ import annotations

import os
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
    # a journal on the mesh: rank 0 writes it; every rank passes a
    # directory of its own, and every rank lists all of them
    box = [tempfile.mkdtemp() if mesh.rank == 0 else None]
    dist.broadcast_object_list(box, src=0)
    dirs = [os.path.join(box[0], f"rank{r}") for r in range(mesh.size)]
    jsvc = TCQService(g, cache=False, mesh=mesh, wal_dir=dirs[mesh.rank])
    jsvc.submit(offered[0])
    jsvc.run_until_idle()
    journal = {"checkpoint": jsvc.checkpoint(), "stats": jsvc.wal.stats()}
    jsvc.wal.close()
    dist.barrier()
    files = [sorted(os.listdir(d)) if os.path.isdir(d) else None
             for d in dirs]
    return {"journal": journal, "journal_files": files,
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


# ------------------------------------- the journal on a mesh (A13 drills)
def wal_graph():
    """tests/test_torch_wal.py's drill graph."""
    return powerlaw_temporal(60, 360, 48, seed=5)


def wal_ops(g, seed: int = 0) -> list:
    """tests/test_torch_wal.py's tape: admissions, a same-tick
    submit+cancel twin of the first request, ingest, a checkpoint, more of
    both.  Its journal records: 0-4 four admissions and a cancel, 5 an
    edge batch, (the checkpoint), 6 an admission, 7 an edge batch."""
    uts = g.unique_ts
    n = int(uts.size)
    reqs = [{"k": 2 + (i % 2), "ts": int(uts[a]), "te": int(uts[b])}
            for i, (a, b) in enumerate([(0, n // 2), (n // 3, n - 1),
                                        (n // 5, n // 2 + 2),
                                        (1, n // 4)])]
    rng = np.random.default_rng(seed)
    V = int(g.num_vertices)

    def batch(m):
        u = rng.integers(0, V, size=m)
        v = (u + 1 + rng.integers(0, V - 1, size=m)) % V
        t = rng.integers(int(uts[0]), int(uts[-1]) + 1, size=m)
        return (u.astype(np.int64), v.astype(np.int64),
                t.astype(np.int64))

    return ([("submit", reqs[0]), ("submit_cancel", reqs[0])]
            + [("submit", r) for r in reqs[1:3]]
            + [("edges", batch(16)), ("checkpoint",),
               ("submit", reqs[3]), ("edges", batch(8))])


def drive_tape(svc, ops, tickets=None) -> dict:
    """Feed ``ops`` to ``svc``, one per poll, then drain; {id: ticket}."""
    tickets = {} if tickets is None else tickets
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
        elif op[0] == "checkpoint" and s.wal is not None:
            s.checkpoint()

    while state["i"] < len(ops) or svc.pending:
        svc.run_until_idle(poll)
    return tickets


def ticket_digests(tickets) -> dict:
    """{id: (status, epoch, cores)} of the resolved tickets."""
    return {int(i): (tk.status, int(tk.epoch),
                     digest([tk.result])[0] if tk.status == "done" else None)
            for i, tk in tickets.items() if tk.done}


# kill -> (journal record after which rank 0's append dies, whether the
# surviving directory's last record is torn afterwards)
WAL_KILLS = {"mid_tape": (4, False), "after_checkpoint": (6, False),
             "torn_tail": (None, True)}


def _rank_dir(base: str, key: str, kill: str) -> str:
    """Rank 0 journals under ``base/key/kill``; every other rank is given
    a directory of its own, which it must leave untouched."""
    import os

    rank = dist.get_rank()
    return os.path.join(base, key, kill if rank == 0 else
                        f"{kill}-rank{rank}")


def wal_write(cases, base: str) -> dict:
    """The journal's first life on each ``(shape, combine)`` case: the
    whole tape once with a journal (the uninterrupted world), and once
    per ``WAL_KILLS`` entry, dying after the stated journal record (a
    ``CrashingWAL`` on rank 0; every rank stops there) or, for a torn
    tail, running to the end and tearing the last record."""
    from repro_torch.core import WriteAheadLog
    from repro_torch.core.faultinject import (CrashingWAL, InjectedCrash,
                                              torn_tail)

    g = wal_graph()
    ops = wal_ops(g)
    out = {"rank": dist.get_rank()}
    for shape, combine in cases:
        mesh = Mesh(tuple(shape), device="cpu")
        key = f"{shape[0]}x{shape[1]}-{combine}"
        got = {}
        svc = TCQService(g, device="cpu", use_kernel=False, mesh=mesh,
                         combine=combine,
                         wal_dir=_rank_dir(base, key, "full"),
                         fsync="always")
        got["full"] = {"tickets": ticket_digests(drive_tape(svc, ops)),
                       "stats": svc.wal.stats(), "epoch": svc.epoch}
        svc.wal.close()
        for kill, (after, torn) in WAL_KILLS.items():
            d = _rank_dir(base, key, kill)
            wal = None
            if after is not None and mesh.rank == 0:
                wal = CrashingWAL(WriteAheadLog(d, fsync="always"),
                                  crash_after_records=after)
            svc = TCQService(g, device="cpu", use_kernel=False, mesh=mesh,
                             combine=combine, wal=wal, wal_dir=d,
                             fsync="always")
            seen = {}
            crashed = False
            try:
                drive_tape(svc, ops, seen)
            except InjectedCrash:
                crashed = True
            if mesh.rank == 0:
                svc.wal.close()
                if torn:
                    torn_tail(d)
            dist.barrier()
            got[kill] = {"crashed": crashed,
                         "precrash": ticket_digests(seen)}
        out[key] = got
    return out


def wal_recover(cases, base: str) -> dict:
    """A new world after each ``wal_write`` kill: ``TCQService.recover(
    wal_dir, mesh=)`` on every rank (rank 0 reads its directory, the
    others are handed their own, untouched ones), then a drain; with what
    every rank left in its directory."""
    import os

    out = {"rank": dist.get_rank()}
    for shape, combine in cases:
        mesh = Mesh(tuple(shape), device="cpu")
        key = f"{shape[0]}x{shape[1]}-{combine}"
        got = {}
        for kill in WAL_KILLS:
            d = _rank_dir(base, key, kill)
            svc = TCQService.recover(d, mesh=mesh, device="cpu",
                                     use_kernel=False, combine=combine,
                                     fsync="always")
            rep = dict(svc.recovery_report)
            drained = {tk.id: tk for tk in svc.run_until_idle()}
            stats = svc.wal.stats()
            svc.wal.close()
            got[kill] = {"report": rep, "drained": ticket_digests(drained),
                         "stats": stats, "epoch": svc.epoch}
        mine = sorted(os.path.join(r, f) for r, _, fs in
                      os.walk(os.path.join(base, key)) for f in fs)
        got["files"] = mine
        out[key] = got
    return out


# ------------------------------------------- the dry run against a live mesh
def dryrun_bytes(cases) -> dict:
    """On each ``(shape, combine)`` case: the bytes this rank hands to
    each kind of collective (``Mesh.sent_bytes``) and its layout bytes,
    measured live on the CPU over gloo, beside what the dry run records
    for the same rank of a ``ShapeMesh`` of that shape: the smoke Jamba's
    train step (2 microbatches), its prefill, and one single-iteration
    TCQ step."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.distributed import build_wave_step, shard_graph
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import ShapeMesh
    from repro_torch.launch.shapes import ShapeCell
    from repro_torch.launch.steps import build_train_step, prefill_step
    from repro_torch.models import transformer as T

    def live(mesh, run):
        sent, lay = dict(mesh.sent_bytes), mesh.layout_bytes
        run()
        return ({k: mesh.sent_bytes[k] - sent[k] for k in sent},
                mesh.layout_bytes - lay)

    cfg = get_smoke_config("jamba-1.5-large-398b")
    out = {"rank": dist.get_rank()}
    for shape, combine in cases:
        mesh = Mesh(tuple(shape), device="cpu")
        got = {}
        rng = torch.Generator().manual_seed(0)
        model = T.Transformer(cfg, mesh=mesh, generator=rng)
        train = ShapeCell("train", 32, 4, "train")
        tokens = torch.randint(0, cfg.vocab, (train.batch, train.seq),
                               generator=rng, dtype=torch.int32)
        step, opt = build_train_step(cfg, 2)
        state = opt.init(model.params.tree(), mesh=mesh,
                         pspecs=model.pspecs)
        got["train"] = live(mesh, lambda: step(
            model, state, {"tokens": tokens, "labels": tokens}))
        prefill = ShapeCell("prefill", 32, 4, "prefill")
        cache = T.init_cache(cfg, prefill.batch, prefill.seq, mesh=mesh)
        got["prefill"] = live(mesh, lambda: prefill_step(
            model, {"tokens": tokens}, cache))
        for name, cell, n_micro in (("train", train, 2),
                                    ("prefill", prefill, None)):
            cost, *_ = DR.lm_cost(cfg, cell, ShapeMesh(
                shape, rank=mesh.rank), n_micro=n_micro)
            got[f"{name}_dry"] = (cost.sent_bytes, cost.layout_bytes)
        g = powerlaw_temporal(100, 900, 80, seed=7)
        plan = shard_graph(g, mesh.model_shards)
        arrays = rank_arrays(plan_arrays(plan), mesh)
        tcq = build_wave_step(mesh, num_vertices=plan.num_vertices,
                              combine=combine, p_s=plan.num_pairs_shard,
                              single_iteration=True)
        q = 4
        alive = torch.ones((q, plan.num_vertices), dtype=torch.bool)
        ts, te = np.array([1, 5, 10, 1]), np.array([40, 30, 20, 15])
        got["tcq"] = live(mesh, lambda: tcq(*arrays, alive, ts, te, 3, 1))
        cost, *_ = DR.tcq_cost(DR.meta_tel(plan), q, ShapeMesh(
            shape, rank=mesh.rank), combine)
        got["tcq_dry"] = (cost.sent_bytes, cost.layout_bytes)
        out[f"{shape[0]}x{shape[1]}-{combine}"] = got
    return out
