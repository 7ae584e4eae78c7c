"""Device-resident multi-tenant wave pipeline — the engine behind
``mode="wave"`` and ``TCQEngine.query_batch`` (PyTorch port).

Per-query schedule bookkeeping lives in ``core/scheduler.py``
(:class:`~repro_torch.core.scheduler.QueryState`); this module owns the
device side, one lane pool of persistent [W, V] bool buffers whose rows
("lanes") each peel one schedule cell per wave step.  Cells are drawn
earliest-deadline-first, then round-robin, from any number of
QueryStates, and ``run_pool``'s ``admit`` hook turns the pool into a live
queue.

Where the port differs from the JAX package's engine:

* **In-place lane state.**  JAX donates the lane buffer through every
  step and refills lanes with ``dynamic_update_index_in_dim``; here the
  step peels the persistent buffer in place (``StepResult.alive`` *is*
  the slot's buffer) and refills are index writes into it.  So a warm-
  start row handed to a QueryState is a ``.clone()``: a view would be
  overwritten by the lane's next step.  A non-donating step (the
  degradation ladder's rungs, which must leave their input intact for a
  replay) returns a fresh mask, and the slot adopts it as its buffer.
* **Overlapped retire.**  ``jax.device_get`` becomes, at dispatch,
  non-blocking device-to-host copies of packed/lo/hi/ne/iters into pinned
  host buffers owned by the slot, then an event; ``retire`` waits on that
  event only.  A plain ``.cpu()`` would wait for every launch queued on
  the stream, the next slot's step included, and the ring would stop
  overlapping.  The per-lane (ts, te, k, h) go up the same way, from a
  pinned buffer per slot: the slot's last event has been waited on before
  the buffer is rewritten.
* **Depth-D slot ring.**  Unchanged: while slots B..D execute on the
  device the host retires slot A (pruning, packed collection),
  reassembles and re-dispatches it.  Pruning seen by an in-flight slot is
  up to D-1 steps stale, which at worst re-induces a core its query
  already found; TTI identity (Property 2) removes such duplicates and
  counts them per query.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import trace
from repro_torch.core.graph import DeviceTEL
from repro_torch.core.results import CoreResult, QueryStats
from repro_torch.core.scheduler import QueryState, RowCursor
from repro_torch.core.wave import (StepResult, make_wave_step_fn,
                                   packed_width)


class _Slot:
    """One ring stage: a device lane buffer + its in-flight step.

    ``lanes[li]`` holds the (QueryState, RowCursor) the lane is serving,
    or None when free; ``dirty`` marks lanes holding a stale (dead) mask.
    On CUDA, ``params`` stages the per-lane (ts, te, k, h) and ``host``
    receives the step's (packed, [lo, hi, ne], iters) in pinned memory,
    with ``event`` marking when those copies have landed.
    """

    __slots__ = ("buf", "lanes", "dirty", "inflight", "params", "host",
                 "event")

    def __init__(self, wave: int, num_vertices: int, device: torch.device,
                 rows: Optional[int] = None):
        # a sharded pipeline's buffer holds only this rank's ``rows`` lanes
        self.buf = torch.zeros((wave if rows is None else rows,
                                num_vertices), dtype=torch.bool,
                               device=device)
        self.lanes: List[Optional[Tuple[QueryState, RowCursor]]] = \
            [None] * wave
        self.dirty: set = set()
        self.inflight: Optional[StepResult] = None
        cuda = device.type == "cuda"
        self.params = torch.empty((4, wave), dtype=torch.int32,
                                  pin_memory=cuda)
        self.host = (torch.empty((wave, packed_width(num_vertices)),
                                 dtype=torch.int32, pin_memory=True),
                     torch.empty((3, wave), dtype=torch.int32,
                                 pin_memory=True),
                     torch.empty((), dtype=torch.int32, pin_memory=True)
                     ) if cuda else None
        self.event = torch.cuda.Event() if cuda else None


class WavePipeline:
    """Depth-D software-pipelined lane pool over one wave step.

    :meth:`run_pool` serves any number of QueryStates through one shared
    lane buffer per slot; :meth:`run` is the single-query wrapper used by
    ``TCQEngine.query(mode="wave")``.
    """

    def __init__(self, tel: DeviceTEL, num_vertices: int,
                 seg_pair, seg_vert, wave: int, depth: int = 2,
                 step_fn=None, device=None):
        self.tel = tel
        self.num_vertices = num_vertices
        self.seg_pair = seg_pair
        self.seg_vert = seg_vert
        self.wave = wave
        self.depth = max(1, int(depth))
        self.device = tel.t.device if device is None else torch.device(device)
        # the device step: a prebuilt in-place ``make_wave_step_fn``
        # closure (the engine pins one per windowed TEL), else the default
        # dispatch for the TEL's device
        if step_fn is None:
            step_fn = make_wave_step_fn(tel, num_vertices,
                                        seg_pair=seg_pair, seg_vert=seg_vert,
                                        donate=True)
        self._step = step_fn

    # ------------------------------------------------- subclass seams
    # The sharded pipeline (core/distributed.py) overrides these hooks to
    # keep only its rank's lanes, refill them from host rows, and account
    # per-shard occupancy and collective bytes.  These bodies are the
    # single-device pipeline's.
    def _new_slot(self) -> _Slot:
        return _Slot(self.wave, self.num_vertices, self.device)

    def _refill_lanes(self, slot: _Slot, sets, fills) -> None:
        """Refill lanes of ``slot.buf`` in place: ``sets`` is [(lane,
        row)] warm starts, ``fills`` [(lane, bool)] constant masks (the
        lists name disjoint lanes)."""
        for li, value in fills:
            slot.buf[li].fill_(value)
        for li, row in sets:
            slot.buf[li].copy_(row)

    def _record_occupied(self, occupied: List[int]) -> None:
        pass

    def _warm_row(self, res: StepResult, packed: np.ndarray, li: int):
        """Thunk producing lane ``li``'s [V] row for a warm start, only
        called when the cell becomes its row's best warm start.  A copy:
        this lane's next step overwrites ``res.alive``."""
        return lambda: res.alive[li].clone()

    def _commit_params(self, slot: _Slot, params) -> torch.Tensor:
        """Stage the per-lane (ts, te, k, h) lists and send them to the
        device: a [4, W] int32 tensor."""
        slot.params.numpy()[:] = params
        return slot.params.to(self.device, non_blocking=True)

    def _finish_pool(self, pool_stats: QueryStats) -> None:
        pass

    def run(self, uts: np.ndarray, k: int, h: int, prune: bool,
            stats: QueryStats, cache=None
            ) -> Dict[Tuple[int, int], CoreResult]:
        """Single-query entry: one QueryState, same stats object for both
        the query's and the pool's counters.  ``cache`` is an optional
        corecache.CacheView — hits skip lanes, peels are inserted."""
        qs = QueryState(uts, k, h, prune, stats, cache=cache)
        self.run_pool([qs], stats)
        return qs.decode_results(self.num_vertices)

    def run_pool(self, states: List[QueryState], pool_stats: QueryStats,
                 admit: Optional[Callable[[], List[QueryState]]] = None
                 ) -> None:
        """Drain a live pool of queries through the shared lane buffers.

        Cells are claimed from the live state with the smallest
        ``(deadline, priority)`` key, round-robin among ties, so one step
        mixes lanes from many (k, h, window) queries; each query's results
        accumulate in its own QueryState (bit-identical to running it
        alone).  ``admit`` is polled whenever a slot reassembles and may
        hand back newly admitted QueryStates, which join the rotation at
        once; the pool ends once nothing is in flight and ``admit`` comes
        back empty.  A state whose ``cancelled`` flag is set stops
        claiming, and its in-flight lanes are freed at the next
        assemble/retire without result feedback.
        """
        # the recorder's state is read once a pool: disarmed, a per-step
        # site costs one test of a local
        with trace.span("pool.run"):
            self._run_pool(states, pool_stats, admit, trace.armed())

    def _run_pool(self, states: List[QueryState], pool_stats: QueryStats,
                  admit: Optional[Callable[[], List[QueryState]]],
                  armed: bool) -> None:
        W = self.wave
        cuda = self.device.type == "cuda"
        claimable = deque(s for s in states if s.n > 0 and not s.cancelled)
        occupied_total = 0

        def refill() -> None:
            if admit is None:
                return
            for s in admit():
                if s.n > 0 and not s.cancelled:
                    claimable.append(s)
                    pool_stats.admissions += 1

        def claim() -> Optional[Tuple[QueryState, RowCursor]]:
            while claimable:
                bi, best = 0, claimable[0]._edf
                for i, s2 in enumerate(claimable):
                    k2 = s2._edf
                    if k2 < best:
                        bi, best = i, k2
                claimable.rotate(-bi)       # EDF: walk to an urgent state
                s = claimable[0]
                if s.cancelled:
                    claimable.popleft()
                    continue
                row = s.claim()
                if row is not None:
                    claimable.rotate(-1)    # round-robin among EDF ties
                    return s, row
                claimable.popleft()         # drained: nothing pending
            return None

        def release_cancelled(slot: _Slot) -> None:
            for li in range(W):
                lane = slot.lanes[li]
                if lane is not None and lane[0].cancelled:
                    lane[0].live_rows -= 1
                    slot.lanes[li] = None
                    slot.dirty.add(li)

        def assemble(slot: _Slot) -> None:
            """Claim ready cells into free lanes and refill their masks in
            place: warm rows are copied in, cold rows set to all-ones, and
            lanes that died without a new cell zeroed once, so the shared
            fixpoint loop never spends iterations on them."""
            refill()
            release_cancelled(slot)
            sets, fills = [], []
            for li in range(W):
                if slot.lanes[li] is not None:
                    continue
                got = claim()
                if got is None:
                    break
                s, row = got
                slot.lanes[li] = (s, row)
                warm = s.warm_start(row)
                if warm is not None:
                    sets.append((li, warm))
                else:
                    fills.append((li, True))
                slot.dirty.discard(li)
                pool_stats.lane_refills += 1
            fills.extend((li, False) for li in sorted(slot.dirty))
            slot.dirty.clear()
            self._refill_lanes(slot, sets, fills)

        def dispatch(slot: _Slot) -> None:
            occupied = [li for li in range(W)
                        if slot.lanes[li] is not None]
            if not occupied:
                slot.inflight = None
                return
            # stage per-lane params in python lists: element stores into
            # numpy arrays cost ~100ns each and this runs per step
            ts_l, te_l = [0] * W, [-1] * W      # empty window for padding
            k_l, h_l = [1] * W, [1] * W
            for li in occupied:
                s, row = slot.lanes[li]
                ts_l[li], te_l[li] = s.window(row)
                k_l[li], h_l[li] = s.k, s.h
                s.stats.cells_evaluated += 1
            params = self._commit_params(slot, (ts_l, te_l, k_l, h_l))
            res = self._step(slot.buf, *params)
            # a donating step peeled slot.buf in place; a non-donating one
            # (a degradation-ladder rung) returned a fresh mask, which the
            # slot adopts so the lane's next cell warms from its peel
            slot.buf = res.alive
            slot.inflight = res
            if cuda:
                packed, scalars, iters = slot.host
                packed.copy_(res.packed, non_blocking=True)
                scalars.copy_(torch.stack(
                    [res.tti_lo, res.tti_hi, res.n_edges]),
                    non_blocking=True)
                iters.copy_(res.iters, non_blocking=True)
                slot.event.record()
            pool_stats.device_steps += 1
            nonlocal occupied_total
            occupied_total += len(occupied)
            self._record_occupied(occupied)

        def retire(slot: _Slot) -> None:
            res = slot.inflight
            slot.inflight = None
            if cuda:
                if armed:
                    sp = trace.begin("pool.wait")
                slot.event.synchronize()
                if armed:
                    trace.end(sp)
                packed, scalars, iters = (a.numpy().copy() for a in slot.host)
                lo, hi, ne = scalars
            else:
                packed, lo, hi, ne, iters = (a.numpy().copy() for a in (
                    res.packed, res.tti_lo, res.tti_hi, res.n_edges,
                    res.iters))
            packed = packed.view("<u4")
            pool_stats.host_syncs += 1
            pool_stats.bytes_synced += (packed.nbytes + lo.nbytes + hi.nbytes
                                        + ne.nbytes + iters.nbytes)
            pool_stats.peel_iters += int(iters)
            lo_l, hi_l, ne_l = lo.tolist(), hi.tolist(), ne.tolist()
            if armed:
                sp = trace.begin("scheduler.retire")
            for li in range(W):
                lane = slot.lanes[li]
                if lane is None:
                    continue
                s, row = lane
                if s.cancelled:
                    s.live_rows -= 1
                    slot.lanes[li] = None
                    slot.dirty.add(li)
                    continue
                keep = s.retire(row, lo_l[li], hi_l[li], ne_l[li],
                                packed[li], self._warm_row(res, packed, li))
                if not keep:
                    slot.lanes[li] = None
                    slot.dirty.add(li)
            if armed:
                trace.end(sp)

        # prime every slot, then cycle the ring: retire + reassemble +
        # redispatch one slot while the other D-1 slots' steps execute on
        # the device.  Idle slots reassemble too (a live queue may have
        # admitted new queries since their last dispatch), and the ring
        # only stops once nothing is in flight and the final admit poll is
        # empty.
        slots = [self._new_slot() for _ in range(self.depth)]
        for slot in slots:
            assemble(slot)
            dispatch(slot)
        cur = 0
        while True:
            if all(s.inflight is None for s in slots):
                refill()
                if not claimable:
                    break
            slot = slots[cur]
            if slot.inflight is not None:
                retire(slot)
            assemble(slot)
            dispatch(slot)
            cur = (cur + 1) % self.depth

        if pool_stats.device_steps:
            pool_stats.occupancy = occupied_total / pool_stats.device_steps
        self._finish_pool(pool_stats)
