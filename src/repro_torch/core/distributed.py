"""Sharded TCQ pipeline on ``torch.distributed`` (PyTorch port of
``repro.core.distributed``).

Layout, as in the JAX package (mesh (pod, data, model) or (data, model),
``launch/mesh.py``):

* edges and pairs shard over ``model``, split at PAIR boundaries so the
  edge->pair reduction never crosses shards; shards are padded to equal
  length with never-active sentinel edges;
* query lanes (the OTCD wave) shard over ``pod`` x ``data``;
* the only cross-shard exchange is the per-iteration vertex-degree
  combine over ``model``:
    ``combine="psum"``:  all-reduce of the dense [V, W_loc] f32 degrees;
    ``combine="rs_ag"``: reduce-scatter the degrees along V, threshold the
                         rank's V/m slice, all-gather the bool alive slice.
  Every partial degree is an integer count below 2^24, so the f32 sums are
  exact in any order.

**One controller in JAX, one per rank here.**  JAX's ``shard_map`` runs
from one Python process that sees a global [W, V] alive array;
``torch.distributed`` runs one process per rank.  So the host control is
*replicated*: every rank builds the same :class:`ShardPlan`, QueryStates
and pools from the same inputs, holds its model shard's six edge arrays
and its W/L lanes' alive rows (replicated over ``model``) on its device,
and after each step all-gathers the packed masks, lo, hi and n_edges over
its lane group and max-reduces ``iters`` over the world.  Every rank's
scheduler then sees the same whole ``StepResult`` and takes the same
decisions; refills write only the rank's own rows.  Results come back on
every rank.

On the card the per-rank step is a hand-written kernel either way: with
one model shard the fused ``wave_peel`` kernel runs on the rank's lanes
against the whole window TEL; with several, the composite step's two
segment sums launch ``segdeg``.  Which one is a rule of the mesh's shape,
not a fallback: a kernel that declines a shape on a CUDA tensor raises.

Two generations of the sharded layout live here, as in the JAX package:
:class:`ShardPlan` (the serving path, ``ShardedWavePipeline``) and
:func:`build_wave_step` / :class:`DistributedTCQ`, the one-shot engine.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.engine import WavePipeline, _Slot
from repro_torch.core.graph import TemporalGraph, pow2_capacity
from repro_torch.core.results import QueryStats
from repro_torch.core.wave import (DegradationLadder, ResilienceConfig,
                                   StepDivergence, StepResult,
                                   lanes, make_oracle_step_fn,
                                   make_wave_step_fn, pack_alive_u32,
                                   tti_and_count, unpack_alive_u32)
from repro_torch.kernels.segdeg.ops import make_banded_segsum
from repro_torch.launch.mesh import dp_axes, mesh_shard_counts

_I32_MIN = int(np.iinfo(np.int32).min)
_COMBINES = ("psum", "rs_ag")


# ===================================================================== plans
class ShardedTEL(NamedTuple):
    """Host-side pair-aligned edge partition, stacked as [m, ...] arrays."""
    src: np.ndarray        # [m, E_s]
    dst: np.ndarray        # [m, E_s]
    t: np.ndarray          # [m, E_s]  (int32 min => sentinel padding)
    pair_local: np.ndarray  # [m, E_s]  local pair id (P_s => sentinel)
    hp_src: np.ndarray     # [m, HP_s] vertex of half-pair (V_pad => sentinel)
    hp_pair: np.ndarray    # [m, HP_s] local pair id
    num_vertices: int      # padded to a multiple of 8*m
    num_pairs_shard: int
    num_shards: int


@dataclasses.dataclass(eq=False)
class ShardPlan:
    """Capacity-class sharded TEL with frozen pair-key ownership.

    ``bounds`` are m+1 half-open cuts over the canonical 64-bit pair key
    ``(pair_u << 32) | pair_v``: shard i owns every pair whose key falls
    in ``[bounds[i], bounds[i+1])``.  Pair tables are key-sorted on every
    snapshot, so ownership maps to contiguous pair-id ranges via one
    ``searchsorted``, including for pairs that did not exist when the plan
    was built.  Edge/pair buffers are pow2 capacity classes with
    ``tel_arrays``-compatible sentinels, so :meth:`refresh` absorbs
    appends without changing shapes.  Host numpy, bit-identical to the
    JAX package's plan; each rank ships only its own shard's rows
    (:func:`rank_arrays`).
    """

    src: np.ndarray          # [m, e_cap]
    dst: np.ndarray          # [m, e_cap]
    t: np.ndarray            # [m, e_cap]   (int32 min => sentinel)
    pair_local: np.ndarray   # [m, e_cap]   (p_cap => sentinel)
    hp_src: np.ndarray       # [m, 2*p_cap] (v_pad => sentinel)
    hp_pair: np.ndarray      # [m, 2*p_cap]
    num_vertices: int        # v_pad: multiple of 8*m
    num_pairs_shard: int     # p_cap
    num_shards: int          # m
    bounds: np.ndarray       # [m+1] int64 frozen pair-key cuts
    epoch: int = 0

    @property
    def e_cap(self) -> int:
        return int(self.src.shape[1])

    @property
    def p_cap(self) -> int:
        return int(self.num_pairs_shard)

    # ------------------------------------------------------------- building
    @staticmethod
    def _pair_keys(graph: TemporalGraph) -> np.ndarray:
        return ((graph.pair_u.astype(np.int64) << 32)
                | graph.pair_v.astype(np.int64))

    @staticmethod
    def _cuts(graph: TemporalGraph, bounds: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray]:
        """(pair cuts [m+1], edge cuts [m+1]) of a snapshot under frozen
        key bounds.  Edges are (pair, t)-sorted, so each shard's edges
        are one contiguous slice."""
        keys = ShardPlan._pair_keys(graph)
        pcuts = np.searchsorted(keys, bounds).astype(np.int64)
        ecuts = np.searchsorted(graph.pair_id, pcuts).astype(np.int64)
        return pcuts, ecuts

    @classmethod
    def build(cls, graph: TemporalGraph, m: int, *,
              vertex_capacity: Optional[int] = None) -> "ShardPlan":
        """Freeze edge-balanced pair-aligned ownership over ``graph``."""
        e = graph.num_edges
        keys = cls._pair_keys(graph)
        # edge-balanced cuts, frozen as the KEY of the pair at each cut
        # so ownership survives pair renumbering across appends
        bounds = np.empty(m + 1, np.int64)
        bounds[0] = np.iinfo(np.int64).min
        bounds[m] = np.iinfo(np.int64).max
        for i in range(1, m):
            target = min(i * (-(-e // m)), e)
            if e == 0 or target >= e:
                bounds[i] = bounds[m]
                continue
            pid = int(graph.pair_id[min(target, e - 1)])
            bounds[i] = keys[pid]
        v_pad = cls._round_vertices(
            graph.num_vertices if vertex_capacity is None
            else vertex_capacity, m)
        plan = cls(src=None, dst=None, t=None, pair_local=None, hp_src=None,
                   hp_pair=None, num_vertices=v_pad, num_pairs_shard=0,
                   num_shards=m, bounds=bounds, epoch=int(graph.epoch))
        plan._refill(graph, grow_only=False)
        return plan

    @staticmethod
    def _round_vertices(v: int, m: int) -> int:
        # byte-aligned per model shard: the rs_ag alive exchange slices V/m
        # columns and the packed transfer works in whole bytes
        return -(-max(1, int(v)) // (8 * m)) * 8 * m

    def refresh(self, graph: TemporalGraph, *,
                vertex_capacity: Optional[int] = None) -> bool:
        """Re-fill every shard from a new snapshot under the frozen
        ownership bounds.  Returns True when no buffer changed shape (the
        streaming steady state).  A capacity that overflows grows to the
        next power of two (amortized O(1) by doubling)."""
        if vertex_capacity is not None:
            v_pad = self._round_vertices(vertex_capacity, self.num_shards)
            if v_pad < self.num_vertices:
                v_pad = self.num_vertices    # vertex width never shrinks
        else:
            v_pad = max(self.num_vertices,
                        self._round_vertices(graph.num_vertices,
                                             self.num_shards))
        same_v = v_pad == self.num_vertices
        self.num_vertices = v_pad
        same = self._refill(graph, grow_only=True) and same_v
        self.epoch = int(graph.epoch)
        return same

    @staticmethod
    def _halfpairs(graph: TemporalGraph, lo: int, hi: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """(hp_src, hp_pair) of pairs [lo, hi), sorted by vertex."""
        np_l = hi - lo
        h_src = np.concatenate([graph.pair_u[lo:hi], graph.pair_v[lo:hi]])
        h_pair = np.concatenate([np.arange(np_l), np.arange(np_l)])
        order = np.argsort(h_src, kind="stable")
        return h_src[order], h_pair[order]

    def _refill(self, graph: TemporalGraph, *, grow_only: bool) -> bool:
        m = self.num_shards
        pcuts, ecuts = self._cuts(graph, self.bounds)
        n_e = int((ecuts[1:] - ecuts[:-1]).max()) if m else 0
        n_p = int((pcuts[1:] - pcuts[:-1]).max()) if m else 0
        e_cap = pow2_capacity(n_e)
        p_cap = pow2_capacity(n_p)
        if grow_only:
            same = e_cap <= self.e_cap and p_cap <= self.p_cap
            e_cap = max(e_cap, self.e_cap)
            p_cap = max(p_cap, self.p_cap)
        else:
            same = False
        v_pad = self.num_vertices
        src = np.zeros((m, e_cap), np.int32)
        dst = np.zeros((m, e_cap), np.int32)
        tt = np.full((m, e_cap), _I32_MIN, np.int32)
        pl = np.full((m, e_cap), p_cap, np.int32)
        hps = np.full((m, 2 * p_cap), v_pad, np.int32)
        hpp = np.zeros((m, 2 * p_cap), np.int32)
        for i in range(m):
            a, b = int(ecuts[i]), int(ecuts[i + 1])
            lo, hi = int(pcuts[i]), int(pcuts[i + 1])
            n = b - a
            src[i, :n] = graph.src[a:b]
            dst[i, :n] = graph.dst[a:b]
            tt[i, :n] = graph.t[a:b]
            pl[i, :n] = graph.pair_id[a:b] - lo
            h_src, h_pair = self._halfpairs(graph, lo, hi)
            hps[i, :h_src.size] = h_src
            hpp[i, :h_pair.size] = h_pair
        self.src, self.dst, self.t, self.pair_local = src, dst, tt, pl
        self.hp_src, self.hp_pair = hps, hpp
        self.num_pairs_shard = p_cap
        return same

    def window_arrays(self, graph: TemporalGraph, ts: int, te: int
                      ) -> Tuple[np.ndarray, ...]:
        """Window-truncated per-shard edge arrays (src, dst, t,
        pair_local), pow2-bucketed like ``TCQEngine._window_tel``'s
        truncation.  ``graph`` may be any snapshot whose pairs the frozen
        bounds cover (ancestors always qualify); the half-pair tables come
        from :meth:`hp_arrays`."""
        m = self.num_shards
        pcuts, ecuts = self._cuts(graph, self.bounds)
        win = (graph.t >= ts) & (graph.t <= te)
        locs = []
        for i in range(m):
            a, b = int(ecuts[i]), int(ecuts[i + 1])
            locs.append(np.flatnonzero(win[a:b]) + a)
        e_cap = pow2_capacity(max((loc.size for loc in locs), default=0))
        src = np.zeros((m, e_cap), np.int32)
        dst = np.zeros((m, e_cap), np.int32)
        tt = np.full((m, e_cap), _I32_MIN, np.int32)
        pl = np.full((m, e_cap), self.p_cap, np.int32)
        for i, loc in enumerate(locs):
            n = loc.size
            src[i, :n] = graph.src[loc]
            dst[i, :n] = graph.dst[loc]
            tt[i, :n] = graph.t[loc]
            pl[i, :n] = graph.pair_id[loc] - int(pcuts[i])
        return src, dst, tt, pl

    def hp_arrays(self, graph: TemporalGraph) -> Tuple[np.ndarray, ...]:
        """Half-pair tables (hp_src, hp_pair) for any covered snapshot at
        the plan's current capacities."""
        if int(graph.epoch) == self.epoch:
            return self.hp_src, self.hp_pair
        m = self.num_shards
        pcuts, _ = self._cuts(graph, self.bounds)
        n_p = int((pcuts[1:] - pcuts[:-1]).max()) if m else 0
        if n_p > self.p_cap:
            raise ValueError("snapshot exceeds plan pair capacity — not "
                             "an ancestor of the plan's current graph")
        hps = np.full((m, 2 * self.p_cap), self.num_vertices, np.int32)
        hpp = np.zeros((m, 2 * self.p_cap), np.int32)
        for i in range(m):
            h_src, h_pair = self._halfpairs(graph, int(pcuts[i]),
                                            int(pcuts[i + 1]))
            hps[i, :h_src.size] = h_src
            hpp[i, :h_pair.size] = h_pair
        return hps, hpp


def shard_graph(graph: TemporalGraph, m: int) -> ShardPlan:
    """Pair-aligned edge partition over ``m`` model shards (a
    :class:`ShardPlan`; duck-types :class:`ShardedTEL`'s fields)."""
    return ShardPlan.build(graph, m)


def abstract_sharded_tel(num_vertices: int, num_edges: int, num_pairs: int,
                         m: int) -> ShardedTEL:
    """Shape-only stand-in for a dry run: ``meta``-device int32 tensors,
    no allocation."""
    e_s = -(-num_edges // m)
    p_s = -(-num_pairs // m)
    v_pad = -(-num_vertices // (8 * m)) * 8 * m

    def meta(*shape):
        return torch.empty(shape, dtype=torch.int32, device="meta")

    return ShardedTEL(meta(m, e_s), meta(m, e_s), meta(m, e_s), meta(m, e_s),
                      meta(m, 2 * p_s), meta(m, 2 * p_s), v_pad, p_s, m)


def rank_arrays(arrays, mesh) -> Tuple[torch.Tensor, ...]:
    """This rank's model shard of six stacked [m, ...] host arrays (src,
    dst, t, pair_local, hp_src, hp_pair), on the mesh's device."""
    mi = mesh.model_index
    return tuple(torch.from_numpy(np.ascontiguousarray(a[mi])).to(
        mesh.device) for a in arrays)


def plan_arrays(plan) -> Tuple[np.ndarray, ...]:
    return (plan.src, plan.dst, plan.t, plan.pair_local, plan.hp_src,
            plan.hp_pair)


def wave_shardings(mesh, num_vertices: int, m: int) -> dict:
    """Placements of the wave's arrays, one per mesh axis (DTensor
    ``Shard``/``Replicate``): edge arrays [m, E_s] split on dim 0 over
    ``model``; the alive mask [W, V] and lane vectors [W] split on dim 0
    over pod x data; scalars replicated (the JAX package's
    ``PartitionSpec``s)."""
    from torch.distributed.tensor import Replicate, Shard

    def per_axis(sharded_axes):
        return tuple(Shard(0) if a in sharded_axes else Replicate()
                     for a in mesh.axis_names)

    lane = per_axis(dp_axes(mesh))
    return {"edges": per_axis(("model",)), "alive": lane, "lane": lane,
            "scalar": per_axis(())}


# ============================================== the per-rank degree loop
def combine_bytes_per_lane_iter(combine: str, num_vertices: int,
                                model_shards: int) -> int:
    """Analytic wire bytes one lane moves through the degree combine per
    fixpoint iteration (ring-collective model, summed across the mesh).

    psum:  all-reduce of [V] f32 partial degrees — 2*(m-1)/m * 4V bytes
           per shard, m shards.
    rs_ag: reduce-scatter the same payload one direction ((m-1)/m * 4V per
           shard) plus an all-gather of the V/m-slice bool alive mask
           ((m-1)/m * V bytes per shard).
    """
    m = int(model_shards)
    if m <= 1:
        return 0
    v = int(num_vertices)
    if combine == "psum":
        return 2 * (m - 1) * 4 * v
    return (m - 1) * (4 * v + v)


def _combine(mesh, cur: torch.Tensor, deg_part: torch.Tensor,
             k: torch.Tensor, combine: str, v_pad: int) -> torch.Tensor:
    """Threshold this rank's lanes on the model group's summed degrees.
    ``deg_part``: [v_pad, W_loc] f32 partials; returns the new [W_loc,
    v_pad] alive mask, identical on every rank of the model group."""
    m = mesh.model_shards
    if m == 1 or combine == "psum":
        deg = deg_part if m == 1 else mesh.all_reduce(
            deg_part, dist.ReduceOp.SUM, mesh.model_group)
        return cur & (deg.T >= k[:, None])
    v_m = v_pad // m
    i = mesh.model_index
    deg_s = mesh.reduce_scatter(deg_part.contiguous(), mesh.model_group)
    new_slice = cur[:, i * v_m:(i + 1) * v_m] & (deg_s.T >= k[:, None])
    return mesh.all_gather(new_slice.T.contiguous(), mesh.model_group).T


def _peel_local(mesh, arrays, alive, ts, te, k, h, *, v_pad: int,
                p_cap: int, combine: str, seg_pair, seg_vert,
                max_iters: int = 0):
    """This rank's lanes peeled to the fixpoint over its edge shard ->
    (alive [W_loc, V], edge activity [W_loc, E_s], iters).

    The JAX body: the window mask is hoisted; each iteration counts active
    edges per local pair (segdeg over ``pair_local``, sentinel p_cap
    summed into a dropped last segment), thresholds pairs at h, sums half
    pairs per vertex (segdeg over ``hp_src``, sentinel v_pad dropped the
    same way) and combines over ``model``.  Every rank of a model group
    holds the same alive rows, so they agree on when to stop."""
    src, dst, t, pl, hps, hpp = arrays
    win = (t[None, :] >= ts[:, None]) & (t[None, :] <= te[:, None])
    cur, iters = alive, 0
    while True:
        ea = win & cur[:, src] & cur[:, dst]
        paircnt = seg_pair(ea.T.to(torch.float32), pl)[:p_cap]
        pairact = (paircnt >= h[None, :]).to(torch.float32)
        deg_part = seg_vert(pairact[hpp, :], hps)[:v_pad]
        new = _combine(mesh, cur, deg_part, k, combine, v_pad)
        iters += 1
        if max_iters and iters >= max_iters:
            # a truncated peel stops here, before the host read of the
            # fixpoint test (a dry run's meta tensors hold no values):
            # recount edges, which equal ``ea`` when nothing changed
            return new, win & new[:, src] & new[:, dst], iters
        if not bool((new != cur).any()):
            return new, ea, iters
        cur = new


def _edge_stats(mesh, ea: torch.Tensor, t: torch.Tensor):
    """(lo, hi, n_edges) of this rank's lanes over the whole model group:
    local TTI and counts, then MIN / MAX / SUM over ``model`` (JAX's
    ``pmin``/``pmax``/``psum``), as one all-gather of the three."""
    lo, hi, ne = tti_and_count(ea, t[None, :])
    if mesh.model_shards > 1:
        parts = mesh.all_gather(torch.stack([lo, hi, ne], dim=1)[None],
                                mesh.model_group)          # [m, W_loc, 3]
        lo = parts[..., 0].amin(dim=0)
        hi = parts[..., 1].amax(dim=0)
        ne = parts[..., 2].sum(dim=0, dtype=torch.int32)
    return lo, hi, ne


def _gather_lanes(mesh, packed, lo, hi, ne, iters):
    """Every lane group's (packed, lo, hi, n_edges) on every rank, and the
    world's largest iteration count (JAX: ``lax.pmax(iters, axes)``), as
    one all-gather over the lane group: the ranks of a model group peel
    the same rows in lockstep, so their counts already agree."""
    w_loc = packed.shape[0]
    iters = torch.as_tensor(iters, dtype=torch.int32,
                            device=packed.device).reshape(1)
    if mesh.lane_shards == 1:
        return packed, lo, hi, ne, iters[0]
    cols = torch.cat([packed, torch.stack([lo, hi, ne], dim=1),
                      iters.expand(w_loc)[:, None]], dim=1)
    cols = mesh.all_gather(cols, mesh.lane_group)
    words = packed.shape[1]
    lo, hi, ne = cols[:, words:words + 3].unbind(1)
    return (cols[:, :words], lo, hi, ne,
            cols[:, words + 3].amax().to(torch.int32))


def _local_lanes(mesh, w_loc: int, dev, *vecs):
    """This rank's slice of each whole-wave [W] lane vector."""
    w = w_loc * mesh.lane_shards
    a = mesh.lane_index * w_loc
    return tuple(lanes(x, w, dev)[a:a + w_loc] for x in vecs)


def make_sharded_step_fn(mesh, arrays, *, num_vertices: int, p_cap: int,
                         combine: str = "psum", donate: bool = True):
    """The per-rank composite step with the single-device ``StepResult``
    contract: ``step(alive, ts, te, k, h)`` with ``alive`` this rank's
    [W/L, V] rows and ts/te/k/h whole-wave [W] vectors (or scalars).
    Returns this rank's peeled rows as ``alive`` and every lane's packed
    mask, lo, hi and n_edges.

    ``arrays`` are this rank's six edge/pair shard tensors (src, dst, t,
    pair_local, hp_src, hp_pair).  Its two segment sums are segdeg
    closures: the kernel on CUDA tensors (raising on unsorted ids), the
    plain version on CPU ones.  ``donate`` peels ``alive`` in place (the
    pipeline's lane slab); ladder rungs pass False.
    """
    if combine not in _COMBINES:
        raise ValueError(f"combine must be one of {_COMBINES}, got "
                         f"{combine!r}")
    L, m = mesh_shard_counts(mesh)
    v_pad, p_cap = int(num_vertices), int(p_cap)
    if v_pad % m:
        raise ValueError(f"num_vertices={v_pad} is not a multiple of "
                         f"{m} model shards")
    t = arrays[2]
    seg_pair = make_banded_segsum(p_cap + 1, arrays[3])
    seg_vert = make_banded_segsum(v_pad + 1, arrays[4])

    def step(alive, ts, te, k, h):
        ts, te, k, h = _local_lanes(mesh, alive.shape[0], alive.device,
                                    ts, te, k, h)
        new, ea, iters = _peel_local(mesh, arrays, alive, ts, te, k, h,
                                     v_pad=v_pad, p_cap=p_cap,
                                     combine=combine, seg_pair=seg_pair,
                                     seg_vert=seg_vert)
        lo, hi, ne = _edge_stats(mesh, ea, t)
        new = alive.copy_(new) if donate else new.contiguous()
        packed = pack_alive_u32(new, num_vertices=v_pad)
        return StepResult(new, *_gather_lanes(mesh, packed, lo, hi, ne,
                                              iters))

    step.backend = "sharded"
    step.combine = combine
    step.lane_shards = L
    step.model_shards = m
    step.bytes_per_lane_iter = combine_bytes_per_lane_iter(
        combine, v_pad, m)
    return step


def lane_sharded(mesh, local_step, *, backend: str):
    """A whole-TEL step run on this rank's lanes, then gathered: the
    ``StepResult`` contract of :func:`make_sharded_step_fn` around any
    single-device step (the fused kernel, the numpy oracle)."""

    def step(alive, ts, te, k, h):
        r = local_step(alive, *_local_lanes(mesh, alive.shape[0],
                                            alive.device, ts, te, k, h))
        return StepResult(r.alive, *_gather_lanes(
            mesh, r.packed, r.tti_lo, r.tti_hi, r.n_edges, r.iters))

    L, m = mesh_shard_counts(mesh)
    step.backend = backend
    step.combine = "none"
    step.lane_shards = L
    step.model_shards = m
    step.bytes_per_lane_iter = 0
    return step


def make_sharded_kernel_step(mesh, tel, num_vertices: int, *,
                             donate: bool = False,
                             use_kernel: Optional[bool] = None):
    """The fused wave_peel kernel as the per-rank step: this rank's lanes
    against the whole window TEL, results gathered over the lanes.

    Only meshes with one model shard qualify (edges replicated, lanes
    sharded over pod x data), and only where ``use_kernel`` asks for the
    kernel under the mesh's capacity rule (``wave_peel.ops.wants_kernel``:
    None takes it on CUDA for a V that fits its shared memory; the mesh
    has no global-memory tier); returns None otherwise, where the
    composite step over segdeg is the path.
    ``use_kernel=True`` on a V above the limit raises
    (``make_fused_wave_step``); on a CPU TEL the step is the kernel's
    plain version.
    """
    L, m = mesh_shard_counts(mesh)
    if m != 1:
        return None
    from repro_torch.kernels.wave_peel import ops as peel

    if not peel.wants_kernel(use_kernel, num_vertices, mesh.device):
        return None
    fused = peel.make_fused_wave_step(tel, num_vertices, donate=donate)
    return lane_sharded(mesh, fused, backend=fused.backend)


class ShardedDegradationLadder(DegradationLadder):
    """The degradation ladder over the sharded lowerings: the fused kernel
    per rank (one model shard) -> the sharded composite -> the numpy
    oracle on each rank's lanes.

    Every rank holds the same ladder and swaps rungs together, as JAX
    swaps the local step "for every shard at once": on the CPU each call's
    failure flag, and everywhere each tripwire verdict, is all-reduced over
    the world before anyone demotes or raises.  The tripwire samples the same lane on every rank (one
    seed); the ranks holding it check it on the oracle.  As in
    :class:`~repro_torch.core.wave.DegradationLadder`, demotion is for CPU
    tensors only: on the card the ladder holds the one rung the mesh's
    shape routes to, and logs then raises a failure or a divergence.
    A fused rung the mesh's shape or the capacity rule leaves out is
    logged once (``"multi_shard"``, ``"smem_limit"``).

    ``tel`` is the whole window: the fused rung's input on the mesh's
    device when the mesh has one model shard, else only the oracle's,
    which may hold it on the host.
    """

    def __init__(self, mesh, arrays, tel, num_vertices: int, *,
                 p_cap: int, combine: str = "psum",
                 use_kernel: Optional[bool] = False,
                 config: Optional[ResilienceConfig] = None):
        # DegradationLadder.__init__'s state by hand: these rungs are the
        # sharded lowerings
        self.config = config or ResilienceConfig()
        self.events = []
        self.calls = 0
        self.rung = 0
        self.mesh = mesh
        self.demotes = mesh.device.type != "cuda"
        self._rng = np.random.default_rng(self.config.seed)
        L, m = mesh_shard_counts(mesh)
        from repro_torch.kernels.wave_peel import ops as peel

        rungs = []
        asked = (mesh.device.type in ("cuda", "meta") if use_kernel is None
                 else bool(use_kernel))
        reason = peel.declined(use_kernel, num_vertices, mesh.device)
        if asked and m != 1:
            self._log("fused", "multi_shard",
                      f"model={m}: the fused kernel peels a whole TEL; "
                      "kernel-within-shard needs a lane-only mesh")
        elif reason is not None:
            self._log("fused", "smem_limit", reason)
        elif asked:
            rungs.append(("fused", make_sharded_kernel_step(
                mesh, tel, num_vertices, use_kernel=True)))
        if self.demotes or not rungs:
            rungs.append(("composite", make_sharded_step_fn(
                mesh, arrays, num_vertices=num_vertices, p_cap=p_cap,
                combine=combine, donate=False)))
        self._truth = make_oracle_step_fn(tel, num_vertices)  # unwrapped
        if self.demotes:
            rungs.append(("oracle", lane_sharded(mesh, self._truth,
                                                 backend="oracle")))
        wrap = self.config.rung_wrapper
        if wrap is not None:
            rungs = [(name, wrap(name, fn) or fn) for name, fn in rungs]
        self.rungs = rungs
        self.combine = combine
        self.lane_shards = L
        self.model_shards = m
        self.bytes_per_lane_iter = combine_bytes_per_lane_iter(
            combine, num_vertices, m)

    def _lane_check(self, res: StepResult, alive, ts, te, k, h) -> bool:
        """The tripwire on one lane of the whole wave (the same lane on
        every rank); a rank that does not hold it passes."""
        w = int(res.packed.shape[0])
        lane = int(self._rng.integers(w))
        li = lane - self.mesh.lane_index * int(alive.shape[0])
        if not 0 <= li < int(alive.shape[0]):
            return True
        truth = self._truth(
            alive[li:li + 1],
            self._lane_slice(ts, lane, w), self._lane_slice(te, lane, w),
            self._lane_slice(k, lane, w), self._lane_slice(h, lane, w))
        got = (res.alive[li], res.packed[lane], res.tti_lo[lane],
               res.tti_hi[lane], res.n_edges[lane])
        want = (truth.alive[0], truth.packed[0], truth.tti_lo[0],
                truth.tti_hi[0], truth.n_edges[0])
        return all(np.array_equal(g.cpu().numpy(), x.cpu().numpy())
                   for g, x in zip(got, want))

    def __call__(self, alive, ts, te, k, h) -> StepResult:
        self.calls += 1
        every = self.config.tripwire_every
        check = bool(every) and self.calls % every == 0
        while True:
            name, fn = self.rungs[self.rung]
            last = self.rung == len(self.rungs) - 1
            err, res = None, None
            try:
                res = fn(alive, ts, te, k, h)
            except Exception as e:
                if not self.demotes:            # the card: log and raise
                    self._log(name, "error", repr(e))
                    raise
                err = e
            # only a ladder that may demote agrees on failures: on the
            # card a failure has raised already, so no flag is reduced
            if self.demotes and self.mesh.any(err is not None):
                if last:
                    raise err if err is not None else RuntimeError(
                        f"rung {name} failed on another rank")
                self._log(name, "error", repr(err) if err is not None
                          else "failed on another rank")
                self.rung += 1
                continue            # replay the same cells one rung down
            if check and name != "oracle" and self.mesh.any(
                    not self._lane_check(res, alive, ts, te, k, h)):
                self._log(name, "divergence", f"call {self.calls}")
                if not self.demotes:
                    raise StepDivergence(
                        f"{name} step diverged from the oracle at call "
                        f"{self.calls}")
                self.rung += 1
                continue            # quarantine + bit-identical replay
            return res


# ================================================== sharded lane pipeline
class ShardedWavePipeline(WavePipeline):
    """The lane pool over a mesh: ``engine.WavePipeline`` whose slots hold
    only this rank's W/L lanes and whose device step is a sharded step.

    The pool scheduler (EDF claiming, mid-flight admission, staircase
    pruning, cache probes) runs unchanged, and identically on every rank,
    on the whole wave's gathered ``StepResult``; what changes:

    * slot buffers are [W/L, V]: refills write only this rank's lanes;
    * warm-start rows come from the gathered packed masks (a lane's warm
      row may be claimed by a lane of another rank), so every rank holds
      them on the host;
    * per-shard occupancy and combine wire bytes are accounted per pool
      and surfaced through ``QueryStats`` and ``TCQEngine.stats()``.
    """

    def __init__(self, step_fn, *, mesh, num_vertices: int, wave: int,
                 depth: int = 2, dist_counters: Optional[dict] = None):
        L, m = mesh_shard_counts(mesh)
        if wave % L:
            raise ValueError(
                f"wave={wave} not a multiple of lane shards {L}")
        super().__init__(step_fn, num_vertices, wave, depth,
                         device=mesh.device)
        self.mesh = mesh
        self.lane_shards = L
        self.model_shards = m
        self._w_loc = wave // L
        self._lane_lo = mesh.lane_index * self._w_loc
        self._bytes_per_lane_iter = int(
            getattr(step_fn, "bytes_per_lane_iter", 0))
        self._shard_occupied = [0] * L
        self._dist = dist_counters

    # ----------------------------------------------------------- hooks
    def _new_slot(self) -> _Slot:
        return _Slot(self.wave, self.num_vertices, self.device,
                     rows=self._w_loc)

    def _refill_lanes(self, slot: _Slot, sets, fills) -> None:
        a = self._lane_lo
        for li, value in fills:
            if a <= li < a + self._w_loc:
                slot.buf[li - a].fill_(value)
        for li, row in sets:
            if a <= li < a + self._w_loc:
                slot.buf[li - a].copy_(torch.as_tensor(row))

    def _record_occupied(self, occupied) -> None:
        for li in occupied:
            self._shard_occupied[li // self._w_loc] += 1

    def _warm_row(self, res, packed, li):
        """With one lane shard every rank holds every lane's device row
        (the single-device copy); otherwise host-unpack the lane's
        gathered bitmask, since only one lane group holds the row."""
        if self.lane_shards == 1:
            return super()._warm_row(res, packed, li)
        v = self.num_vertices
        return lambda: unpack_alive_u32(packed[li], v)

    def _finish_pool(self, pool_stats: QueryStats) -> None:
        steps = pool_stats.device_steps
        if steps:
            pool_stats.shard_occupancy = [
                c / (steps * self._w_loc) for c in self._shard_occupied]
        pool_stats.collective_bytes = (
            self._bytes_per_lane_iter * self.wave * pool_stats.peel_iters)
        self._shard_occupied = [0] * self.lane_shards
        if self._dist is not None:
            self._dist["pool_runs"] += 1
            self._dist["device_steps"] += steps
            self._dist["collective_bytes"] += pool_stats.collective_bytes


# =============================================== one-shot reference engine
def build_wave_step(mesh, *, num_vertices: int, combine: str = "rs_ag",
                    p_s: int, max_iters: int = 0,
                    single_iteration: bool = False):
    """Batched peel over (pod, data | data) query lanes and model-axis edge
    shards, with one (k, h) for the wave.  Returns ``step(src, dst, t,
    pair_l, hp_src, hp_pair, alive, ts, te, k, h) -> (alive, tti_lo,
    tti_hi, n_edges, iters)``: the six arrays are this rank's shard,
    ``alive`` [Q, V] and ts/te [Q] the whole wave (the same on every rank),
    and the outputs the whole wave's, gathered over the lanes."""
    L, m = mesh_shard_counts(mesh)
    v_pad = int(num_vertices)
    if v_pad % m:
        raise ValueError(f"num_vertices={v_pad} not a multiple of {m}")
    if combine not in _COMBINES:
        raise ValueError(f"unknown combine {combine!r}")

    def step(src, dst, t, pair_l, hp_src, hp_pair, alive, ts, te, k, h):
        q = alive.shape[0]
        if q % L:
            raise ValueError(f"{q} lanes do not split over {L} lane shards")
        dev = src.device
        w_loc = q // L
        a = mesh.lane_index * w_loc
        alive = torch.as_tensor(alive, dtype=torch.bool, device=dev)
        cur = alive[a:a + w_loc].contiguous()
        ts, te, k, h = _local_lanes(mesh, w_loc, dev, ts, te, k, h)
        arrays = (src, dst, t, pair_l, hp_src, hp_pair)
        new, ea, iters = _peel_local(
            mesh, arrays, cur, ts, te, k, h, v_pad=v_pad, p_cap=int(p_s),
            combine=combine, seg_pair=make_banded_segsum(int(p_s) + 1),
            seg_vert=make_banded_segsum(v_pad + 1),
            max_iters=1 if single_iteration else int(max_iters))
        lo, hi, ne = _edge_stats(mesh, ea, t)
        new = new.contiguous()
        it = torch.tensor([iters], dtype=torch.int32, device=dev)
        if L > 1:
            new = mesh.all_gather(new, mesh.lane_group)
            lo, hi, ne, it = mesh.all_gather(
                torch.stack([lo, hi, ne, it.expand(w_loc)], dim=1),
                mesh.lane_group).unbind(1)
        return new, lo, hi, ne, it.amax()

    return step


class DistributedTCQ:
    """Runnable distributed engine (any mesh, the unit mesh included).

    On a one-rank mesh the sharded program degenerates to the composite
    with no collectives, so it routes through
    ``core.wave.make_wave_step_fn`` instead: on the card the wave_peel
    kernel's tier for V (shared memory where V fits it, global memory
    above), plain versions on the CPU (``use_fused=False`` keeps the
    sharded program).  Meshes of several ranks always run the sharded step.
    """

    def __init__(self, graph: TemporalGraph, mesh, combine: str = "rs_ag",
                 *, use_fused: Optional[bool] = None):
        self.graph = graph
        self.mesh = mesh
        m = mesh_shard_counts(mesh)[1]
        plan = shard_graph(graph, m)
        self.plan = plan
        self.arrays = rank_arrays(plan_arrays(plan), mesh)
        self.step = build_wave_step(mesh, num_vertices=plan.num_vertices,
                                    combine=combine,
                                    p_s=plan.num_pairs_shard)
        self._fused = None
        if mesh.size == 1 and use_fused is not False:
            tel = graph.device_tel(vertex_capacity=plan.num_vertices,
                                   device=mesh.device)
            self._fused = make_wave_step_fn(tel, plan.num_vertices,
                                            use_kernel=use_fused)

    def query_wave(self, ts, te, k: int, h: int = 1, alive=None, *,
                   packed: bool = False):
        """Batched peel over the sharded TEL; every rank gets the whole
        wave back.  With ``packed=True`` the alive masks come back as [Q,
        ceil(V/32)] int32 words (``unpack_alive_u32`` decodes them)."""
        q = len(ts)
        v = self.plan.num_vertices
        dev = self.mesh.device
        alive = (torch.ones((q, v), dtype=torch.bool, device=dev)
                 if alive is None else
                 torch.as_tensor(alive, dtype=torch.bool, device=dev))
        if self._fused is not None:
            r = self._fused(alive, ts, te, k, h)
            return ((r.packed if packed else r.alive), r.tti_lo, r.tti_hi,
                    r.n_edges, r.iters)
        out = self.step(*self.arrays, alive, ts, te, k, h)
        if packed:
            return (pack_alive_u32(out[0], num_vertices=v),) + out[1:]
        return out
