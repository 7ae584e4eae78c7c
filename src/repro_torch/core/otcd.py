"""TCD / OTCD query scheduling (paper §3–§4) over the device engines
(PyTorch port of ``repro.core.otcd``).

The schedule bookkeeping (which (ts, te) cells remain, per the three
pruning rules) is sequential, tiny and lives on the host
(``core/scheduler.py``).  Enumeration is over *unique* timestamps inside
[Ts, Te]; all modes peel against a *windowed* TEL
(:meth:`TCQEngine._window_tel`, an LRU-cached, power-of-two-bucketed
truncation), so per-cell work scales with the query window, not |E|.

Two execution modes share that schedule:

* ``serial`` — paper-faithful: one cell per ``tcd.tcd`` call, decremental
  warm starts along each row (Theorem 1), one host read of the cell's
  edge count and TTI per cell.
* ``wave`` — the device-resident lane pool (``engine.WavePipeline``): one
  wave step per batch of schedule cells with per-lane (ts, te, k, h), the
  fused wave-peel CUDA kernel on the card by default.

**Streaming.**  ``update_graph`` installs a new immutable snapshot under a
fresh epoch and refreshes the device TEL inside power-of-two capacity
classes.  ``_window_tel`` is keyed by ``(epoch, Ts, Te)`` and each entry
pins its TEL and its wave step, so a graph update can never serve a stale
truncation.  With ``cache=`` the engine keeps a TTI-keyed core cache
(``core/corecache.py``) that ``update_graph`` advances across the
appended batch; with ``resilience=`` every window entry pins a
degradation ladder (``core/wave.py``) in place of the single step.

**Custom degrees.**  ``TCQEngine(graph, degree_fn)`` peels with
``degree_fn`` in place of the paper's distinct-neighbour degree
(see ``core/tcd.py``).  Only the serial TCD path carries it: a wave query
runs serial, ``query_batch`` loops ``query``, and the core cache is off.

The engine runs on the card unless told otherwise: ``TCQEngine(graph)``
resolves to CUDA and raises when there is none.  ``device="cpu"`` runs the
plain PyTorch versions of the kernels.  ``mesh=`` shards the wave pools
over a mesh of ranks (``core/distributed.py``).
"""

from __future__ import annotations

import time
from collections import OrderedDict, defaultdict
from typing import (Dict, List, Mapping, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from repro_torch.core.corecache import CacheView, CoreCache
from repro_torch.core.distributed import (ShardedDegradationLadder,
                                          ShardedWavePipeline, ShardPlan,
                                          make_sharded_kernel_step,
                                          make_sharded_step_fn, plan_arrays,
                                          rank_arrays)
from repro_torch.core.engine import WavePipeline
from repro_torch.core.graph import DeviceTEL, TemporalGraph, pow2_capacity
from repro_torch.core.intervals import IntervalSet
from repro_torch.core.results import CoreResult, QueryStats, TCQResult
from repro_torch.core.scheduler import (QueryState, autotune_wave,
                                        choose_combine)
from repro_torch.core.tcd import TCDResult, tcd
from repro_torch.core.wave import ResilienceConfig, make_wave_step_fn
from repro_torch.kernels.segdeg.ops import make_banded_segsum
from repro_torch.launch.mesh import Mesh

_I32_MIN = np.iinfo(np.int32).min
_WINDOW_CACHE_MAX = 64
_EPOCH_AUX_MAX = 8          # snapshot pair-table LRU (epochs still in flight)


def resolve_device(device=None, who: str = "TCQEngine") -> torch.device:
    """The device of an engine or model (``who``, for the error): CUDA
    unless the caller names another.  Raises when CUDA is asked for (or
    defaulted to) and there is none — the port never carries on quietly
    on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who} runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain versions")
    return dev


class WindowTEL(NamedTuple):
    """One window-truncated TEL plus everything needed to peel it."""

    tel: DeviceTEL
    seg_pair: object         # edge->pair segsum closure for this TEL
    seg_vert: object         # halfpair->vertex segsum closure
    num_vertices: int        # device vertex width (capacity, >= live V)
    window_edges: int        # live (non-sentinel) edges inside the window
    step_fn: object = None   # pinned wave step (make_wave_step_fn closure)


class _EpochAux(NamedTuple):
    """Per-epoch pair-table device tensors (capacity padded)."""

    pair_u: torch.Tensor
    pair_v: torch.Tensor
    hp_src: torch.Tensor
    hp_pair: torch.Tensor
    pair_cap: int
    v_cap: int


class TCQEngine:
    """Holds the device TEL for one temporal graph and answers TCQs on it.

    ``device`` defaults to CUDA (raising without it).  ``use_kernel``
    selects the wave step: True the fused wave-peel kernel, False the
    composite lowering (torch gathers + the segdeg kernel), None (default)
    the fused kernel on CUDA.  On the CPU both run plain PyTorch.

    ``degree_fn`` (second positional, as in the JAX package) replaces the
    degree semantics on the serial path (see the module docstring); it
    runs on the engine's device and forces ``core_cache`` to None.

    ``cache`` is True (a default :class:`CoreCache`), an instance, or
    None/False (off, the default for a bare engine).  ``resilience`` is
    True (a default :class:`ResilienceConfig`), a config, or None/False:
    with it every window's step is a ladder whose events
    :meth:`resilience_events` reports: demotions on the CPU; on the card
    a kernel failure or a tripwire divergence, logged and raised (without
    it a kernel failure raises too).

    ``num_vertices`` is the *device* vertex width (a capacity >= the live
    vertex count once the graph has grown); padded vertices have no
    incident edges, peel out on the first fixpoint iteration for any
    k >= 1, and never appear in results.  On a mesh it is rounded up to a
    multiple of 8 x the model shards.

    ``mesh`` (a ``launch.mesh.Mesh``) shards every wave pool
    (``core/distributed.py``); the engine then runs on the mesh's device,
    every rank of the mesh runs the same calls, and ``stats()`` gains a
    ``"distributed"`` entry.  ``combine`` picks the degree combine of a
    model-sharded mesh: ``"psum"``, ``"rs_ag"`` or ``"auto"``.  There a
    rank's wave pools put only its edge shards on its device; the whole
    TEL goes there when a serial query or a custom degree reads it.
    """

    def __init__(self, graph: TemporalGraph, degree_fn=None, *,
                 device=None, use_kernel: Optional[bool] = None, mesh=None,
                 combine: str = "auto", cache=None, resilience=None):
        self.mesh = mesh
        if mesh is not None:
            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh must be a repro_torch.launch.mesh."
                                f"Mesh, got {type(mesh).__name__}")
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device={device} but the mesh computes "
                                 f"on {mesh.device}")
            device = mesh.device
            self._lane_shards = mesh.lane_shards
            self._model_shards = mesh.model_shards
            self._dist = {"pool_runs": 0, "device_steps": 0,
                          "collective_bytes": 0}
        else:
            self._lane_shards = self._model_shards = 1
            self._dist = None
        # a mesh with several model shards peels only this rank's edge
        # shard: the whole TEL goes to the device only when a path that
        # reads it (serial mode, a custom degree) asks for it
        self._edge_sharded = self._model_shards > 1
        self._tel = None
        if combine not in ("auto", "psum", "rs_ag"):
            raise ValueError(f"combine must be 'auto', 'psum' or 'rs_ag', "
                             f"got {combine!r}")
        self._combine_req = combine
        self._combine = None
        self._shard_plan = None
        self._plan_arrays = None
        self.device = resolve_device(device)
        self._use_kernel = (self.device.type == "cuda"
                            if use_kernel is None else bool(use_kernel))
        self._degree_fn = degree_fn
        if cache is True:
            cache = CoreCache()
        # cached cores are only sound for the standard degree
        self.core_cache: Optional[CoreCache] = \
            (cache or None) if degree_fn is None else None
        if resilience is True:
            resilience = ResilienceConfig()
        self._resilience: Optional[ResilienceConfig] = resilience or None
        self.epoch = 0
        # (epoch, Ts, Te) -> WindowTEL, LRU
        self._win_cache: "OrderedDict[Tuple[int, int, int], WindowTEL]" = \
            OrderedDict()
        self._win_hits = 0
        self._win_misses = 0
        self._win_evictions = 0
        # epoch -> _EpochAux, LRU (snapshots with queries still in flight)
        self._epoch_aux: "OrderedDict[int, _EpochAux]" = OrderedDict()
        self._install(graph, initial=True)

    # ------------------------------------------------------------- streaming
    def _install(self, graph: TemporalGraph, initial: bool) -> None:
        """(Re)build the device TEL inside the engine's capacity classes:
        exact at first, then the next power of two once an append
        outgrows a capacity."""
        if initial:
            self._edge_cap = graph.num_edges
            self._pair_cap = graph.num_pairs
            self._v_cap = graph.num_vertices
            grew_verts = True
        else:
            grew_verts = graph.num_vertices > self._v_cap
            if graph.num_edges > self._edge_cap:
                self._edge_cap = pow2_capacity(graph.num_edges)
            if graph.num_pairs > self._pair_cap:
                self._pair_cap = pow2_capacity(graph.num_pairs)
            if grew_verts:
                self._v_cap = pow2_capacity(graph.num_vertices)
        if self.mesh is not None:
            # one vertex width everywhere: the sharded step needs V to be
            # a multiple of 8 x model shards (byte-aligned alive slices),
            # and the window TELs' hp_src sentinel must sit at that width
            self._v_cap = ShardPlan._round_vertices(self._v_cap,
                                                    self._model_shards)
        self.graph = graph
        self._tel = None
        if initial or grew_verts:
            self.num_vertices = self._v_cap
            self._ones = torch.ones(self._v_cap, dtype=torch.bool,
                                    device=self.device)
        if not self._edge_sharded:
            self._remember_aux(self.epoch, _EpochAux(
                self.tel.pair_u, self.tel.pair_v, self.tel.hp_src,
                self.tel.hp_pair, self._pair_cap, self._v_cap))
        if self.mesh is not None:
            self._install_shards(graph, initial)

    @property
    def tel(self) -> DeviceTEL:
        """The current snapshot's whole TEL on the engine's device, padded
        to the capacity classes; built at install, or on an edge-sharded
        mesh at first use."""
        if self._tel is None:
            self._tel = self.graph.device_tel(
                edge_capacity=self._edge_cap, pair_capacity=self._pair_cap,
                vertex_capacity=self._v_cap, device=self.device)
        return self._tel

    def _install_shards(self, graph: TemporalGraph, initial: bool) -> None:
        """Build, or refresh in place, the frozen-ownership shard plan;
        this rank's model shard of the whole graph goes to its device
        when a step first reads it (``_shard_arrays``)."""
        if initial or self._shard_plan is None:
            self._shard_plan = ShardPlan.build(graph, self._model_shards,
                                               vertex_capacity=self._v_cap)
        else:
            self._shard_plan.refresh(graph, vertex_capacity=self._v_cap)
        plan = self._shard_plan
        if plan.num_vertices != self._v_cap:
            raise AssertionError(f"shard plan width {plan.num_vertices} "
                                 f"!= engine width {self._v_cap}")
        self._plan_arrays = None        # shipped at first use
        if self._combine_req == "auto":
            # a nominal wave of 32 lanes: the choice only flips on V
            self._combine = choose_combine(self._v_cap, 32,
                                           self._model_shards)
        else:
            self._combine = self._combine_req

    def _sharded_step(self, shards, tel: Optional[DeviceTEL]):
        """The per-rank step (or ladder) for one window entry: ``shards()``
        ships this rank's edge shards (called only when a composite rung
        or the ladder reads them), ``tel`` is the whole window TEL (the
        fused kernel's input, on the device, with one model shard; the
        oracle's, on the host, when edges are sharded; else None).  With
        ``use_kernel`` one model shard takes the fused kernel and several
        the composite over segdeg; a kernel that declines the TEL on the
        card raises."""
        plan = self._shard_plan
        if self._resilience is not None:
            return ShardedDegradationLadder(
                self.mesh, shards(), tel, self._v_cap, p_cap=plan.p_cap,
                combine=self._combine, use_kernel=self._use_kernel,
                config=self._resilience)
        if self._use_kernel and self._model_shards == 1:
            return make_sharded_kernel_step(self.mesh, tel, self._v_cap,
                                            donate=True)
        return make_sharded_step_fn(
            self.mesh, shards(), num_vertices=self._v_cap, p_cap=plan.p_cap,
            combine=self._combine, donate=True)

    def update_graph(self, graph: TemporalGraph) -> int:
        """Install a new graph snapshot (streaming append) under a fresh
        epoch; returns the new epoch.  In-flight queries pinned to older
        epochs are untouched — their window TELs stay valid and
        epoch-keyed.

        When the new snapshot is the direct child of the current one
        (``graph.parent_uid`` matches and the appended batch's time span
        is known), the core cache is *advanced*, not flushed: entries
        whose window (cells) or TTI (cores) avoids the batch's span are
        re-keyed to the new epoch, the rest invalidated
        (``CoreCache.advance_epoch``).  An unrelated snapshot starts the
        new epoch cold."""
        old_epoch, old_uid = self.epoch, self.graph.uid
        self.epoch += 1
        self._install(graph, initial=False)
        span = graph.appended_span
        if self.core_cache is not None and span is not None and \
                graph.parent_uid == old_uid:
            self.core_cache.advance_epoch(old_epoch, self.epoch,
                                          int(span[0]), int(span[1]))
        return self.epoch

    def _remember_aux(self, epoch: int, aux: _EpochAux) -> None:
        self._epoch_aux[epoch] = aux
        self._epoch_aux.move_to_end(epoch)
        while len(self._epoch_aux) > _EPOCH_AUX_MAX:
            self._epoch_aux.popitem(last=False)

    def _aux_for(self, epoch: int, g: TemporalGraph) -> _EpochAux:
        """Pair-table device tensors for one epoch's snapshot, padded to
        the engine's *current* capacity classes (snapshots are ancestors
        of the current graph, so they always fit)."""
        hit = self._epoch_aux.get(epoch)
        if hit is not None:
            self._epoch_aux.move_to_end(epoch)
            return hit
        if g.num_pairs > self._pair_cap or g.num_vertices > self._v_cap:
            raise ValueError(
                "snapshot exceeds engine capacities — not an ancestor of "
                "the engine's current graph")
        arrs = g.tel_arrays(pair_capacity=self._pair_cap,
                            vertex_capacity=self._v_cap)
        aux = _EpochAux(*(torch.from_numpy(arrs[k]).to(self.device)
                          for k in ("pair_u", "pair_v", "hp_src",
                                    "hp_pair")),
                        self._pair_cap, self._v_cap)
        self._remember_aux(epoch, aux)
        return aux

    def retire_epochs(self, live_epochs) -> int:
        """Evict window-TEL and pair-table cache entries for epochs no
        longer pinned by any in-flight or pending query; the current epoch
        is always kept.  Returns the number of evicted entries."""
        live = {int(e) for e in live_epochs}
        live.add(self.epoch)
        dead_w = [k for k in self._win_cache if k[0] not in live]
        for k in dead_w:
            del self._win_cache[k]
        dead_a = [e for e in self._epoch_aux if e not in live]
        for e in dead_a:
            del self._epoch_aux[e]
        if self.core_cache is not None:
            self.core_cache.retire_epochs(live)
        return len(dead_w) + len(dead_a)

    def rebase_epoch(self, epoch: int) -> None:
        """Re-key the engine's current snapshot under an externally
        dictated epoch number (crash recovery: a restored service resumes
        its pre-crash epoch numbering, so re-admitted tickets' pinned
        epochs stay meaningful and later pushes continue the sequence)."""
        epoch = int(epoch)
        if epoch == self.epoch:
            return
        aux = self._epoch_aux.pop(self.epoch, None)
        moved = [(k, v) for k, v in self._win_cache.items()
                 if k[0] == self.epoch]
        for k, _ in moved:
            del self._win_cache[k]
        if self.core_cache is not None:
            self.core_cache.rebase_epoch(self.epoch, epoch)
        self.epoch = epoch
        if aux is not None:
            self._epoch_aux[epoch] = aux
        for (_, ts, te), v in moved:
            self._win_cache[(epoch, ts, te)] = v

    def resilience_events(self) -> List[Dict]:
        """Degradation events (demotions on the CPU, failures raised on
        the card) across every live window ladder, most recent windows
        last.  Empty when the engine was built without ``resilience``."""
        out: List[Dict] = []
        for (ep, ts, te), wt in self._win_cache.items():
            for ev in getattr(wt.step_fn, "events", ()):
                out.append({"epoch": ep, "window": (ts, te), **ev})
        return out

    # -------------------------------------------------------- window slicing
    def _window_tel(self, Ts: int, Te: int, *,
                    graph: Optional[TemporalGraph] = None,
                    epoch: Optional[int] = None,
                    pool: bool = False) -> WindowTEL:
        """Device TEL truncated to [Ts, Te] for one epoch's snapshot.

        Edge arrays are padded to a power-of-two bucket with sentinel
        edges (t = int32 min, pair_id = pair capacity, ignored by every
        degree path).  The cache is LRU and keyed by ``(epoch, Ts, Te)``;
        queries pinned to an older epoch pass ``graph``/``epoch``
        explicitly.  Each entry pins the wave step built for its TEL (the
        fused kernel's band tables follow the truncation's segment ids),
        or with ``resilience`` its degradation ladder, whose rungs never
        donate the lane buffer.

        On an edge-sharded mesh a pool's entry (``pool=True``) holds only
        this rank's edge shards and the sharded step (``tel`` None; with
        ``resilience`` the oracle's whole TEL stays on the host), and a
        serial query's whole window is built afresh, uncached.
        """
        g = self.graph if graph is None else graph
        ep = self.epoch if epoch is None else int(epoch)
        if self._edge_sharded and not pool:
            tel, v_cap, e = self._whole_window(g, ep, Ts, Te, self.device)
            return WindowTEL(tel, None, None, v_cap, e)
        key = (ep, int(Ts), int(Te))
        hit = self._win_cache.get(key)
        if hit is not None:
            self._win_hits += 1
            self._win_cache.move_to_end(key)
            return hit
        self._win_misses += 1
        if self._edge_sharded:
            e = int(np.count_nonzero((g.t >= Ts) & (g.t <= Te)))
            host = (self._whole_window(g, ep, Ts, Te, torch.device("cpu"))[0]
                    if self._resilience is not None else None)
            out = WindowTEL(None, None, None, self._v_cap, e,
                            self._sharded_step(
                                lambda: self._shard_arrays(g, ep, Ts, Te, e),
                                host))
        else:
            tel, v_cap, e = self._whole_window(g, ep, Ts, Te, self.device)
            seg_pair = make_banded_segsum(int(tel.pair_u.shape[0]),
                                          tel.pair_id)
            seg_vert = make_banded_segsum(v_cap, tel.hp_src)
            if self.mesh is not None:
                step = self._sharded_step(
                    lambda: self._shard_arrays(g, ep, Ts, Te, e), tel)
            else:
                step = make_wave_step_fn(tel, v_cap, seg_pair=seg_pair,
                                         seg_vert=seg_vert,
                                         use_kernel=self._use_kernel,
                                         donate=self._resilience is None,
                                         resilience=self._resilience)
            out = WindowTEL(tel, seg_pair, seg_vert, v_cap, e, step)
        if len(self._win_cache) >= _WINDOW_CACHE_MAX:
            self._win_cache.popitem(last=False)     # evict least-recent
            self._win_evictions += 1
        self._win_cache[key] = out
        return out

    def _whole_window(self, g: TemporalGraph, ep: int, Ts: int, Te: int,
                      device: torch.device) -> Tuple[DeviceTEL, int, int]:
        """Snapshot ``g``'s window [Ts, Te] as one TEL on ``device`` ->
        (tel, vertex width, live edges): the current whole TEL when the
        window spans it, else the truncation, padded to a power of two.
        Pair tables on the engine's device are cached per epoch."""
        idx = np.flatnonzero((g.t >= Ts) & (g.t <= Te))
        e = int(idx.size)
        on_engine = device == self.device
        if on_engine and ep == self.epoch and e >= g.num_edges:
            return self.tel, self._v_cap, e
        if on_engine:
            aux = self._aux_for(ep, g)
        else:
            arrs = g.tel_arrays(pair_capacity=self._pair_cap,
                                vertex_capacity=self._v_cap)
            aux = _EpochAux(*(torch.from_numpy(arrs[k]).to(device)
                              for k in ("pair_u", "pair_v", "hp_src",
                                        "hp_pair")),
                            self._pair_cap, self._v_cap)
        pad = pow2_capacity(e) - e
        t_w = np.concatenate([g.t[idx], np.full(pad, _I32_MIN, np.int32)])
        cols = {
            "src": np.concatenate([g.src[idx], np.zeros(pad, np.int32)]),
            "dst": np.concatenate([g.dst[idx], np.zeros(pad, np.int32)]),
            "t": t_w,
            "pair_id": np.concatenate(
                [g.pair_id[idx], np.full(pad, aux.pair_cap, np.int32)]),
            "time_perm": np.argsort(t_w, kind="stable").astype(np.int32),
        }
        dev = {k: torch.from_numpy(v).to(device) for k, v in cols.items()}
        tel = DeviceTEL(pair_u=aux.pair_u, pair_v=aux.pair_v,
                        hp_src=aux.hp_src, hp_pair=aux.hp_pair, **dev)
        return tel, aux.v_cap, e

    def _shard_arrays(self, g: TemporalGraph, ep: int, Ts: int, Te: int,
                      e: int) -> Tuple[torch.Tensor, ...]:
        """This rank's six edge shards of snapshot ``g``'s window [Ts, Te]
        (``e`` live edges) on its device: the installed plan's when the
        window spans the current snapshot."""
        plan = self._shard_plan
        if ep == self.epoch and e >= g.num_edges:
            if self._plan_arrays is None:
                self._plan_arrays = rank_arrays(plan_arrays(plan), self.mesh)
            return self._plan_arrays
        return rank_arrays(plan.window_arrays(g, int(Ts), int(Te))
                           + plan.hp_arrays(g), self.mesh)

    # ------------------------------------------------------------ pool seam
    def make_pool(self, lo: int, hi: int, *,
                  graph: Optional[TemporalGraph] = None,
                  epoch: Optional[int] = None, num_queries: int = 1,
                  wave: Union[int, str] = "auto", depth: int = 2):
        """Window TEL + lane pipeline for one pool run; returns
        ``(pipe, wt, wave)`` with W autotuned when ``wave="auto"``."""
        wt = self._window_tel(int(lo), int(hi), graph=graph, epoch=epoch,
                              pool=True)
        if self.mesh is None:
            if wave == "auto":
                wave = autotune_wave(wt.num_vertices, wt.window_edges,
                                     num_queries=num_queries, depth=depth)
            pipe = WavePipeline(wt.tel, wt.num_vertices, wt.seg_pair,
                                wt.seg_vert, wave, depth, step_fn=wt.step_fn)
            return pipe, wt, wave
        L = self._lane_shards
        if wave == "auto":
            wave = autotune_wave(wt.num_vertices, wt.window_edges,
                                 num_queries=num_queries, depth=depth,
                                 lane_shards=L)
        else:
            wave = -(-int(wave) // L) * L   # even lane split per shard
        pipe = ShardedWavePipeline(wt.step_fn, mesh=self.mesh,
                                   num_vertices=wt.num_vertices, wave=wave,
                                   depth=depth, dist_counters=self._dist)
        return pipe, wt, wave

    # --------------------------------------------------------- observability
    def stats(self) -> Dict:
        """The window-TEL LRU's hit/miss/eviction counters and, when
        result caching is on, the core cache's (``CoreCache.stats``)."""
        out = {
            "epoch": self.epoch,
            "device": str(self.device),
            "window_tel": {
                "hits": self._win_hits,
                "misses": self._win_misses,
                "evictions": self._win_evictions,
                "size": len(self._win_cache),
            },
        }
        if self.core_cache is not None:
            out["core_cache"] = self.core_cache.stats()
        if self.mesh is not None:
            out["distributed"] = {
                "mesh": dict(zip(self.mesh.axis_names, self.mesh.shape)),
                "devices": int(self.mesh.size),
                "lane_shards": self._lane_shards,
                "model_shards": self._model_shards,
                "combine": self._combine,
                "backend": self.mesh.backend,
                **self._dist,
            }
        return out

    def _cache_view(self, k: int, h: int, epoch: Optional[int] = None):
        """CacheView bound to (epoch, k, h), or None when caching is off."""
        if self.core_cache is None:
            return None
        return CacheView(self.core_cache,
                         self.epoch if epoch is None else int(epoch), k, h)

    # ------------------------------------------------------------- primitives
    def _tcd(self, alive, ts, te, k, h,
             wt: Optional[WindowTEL] = None) -> TCDResult:
        """One TCD cell: on the engine's full TEL when ``wt`` is None,
        else on the window truncation, with the engine's ``degree_fn``."""
        tel = self.tel if wt is None else wt.tel
        nv = self.num_vertices if wt is None else wt.num_vertices
        return tcd(tel, alive, ts, te, k, h, num_vertices=nv,
                   degree_fn=self._degree_fn)

    # ------------------------------------------------------------------ query
    def query(self, k: int, Ts: int, Te: int, *, h: int = 1,
              algorithm: str = "otcd", mode: str = "serial",
              wave: Union[int, str] = 8, depth: int = 2,
              min_span: Optional[int] = None,
              max_span: Optional[int] = None) -> TCQResult:
        """All distinct temporal k-cores over subintervals of [Ts, Te].

        algorithm: "otcd" (TTI pruning, §4) or "tcd" (full enumeration, §3).
        mode: "serial" (paper-faithful) or "wave" (device-resident lane
        pool — up to ``wave`` schedule cells per device step, ``depth``
        steps in flight; ``wave="auto"`` autotunes W).
        h: link-strength lower bound (paper §6.2); 1 = plain TCQ.
        min_span/max_span: time-span constraint (paper §6.2).
        With a ``degree_fn`` the query runs serial on the full TEL.
        """
        if mode not in ("serial", "wave"):
            raise ValueError(
                f"unknown mode {mode!r}: expected 'serial' or 'wave'")
        t0 = time.perf_counter()
        uts = self.graph.unique_ts
        uts = uts[(uts >= Ts) & (uts <= Te)].astype(np.int64)
        n = int(uts.size)
        stats = QueryStats(n_timestamps=n, cells_total=n * (n + 1) // 2)
        if n == 0:
            return TCQResult([], stats)
        prune = algorithm == "otcd"
        if self._degree_fn is not None:
            # the fused step knows only the standard degree; a custom one
            # is written against the graph's real TEL, never a truncation
            stats.window_edges = self.graph.num_edges
            cores = self._run_serial(uts, k, h, prune, stats)
        elif mode == "wave":
            pipe, wt, wave = self.make_pool(int(uts[0]), int(uts[-1]),
                                            wave=wave, depth=depth)
            stats.window_edges = wt.window_edges
            cores = pipe.run(uts, k, h, prune, stats,
                             cache=self._cache_view(k, h))
        else:
            wt = self._window_tel(int(uts[0]), int(uts[-1]))
            stats.window_edges = wt.window_edges
            cores = self._run_serial(uts, k, h, prune, stats, wt)
        stats.wall_time_s = time.perf_counter() - t0
        res = TCQResult(list(cores.values()), stats)
        if min_span is not None or max_span is not None:
            res = res.filter_span(min_span, max_span)
        return res

    # ------------------------------------------------------------ query batch
    def query_batch(self, requests: Sequence[Mapping], *,
                    algorithm: str = "otcd", wave: Union[int, str] = "auto",
                    depth: int = 2) -> List[TCQResult]:
        """Serve many concurrent TCQ queries through one shared lane pool.

        ``requests`` holds mappings with keys ``k``, ``ts``, ``te`` and
        optionally ``h`` (default 1).  Each request gets its own
        QueryState; one TEL truncated to the *union* window serves the
        batch, and per-lane windows keep each query's exact semantics, so
        every returned result is bit-identical to running that query
        alone.  Per-query stats carry that query's schedule counters;
        pipeline counters describe the shared batch.  With a
        ``degree_fn`` each request runs alone through :meth:`query`.
        """
        t0 = time.perf_counter()
        reqs = [dict(r) for r in requests]
        if self._degree_fn is not None:
            return [self.query(int(r["k"]), int(r["ts"]), int(r["te"]),
                               h=int(r.get("h", 1)), algorithm=algorithm)
                    for r in reqs]
        prune = algorithm == "otcd"
        outs: List[Optional[TCQResult]] = [None] * len(reqs)
        states: List[Tuple[int, QueryState]] = []
        for qi, r in enumerate(reqs):
            uts = self.graph.unique_ts
            uts = uts[(uts >= int(r["ts"])) & (uts <= int(r["te"]))]
            uts = uts.astype(np.int64)
            n = int(uts.size)
            stats = QueryStats(n_timestamps=n,
                               cells_total=n * (n + 1) // 2,
                               batch_size=len(reqs))
            if n == 0:
                outs[qi] = TCQResult([], stats)
                continue
            states.append((qi, QueryState(
                uts, int(r["k"]), int(r.get("h", 1)), prune, stats,
                qid=qi,
                cache=self._cache_view(int(r["k"]), int(r.get("h", 1))))))
        if states:
            lo = min(int(s.uts[0]) for _, s in states)
            hi = max(int(s.uts[-1]) for _, s in states)
            pipe, wt, wave = self.make_pool(lo, hi,
                                            num_queries=len(states),
                                            wave=wave, depth=depth)
            pool_stats = QueryStats()
            pipe.run_pool([s for _, s in states], pool_stats)
            for qi, s in states:
                st = s.stats
                st.absorb_pool(pool_stats, window_edges=wt.window_edges,
                               batch_size=len(reqs))
                cores = s.decode_results(wt.num_vertices)
                outs[qi] = TCQResult(list(cores.values()), st)
        wall = time.perf_counter() - t0
        for out in outs:
            out.stats.wall_time_s = wall
        return outs

    # ----------------------------------------------------------- serial mode
    def _run_serial(self, uts, k, h, prune, stats,
                    wt: Optional[WindowTEL] = None):
        n = uts.size
        idx_of = {int(t): i for i, t in enumerate(uts)}
        pruned: Dict[int, IntervalSet] = defaultdict(IntervalSet)
        results: Dict[Tuple[int, int], CoreResult] = {}
        ones = self._ones if wt is None or \
            wt.num_vertices == self._ones.shape[0] else \
            torch.ones(wt.num_vertices, dtype=torch.bool, device=self.device)
        empty_col_max = -1          # cells (r, c<=bound) are provably empty
        row_alive = None            # warm start across rows (Theorem 1)
        row_alive_j = -1
        for i in range(n):
            iv = pruned.pop(i, IntervalSet())
            j: Optional[int] = n - 1
            cur_alive = None
            first_in_row = True
            while j is not None and j >= i:
                j = iv.highest_uncovered_leq(j)
                if j is None or j < i:
                    break
                if j <= empty_col_max:
                    stats.cells_trivial += (j - i + 1) - iv.total_covered(i, j)
                    break
                if cur_alive is not None:
                    warm = cur_alive
                elif row_alive is not None and j <= row_alive_j:
                    warm = row_alive
                else:
                    warm = ones
                res = self._tcd(warm, int(uts[i]), int(uts[j]), k, h, wt)
                stats.cells_evaluated += 1
                stats.device_steps += 1
                # one host read per cell: edge count and TTI together
                n_edges, tti_lo, tti_hi = torch.stack(
                    [res.n_edges, res.tti_lo, res.tti_hi]).tolist()
                if n_edges == 0:
                    if j > i:
                        stats.pruned_empty += (j - i) - iv.total_covered(i, j - 1)
                    empty_col_max = max(empty_col_max, j)
                    if j == n - 1:
                        # T[ts_i, Te] empty => all deeper rows empty
                        stats.cells_trivial += sum(
                            n - r for r in range(i + 1, n))
                        return results
                    break
                cur_alive = res.alive
                if first_in_row:
                    row_alive, row_alive_j = res.alive, j
                    first_in_row = False
                a_idx = idx_of[tti_lo]
                b_idx = idx_of[tti_hi]
                self._collect(results, res, n_edges, a_idx, b_idx, uts, k,
                              stats)
                if prune:
                    if b_idx < j:                       # Rule 1: PoR
                        stats.por_triggers += 1
                        stats.pruned_por += (j - b_idx) - iv.total_covered(
                            b_idx, j - 1)
                    if a_idx > i:                       # Rule 2: PoU
                        stats.pou_triggers += 1
                        for r in range(i + 1, a_idx + 1):
                            stats.pruned_pou += pruned[r].add(r, j)
                    if a_idx > i and b_idx < j:         # Rule 3: PoL
                        stats.pol_triggers += 1
                        for r in range(a_idx + 1, b_idx + 1):
                            stats.pruned_pol += pruned[r].add(b_idx + 1, j)
                    j = (b_idx - 1) if b_idx < j else j - 1
                else:
                    j = j - 1
        return results

    # ---------------------------------------------------------------- collect
    def _collect(self, results, res, n_edges, a_idx, b_idx, uts, k, stats):
        key = (int(uts[a_idx]), int(uts[b_idx]))
        if key in results:
            stats.duplicates += 1
            return
        alive = res.alive.cpu().numpy()         # full [V] bool transfer
        stats.host_syncs += 1
        stats.bytes_synced += alive.nbytes
        results[key] = CoreResult(k=k, tti=key, vertices=np.flatnonzero(alive),
                                  n_edges=int(n_edges))


def temporal_kcore_query(graph: TemporalGraph, k: int, Ts: int, Te: int, *,
                         device=None, degree_fn=None, **kw) -> TCQResult:
    """One-shot convenience wrapper (builds a throwaway engine)."""
    return TCQEngine(graph, degree_fn, device=device).query(k, Ts, Te, **kw)
