"""Host-side scheduling state for the multi-tenant wave pipeline.

The wave engine (`engine.WavePipeline`) is a *lane pool*: a persistent
[W, V] device buffer whose rows each peel one schedule cell per fused
step.  Everything the pool needs to know about *which* cell a lane should
peel next is per-query bookkeeping — row cursors, the IntervalSet pruning
state of Rules 1–3, the empty-cell staircase, warm-start rows (Theorem 1)
and TTI dedup (Property 2).  This module owns that bookkeeping:

* :class:`QueryState` — one in-flight TCQ query.  The pipeline calls
  ``claim()`` to draw a ready cell, ``retire()`` to feed back one
  evaluated cell's (TTI, n_edges, packed mask), and ``decode_results()``
  once the query drains.  Because each query keeps its own pruning and
  dedup state, a lane pool serving many QueryStates returns *exactly*
  the result set of running each query alone — cross-query packing only
  changes which lanes cells ride in, never which cores exist.

* :class:`EmptyStaircase` — the incremental replacement for the
  O(|empty_marks|)-per-call ``empty_bound`` scan: empty cell (i, j)
  implies every cell (r >= i, c <= j) is empty, so the bound
  ``max{j : (i, j) marked, i <= r}`` is a monotone step function of r,
  kept as a strictly-increasing corner list with O(log m) queries and
  amortized O(log m) inserts.

* :func:`autotune_wave` — picks the lane count W from the vertex count
  and the *windowed* edge count (each lane costs O(E_w + V) active
  elements per fixpoint iteration), scaled by how many queries the pool
  is serving.
"""

from __future__ import annotations

import bisect
from collections import defaultdict, deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.intervals import IntervalSet
from repro_torch.core.results import CoreResult, QueryStats
from repro_torch.core.wave import unpack_alive_u32


# ---------------------------------------------------------- empty staircase
class EmptyStaircase:
    """Monotone bound ``max{j : mark (i, j), i <= r}`` over empty cells.

    Marks arrive in arbitrary order (wave lanes retire concurrently, rows
    are not swept in ascending order), but the bound itself is
    non-decreasing in r, so only the *dominant* corners need keeping:
    ``_is`` strictly increasing, ``_js`` strictly increasing, and a mark
    (i, j) is dominated iff some kept (i', j') has i' <= i and j' >= j.
    """

    __slots__ = ("_is", "_js")

    def __init__(self):
        self._is: List[int] = []
        self._js: List[int] = []

    def add(self, i: int, j: int) -> None:
        """Record empty cell (i, j); drops it if dominated, else replaces
        every corner it dominates (amortized O(log m))."""
        pos = bisect.bisect_right(self._is, i)
        if pos and self._js[pos - 1] >= j:
            return
        start = pos - 1 if pos and self._is[pos - 1] == i else pos
        end = pos
        while end < len(self._js) and self._js[end] <= j:
            end += 1
        self._is[start:end] = [i]
        self._js[start:end] = [j]

    def bound(self, r: int) -> int:
        """Largest marked j with i <= r, or -1: cells (r, c <= bound) are
        provably empty."""
        pos = bisect.bisect_right(self._is, r)
        return self._js[pos - 1] if pos else -1

    def __len__(self) -> int:
        return len(self._is)


# --------------------------------------------------------------- row cursor
class RowCursor:
    """Cursor of one schedule row: cells (i, j) swept right-to-left."""

    __slots__ = ("i", "j", "first")

    def __init__(self, i: int, n: int):
        self.i, self.j, self.first = i, n - 1, True


# -------------------------------------------------------------- query state
class QueryState:
    """Schedule bookkeeping for one TCQ query served by the lane pool.

    Owns the per-query pruning state (IntervalSets of Rules 1–3, the
    empty-cell staircase), warm-start tracking (best completed row-initial
    core, Theorem 1), TTI dedup (Property 2) and the packed result rows.
    ``stats`` accumulates this query's own counters (cells evaluated,
    prune triggers, duplicates); pipeline-level counters (device steps,
    syncs) belong to whoever runs the pool.
    """

    def __init__(self, uts: np.ndarray, k: int, h: int, prune: bool,
                 stats: QueryStats, qid: int = 0,
                 deadline: float = float("inf"), priority: int = 0,
                 cache=None):
        self.qid = qid
        self.uts = np.asarray(uts)
        self.n = int(self.uts.size)
        self.k, self.h = int(k), int(h)
        self.prune = bool(prune)
        self.stats = stats
        # optional corecache.CacheView bound to this query's (epoch, k, h):
        # claim() resolves cached cells without spending a lane, retire()
        # inserts every freshly peeled cell (insert-on-peel)
        self.cache = cache
        # EDF admission key: the lane pool claims cells from the state
        # with the smallest (deadline, priority) first (scheduler ties
        # fall back to round-robin).  inf deadline = best-effort.
        self.deadline = float(deadline)
        self.priority = int(priority)
        # memoized (deadline, priority): both are fixed at admission, and
        # the pool's EDF claim loop reads the key O(states) per claim
        self._edf = (self.deadline, self.priority)
        # set by cancel(): the pool reclaims this query's lanes at the
        # next assemble/retire instead of peeling them further
        self.cancelled = False
        self.idx_of = {int(t): i for i, t in enumerate(self.uts)}
        self.pruned: Dict[int, IntervalSet] = defaultdict(IntervalSet)
        self.empty = EmptyStaircase()
        # (row, col, device [V] row) of the best completed row-initial core
        self.best_init: Optional[Tuple[int, int, object]] = None
        # cursor objects (not bare indices): cache probing can part-consume
        # a row without claiming a lane, so cursor position must survive
        # being requeued
        self.pending = deque(RowCursor(i, self.n) for i in range(self.n))
        self.live_rows = 0          # rows currently holding a lane
        # tti key -> (packed uint32 row, n_edges); decoded in bulk at the end
        self.collected: Dict[Tuple[int, int], Tuple[np.ndarray, int]] = {}

    # ------------------------------------------------------------- claiming
    @property
    def drained(self) -> bool:
        """No more rows to hand out (in-flight rows may still be peeling)."""
        return not self.pending

    @property
    def done(self) -> bool:
        return not self.pending and self.live_rows == 0

    def cancel(self) -> None:
        """Withdraw the query: drop every unclaimed cell and flag the
        state so the lane pool frees its in-flight lanes (deadline
        timeout / client cancellation).  Idempotent; ``done`` becomes
        True once the pool has reclaimed the last live lane."""
        self.cancelled = True
        self.pending.clear()

    def claim(self) -> Optional[RowCursor]:
        """Next ready row cursor, or None when nothing is pending.

        With a cache attached, cells that resolve from it are consumed
        here — fed through the same pruning/dedup feedback as a peeled
        cell — and only a row whose next cell *misses* ever takes a lane.
        """
        while self.pending:
            row = self.pending.popleft()
            if not self._advance(row):
                continue
            if self._drain_cached(row):
                self.live_rows += 1
                return row
        return None

    def _drain_cached(self, row: RowCursor) -> bool:
        """Resolve the row's cells from the cache until a miss (True — the
        row still needs a lane) or exhaustion (False)."""
        if self.cache is None:
            return True
        while True:
            hit = self.cache.lookup(*self.window(row))
            if hit is None:
                return True
            self.stats.cells_cached += 1
            if not self._feedback(row, hit.tti_lo, hit.tti_hi, hit.n_edges,
                                  hit.packed, None):
                return False

    def resolve_cached(self) -> int:
        """Admission-time sweep: resolve every pending row as far as the
        cache reaches; rows that miss keep their cursor position for the
        lane pool.  Returns the number of cells resolved (``done`` turns
        True when the whole query was served from cache)."""
        resolved0 = self.stats.cells_cached
        if self.cache is not None and not self.cancelled:
            keep = deque()
            while self.pending:
                row = self.pending.popleft()
                if self._advance(row) and self._drain_cached(row):
                    keep.append(row)
            self.pending = keep
        return self.stats.cells_cached - resolved0

    def _advance(self, row: RowCursor) -> bool:
        """Move the cursor past pruned/empty cells; False once exhausted."""
        j = self.pruned[row.i].highest_uncovered_leq(row.j)
        if j is None or j < row.i or j <= self.empty.bound(row.i):
            return False
        row.j = j
        return True

    def window(self, row: RowCursor) -> Tuple[int, int]:
        return int(self.uts[row.i]), int(self.uts[row.j])

    def warm_start(self, row: RowCursor):
        """Device [V] row to warm the lane with, or None for cold all-ones.

        Theorem 1: any completed core over an enclosing window is a valid
        peel superset, so the widest finished row-initial core warms every
        cell it sandwiches."""
        b = self.best_init
        if b is not None and b[0] <= row.i and b[1] >= row.j:
            return b[2]
        return None

    # ------------------------------------------------------------- retiring
    def retire(self, row: RowCursor, tti_lo: int, tti_hi: int, n_edges: int,
               packed_row: np.ndarray, alive_row: Callable[[], object]
               ) -> bool:
        """Feed back one evaluated cell; True iff the row keeps its lane
        (its peeled mask is then the warm start for the next cell).

        ``alive_row`` is a thunk producing the lane's device [V] row — it
        is only materialized when the cell becomes the new best warm-start
        row, so retiring never copies lanes it does not need.  The row it
        returns must be a copy the lane pool will not overwrite: the port
        refills lane buffers in place.

        With a cache attached, the peeled cell is inserted before feedback
        (insert-on-peel), and the row's subsequent cells are drained from
        the cache so the lane is only kept for a genuine miss.
        """
        if self.cache is not None:
            ts, te = self.window(row)
            if n_edges == 0:
                self.cache.insert_empty(ts, te)
            else:
                self.cache.insert(ts, te, tti_lo, tti_hi, n_edges,
                                  packed_row)
        keep = self._feedback(row, tti_lo, tti_hi, n_edges, packed_row,
                              alive_row)
        if keep:
            keep = self._drain_cached(row)
        if not keep:
            self.live_rows -= 1
        return keep

    def _feedback(self, row: RowCursor, tti_lo: int, tti_hi: int,
                  n_edges: int, packed_row: Optional[np.ndarray],
                  alive_row: Optional[Callable[[], object]]) -> bool:
        """Apply one resolved cell (peeled or cache-served) to the query's
        pruning/dedup/staircase state and advance the cursor; True while
        the row has cells left.  ``alive_row`` is None for cache hits —
        there is no device row to promote to a warm start (Theorem 1 makes
        that a pure perf concession, never a correctness one)."""
        i, j = row.i, row.j
        stats = self.stats
        if n_edges == 0:
            self.empty.add(i, j)        # staircase: row exhausted
            return False
        a_idx = self.idx_of[tti_lo]
        b_idx = self.idx_of[tti_hi]
        key = (tti_lo, tti_hi)
        if key in self.collected:
            stats.duplicates += 1
        else:
            self.collected[key] = (packed_row, n_edges)
        if alive_row is not None and row.first and \
                (self.best_init is None or j >= self.best_init[1]):
            self.best_init = (i, j, alive_row())
        row.first = False
        if self.prune:
            if b_idx < j:                        # Rule 1: PoR
                stats.por_triggers += 1
                stats.pruned_por += self.pruned[i].add(b_idx, j - 1)
            if a_idx > i:                        # Rule 2: PoU
                stats.pou_triggers += 1
                for r2 in range(i + 1, a_idx + 1):
                    stats.pruned_pou += self.pruned[r2].add(r2, j)
            if a_idx > i and b_idx < j:          # Rule 3: PoL
                stats.pol_triggers += 1
                for r2 in range(a_idx + 1, b_idx + 1):
                    stats.pruned_pol += self.pruned[r2].add(b_idx + 1, j)
            row.j = (b_idx - 1) if b_idx < j else j - 1
        else:
            row.j = j - 1
        return self._advance(row)

    # -------------------------------------------------------------- results
    def decode_results(self, num_vertices: int
                       ) -> Dict[Tuple[int, int], CoreResult]:
        """One deferred bulk unpack of every collected packed core row.

        Rows are grouped by packed width before stacking: cache-served
        rows may predate a capacity growth and carry fewer uint32 words
        than freshly peeled ones.  Vertex capacities only ever grow and
        padded vertices are never core members, so a narrower row decodes
        to the same vertex set.
        """
        results: Dict[Tuple[int, int], CoreResult] = {}
        by_width: Dict[int, list] = defaultdict(list)
        for key, (packed_row, _) in self.collected.items():
            by_width[int(packed_row.size)].append(key)
        for width, keys in by_width.items():
            bits = unpack_alive_u32(
                np.stack([self.collected[key][0] for key in keys]),
                min(int(num_vertices), width * 32))
            # one nonzero over the stacked group, split at row boundaries
            # (vs a flatnonzero per core: this loop is the hot tail of
            # every query's finalize)
            rows_idx, cols = np.nonzero(bits)
            verts = np.split(cols, np.searchsorted(
                rows_idx, np.arange(1, len(keys))))
            for key, v in zip(keys, verts):
                results[key] = CoreResult(
                    k=self.k, tti=key, vertices=v,
                    n_edges=self.collected[key][1])
        return results


# ----------------------------------------------------------- lane autotuning
_LANE_ELEM_BUDGET = 1 << 19     # active elements (~f32 words) per device step
_LANES_PER_QUERY = 8            # demand: lanes one query can keep busy
_W_MIN, _W_MAX = 4, 64


def autotune_wave(num_vertices: int, window_edges: int,
                  num_queries: int = 1, depth: int = 2,
                  lane_shards: int = 1) -> int:
    """Pick the lane count W for a (batch of) wave queries.

    One fixpoint iteration touches O(W * (E_w + V)) active elements (edge
    activity + degrees per lane), so W is sized to keep the pipeline's
    *in-flight* working set near ``_LANE_ELEM_BUDGET`` — large enough to
    amortize per-step dispatch/sync overhead, small enough to stay
    cache-resident and to bound the waste of the shared fixpoint loop
    (every lane runs until the slowest converges).  The slot ring keeps
    ``depth`` lane buffers in flight at once (D·W lanes of live state),
    so the supply bound scales as 1/depth — the budget is calibrated at
    the default depth of 2, and deeper rings shrink W instead of
    overshooting the element budget.  Demand caps supply: a single query
    rarely keeps more than ~8 lanes full (schedule tails drain), so W
    also scales with how many queries the pool serves.  Result is a power
    of two in [4, 64] so lane-buffer shapes are reused.  The
    constants match the JAX package's, so both pick the same W.

    On a mesh, ``lane_shards`` is the lane-axis size (pod x data): the
    supply/budget math is *per shard* (each shard holds W/L lanes of
    live state and the edge shards are narrower by the model factor,
    which ``window_edges`` callers already account for by passing the
    union-window edge count — conservative), the per-query demand is
    divided across shards, and the result is scaled back to a global W
    that is a multiple of L so the [W, V] buffer splits evenly over the
    lane axis.  ``lane_shards=1`` reproduces the single-device choice
    exactly.
    """
    per_lane = max(1, int(num_vertices) + int(window_edges))
    supply = max(1, (2 * _LANE_ELEM_BUDGET) // (per_lane * max(1, int(depth))))
    shards = max(1, int(lane_shards))
    demand = -(-(_LANES_PER_QUERY * max(1, int(num_queries))) // shards)
    w = max(_W_MIN, min(_W_MAX, supply, demand))
    w = 1 << (w.bit_length() - 1)               # round down to a power of two
    return w * shards


# Dense psum payloads up to this many elements (V * W f32 degrees) are
# cheaper than the extra all-gather latency of rs_ag on small problems;
# beyond it the ~7x wire saving of reduce-scatter + 1-byte alive gather
# wins.  The sharded engine's ``combine="auto"`` picks with it.
_COMBINE_DENSE_MAX = 1 << 16


def choose_combine(num_vertices: int, wave: int, model_shards: int) -> str:
    """Auto-select the sharded degree-combine collective: dense all-reduce
    ("psum") for small V*W payloads, reduce-scatter + alive all-gather
    ("rs_ag") once the dense payload outgrows ``_COMBINE_DENSE_MAX``.
    Single-model-shard meshes have no combine; "psum" (a no-op) keeps the
    step collective-free."""
    if model_shards <= 1:
        return "psum"
    if int(num_vertices) * max(1, int(wave)) <= _COMBINE_DENSE_MAX:
        return "psum"
    return "rs_ag"
