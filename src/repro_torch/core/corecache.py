"""TTI-keyed core-result cache with incremental epoch invalidation
(PyTorch port of ``repro.core.corecache``: host-side numpy, the same
entries, counters and ``state_dict`` layout, so a cache persisted by
either package loads in the other).

The paper's Property 2 makes the Tightest Time Interval a canonical
identity: for a fixed graph snapshot and (k, h), two windows with the same
TTI induce the *same* (k, h)-core subgraph.  That turns the TTI into a
content-addressable key — a peeled core can be stored once per
``(epoch, k, h, TTI)`` and served to every later window that tightens to
it, across requests.  This module is that store.

Two index layers mirror the two halves of Property 2:

* **cores** — ``(epoch, k, h, lo, hi) -> (packed uint32 vertex bitmask,
  n_edges)``.  One entry per distinct core subgraph; payload bytes are
  bounded by a size-capped LRU (the packed uint32 format keeps a core
  at V/8 bytes).
* **cells** — ``(epoch, k, h, ts, te) -> None | (lo, hi)``: the evaluated
  query window mapped to its TTI outcome (``None`` records a window with
  no (k, h)-core at all).  Cells are what admission-time lookup probes;
  they resolve a window without touching the device.

Lookups also exploit *dominance* (core monotonicity, paper Lemma 1): a
known cell ``(ts, te) -> (lo, hi)`` resolves any queried window
``(a, b)`` with ``ts <= a <= lo`` and ``hi <= b <= te`` — shrinking a
window while still containing its core's TTI cannot change the core.  An
empty cell resolves every sub-window the same way.  Note the converse
merge is *unsound*: two same-TTI windows cannot be unioned (edges between
the windows' slack regions can create a larger core), so entries stay
per-cell and dominance is a per-group scan.

The port keeps each group's cells as int64 columns (:class:`_Group`)
and scans them with numpy: a serving run at
the sx-mathoverflow shape holds ~30k cells in one (k, h) group, and the
JAX package's Python loop over them took ~2 ms per miss, most of a
pool's host time.  The columns are in the group's insertion order and
the scan takes the first cell that resolves the window, as the loop
does, so both packages return the same hits and count the same
statistics.

Ingest never flushes.  ``advance_epoch(old, new, batch_lo, batch_hi)``
deletes only entries the appended batch can affect — a **cell** dies when
its *window* intersects the batch span (a new edge anywhere inside the
window can grow the core, even outside the old TTI); a **core payload**
dies when its *TTI* intersects (the payload is exactly ``core([lo, hi])``).
Survivors are re-keyed to the new epoch in place, so an append costs one
pass over the affected epoch's entries, not a cold cache.  The same
re-keying seam backs the engine's ``rebase_epoch``/``retire_epochs``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Iterable, NamedTuple, Optional, Tuple

import numpy as np

_MISS = object()
_EMPTY, _CORE = 1, 2        # _Group cell kinds (0: a removed cell)


class _Group:
    """One (epoch, k, h) group's cells, window -> outcome, as growable
    int64 columns (ts, te, lo, hi, kind) in insertion order, so that a
    dominance lookup is one vectorized scan.  Removed cells are marked
    dead and squeezed out when the columns fill."""

    __slots__ = ("cols", "wins", "slot", "n")

    def __init__(self):
        self.cols = np.zeros((5, 64), np.int64)
        self.wins: list = []            # slot -> window (None once dead)
        self.slot: Dict[tuple, int] = {}
        self.n = 0

    def __len__(self) -> int:
        return len(self.slot)

    def _outcome(self, i: int) -> Optional[tuple]:
        if self.cols[4, i] == _EMPTY:
            return None
        return int(self.cols[2, i]), int(self.cols[3, i])

    def get(self, win: tuple):
        """The window's outcome (None: no core), or ``_MISS``."""
        i = self.slot.get(win)
        return _MISS if i is None else self._outcome(i)

    def items(self) -> list:
        """(window, outcome) of the live cells, in insertion order."""
        return [(w, self._outcome(i)) for i, w in enumerate(self.wins)
                if w is not None]

    def add(self, win: tuple, outcome: Optional[tuple]) -> None:
        if self.n == self.cols.shape[1]:
            live = [i for i in range(self.n) if self.wins[i] is not None]
            if 2 * len(live) > self.n:          # mostly live: grow
                self.cols = np.concatenate(
                    [self.cols, np.zeros_like(self.cols)], axis=1)
            else:                               # mostly dead: squeeze
                self.cols[:, :len(live)] = self.cols[:, live]
                self.wins = [self.wins[i] for i in live]
                self.slot = {w: i for i, w in enumerate(self.wins)}
                self.n = len(live)
        i = self.n
        lo, hi = (0, -1) if outcome is None else outcome
        self.cols[:, i] = (win[0], win[1], lo, hi,
                           _EMPTY if outcome is None else _CORE)
        self.wins.append(win)
        self.slot[win] = i
        self.n += 1

    def remove(self, win: tuple) -> None:
        i = self.slot.pop(win, None)
        if i is not None:
            self.cols[4, i] = 0
            self.wins[i] = None

    def dominating(self, a: int, b: int):
        """Outcomes of the live cells that resolve ``[a, b]`` by
        dominance, in insertion order: empty cells with ts <= a and
        b <= te, core cells with ts <= a <= lo and hi <= b <= te."""
        ts, te, lo, hi, kind = self.cols[:, :self.n]
        hit = (ts <= a) & (b <= te) & (
            (kind == _EMPTY) | ((kind == _CORE) & (a <= lo) & (hi <= b)))
        for i in np.flatnonzero(hit).tolist():
            yield self._outcome(i)


class CacheHit(NamedTuple):
    """A resolved cell: its TTI and the cached core payload.

    ``n_edges == 0`` means the window has no (k, h)-core; then ``packed``
    is ``None`` and ``(tti_lo, tti_hi)`` echo the probed window.
    """

    tti_lo: int
    tti_hi: int
    n_edges: int
    packed: Optional[np.ndarray]   # uint32 LSB-first vertex bitmask row


class CoreCache:
    """Size-capped LRU of peeled cores, keyed ``(epoch, k, h, TTI)``.

    ``max_bytes`` bounds the packed-bitmask payload bytes; ``max_cells``
    bounds the (tiny, fixed-size) cell index.  Single-threaded, host-side.
    """

    def __init__(self, max_bytes: int = 64 << 20, max_cells: int = 1 << 16):
        self.max_bytes = int(max_bytes)
        self.max_cells = int(max_cells)
        # (epoch, k, h, lo, hi) -> (packed row, n_edges); LRU order
        self._cores: "OrderedDict[tuple, Tuple[np.ndarray, int]]" = \
            OrderedDict()
        # (epoch, k, h) -> its cells, (ts, te) -> None | (lo, hi); groups
        # give dominance scans locality, _cells keeps the global LRU order
        self._groups: Dict[tuple, _Group] = {}
        self._cells: "OrderedDict[tuple, None]" = OrderedDict()
        self.bytes = 0
        self.hits = 0            # exact-key cell hits
        self.dominance_hits = 0  # resolved by the monotonicity scan
        self.misses = 0
        self.inserts = 0
        self.invalidated = 0     # entries killed by an ingest batch
        self.rekeyed = 0         # entries carried across an ingest epoch
        self.evicted_cores = 0
        self.evicted_cells = 0

    # ------------------------------------------------------------- internals
    def _cell_del(self, ckey: tuple) -> None:
        gkey, win = ckey[:3], ckey[3:]
        self._cells.pop(ckey, None)
        grp = self._groups.get(gkey)
        if grp is not None:
            grp.remove(win)
            if not grp:
                del self._groups[gkey]

    def _cell_put(self, gkey: tuple, win: tuple,
                  outcome: Optional[tuple]) -> None:
        ckey = gkey + win
        if ckey not in self._cells:
            grp = self._groups.get(gkey)
            if grp is None:
                grp = self._groups[gkey] = _Group()
            grp.add(win, outcome)
            self._cells[ckey] = None
        self._cells.move_to_end(ckey)
        while len(self._cells) > self.max_cells:
            victim, _ = self._cells.popitem(last=False)
            self._cell_del(victim)
            self.evicted_cells += 1

    def _core_del(self, key: tuple) -> None:
        payload = self._cores.pop(key, None)
        if payload is not None:
            self.bytes -= payload[0].nbytes

    # ----------------------------------------------------------------- reads
    def lookup(self, epoch: int, k: int, h: int, a: int, b: int
               ) -> Optional[CacheHit]:
        """Resolve window ``[a, b]`` at (epoch, k, h), or ``None`` on miss.

        Exact cell hit first; otherwise one dominance scan over the
        group's cells.  A dominance hit is memoized as an exact cell so
        repeats of the same window skip the scan.
        """
        gkey = (int(epoch), int(k), int(h))
        grp = self._groups.get(gkey)
        if grp is None:
            self.misses += 1
            return None
        win = (int(a), int(b))     # grp is held: a stale cell may empty it
        out = grp.get(win)
        if out is not _MISS:
            hit = self._materialize(gkey, win, out)
            if hit is not None:
                self.hits += 1
                self._cells.move_to_end(gkey + win)
                return hit
            self._cell_del(gkey + win)     # payload was evicted: stale cell
        for o in grp.dominating(*win):
            if o is None:
                self.dominance_hits += 1
                self._cell_put(gkey, win, None)
                return CacheHit(win[0], win[1], 0, None)
            hit = self._materialize(gkey, win, o)
            if hit is not None:
                self.dominance_hits += 1
                self._cell_put(gkey, win, o)
                return hit
        self.misses += 1
        return None

    def _materialize(self, gkey: tuple, win: tuple,
                     outcome: Optional[tuple]) -> Optional[CacheHit]:
        if outcome is None:
            return CacheHit(win[0], win[1], 0, None)
        payload = self._cores.get(gkey + outcome)
        if payload is None:
            return None                    # evicted under memory pressure
        self._cores.move_to_end(gkey + outcome)
        return CacheHit(outcome[0], outcome[1], payload[1], payload[0])

    # ---------------------------------------------------------------- writes
    def insert(self, epoch: int, k: int, h: int, ts: int, te: int,
               lo: int, hi: int, n_edges: int, packed: np.ndarray) -> None:
        """Record a peeled cell ``(ts, te) -> TTI (lo, hi)`` and its core.

        Also records the canonical cell ``(lo, hi) -> (lo, hi)`` — the TTI
        window itself always resolves to the same core (Property 2).
        """
        gkey = (int(epoch), int(k), int(h))
        tti = (int(lo), int(hi))
        ckey = gkey + tti
        if ckey not in self._cores:
            row = np.ascontiguousarray(packed, dtype=np.uint32)
            row.flags.writeable = False    # rows are shared across states
            self._cores[ckey] = (row, int(n_edges))
            self.bytes += row.nbytes
            while self.bytes > self.max_bytes and self._cores:
                victim, (vrow, _) = self._cores.popitem(last=False)
                self.bytes -= vrow.nbytes
                self.evicted_cores += 1
        else:
            self._cores.move_to_end(ckey)
        self.inserts += 1
        self._cell_put(gkey, (int(ts), int(te)), tti)
        if (int(ts), int(te)) != tti:
            self._cell_put(gkey, tti, tti)

    def insert_empty(self, epoch: int, k: int, h: int, ts: int, te: int
                     ) -> None:
        """Record that window ``[ts, te]`` has no (k, h)-core."""
        self.inserts += 1
        self._cell_put((int(epoch), int(k), int(h)), (int(ts), int(te)),
                       None)

    # ------------------------------------------------------------ epoch flow
    def advance_epoch(self, old: int, new: int, batch_lo: int,
                      batch_hi: int) -> Tuple[int, int]:
        """Carry epoch ``old`` entries to ``new`` across an appended batch
        spanning ``[batch_lo, batch_hi]``.

        Cells whose *window* intersects the batch are invalidated (an
        appended edge inside the window can grow the core); core payloads
        whose *TTI* intersects are invalidated (the payload is the core of
        exactly ``[lo, hi]``).  A surviving cell's window avoids the batch
        span, hence so does its TTI — cell and payload survival are
        consistent.  Returns ``(invalidated, rekeyed)`` entry counts.
        """
        inv = moved = 0
        for gkey in [g for g in self._groups if g[0] == old]:
            ngkey = (new,) + gkey[1:]
            for win, out in self._groups[gkey].items():
                self._cell_del(gkey + win)
                if win[0] <= batch_hi and batch_lo <= win[1]:
                    inv += 1
                else:
                    self._cell_put(ngkey, win, out)
                    moved += 1
        for key in [c for c in self._cores if c[0] == old]:
            if key[3] <= batch_hi and batch_lo <= key[4]:
                self._core_del(key)
                inv += 1
            else:
                payload = self._cores.pop(key)
                self._cores[(new,) + key[1:]] = payload
                moved += 1
        self.invalidated += inv
        self.rekeyed += moved
        return inv, moved

    def rebase_epoch(self, old: int, new: int) -> None:
        """Re-key every epoch ``old`` entry to ``new`` (snapshot restore
        renumbering — same graph, new epoch label, nothing invalidated)."""
        if old == new:
            return
        for gkey in [g for g in self._groups if g[0] == old]:
            ngkey = (new,) + gkey[1:]
            for win, out in self._groups[gkey].items():
                self._cell_del(gkey + win)
                self._cell_put(ngkey, win, out)
        for key in [c for c in self._cores if c[0] == old]:
            self._cores[(new,) + key[1:]] = self._cores.pop(key)

    def retire_epochs(self, live: Iterable[int]) -> None:
        """Drop every entry whose epoch is not in ``live`` (mirrors the
        engine's window-TEL retirement when pinned queries drain)."""
        keep = set(int(e) for e in live)
        for gkey in [g for g in self._groups if g[0] not in keep]:
            for win, _ in self._groups[gkey].items():
                self._cell_del(gkey + win)
                self.evicted_cells += 1
        for key in [c for c in self._cores if c[0] not in keep]:
            self._core_del(key)
            self.evicted_cores += 1

    # --------------------------------------------------------------- observe
    def stats(self) -> Dict[str, int]:
        probes = self.hits + self.dominance_hits + self.misses
        return {
            "hits": self.hits,
            "dominance_hits": self.dominance_hits,
            "misses": self.misses,
            "hit_rate": ((self.hits + self.dominance_hits) / probes
                         if probes else 0.0),
            "inserts": self.inserts,
            "invalidated": self.invalidated,
            "rekeyed": self.rekeyed,
            "evicted_cores": self.evicted_cores,
            "evicted_cells": self.evicted_cells,
            "n_cores": len(self._cores),
            "n_cells": len(self._cells),
            "bytes": self.bytes,
        }

    # ----------------------------------------------------------- persistence
    def state_dict(self) -> Dict[str, np.ndarray]:
        """Flat str->ndarray snapshot (``np.savez``-ready); round-trips
        through :meth:`load_state`.  LRU recency and counters are not
        persisted — a restored cache is warm but freshly ranked."""
        cell_rows = []
        for ckey in self._cells:               # oldest -> newest
            gkey, win = ckey[:3], ckey[3:]
            out = self._groups[gkey].get(win)
            lo, hi = (0, -1) if out is None else out   # lo > hi == empty
            cell_rows.append(gkey + win + (lo, hi))
        core_keys = list(self._cores.keys())   # oldest -> newest
        packed = [self._cores[k][0] for k in core_keys]
        widths = np.asarray([p.size for p in packed], dtype=np.int64)
        return {
            "cells": np.asarray(cell_rows, dtype=np.int64).reshape(-1, 7),
            "core_keys": np.asarray(core_keys,
                                    dtype=np.int64).reshape(-1, 5),
            "core_edges": np.asarray([self._cores[k][1] for k in core_keys],
                                     dtype=np.int64),
            "core_offsets": np.concatenate(
                [[0], np.cumsum(widths)]).astype(np.int64),
            "core_packed": (np.concatenate(packed).astype(np.uint32)
                            if packed else np.zeros(0, np.uint32)),
            "caps": np.asarray([self.max_bytes, self.max_cells],
                               dtype=np.int64),
        }

    def load_state(self, state) -> None:
        """Install entries from a :meth:`state_dict` snapshot (additive —
        call on a fresh cache for an exact round-trip)."""
        caps = np.asarray(state["caps"], dtype=np.int64)
        self.max_bytes = int(caps[0])
        self.max_cells = int(caps[1])
        keys = np.asarray(state["core_keys"], dtype=np.int64)
        edges = np.asarray(state["core_edges"], dtype=np.int64)
        off = np.asarray(state["core_offsets"], dtype=np.int64)
        flat = np.asarray(state["core_packed"], dtype=np.uint32)
        for i in range(keys.shape[0]):
            row = np.ascontiguousarray(flat[off[i]:off[i + 1]])
            row.flags.writeable = False
            key = tuple(int(x) for x in keys[i])
            if key not in self._cores:
                self._cores[key] = (row, int(edges[i]))
                self.bytes += row.nbytes
        for r in np.asarray(state["cells"], dtype=np.int64):
            e, k, h, ts, te, lo, hi = (int(x) for x in r)
            self._cell_put((e, k, h), (ts, te),
                           None if lo > hi else (lo, hi))

    @classmethod
    def from_state(cls, state) -> "CoreCache":
        cache = cls()
        cache.load_state(state)
        return cache


class CacheView:
    """A :class:`CoreCache` bound to one ``(epoch, k, h)`` — the handle a
    QueryState carries, so scheduler code never sees epoch bookkeeping."""

    __slots__ = ("cache", "epoch", "k", "h")

    def __init__(self, cache: CoreCache, epoch: int, k: int, h: int):
        self.cache = cache
        self.epoch = int(epoch)
        self.k = int(k)
        self.h = int(h)

    def lookup(self, ts: int, te: int) -> Optional[CacheHit]:
        return self.cache.lookup(self.epoch, self.k, self.h, ts, te)

    def insert(self, ts: int, te: int, lo: int, hi: int, n_edges: int,
               packed: np.ndarray) -> None:
        self.cache.insert(self.epoch, self.k, self.h, ts, te, lo, hi,
                          n_edges, packed)

    def insert_empty(self, ts: int, te: int) -> None:
        self.cache.insert_empty(self.epoch, self.k, self.h, ts, te)
