"""ArrayTEL: the temporal edge list as a structure of arrays (PyTorch port).

Host-side construction is numpy and byte-identical to ``repro.core.graph``
(the JAX package this port is gated against): edges are stored once,
canonically sorted by ``(pair_id, t)``, pairs by ``(u, v)`` with ``u < v``,
and half-pairs by vertex, so every segment reduction on the device sees
sorted segment ids.  Streaming appends (:meth:`TemporalGraph.add_edges`)
are an incremental sorted-run merge that bumps ``epoch``.

:meth:`TemporalGraph.device_tel` ships one epoch's arrays to a torch device as a
:class:`DeviceTEL` of int32 tensors, optionally padded to power-of-two
capacity classes with never-active sentinel rows (``t = int32 min``,
``pair_id = P_cap``, ``hp_src = V_cap``).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

_I32_MIN = np.iinfo(np.int32).min
_I32_MAX = np.iinfo(np.int32).max

# Monotonic graph identity.  ``id(graph)`` is reused after GC, so caches
# keyed on it can silently serve closures built for a dead graph; every
# TemporalGraph instead draws a process-unique uid at construction.
_GRAPH_UID = itertools.count()


class GraphIngestError(ValueError):
    """A malformed edge batch was rejected before touching the TEL.

    The canonical ArrayTEL layout has hard representational invariants —
    vertex ids pack into ``(lo << 32) | hi`` 64-bit pair keys, timestamps
    and ids are stored int32, and the merge-append's composite sort key
    biases timestamps by ``int32 min`` — so NaN, fractional, negative-id
    or out-of-int32 inputs would not fail loudly: they would silently
    corrupt the sort invariant every engine and cache is built on.
    ``from_edges``/``add_edges`` raise this instead.
    """


def _validate_edge_batch(u, v, t, *, strict: bool = False,
                         num_vertices: Optional[int] = None):
    """Validate and canonicalize one (u, v, t) batch to int64 1-D arrays.

    Always rejected (these silently corrupt the TEL otherwise): non-numeric
    or non-finite values, fractional values, negative vertex ids, ids or
    timestamps outside the int32 range (ids must also leave the pair-key
    packing unambiguous), a timestamp equal to the ``int32 min`` sentinel,
    and — when ``num_vertices`` is given — ids >= num_vertices.

    ``strict=True`` additionally rejects self-loops and negative
    timestamps; by default both are legal (self-loops are dropped — they
    never contribute to distinct-neighbour degree — and late/negative
    timestamps are an explicitly supported streaming regime).
    """
    cols = []
    for name, col in (("u", u), ("v", v), ("t", t)):
        a = np.asarray(col)
        if a.dtype == object or not (
                np.issubdtype(a.dtype, np.integer)
                or np.issubdtype(a.dtype, np.floating)
                or np.issubdtype(a.dtype, np.bool_)):
            raise GraphIngestError(
                f"edge batch column {name!r} has non-numeric dtype "
                f"{a.dtype}")
        if np.issubdtype(a.dtype, np.floating):
            if not np.all(np.isfinite(a)):
                raise GraphIngestError(
                    f"edge batch column {name!r} contains NaN/inf")
            if a.size and np.any(a != np.floor(a)):
                raise GraphIngestError(
                    f"edge batch column {name!r} contains fractional "
                    "values")
        cols.append(a.astype(np.int64).ravel())
    u64, v64, t64 = cols
    if not (u64.shape == v64.shape == t64.shape):
        raise GraphIngestError("u, v, t must have identical shapes")
    for name, a in (("u", u64), ("v", v64)):
        if a.size and int(a.min()) < 0:
            raise GraphIngestError(
                f"edge batch column {name!r} contains negative vertex ids")
        if a.size and int(a.max()) > _I32_MAX:
            raise GraphIngestError(
                f"edge batch column {name!r} exceeds the int32 id range")
    if num_vertices is not None and u64.size:
        mx = max(int(u64.max()), int(v64.max()))
        if mx >= int(num_vertices):
            raise GraphIngestError(
                f"vertex id {mx} out of range for num_vertices="
                f"{int(num_vertices)}")
    if t64.size:
        # t == int32 min is the capacity-padding sentinel (outside every
        # representable window); a real edge carrying it would be dropped
        # by the window masks as if it were padding
        if int(t64.min()) <= _I32_MIN or int(t64.max()) > _I32_MAX:
            raise GraphIngestError(
                "edge batch timestamps outside the representable int32 "
                "range (int32 min is reserved as the padding sentinel)")
    if strict:
        if np.any(u64 == v64):
            raise GraphIngestError("edge batch contains self-loops "
                                   "(strict ingest)")
        if t64.size and int(t64.min()) < 0:
            raise GraphIngestError("edge batch contains negative "
                                   "timestamps (strict ingest)")
    return u64, v64, t64


def pow2_capacity(n: int, floor: int = 128) -> int:
    """Smallest power of two >= max(n, floor) — the capacity classes used
    for padded device buffers (and the window-TEL edge buckets)."""
    return max(floor, 1 << max(0, int(n) - 1).bit_length())


def _merge_sorted_unique(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Union of two sorted-unique int arrays in O(|a| + |b| log |a|)."""
    if b.size == 0:
        return a
    if a.size == 0:
        return b
    pos_a = np.searchsorted(a, b)
    present = (pos_a < a.size) & (a[np.minimum(pos_a, a.size - 1)] == b)
    fresh = b[~present]
    merged = np.empty(a.size + fresh.size, dtype=a.dtype)
    pos = np.searchsorted(a, fresh) + np.arange(fresh.size)
    mask = np.ones(merged.size, dtype=bool)
    mask[pos] = False
    merged[pos] = fresh
    merged[mask] = a
    return merged


class DeviceTEL(NamedTuple):
    """Device-resident temporal edge list: int32 torch tensors, bit-identical
    to :meth:`TemporalGraph.tel_arrays`.

    Shapes: E edges, P distinct vertex pairs ("links"), V vertices.
    Edges are sorted by (pair_id, t); pairs are sorted by (u, v) with u < v;
    half-pairs (2P incidences) are sorted by their vertex id.

    Arrays may be *capacity padded* (see :meth:`TemporalGraph.tel_arrays`):
    sentinel edges carry ``t = int32 min`` (outside every representable
    window) and ``pair_id`` equal to the padded pair count, sentinel
    half-pairs point at the padded vertex count — both are dropped by the
    segment reductions, so padded and exact TELs peel identically while
    the padded shapes keep kernel shapes stable across epochs.
    """

    src: torch.Tensor        # [E] int32
    dst: torch.Tensor        # [E] int32
    t: torch.Tensor          # [E] int32 timestamps
    pair_id: torch.Tensor    # [E] int32, sorted ascending
    pair_u: torch.Tensor     # [P] int32 (u < v)
    pair_v: torch.Tensor     # [P] int32
    hp_src: torch.Tensor     # [2P] int32, sorted ascending (vertex of incidence)
    hp_pair: torch.Tensor    # [2P] int32 (pair of incidence)

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def num_pairs(self) -> int:
        return int(self.pair_u.shape[0])


@dataclasses.dataclass(frozen=True)
class TemporalGraph:
    """Host-side temporal multigraph in canonical ArrayTEL layout.

    Immutable: :meth:`add_edges` returns a *new* graph with ``epoch`` + 1,
    so every epoch is a zero-copy-consistent snapshot — in-flight queries
    pinned to an older epoch keep peeling their snapshot's arrays while
    new arrivals land (the streaming service's snapshot-consistency
    contract rests on exactly this).
    """

    src: np.ndarray          # [E] int32, canonical order (pair_id, t)
    dst: np.ndarray          # [E] int32
    t: np.ndarray            # [E] int32
    pair_id: np.ndarray      # [E] int32 ascending
    pair_u: np.ndarray       # [P] int32
    pair_v: np.ndarray       # [P] int32
    num_vertices: int
    unique_ts: np.ndarray    # sorted unique timestamps
    epoch: int = 0           # bumped by every add_edges batch
    # process-unique identity (never reused, unlike id()); compare=False
    # keeps two structurally equal graphs equal
    uid: int = dataclasses.field(
        default_factory=lambda: next(_GRAPH_UID), compare=False)
    # lineage of the last append: the uid of the graph this one was grown
    # from and the [t_min, t_max] span of the appended batch — what lets
    # the core-result cache invalidate only entries the batch can affect
    parent_uid: Optional[int] = dataclasses.field(default=None, compare=False)
    appended_span: Optional[Tuple[int, int]] = dataclasses.field(
        default=None, compare=False)

    # ------------------------------------------------------------------ build
    @staticmethod
    def from_edges(u, v, t, num_vertices: Optional[int] = None, *,
                   strict: bool = False) -> "TemporalGraph":
        """Build from parallel arrays of (u, v, t) temporal edges.

        Self loops are dropped (they never contribute to distinct-neighbour
        degree).  Endpoints are normalized to u < v for pair identity — the
        graph is undirected, matching the paper's data model.

        Malformed batches raise :class:`GraphIngestError` instead of
        silently corrupting the TEL sort invariant: NaN/fractional values,
        negative or out-of-int32 vertex ids, ids >= an explicit
        ``num_vertices``, and timestamps outside int32 are always
        rejected; ``strict=True`` additionally rejects self-loops and
        negative timestamps.
        """
        u, v, t = _validate_edge_batch(u, v, t, strict=strict,
                                       num_vertices=num_vertices)
        keep = u != v
        u, v, t = u[keep], v[keep], t[keep]
        lo = np.minimum(u, v)
        hi = np.maximum(u, v)
        if num_vertices is None:
            num_vertices = int(hi.max()) + 1 if hi.size else 0
        if lo.size:
            # factorize pairs: one sort of the (lo, hi) keys gives the pair
            # ids, then one sort of (pair_id, t) packed in 64 bits (t less
            # int32 min fits 32) the canonical order; equal keys are equal
            # edges, so the sort need not be stable
            width = int(hi.max()) + 1
            keys, pair_id = np.unique(lo * width + hi, return_inverse=True)
            order = np.sort((pair_id << 32) | (t - _I32_MIN))
            pair_id = order >> 32
            t = (order & 0xFFFFFFFF) + _I32_MIN
            pair_u, pair_v = keys // width, keys % width
            lo, hi = pair_u[pair_id], pair_v[pair_id]
        else:
            pair_id = np.zeros(0, dtype=np.int64)
            pair_u = np.zeros(0, dtype=np.int64)
            pair_v = np.zeros(0, dtype=np.int64)
        return TemporalGraph(
            src=lo.astype(np.int32),
            dst=hi.astype(np.int32),
            t=t.astype(np.int32),
            pair_id=pair_id.astype(np.int32),
            pair_u=pair_u.astype(np.int32),
            pair_v=pair_v.astype(np.int32),
            num_vertices=int(num_vertices),
            unique_ts=np.unique(t).astype(np.int32),
        )

    @staticmethod
    def from_edge_list(edges, num_vertices: Optional[int] = None) -> "TemporalGraph":
        """Build from an iterable of (u, v, t) triples."""
        arr = np.asarray(list(edges), dtype=np.int64)
        if arr.size == 0:
            arr = arr.reshape(0, 3)
        return TemporalGraph.from_edges(arr[:, 0], arr[:, 1], arr[:, 2], num_vertices)

    # --------------------------------------------------------------- dynamic
    def add_edges(self, u, v, t, *, strict: bool = False) -> "TemporalGraph":
        """Dynamic-graph extension (paper §6.1): incremental merge-append.

        The paper appends one edge in O(1) by pointer surgery; the array
        equivalent is a *sorted-run merge*: the existing canonical arrays are
        already sorted by (pair_id, t), so a batch of B new edges only needs
        its own O(B log B) sort plus an O(E + B log E) two-run merge — never
        a full O(E log E) re-sort.  The result is bit-identical to a
        from-scratch :meth:`from_edges` rebuild (same canonical arrays, same
        pair factorization), with ``epoch`` bumped by one.  Timestamps may
        be arbitrary (late data is allowed — stricter than the paper, which
        assumes monotone arrival), and new vertices/pairs may appear.

        Malformed batches raise :class:`GraphIngestError` (see
        :meth:`from_edges`); ``strict=True`` additionally rejects
        self-loops and negative timestamps.
        """
        u, v, t = _validate_edge_batch(u, v, t, strict=strict)
        keep = u != v                       # self loops never contribute
        u, v, t = u[keep], v[keep], t[keep]
        if u.size == 0:
            return self
        lo = np.minimum(u, v)
        hi = np.maximum(u, v)
        n_vert = max(self.num_vertices, int(hi.max()) + 1)
        # canonicalize the batch: O(B log B), the only sort in the append
        order = np.lexsort((t, hi, lo))
        lo, hi, t = lo[order], hi[order], t[order]

        # --- merge the pair tables (64-bit (u, v) keys, both runs sorted)
        old_keys = (self.pair_u.astype(np.int64) << 32) | \
            self.pair_v.astype(np.int64)
        batch_keys = (lo << 32) | hi
        batch_pairs = np.unique(batch_keys)         # sorted-input unique: O(B)
        merged_keys = _merge_sorted_unique(old_keys, batch_pairs)
        # old pair id -> merged pair id is strictly increasing, so the old
        # edges stay sorted under the relabel
        old_pid_map = np.searchsorted(merged_keys, old_keys).astype(np.int64)
        pid_old = old_pid_map[self.pair_id.astype(np.int64)]
        pid_batch = np.searchsorted(merged_keys, batch_keys).astype(np.int64)

        # --- merge the edge runs on the composite (pair_id, t) key
        t_old = self.t.astype(np.int64)
        ckey_old = (pid_old << 32) | (t_old - _I32_MIN)
        ckey_batch = (pid_batch << 32) | (t - _I32_MIN)
        pos_b = np.searchsorted(ckey_old, ckey_batch, side="right") + \
            np.arange(ckey_batch.size)
        n_all = self.num_edges + lo.size
        is_new = np.zeros(n_all, dtype=bool)
        is_new[pos_b] = True

        def _interleave(old_col, new_col, dtype=np.int32):
            out = np.empty(n_all, dtype=dtype)
            out[pos_b] = new_col
            out[~is_new] = old_col
            return out

        return TemporalGraph(
            src=_interleave(self.src, lo),
            dst=_interleave(self.dst, hi),
            t=_interleave(self.t, t),
            pair_id=_interleave(pid_old, pid_batch),
            pair_u=(merged_keys >> 32).astype(np.int32),
            pair_v=(merged_keys & 0xFFFFFFFF).astype(np.int32),
            num_vertices=int(n_vert),
            unique_ts=_merge_sorted_unique(
                self.unique_ts, np.unique(t).astype(np.int32)),
            epoch=self.epoch + 1,
            parent_uid=self.uid,
            appended_span=(int(t.min()), int(t.max())),
        )

    # ----------------------------------------------------------------- views
    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def num_pairs(self) -> int:
        return int(self.pair_u.shape[0])

    @property
    def span(self):
        if self.t.size == 0:
            return (0, 0)
        return (int(self.t.min()), int(self.t.max()))

    def window_counts(self, ts: int, te: int):
        """(#edges, #unique timestamps) inside [ts, te] — host-side metadata."""
        m = (self.t >= ts) & (self.t <= te)
        return int(m.sum()), int(np.unique(self.t[m]).size)

    def tel_arrays(self, *, edge_capacity: Optional[int] = None,
                   pair_capacity: Optional[int] = None,
                   vertex_capacity: Optional[int] = None
                   ) -> Dict[str, np.ndarray]:
        """Host-side TEL arrays, optionally padded to capacity classes.

        Half-pair incidence is derived here (sorted by vertex) so the
        degree reduction also sees sorted segment ids.  With capacities,
        sentinel rows pad each array family: sentinel edges carry
        ``t = int32 min`` (outside every window) and ``pair_id`` equal to
        the padded pair count; sentinel half-pairs carry ``hp_src`` equal
        to ``vertex_capacity`` — out-of-range segment ids that the
        segment reductions drop.  Device buffers therefore depend only on
        the *capacity* shapes, not the live counts, so a streaming engine
        absorbs appends without reallocating them.
        """
        e, p = self.num_edges, self.num_pairs
        e_cap = e if edge_capacity is None else int(edge_capacity)
        p_cap = p if pair_capacity is None else int(pair_capacity)
        v_cap = (self.num_vertices if vertex_capacity is None
                 else int(vertex_capacity))
        if e_cap < e or p_cap < p or v_cap < self.num_vertices:
            raise ValueError("capacity below live count")

        def pad(a, n, fill, dtype=np.int32):
            if n == a.shape[0]:
                return a.astype(dtype, copy=False)
            out = np.full(n, fill, dtype=dtype)
            out[:a.shape[0]] = a
            return out

        hp_src = np.concatenate([self.pair_u, self.pair_v])
        hp_pair = np.concatenate(
            [np.arange(p, dtype=np.int32), np.arange(p, dtype=np.int32)])
        order = np.argsort(hp_src, kind="stable")
        return {
            "src": pad(self.src, e_cap, 0),
            "dst": pad(self.dst, e_cap, 0),
            "t": pad(self.t, e_cap, _I32_MIN),
            "pair_id": pad(self.pair_id, e_cap, p_cap),
            "pair_u": pad(self.pair_u, p_cap, 0),
            "pair_v": pad(self.pair_v, p_cap, 0),
            "hp_src": pad(hp_src[order].astype(np.int32), 2 * p_cap, v_cap),
            "hp_pair": pad(hp_pair[order].astype(np.int32), 2 * p_cap, 0),
        }

    def device_tel(self, *, edge_capacity: Optional[int] = None,
                   pair_capacity: Optional[int] = None,
                   vertex_capacity: Optional[int] = None,
                   device="cuda") -> DeviceTEL:
        """Ship to ``device`` as int32 tensors, optionally padded to
        capacity classes (see :meth:`tel_arrays`); the tensors equal
        ``tel_arrays(...)`` bit for bit.  Default (no capacities) is the
        exact TEL."""
        arrs = self.tel_arrays(edge_capacity=edge_capacity,
                               pair_capacity=pair_capacity,
                               vertex_capacity=vertex_capacity)
        return DeviceTEL(**{k: torch.from_numpy(arrs[k]).to(device)
                            for k in DeviceTEL._fields})

    def memory_bytes(self) -> int:
        """ArrayTEL footprint (paper Table 5 analogue): the bytes of the
        exact :meth:`device_tel`."""
        per_edge = 4 * 4  # src, dst, t, pair_id
        per_pair = 4 * 2 + 4 * 2 * 2  # pair_u/v + half pairs (src,pair)x2
        return self.num_edges * per_edge + self.num_pairs * per_pair

    def fingerprint(self) -> int:
        """CRC32 over the canonical arrays + counts — a cheap structural
        identity for lineage-checked WAL replay.  Two graphs with equal
        fingerprints have byte-identical canonical TELs (same edges, same
        pair factorization, same epoch), so a replayed ``add_edges`` can
        be verified against the fingerprint its journal record promised.
        ``uid``/``parent_uid`` are process-local and deliberately
        excluded: lineage across restarts is exactly what the
        fingerprint replaces.
        """
        import zlib

        c = zlib.crc32(
            np.int64([self.num_vertices, self.epoch, self.num_edges,
                      self.num_pairs]).tobytes())
        for name in self._STATE_ARRAYS:
            a = np.ascontiguousarray(getattr(self, name))
            a = a.astype(a.dtype.newbyteorder("<"), copy=False)
            c = zlib.crc32(a.tobytes(), c)
        return c

    # ----------------------------------------------------------- persistence
    _STATE_ARRAYS = ("src", "dst", "t", "pair_id", "pair_u", "pair_v",
                     "unique_ts")

    def state_dict(self) -> Dict[str, np.ndarray]:
        """Serializable snapshot: the canonical arrays plus scalars as 0-d
        arrays — a flat str->ndarray mapping ``np.savez`` accepts directly.
        Round-trips exactly through :meth:`from_state` (the crash-recovery
        gate: a restored graph is bit-identical, epoch included)."""
        d = {name: np.asarray(getattr(self, name))
             for name in self._STATE_ARRAYS}
        d["num_vertices"] = np.int64(self.num_vertices)
        d["epoch"] = np.int64(self.epoch)
        return d

    @staticmethod
    def from_state(state) -> "TemporalGraph":
        """Inverse of :meth:`state_dict` (accepts an ``np.load`` mapping or
        the reference package's ``TemporalGraph.state_dict()``): the
        canonical arrays come back byte-identical, epoch included."""
        return TemporalGraph(
            src=np.asarray(state["src"], np.int32),
            dst=np.asarray(state["dst"], np.int32),
            t=np.asarray(state["t"], np.int32),
            pair_id=np.asarray(state["pair_id"], np.int32),
            pair_u=np.asarray(state["pair_u"], np.int32),
            pair_v=np.asarray(state["pair_v"], np.int32),
            num_vertices=int(state["num_vertices"]),
            unique_ts=np.asarray(state["unique_ts"], np.int32),
            epoch=int(state["epoch"]),
        )

