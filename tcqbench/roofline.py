"""The yardstick of the wave step: the bytes one device step needs, and the
H100's peak rate (NVIDIA's data sheet, SXM part, at its 700 W limit).

A device step peels ``lanes`` schedule cells of a batch's windows to their
fixpoints.  Whatever implements it (wave_peel, or the composite over
segdeg), and however the program lays out its tables, it needs at least:
the edges whose time lies in one of the batch's windows (``src``, ``dst``,
``t`` and a pair index: 16 B an edge) and the distinct pairs they join
(both ends and a half-pair incidence each way: 24 B a pair) read once;
each occupied lane's alive mask over the vertices those edges touch read
and written once (1 B a vertex each way); and the step's outputs written
once: each lane's packed mask (4 B per 32 of those vertices) and its TTI
ends and edge count (12 B).  The sizes come from the benchmark's own edge
arrays (``window_sizes``), so they depend on the windows and the lanes,
never on the program's layout or on how many fixpoint rounds a step runs.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12


def step_bytes(window_edges: int, num_pairs: int, num_vertices: int,
               lanes: float) -> float:
    """Bytes of one device step over ``lanes`` occupied lanes (a mean may
    be fractional)."""
    tel = 16 * window_edges + 24 * num_pairs
    lane = 2 * num_vertices + 4 * -(-num_vertices // 32) + 12
    return tel + lanes * lane


class WindowSizes:
    """Edges, pairs and vertices of the union of a set of windows, from raw
    ``(u, v, t)`` arrays (self-loops dropped, as the graph drops them)."""

    def __init__(self, u, v, t):
        keep = np.asarray(u) != np.asarray(v)
        lo = np.minimum(u, v)[keep].astype(np.int64)
        hi = np.maximum(u, v)[keep].astype(np.int64)
        tk = np.asarray(t)[keep]
        order = np.argsort(tk, kind="stable")
        self.t = tk[order]
        self.lo, self.hi = lo[order], hi[order]
        self.width = int(hi.max()) + 1 if hi.size else 1

    def __call__(self, windows) -> tuple:
        """``(edges, pairs, vertices)`` of the windows ``[(ts, te), ...]``,
        each end inclusive."""
        spans = []
        for ts, te in sorted(windows):
            if spans and ts <= spans[-1][1] + 1:
                spans[-1][1] = max(spans[-1][1], te)
            else:
                spans.append([ts, te])
        parts = [np.arange(np.searchsorted(self.t, a, "left"),
                           np.searchsorted(self.t, b, "right"))
                 for a, b in spans]
        idx = np.concatenate(parts) if parts else np.zeros(0, np.int64)
        lo, hi = self.lo[idx], self.hi[idx]
        pairs = np.unique(lo * self.width + hi).size
        verts = np.unique(np.concatenate([lo, hi])).size
        return int(idx.size), int(pairs), int(verts)


def batch_bytes(batches, edges) -> float:
    """Bytes of every device step of the window's batches (records with
    ``device_steps``, ``occupancy`` and ``windows``), over the raw edge
    arrays ``edges``."""
    sizes = WindowSizes(*edges)
    total = 0.0
    for b in batches:
        e, p, nv = sizes(b["windows"])
        total += b["device_steps"] * step_bytes(e, p, nv, b["occupancy"])
    return total
