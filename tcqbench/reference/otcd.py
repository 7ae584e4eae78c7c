"""Plain serial OTCD: every distinct temporal k-core of a time range, as the
paper defines it (TCD with TTI pruning), in plain PyTorch.

It builds its own edge list from the raw ``(u, v, t)`` arrays, runs on any
device, and imports nothing of the program under test.

Definitions.  The k-core of a window ``[ts, te]`` is the largest vertex set
in which every vertex has at least ``k`` distinct neighbours over pairs
with at least ``h`` edges inside the window among the set.  Its edges are
the window's edges between two of its vertices; its TTI is the least and
the greatest timestamp of those edges.  A TCQ ``(k, h, Ts, Te)`` returns
the distinct cores of every window ``[ts, te]`` whose ends are timestamps
of the range, one per TTI.

Over the range's unique timestamps ``u_0 < ... < u_{n-1}``, cell ``(i, j)``
is the core of ``[u_i, u_j]``.  If cell ``(i, j)`` has TTI ``[u_a, u_b]``:
cells ``(i, c)``, ``b <= c <= j`` hold the same core (rule PoR); so do
cells ``(r, c)``, ``i < r <= a``, ``b <= c <= j`` (PoU); and cells
``(r, c)``, ``a < r <= b``, ``b < c <= j`` hold the core of cell
``(r, b)`` (PoL).  An empty cell ``(i, j)`` makes every cell ``(r, c)``,
``r >= i``, ``c <= j`` empty.  A row peels its cells from the right,
each warm-started from the one before (a window's core holds the core of
every window inside it).
"""

from __future__ import annotations

import bisect
from typing import Dict, Tuple

import numpy as np
import torch

Core = Tuple[np.ndarray, int]           # (sorted vertex ids, edge count)


class EdgeList:
    """Edges of one graph snapshot sorted by time: ``lo < hi`` endpoints and
    timestamps, on ``device``.  Self-loops are dropped."""

    def __init__(self, u, v, t, device="cpu"):
        u, v, t = (np.asarray(a, np.int64) for a in (u, v, t))
        keep = u != v
        u, v, t = u[keep], v[keep], t[keep]
        order = np.argsort(t, kind="stable")
        self.t_host = t[order]
        dev = torch.device(device)
        self.lo = torch.from_numpy(np.minimum(u, v)[order]).to(dev)
        self.hi = torch.from_numpy(np.maximum(u, v)[order]).to(dev)
        self.t = torch.from_numpy(self.t_host).to(dev)
        self.device = dev


class _Cover:
    """Covered columns of one row: sorted, disjoint closed intervals."""

    def __init__(self):
        self.lo: list = []
        self.hi: list = []

    def add(self, lo: int, hi: int) -> None:
        i = bisect.bisect_left(self.hi, lo - 1)
        j = i
        while j < len(self.lo) and self.lo[j] <= hi + 1:
            lo, hi = min(lo, self.lo[j]), max(hi, self.hi[j])
            j += 1
        self.lo[i:j] = [lo]
        self.hi[i:j] = [hi]

    def free_at_or_below(self, j: int) -> int:
        i = bisect.bisect_left(self.hi, j)
        if i < len(self.lo) and self.lo[i] <= j:
            return self.lo[i] - 1
        return j


class _Window:
    """One query's edges, with vertices and pairs numbered locally."""

    def __init__(self, edges: EdgeList, ts: int, te: int):
        a = int(np.searchsorted(edges.t_host, ts, side="left"))
        b = int(np.searchsorted(edges.t_host, te, side="right"))
        t_host = edges.t_host[a:b]
        self.uts = np.unique(t_host)
        # edges of cell columns: [first[i], last[j]) covers [uts[i], uts[j]]
        self.first = np.searchsorted(t_host, self.uts, side="left")
        self.last = np.searchsorted(t_host, self.uts, side="right")
        lo, hi = edges.lo[a:b], edges.hi[a:b]
        self.t = edges.t[a:b]
        self.verts, inv = torch.unique(torch.cat([lo, hi]),
                                       return_inverse=True)
        n = lo.shape[0]
        self.eu, self.ev = inv[:n], inv[n:]
        nv = int(self.verts.shape[0])
        keys, self.pid = torch.unique(self.eu * nv + self.ev,
                                      return_inverse=True)
        self.pu, self.pv = keys // nv, keys % nv
        self.nv, self.np_ = nv, int(keys.shape[0])

    def peel(self, i: int, j: int, alive: torch.Tensor, k: int, h: int,
             max_iters: int = 0):
        """Core of cell ``(i, j)`` from the superset ``alive`` -> (alive,
        edge mask of its edges inside ``[first[i], last[j])``, offset)."""
        a, b = int(self.first[i]), int(self.last[j])
        eu, ev, pid = self.eu[a:b], self.ev[a:b], self.pid[a:b]
        dev = alive.device
        iters = 0
        while True:
            ea = alive[eu] & alive[ev]
            cnt = torch.zeros(self.np_, dtype=torch.int32, device=dev)
            cnt.index_add_(0, pid, ea.to(torch.int32))
            act = (cnt >= h).to(torch.int32)
            deg = torch.zeros(self.nv, dtype=torch.int32, device=dev)
            deg.index_add_(0, self.pu, act)
            deg.index_add_(0, self.pv, act)
            new = alive & (deg >= k)
            iters += 1
            if torch.equal(new, alive) or (max_iters and iters >= max_iters):
                alive = new
                break
            alive = new
        ea = alive[eu] & alive[ev]
        return alive, ea, a


def otcd(edges: EdgeList, k: int, ts: int, te: int, h: int = 1,
         max_iters: int = 0) -> Dict[Tuple[int, int], Core]:
    """Distinct cores of the TCQ ``(k, h, [ts, te])``: {TTI: (vertices,
    edges)}.  ``max_iters`` > 0 stops each peel after that many rounds,
    short of the fixpoint: the benchmark's control, never a reference."""
    w = _Window(edges, int(ts), int(te))
    n = int(w.uts.size)
    out: Dict[Tuple[int, int], Core] = {}
    if n == 0:
        return out
    col_of = {int(x): c for c, x in enumerate(w.uts)}
    covers: Dict[int, _Cover] = {}
    empty_to = -1           # cells (r >= this row, c <= empty_to) are empty
    ones = torch.ones(w.nv, dtype=torch.bool, device=edges.device)
    for i in range(n):
        cover = covers.pop(i, None)
        alive = ones
        j = n - 1
        while j >= i:
            if cover is not None:
                j = cover.free_at_or_below(j)
            if j < i or j <= empty_to:
                break
            alive, ea, off = w.peel(i, j, alive, k, h, max_iters)
            idx = torch.nonzero(ea).flatten()
            if idx.numel() == 0:
                empty_to = j
                if j == n - 1:
                    return out
                break
            tt = w.t[off + idx]
            lo, hi = int(tt.min()), int(tt.max())
            a, b = col_of[lo], col_of[hi]
            if (lo, hi) not in out:
                verts = w.verts[alive].cpu().numpy()
                out[(lo, hi)] = (verts, int(idx.numel()))
            for r in range(i + 1, a + 1):                       # PoU
                covers.setdefault(r, _Cover()).add(b, j)
            if b < j:
                for r in range(a + 1, b + 1):                   # PoL
                    covers.setdefault(r, _Cover()).add(b + 1, j)
            j = b - 1                                           # PoR
    return out
