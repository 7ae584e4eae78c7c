"""Temporal Core Decomposition (TCD) — the paper's §3, serial path (PyTorch).

Frontier peeling: one fixpoint iteration removes **all** vertices with
fewer than k distinct alive neighbours at once, and the loop runs to the
fixpoint.  Correctness is the classical k-core invariance to peel order,
plus the paper's Theorem 1: peeling may warm-start from any sandwiched
supergraph.

Degree semantics are the paper's: the number of distinct neighbour
*vertices*, realized as a two-level segment reduction edges -> pairs ->
vertices; a pair counts only with >= h alive parallel edges (the
link-strength extension, §6.2).  The JAX package computes these sums with
XLA's ``segment_sum`` outside any Pallas kernel, so this path is plain
torch (``index_add_``) on every device.  ``lax.while_loop`` becomes a
Python loop with one host read per iteration.

``degree_fn`` replaces those semantics: any
``degree_fn(tel, ea, h, *, num_vertices) -> [V] int32`` over the torch
``DeviceTEL`` and the [E] bool edge activity, run on the TEL's device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.graph import DeviceTEL
from repro_torch.core.wave import tti_and_count


class TCDResult(NamedTuple):
    alive: torch.Tensor    # [V] bool — vertices of T^k_[ts,te]
    tti_lo: torch.Tensor   # 0-d int32 (I32_MAX when core is empty)
    tti_hi: torch.Tensor   # 0-d int32 (I32_MIN when core is empty)
    n_edges: torch.Tensor  # 0-d int32
    n_verts: torch.Tensor  # 0-d int32
    peel_iters: int = 0    # fixpoint iterations (one host read each)


def edge_activity(tel: DeviceTEL, alive: torch.Tensor, ts, te
                  ) -> torch.Tensor:
    """[E] bool: edge is inside the window and both endpoints are alive."""
    win = (tel.t >= ts) & (tel.t <= te)
    return win & alive[tel.src] & alive[tel.dst]


def _segment_sum(values: torch.Tensor, seg_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """Integer segment sum that drops ids >= num_segments (they land in
    one extra trash segment)."""
    out = torch.zeros(num_segments + 1, dtype=values.dtype,
                      device=values.device)
    out.index_add_(0, seg_ids.clamp(max=num_segments), values)
    return out[:num_segments]


def degrees(tel: DeviceTEL, ea: torch.Tensor, h, *,
            num_vertices: int) -> torch.Tensor:
    """[V] int32 distinct-neighbour degrees from edge activity."""
    paircnt = _segment_sum(ea.to(torch.int32), tel.pair_id, tel.num_pairs)
    pairact = (paircnt >= h).to(torch.int32)
    return _segment_sum(pairact[tel.hp_pair], tel.hp_src, num_vertices)


def tcd(tel: DeviceTEL, alive: torch.Tensor, ts, te, k, h,
        *, num_vertices: int, degree_fn=None) -> TCDResult:
    """One TCD operation: truncate to [ts, te], peel to the k-core fixpoint.

    ``alive`` may be any superset core's vertex mask (Theorem 1) — all-ones
    for a cold start; it is not modified.
    """
    dfn = degree_fn or degrees
    win = (tel.t >= ts) & (tel.t <= te)
    cur = alive
    iters = 0
    # edge activity rides along: the final iteration observes new == cur,
    # so the ea it computed is exactly ea(fixpoint)
    while True:
        ea = win & cur[tel.src] & cur[tel.dst]
        new = cur & (dfn(tel, ea, h, num_vertices=num_vertices) >= k)
        changed = bool((new != cur).any())
        iters += 1
        cur = new
        if not changed:
            break
    tti_lo, tti_hi, n_edges = tti_and_count(ea, tel.t)
    n_verts = cur.sum(dtype=torch.int32)
    return TCDResult(cur, tti_lo, tti_hi, n_edges, n_verts, iters)


def tcd_batch(tel: DeviceTEL, alive: torch.Tensor, ts, te, k, h,
              *, num_vertices: int, degree_fn=None) -> TCDResult:
    """Q independent cells (alive: [Q, V]; ts/te: [Q]), each peeled by
    :func:`tcd`; tensor fields are stacked along a leading lane axis and
    ``peel_iters`` sums the lanes'."""
    res = [tcd(tel, alive[q], int(ts[q]), int(te[q]), k, h,
               num_vertices=num_vertices, degree_fn=degree_fn)
           for q in range(alive.shape[0])]
    *fields, iters = zip(*res)
    return TCDResult(*(torch.stack(f) for f in fields), sum(iters))


def coreness(tel: DeviceTEL, ts, te, *, num_vertices: int,
             k_max: int = 64) -> torch.Tensor:
    """Per-vertex coreness over a window: core decomposition by successive
    warm-started ``tcd`` runs for k = 1..k_max."""
    alive = torch.ones(num_vertices, dtype=torch.bool, device=tel.t.device)
    core = torch.zeros(num_vertices, dtype=torch.int32, device=tel.t.device)
    for k in range(1, k_max + 1):
        alive = tcd(tel, alive, ts, te, k, 1,
                    num_vertices=num_vertices).alive
        core = torch.where(alive, k, core)
    return core
