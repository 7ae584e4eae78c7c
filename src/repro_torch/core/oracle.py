"""Brute-force oracle: per-subinterval temporal k-core from scratch (numpy).

This is the O(span^2 * |E|) strawman the paper argues against — kept as the
ground truth for every correctness test.  Results are keyed by the *edge set*
(true subgraph identity), which independently validates Property 2
(TTI equality <=> subgraph identity) against the engine's TTI-keyed dedup.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, Tuple

import numpy as np

from repro_torch.core.graph import TemporalGraph


def peel_window(graph: TemporalGraph, ts: int, te: int, k: int,
                h: int = 1) -> np.ndarray:
    """Boolean edge mask of T^k_[ts,te] (empty mask if no core)."""
    win = (graph.t >= ts) & (graph.t <= te)
    alive = np.ones(graph.num_vertices, dtype=bool)
    p = graph.num_pairs
    while True:
        ea = win & alive[graph.src] & alive[graph.dst]
        paircnt = np.bincount(graph.pair_id[ea], minlength=p)
        pairact = paircnt >= h
        deg = (np.bincount(graph.pair_u[pairact], minlength=graph.num_vertices)
               + np.bincount(graph.pair_v[pairact], minlength=graph.num_vertices))
        new = alive & (deg >= k)
        if np.array_equal(new, alive):
            break
        alive = new
    return win & alive[graph.src] & alive[graph.dst]


def brute_force_query(graph: TemporalGraph, k: int, Ts: int, Te: int,
                      h: int = 1) -> Dict[Tuple[int, int], dict]:
    """All distinct temporal k-cores of subintervals of [Ts, Te].

    Returns {tti: {"vertices": frozenset, "n_edges": int, "edges": frozenset}}.
    Raises if two different subgraphs ever map to one TTI (would falsify
    Property 2 — it never happens; the check keeps the oracle honest).
    """
    uts = graph.unique_ts
    uts = uts[(uts >= Ts) & (uts <= Te)]
    out: Dict[Tuple[int, int], dict] = {}
    seen_edges: Dict[FrozenSet[int], Tuple[int, int]] = {}
    for i in range(uts.size):
        for j in range(i, uts.size):
            em = peel_window(graph, int(uts[i]), int(uts[j]), k, h)
            if not em.any():
                continue
            tti = (int(graph.t[em].min()), int(graph.t[em].max()))
            edges = frozenset(np.flatnonzero(em).tolist())
            verts = frozenset(np.unique(
                np.concatenate([graph.src[em], graph.dst[em]])).tolist())
            if tti in out:
                if out[tti]["edges"] != edges:
                    raise AssertionError(
                        f"Property 2 violated at tti={tti}")  # pragma: no cover
            else:
                out[tti] = {"vertices": verts, "n_edges": int(em.sum()),
                            "edges": edges}
            if edges in seen_edges and seen_edges[edges] != tti:
                raise AssertionError("one subgraph, two TTIs")  # pragma: no cover
            seen_edges[edges] = tti
    return out
