"""Temporal graph generators.

The paper evaluates on KONECT/SNAP datasets (Youtube, DBLP, Flickr,
CollegeMsg, email-Eu-core, sx-mathoverflow, sx-stackoverflow).  Those are not
redistributable inside this offline container, so benchmarks use generators
matched to their published shape statistics (|V|, |E|, time span, burstiness);
`load_snap_edges` ingests the real files when present.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.graph import TemporalGraph


def erdos_temporal(num_vertices: int, num_edges: int, time_span: int,
                   seed: int = 0) -> TemporalGraph:
    """Uniform random endpoints and timestamps — the adversarial case for
    pruning (few repeated cores)."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, num_vertices, num_edges)
    v = rng.integers(0, num_vertices, num_edges)
    t = rng.integers(1, time_span + 1, num_edges)
    return TemporalGraph.from_edges(u, v, t, num_vertices)


def powerlaw_temporal(num_vertices: int, num_edges: int, time_span: int,
                      alpha: float = 1.5, burst_periods: int = 6,
                      burst_frac: float = 0.5, seed: int = 0) -> TemporalGraph:
    """Skewed degrees + bursty timestamps — the social-network-like regime
    the paper's datasets live in (communities emerge in bursts)."""
    rng = np.random.default_rng(seed)
    # zipf-ish vertex popularity
    w = (np.arange(1, num_vertices + 1, dtype=np.float64)) ** (-alpha)
    w /= w.sum()
    u = rng.choice(num_vertices, size=num_edges, p=w)
    v = rng.choice(num_vertices, size=num_edges, p=w)
    # timestamps: uniform background + bursts
    n_burst = int(num_edges * burst_frac)
    t_bg = rng.integers(1, time_span + 1, num_edges - n_burst)
    centers = rng.integers(1, time_span + 1, burst_periods)
    which = rng.integers(0, burst_periods, n_burst)
    width = max(1, time_span // (burst_periods * 8))
    t_b = centers[which] + rng.integers(-width, width + 1, n_burst)
    t = np.clip(np.concatenate([t_bg, t_b]), 1, time_span)
    return TemporalGraph.from_edges(u, v, t, num_vertices)


def planted_cores(num_vertices: int = 64, k: int = 3, n_cliques: int = 4,
                  clique_size: int = 6, time_span: int = 40,
                  noise_edges: int = 120, seed: int = 0) -> TemporalGraph:
    """Graphs with known dense pockets at known times — sharp test cases for
    TTI pruning (many identical cores across subintervals)."""
    rng = np.random.default_rng(seed)
    us, vs, ts = [], [], []
    for c in range(n_cliques):
        verts = rng.choice(num_vertices, clique_size, replace=False)
        t0 = rng.integers(1, max(2, time_span - 4))
        for i in range(clique_size):
            for j in range(i + 1, clique_size):
                us.append(verts[i]); vs.append(verts[j])
                ts.append(int(t0 + rng.integers(0, 4)))
    u = rng.integers(0, num_vertices, noise_edges)
    v = rng.integers(0, num_vertices, noise_edges)
    t = rng.integers(1, time_span + 1, noise_edges)
    us = np.concatenate([np.array(us, dtype=np.int64), u])
    vs = np.concatenate([np.array(vs, dtype=np.int64), v])
    ts = np.concatenate([np.array(ts, dtype=np.int64), t])
    return TemporalGraph.from_edges(us, vs, ts, num_vertices)


def paper_style_example() -> TemporalGraph:
    """A small hand-built graph in the spirit of the paper's Figure 1:
    9 vertices, timestamps 1..8, two small bursty 2-cores that later merge
    into a larger one.  (The exact Figure 1 edge list is not recoverable from
    the text; tests validate against the brute-force oracle, and
    examples/quickstart.py walks this graph.)"""
    edges = [
        # an early triangle core around t=2..3 (v1,v2,v3)
        (1, 2, 2), (2, 3, 2), (1, 3, 3), (1, 2, 3),
        # a second burst at t=5..6 (v5,v6,v7) + bridge via v5
        (5, 6, 5), (6, 7, 5), (5, 7, 6), (5, 6, 6),
        # the merge: v3-v5, v4 joins everyone around t=6..8
        (3, 5, 6), (3, 4, 7), (4, 5, 7), (3, 4, 8), (4, 5, 8), (3, 5, 8),
        # background noise
        (0, 8, 1), (0, 1, 4), (7, 8, 4), (2, 6, 1), (1, 6, 8),
    ]
    return TemporalGraph.from_edge_list(edges, num_vertices=9)
