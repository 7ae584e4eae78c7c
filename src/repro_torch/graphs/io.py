"""Edge-list IO: SNAP/KONECT-style whitespace ``u v t`` files (+ npz cache)."""

from __future__ import annotations

import os

import numpy as np

from repro_torch.core.graph import TemporalGraph


def load_snap_edges(path: str, num_vertices=None,
                    time_unit: int = 1) -> TemporalGraph:
    """Load a SNAP temporal edge list (``SRC DST UNIXTS`` per line).

    time_unit > 1 coarsens timestamps (the paper unifies to seconds; coarser
    units shrink the schedule for interactive experimentation).
    """
    if path.endswith(".npz"):
        z = np.load(path)
        u, v, t = z["u"], z["v"], z["t"]
    else:
        data = np.loadtxt(path, dtype=np.int64, comments=("#", "%"))
        u, v, t = data[:, 0], data[:, 1], data[:, 2]
    if time_unit > 1:
        t = t // time_unit
    t = t - t.min() + 1
    return TemporalGraph.from_edges(u, v, t, num_vertices)


def save_edges(graph: TemporalGraph, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, u=graph.src, v=graph.dst, t=graph.t)
