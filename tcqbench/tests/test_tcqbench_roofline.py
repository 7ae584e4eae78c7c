"""The wave step's byte count, worked by hand on a small TEL."""

import numpy as np
import pytest

from tcqbench.roofline import (HBM_BYTES_PER_S, WindowSizes, batch_bytes,
                               step_bytes)

# (u, v, t): pair {0, 1} twice in either direction, a self-loop at t 3
EDGES = (np.array([0, 1, 2, 1, 3, 0]), np.array([1, 0, 2, 2, 4, 1]),
         np.array([1, 2, 3, 5, 9, 10]))


def test_step_bytes_by_hand():
    # 10 window edges x (src, dst, t, pair index) = 160 B; 4 pairs x
    # (both ends, a half-pair incidence each way) = 96 B; a lane over 40
    # vertices: mask read 40 + written 40, packed 2 words = 8, tti_lo,
    # tti_hi, n_edges 12 -> 100 B
    assert step_bytes(10, 4, 40, 1) == 160 + 96 + 100
    assert step_bytes(10, 4, 40, 3) == 160 + 96 + 300
    assert step_bytes(10, 4, 40, 2.5) == 160 + 96 + 250


@pytest.mark.parametrize("windows, want", [
    # t 1, 2, 5: pairs {0,1}, {1,2}; vertices 0, 1, 2
    ([(1, 2), (4, 6)], (3, 2, 3)),
    # [1, 3] and [4, 10] touch: every edge but the self-loop
    ([(4, 10), (1, 3)], (5, 3, 5)),
    # overlapping windows count an edge once: t 2, 5, 9
    ([(5, 9), (2, 6)], (3, 3, 5)),
    # a window with no edge
    ([(11, 20)], (0, 0, 0)),
])
def test_window_sizes_by_hand(windows, want):
    assert WindowSizes(*EDGES)(windows) == want


def test_batch_bytes_sums_steps():
    b = {"device_steps": 7, "occupancy": 2.0, "windows": [(1, 2), (4, 6)]}
    # 3 edges, 2 pairs, 3 vertices: 48 + 48 + 2 x (6 + 4 + 12)
    assert batch_bytes([b], EDGES) == 7 * 140
    assert batch_bytes([b, b], EDGES) == 2 * 7 * 140
    assert HBM_BYTES_PER_S == 3.35e12


def test_roofline_metric_reads_nothing_without_a_trace():
    from tcqbench.run import HERE, load_module

    read = load_module(HERE / "metrics" / "step_roofline_pct.batch.py").read
    b = {"device_steps": 1000, "occupancy": 4.0, "windows": [(1, 10)]}
    assert read({"trace": None, "batches": [b], "edges": EDGES}) is None
    pct = read({"trace": {"busy_s": 0.5, "window_s": 1.0},
                "batches": [b], "edges": EDGES})
    assert abs(pct - 100 * batch_bytes([b], EDGES) / 3.35e12 / 0.5) < 1e-9
