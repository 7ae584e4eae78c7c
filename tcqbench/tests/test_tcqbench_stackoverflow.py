"""The sx-stackoverflow configuration and its cell: the file against
``BENCHMARK.json`` and SNAP's counts, and the program against the reference
on a graph of its shape at a thousandth of its scale.

The full graph (63.5 M edges) is generated on the card's host only.  Here
the small graph keeps the configuration's generator, alpha, bursts, span
and graph seed, and its temporal edges per vertex (63,490 edges on 2,602
vertices: 24.4, SNAP's 24.4); its temporal edges per distinct pair come to
1.9 (SNAP's 1.75), since a thousandth of the vertices holds fewer pairs.
The engine answers the cell's stratified 64-day windows in the modes the
card runs (``query_batch``; ``query`` wave over the composite; serial),
each core, TTI and edge count equal to the reference's.
"""

import json

import numpy as np
import pytest

from tcqbench import gen
from tcqbench.check import differing, program_cores
from tcqbench.reference.otcd import EdgeList, otcd
from tcqbench.tests.tiny import ROOT, bench, one_thread  # noqa: F401

NAME = "sx-stackoverflow"
CELL = "sx-stackoverflow.batch"
SNAP = {"vertices": 2_601_977, "temporal_edges": 63_497_050,
        "static_edges": 36_233_450, "time_span_days": 2_774}


def config():
    return json.loads((ROOT / "tcqbench" / "configs" / f"{NAME}.json")
                      .read_text())


def workload():
    return json.loads((ROOT / "tcqbench" / "workloads" / f"{CELL}.json")
                      .read_text())


def test_configuration_states_snaps_counts():
    cfg, b = config(), bench()
    entry = next(c for c in b["configs"] if c["name"] == NAME)
    assert cfg["published"] == SNAP
    assert cfg["reduced"] == entry["reduced"] == []
    assert len(entry["source"]) <= 200
    assert "snap.stanford.edu/data/sx-stackoverflow" in entry["source"]
    assert "tcq-stackoverflow" in entry["source"]
    g = cfg["graph"]
    assert g["num_vertices"] == SNAP["vertices"]
    assert g["time_span"] == SNAP["time_span_days"]
    assert (g["burst_periods"], g["burst_frac"], g["seed"]) == (14, 0.5, 11)
    assert cfg["edges_after_self_loops"] == SNAP["temporal_edges"]
    a = cfg["assumed"]
    assert a["alpha"] == g["alpha"] and a["num_edges_drawn"] == g["num_edges"]
    assert abs(a["distinct_pairs"] / SNAP["static_edges"] - 1) < 0.01
    assert cfg["reference"].startswith("tcqbench/reference/otcd.py")


def test_cell_is_the_batch_driver_on_one_chip():
    b, w = bench(), workload()
    entry = next(x for x in b["workloads"] if x["name"] == CELL)
    assert (entry["config"], entry["traffic"], entry["chips"]) == \
        (NAME, "batch", 1)
    assert w["driver"] == "batch" and w["config"] == NAME
    p = w["params"]
    r = p["requests"]
    assert (r["kind"], r["per_batch"], r["span"], r["h"]) == \
        ("stratified", 8, 64, 1)
    assert r["k"] in (12, 16, 20, 24, 32)
    assert (p["warmup_batches"], p["check_queries"]) == (1, 8)
    qps = next(m for m in b["end_to_end"] if m["name"] == "tcq_qps")
    assert CELL in qps["workloads"]
    batch = [m for m in b["per_layer"] if m["name"].endswith(".batch")]
    assert len(batch) == 10 and all(CELL in m["workloads"] for m in batch)
    kept = next(m for m in b["per_layer"] if m["name"] == "hp_kept_pct.batch")
    assert kept["workloads"] == [CELL, "tcq-youtube.batch"]
    assert (kept["layer"], kept["moves"], kept["better"], kept["unit"]) == \
        ("wave step and kernels", "tcq_qps", "higher", "%")


# a thousandth of the graph: the configuration's generator at its alpha
SMALL = {"num_vertices": 2_602, "num_edges": 65_041, "time_span": 2_774,
         "burst_periods": 14, "burst_frac": 0.5, "seed": 11}


@pytest.fixture(scope="module")
def small():
    g = dict(config()["graph"], **SMALL)
    u, v, t = gen.powerlaw_edges(**g)
    return u, v, t


def test_small_graph_keeps_the_shape(small):
    u, v, t = small
    keep = u != v
    lo, hi = np.minimum(u, v)[keep], np.maximum(u, v)[keep]
    pairs = np.unique(lo.astype(np.int64) * SMALL["num_vertices"] + hi).size
    edges = int(keep.sum())
    assert edges == 63_490
    per_vertex = SNAP["temporal_edges"] / SNAP["vertices"]
    assert abs(edges / SMALL["num_vertices"] / per_vertex - 1) < 0.01
    per_pair = SNAP["temporal_edges"] / SNAP["static_edges"]
    assert 1.0 < edges / pairs / per_pair < 1.1
    assert t.min() >= 1 and t.max() <= SNAP["time_span_days"]


@pytest.mark.parametrize("seed", [2**31 + 11, 7])
def test_small_graph_answers_equal_the_reference(small, seed):
    """A stratified batch of the cell's spec at k 6 (k 12 holds no core at
    this scale, k 4 over a thousand in a burst's window): every mode's
    cores equal the reference's."""
    from repro_torch.core import TCQEngine, TemporalGraph

    u, v, t = small
    g = TemporalGraph.from_edges(u, v, t, SMALL["num_vertices"])
    spec = dict(workload()["params"]["requests"], k=6)
    t_min, t_max = int(g.t.min()), int(g.t.max())
    reqs = gen.batch_requests(spec, seed, 0, t_min, t_max)
    eng = TCQEngine(g, device="cpu")
    el = EdgeList(u, v, t)
    batch = eng.query_batch(reqs)
    cores = 0
    for i, r in enumerate(reqs):
        want = otcd(el, r["k"], r["ts"], r["te"], h=r["h"])
        cores += len(want)
        got = {"batch": batch[i]}
        if i < 3:
            for mode in ("wave", "serial"):
                got[mode] = eng.query(r["k"], r["ts"], r["te"], h=r["h"],
                                      mode=mode)
        for mode, res in got.items():
            assert differing(program_cores(res), want) == 0, (r, mode)
    assert cores > 0
