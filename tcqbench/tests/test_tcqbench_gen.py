"""The benchmark's frozen generator and request specs against digests
recorded when they were frozen, the generator against the program's
original, and the sx-mathoverflow graph against its published counts."""

import hashlib

import numpy as np

from tcqbench import gen


def digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a, np.int64)).tobytes())
    return h.hexdigest()[:16]


def test_powerlaw_edges_digest():
    assert digest(*gen.powerlaw_edges(1000, 20_000, 500, burst_periods=14,
                                      seed=11)) == "4fe63d2dc5ec1cee"
    assert digest(*gen.powerlaw_edges(5000, 30_000, 4096, alpha=0.9,
                                      burst_periods=14, seed=11)) \
        == "cb851a0cf6c567d3"


def test_batches_digest():
    spec = {"kind": "stratified", "per_batch": 8, "k": 16, "span": 64}
    b = gen.batch_requests(spec, 7, 3, 1, 2350)
    assert digest([[r["k"], r["ts"], r["te"]] for r in b]) \
        == "7f26efc2cfc0c098"
    starts = [r["ts"] for i in range(100)
              for r in gen.batch_requests(spec, 7, i, 1, 2350)]
    counts = np.histogram(starts, bins=10)[0]
    assert counts.min() >= 78 and counts.max() <= 82    # evenly spread
    wins = [[15, 138353, 152915], [23, 505869, 513149],
            [10, 780034, 787314]]
    spec = {"kind": "shifted", "shift_div": 32, "shift_seed": 11,
            "windows": wins}
    b = gen.batch_requests(spec, 7, 3, 1, 2**20)
    assert digest([[r["k"], r["ts"], r["te"]] for r in b]) \
        == "bb70bf6adef362cf"
    # another seed asks the same windows in another order; another batch
    # asks other windows
    key = lambda rs: sorted((r["k"], r["ts"], r["te"]) for r in rs)  # noqa
    assert key(gen.batch_requests(spec, 8, 3, 1, 2**20)) == key(b)
    assert key(gen.batch_requests(spec, 7, 4, 1, 2**20)) != key(b)
    for r in b:     # k kept, span kept, moved within 1/32 of the span
        w = next(w for w in wins if w[0] == r["k"])
        assert r["te"] - r["ts"] == w[2] - w[1]
        assert abs(r["ts"] - w[1]) <= (w[2] - w[1] + 1) // 32


def test_frozen_copies_equal_the_program_generators():
    from repro_torch.core import TemporalGraph
    from repro_torch.graphs import powerlaw_temporal

    u, v, t = gen.powerlaw_edges(700, 9000, 300, alpha=1.2,
                                 burst_periods=5, seed=4)
    a = TemporalGraph.from_edges(u, v, t, 700)
    b = powerlaw_temporal(700, 9000, 300, alpha=1.2, burst_periods=5,
                          seed=4)
    for name in ("src", "dst", "t", "pair_id", "pair_u", "pair_v"):
        assert np.array_equal(getattr(a, name), getattr(b, name))


def test_graph_edges_cache(tmp_path, monkeypatch):
    monkeypatch.setattr(gen, "CACHE_DIR", tmp_path)
    spec = {"num_vertices": 300, "num_edges": 3000, "time_span": 100,
            "seed": 2}
    first = gen.graph_edges("x", spec)
    assert len(list(tmp_path.iterdir())) == 1
    again = gen.graph_edges("x", spec)
    for a, b in zip(first, again):
        assert np.array_equal(a, b)


def test_sx_mathoverflow_graph_fits_its_published_counts():
    import json

    from tcqbench.tests.tiny import ROOT

    cfg = json.loads((ROOT / "tcqbench" / "configs" / "sx-mathoverflow.json")
                     .read_text())
    pub = cfg["published"]
    u, v, t = gen.powerlaw_edges(**cfg["graph"])
    keep = u != v
    assert int(keep.sum()) == pub["temporal_edges"] \
        == cfg["edges_after_self_loops"]
    lo, hi = np.minimum(u, v)[keep], np.maximum(u, v)[keep]
    pairs = np.unique(lo.astype(np.int64) * pub["vertices"] + hi).size
    assert pairs == cfg["assumed"]["distinct_pairs"]
    assert abs(pairs / pub["static_edges"] - 1) < 0.005
    assert u.max() < pub["vertices"] and v.max() < pub["vertices"]
    assert t.min() >= 1 and t.max() <= pub["time_span_days"]
