"""The port's iPHC baseline and dynamic-graph behaviour against the JAX
package's: tests/test_baseline_and_dynamic.py, case by case, through both.

Both packages get the same graph (the port's built with ``from_state``
from the reference's ``state_dict``).  Every output is an integer or a
boolean, so the tolerance is exact: ``PHCIndex.core_time`` and ``uts``
bit-identical, the build's TCD calls equal in number, and ``iphc_query``'s
cores (TTI, vertices, edge count), ``cells_evaluated`` and ``duplicates``
equal to the reference's and to the brute-force oracle.  The port builds
on the CPU here (``device="cpu"``); tests/test_torch_cuda.py builds it on
the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import PHCIndex as JIndex  # noqa: E402
from repro.core import TCQEngine as JEngine  # noqa: E402
from repro.core import brute_force_query  # noqa: E402
from repro.core import iphc_query as jiphc  # noqa: E402
from repro.graphs import EdgeStream as JStream  # noqa: E402
from repro.graphs import (paper_style_example, planted_cores,  # noqa: E402
                          powerlaw_temporal)
from repro_torch.core import (PHCIndex, TCQEngine, TemporalGraph,  # noqa: E402
                              iphc_query)
from repro_torch.graphs import EdgeStream  # noqa: E402

CASES = {
    # (graph, k, Ts, Te): test_iphc_matches_oracle's two seeds, the index
    # size case's graph, and a graph with parallel edges
    "planted0": (lambda: planted_cores(seed=0, num_vertices=32, n_cliques=3,
                                       clique_size=5, time_span=20,
                                       noise_edges=60), 3, 1, 20),
    "planted3": (lambda: planted_cores(seed=3, num_vertices=32, n_cliques=3,
                                       clique_size=5, time_span=20,
                                       noise_edges=60), 3, 1, 20),
    "planted1": (lambda: planted_cores(seed=1), 3, 1, 40),
    "powerlaw": (lambda: powerlaw_temporal(50, 400, 30, seed=4), 3, 1, 30),
}
_built = {}


def _port(g):
    return TemporalGraph.from_state(g.state_dict())


def _indexes(name):
    """(reference graph, reference index, its TCD call count, port graph,
    port index) for one case, shared across this module's tests."""
    if name not in _built:
        make, k, ts, te = CASES[name]
        g = make()
        calls = []
        orig = JEngine._tcd

        def counted(self, *a, **kw):
            calls.append(1)
            return orig(self, *a, **kw)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JEngine, "_tcd", counted)
            want = JIndex(g, k, ts, te)
        pg = _port(g)
        _built[name] = (g, want, len(calls), pg,
                        PHCIndex(pg, k, ts, te, device="cpu"))
    return _built[name]


def assert_same_cores(got, want, ctx=""):
    bg, bw = got.by_tti(), want.by_tti()
    assert bg.keys() == bw.keys(), ctx
    for key, cw in bw.items():
        assert np.array_equal(bg[key].vertices, cw.vertices), (ctx, key)
        assert bg[key].n_edges == cw.n_edges, (ctx, key)


def assert_matches_oracle(res, oracle, ctx=""):
    assert set(c.tti for c in res.cores) == set(oracle.keys()), ctx
    for c in res.cores:
        assert set(c.vertices.tolist()) == set(oracle[c.tti]["vertices"]), ctx
        assert c.n_edges == oracle[c.tti]["n_edges"], ctx


def test_powerlaw_case_has_parallel_edges():
    g = CASES["powerlaw"][0]()
    assert g.num_pairs < g.num_edges


@pytest.mark.parametrize("name", list(CASES))
def test_phc_index_matches_reference(name):
    _, want, want_calls, _, got = _indexes(name)
    assert got.uts.dtype == np.int64 and got.core_time.dtype == np.int64
    np.testing.assert_array_equal(got.uts, want.uts)
    np.testing.assert_array_equal(got.core_time, want.core_time)
    assert (got.core_time < np.iinfo(np.int64).max).any(), name
    # same warm starts and early stops: one TCD call for each of theirs
    assert got.tcd_calls == want_calls
    rows = int((got.core_time < np.iinfo(np.int64).max).any(1).sum())
    assert got.peel_iters >= got.tcd_calls
    assert got.host_syncs == got.peel_iters + got.tcd_calls + rows


@pytest.mark.parametrize("name", list(CASES))
def test_iphc_matches_reference_and_oracle(name):
    """test_iphc_matches_oracle, through both packages."""
    g, want_idx, _, pg, idx = _indexes(name)
    _, k, ts, te = CASES[name]
    want = jiphc(g, want_idx, k, ts, te)
    got = iphc_query(pg, idx, k, ts, te)
    assert_same_cores(got, want, name)
    for f in ("n_timestamps", "cells_total", "cells_evaluated",
              "duplicates"):
        assert getattr(got.stats, f) == getattr(want.stats, f), (name, f)
    assert_matches_oracle(got, brute_force_query(g, k, ts, te), name)
    assert_same_cores(got, TCQEngine(pg, device="cpu").query(k, ts, te),
                      name)


def test_phc_index_size_vs_tel():
    """The paper's point: the index dwarfs the TEL it indexes."""
    _, want, _, pg, idx = _indexes("planted1")
    assert idx.nbytes() == want.nbytes()
    assert idx.nbytes() > pg.memory_bytes()


def test_dynamic_append_equals_rebuild():
    g0 = paper_style_example()
    extra = [(3, 6, 9), (5, 6, 9), (3, 5, 9), (0, 4, 10)]
    want = JEngine(g0.add_edges(*zip(*extra))).query(2, 1, 10)
    p0 = _port(g0)
    p1 = p0.add_edges(*zip(*extra))
    p2 = TemporalGraph.from_edge_list(
        list(zip(p0.src, p0.dst, p0.t)) + extra, num_vertices=9)
    assert p1.num_edges == p2.num_edges
    r1 = TCQEngine(p1, device="cpu").query(2, 1, 10)
    r2 = TCQEngine(p2, device="cpu").query(2, 1, 10)
    assert_same_cores(r1, want)
    assert_same_cores(r2, want)


def test_stream_queries_see_new_cores():
    """Serving loop pattern: push arrival batches, re-query, watch the
    result set grow — the paper's dynamic-graph scenario."""
    g = paper_style_example()
    jstream, stream = JStream(), EdgeStream()
    sizes = []
    for (u, v, t), (pu, pv, pt) in zip(JStream.replay(g, 4),
                                       EdgeStream.replay(_port(g), 4)):
        jstream.push(u, v, t)
        stream.push(pu, pv, pt)
        res = TCQEngine(stream.graph, device="cpu").query(2, 1, 8)
        sizes.append(len(res))
        assert_same_cores(res, JEngine(jstream.graph).query(2, 1, 8))
        assert_matches_oracle(res, brute_force_query(jstream.graph, 2, 1, 8))
    assert sizes[-1] >= sizes[0]
    assert sizes[-1] == 16  # full graph's distinct 2-cores


def test_out_of_order_arrival():
    """Late edges (timestamps before the current max) are accepted — a
    strict superset of the paper's append-only assumption."""
    g = paper_style_example()
    late = g.add_edges([0], [4], [2])
    got = TCQEngine(_port(g).add_edges([0], [4], [2]),
                    device="cpu").query(2, 1, 8)
    assert_same_cores(got, JEngine(late).query(2, 1, 8))
    assert_matches_oracle(got, brute_force_query(late, 2, 1, 8))


def test_phc_index_defaults_to_cuda_and_raises_without_it():
    pg = _port(planted_cores(seed=0, num_vertices=32, n_cliques=3,
                             clique_size=5, time_span=20, noise_edges=60))
    if torch.cuda.is_available():
        assert PHCIndex(pg, 3, 1, 20).tcd_calls > 0
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        PHCIndex(pg, 3, 1, 20)
    with pytest.raises(RuntimeError, match="CUDA"):
        PHCIndex(pg, 3, 1, 20, device="cuda")

