"""The PyTorch port's graph layer against the JAX package's.

Same seeded numpy inputs through ``repro.core.graph`` and
``repro_torch.core.graph``: canonical arrays, capacity-padded TEL arrays
and the device TEL (int32, bit-identical), the incremental merge-append,
``from_state`` round trips, the generators and the brute-force oracle.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import graph as jgraph  # noqa: E402
from repro.core import oracle as joracle  # noqa: E402
from repro import graphs as jgraphs  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.core import oracle as toracle  # noqa: E402
from repro_torch import graphs as tgraphs  # noqa: E402


def _edges(seed, n_v=30, n_e=200, max_t=25, neg_t=False):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_v, n_e)
    v = rng.integers(0, n_v, n_e)
    t = rng.integers(-max_t if neg_t else 1, max_t + 1, n_e)
    return u, v, t


def _assert_graphs_equal(jg, tg):
    for name in jgraph.TemporalGraph._STATE_ARRAYS:
        a, b = getattr(jg, name), getattr(tg, name)
        assert a.dtype == b.dtype == np.int32, name
        assert a.tobytes() == b.tobytes(), name
    assert (jg.num_vertices, jg.epoch) == (tg.num_vertices, tg.epoch)


@pytest.mark.parametrize("seed,padded,neg_t", [
    (0, False, False), (1, True, False), (2, False, True), (3, True, True),
])
def test_tel_arrays_match_reference(seed, padded, neg_t):
    u, v, t = _edges(seed, neg_t=neg_t)
    jg = jgraph.TemporalGraph.from_edges(u, v, t, num_vertices=30)
    tg = tgraph.TemporalGraph.from_edges(u, v, t, num_vertices=30)
    _assert_graphs_equal(jg, tg)
    caps = {}
    if padded:
        caps = dict(edge_capacity=jgraph.pow2_capacity(jg.num_edges),
                    pair_capacity=jgraph.pow2_capacity(jg.num_pairs),
                    vertex_capacity=jgraph.pow2_capacity(jg.num_vertices))
    want = jg.tel_arrays(**caps)
    got = tg.tel_arrays(**caps)
    dev = tg.device_tel(device="cpu", **caps)
    # the JAX package builds one array more, which nothing reads
    assert set(got) == set(dev._fields) == set(want) - {"time_perm"}
    for name in got:
        a = want[name]
        assert got[name].dtype == a.dtype and np.array_equal(got[name], a)
        d = getattr(dev, name)
        assert d.dtype == torch.int32 and d.device.type == "cpu"
        np.testing.assert_array_equal(d.numpy(), a, err_msg=name)


@pytest.mark.parametrize("case", ["int32 ends", "one pair", "dense",
                                  "float ids", "one edge", "no edge"])
def test_from_edges_matches_reference_at_the_extremes(case):
    """The canonical order at the ends of the int32 ranges: ids up to
    2^31 - 1, timestamps from int32 min + 1 to int32 max, many edges of
    one pair at one time, self-loops among them; and the degenerate
    inputs."""
    rng = np.random.default_rng(5)
    top, lo_t = 2**31 - 1, -2**31 + 1
    if case == "int32 ends":
        ids = np.array([0, 1, top - 1, top, 7, 2**30])
        u, v = rng.choice(ids, 500), rng.choice(ids, 500)
        t = rng.choice(np.array([lo_t, lo_t + 1, -1, 0, 1, top - 1, top]),
                       500)
    elif case == "one pair":
        u = np.full(300, 4)
        v = np.where(rng.random(300) < 0.9, 9, 4)
        t = rng.integers(0, 3, 300)
    elif case == "dense":
        u, v = rng.integers(0, 6, 2000), rng.integers(0, 6, 2000)
        t = rng.integers(-3, 4, 2000)
    elif case == "float ids":
        u, v = (rng.integers(0, 20, 100).astype(np.float64)
                for _ in range(2))
        t = rng.integers(1, 9, 100).astype(np.float64)
    elif case == "one edge":
        u, v, t = [3], [1], [lo_t]
    else:
        u, v, t = [2, 2], [2, 2], [5, 6]
    jg = jgraph.TemporalGraph.from_edges(u, v, t)
    tg = tgraph.TemporalGraph.from_edges(u, v, t)
    _assert_graphs_equal(jg, tg)


def test_memory_bytes_is_what_device_tel_ships():
    u, v, t = _edges(4)
    g = tgraph.TemporalGraph.from_edges(u, v, t, num_vertices=30)
    dev = g.device_tel(device="cpu")
    assert g.memory_bytes() == sum(x.numel() * x.element_size()
                                   for x in dev)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_add_edges_merge_append_matches_rebuild_and_reference(seed):
    rng = np.random.default_rng(100 + seed)
    u, v, t = _edges(seed, n_e=120)
    jg = jgraph.TemporalGraph.from_edges(u, v, t)
    tg = tgraph.TemporalGraph.from_edges(u, v, t)
    all_u, all_v, all_t = [u], [v], [t]
    for _ in range(3):
        n = int(rng.integers(1, 40))
        bu = rng.integers(0, 40, n)    # may add vertices and pairs
        bv = rng.integers(0, 40, n)
        bt = rng.integers(-5, 40, n)   # late and negative timestamps
        jg, tg = jg.add_edges(bu, bv, bt), tg.add_edges(bu, bv, bt)
        all_u.append(bu)
        all_v.append(bv)
        all_t.append(bt)
        _assert_graphs_equal(jg, tg)
        rebuilt = tgraph.TemporalGraph.from_edges(
            np.concatenate(all_u), np.concatenate(all_v),
            np.concatenate(all_t), num_vertices=tg.num_vertices)
        for name in tgraph.TemporalGraph._STATE_ARRAYS:
            assert np.array_equal(getattr(rebuilt, name), getattr(tg, name))
    assert tg.epoch == 3 and tg.parent_uid is not None


def test_from_state_round_trips_reference_state():
    jg = jgraphs.powerlaw_temporal(40, 300, 30, seed=5).add_edges(
        [1, 2], [3, 4], [7, 99])
    tg = tgraph.TemporalGraph.from_state(jg.state_dict())
    _assert_graphs_equal(jg, tg)
    assert tg.epoch == 1
    back = tgraph.TemporalGraph.from_state(tg.state_dict())
    _assert_graphs_equal(jg, back)
    assert back.fingerprint() == jg.fingerprint()


@pytest.mark.parametrize("bad", [
    ([0.5], [1], [1]),            # fractional id
    ([0], [1], [np.nan]),         # NaN timestamp
    ([-1], [1], [1]),             # negative id
    ([0], [1], [np.iinfo(np.int32).min]),   # the padding sentinel
])
def test_ingest_validation_matches_reference(bad):
    with pytest.raises(jgraph.GraphIngestError):
        jgraph.TemporalGraph.from_edges(*bad)
    with pytest.raises(tgraph.GraphIngestError):
        tgraph.TemporalGraph.from_edges(*bad)


@pytest.mark.parametrize("name,kw", [
    ("erdos_temporal", dict(num_vertices=30, num_edges=200, time_span=20,
                            seed=1)),
    ("powerlaw_temporal", dict(num_vertices=40, num_edges=300,
                               time_span=30, seed=2)),
    ("planted_cores", dict(seed=3)),
    ("paper_style_example", {}),
])
def test_generators_match_reference(name, kw):
    _assert_graphs_equal(getattr(jgraphs, name)(**kw),
                         getattr(tgraphs, name)(**kw))


@pytest.mark.parametrize("seed,k,h", [(0, 2, 1), (1, 3, 1), (2, 2, 2)])
def test_brute_force_query_agrees(seed, k, h):
    u, v, t = _edges(seed, n_v=14, n_e=70, max_t=8)
    jg = jgraph.TemporalGraph.from_edges(u, v, t)
    tg = tgraph.TemporalGraph.from_state(jg.state_dict())
    want = joracle.brute_force_query(jg, k, 1, 8, h)
    got = toracle.brute_force_query(tg, k, 1, 8, h)
    assert got == want
