"""``QueryState.decode_results`` against the unpack it replaced and the
JAX package's.

The port decodes the collected packed core rows from their nonzero
uint32 words, sparse and dense rows alike.  The oracle kept here is the
algorithm both packages decoded with before: rows grouped by width, each
group stacked, unpacked to a byte a vertex by ``unpack_alive_u32`` and
``np.nonzero``-ed.  Every case must give the same dict, in the same
order, as the oracle and as the JAX package's
``QueryState.decode_results`` on the same rows.
"""

import tracemalloc

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core.results import QueryStats as JQueryStats  # noqa: E402
from repro.core.scheduler import QueryState as JQueryState  # noqa: E402
from repro_torch.core.results import QueryStats  # noqa: E402
from repro_torch.core.scheduler import QueryState  # noqa: E402
from repro_torch.core.wave import packed_width, unpack_alive_u32  # noqa: E402

YOUTUBE_V = 3_276_800       # the tcq-youtube configuration's vertex count


def _pack(ids, width):
    """uint32 row of ``width`` words with bit ``v % 32`` of word
    ``v // 32`` set for each id."""
    row = np.zeros(width, np.uint32)
    ids = np.asarray(ids, np.int64)
    np.bitwise_or.at(row, ids >> 5,
                     np.left_shift(1, ids & 31).astype(np.uint32))
    return row


def _core(rng, v, n):
    """A core of up to ``n`` vertices, most on low ids (the generators'
    hubs), one anywhere below ``v``."""
    ids = rng.integers(0, rng.integers(1, min(v, 4 * n) + 1), n)
    return np.append(ids, rng.integers(0, v))


def _v_not_multiple_of_32(rng):
    v = 10_000
    return [_pack(_core(rng, v, 40), packed_width(v)) for _ in range(12)], v


def _bit31_int32(rng):
    v = 6_400
    rows = [_pack(np.append(32 * rng.integers(0, 200, 8) + 31,
                            _core(rng, v, 10)), packed_width(v))
            for _ in range(6)]
    return [r.view(np.int32) for r in rows], v


def _all_ones(rng):
    v = 1000                       # 32 words hold it; a cached row has 40
    ones = np.full(packed_width(v), 0xFFFFFFFF, np.uint32)
    return [ones, _pack(_core(rng, v, 30), packed_width(v)),
            ones.view(np.int32), np.full(40, 0xFFFFFFFF, np.uint32)], v


def _bits_past_v(rng):
    v = 10_000                     # 313 words hold it; the rows carry 400
    rows = []
    for _ in range(5):
        past = rng.integers(v, 400 * 32, 6)
        rows.append(_pack(np.concatenate([_core(rng, v, 20), past,
                                          [v - 1, v]]), 400))
    return rows, v


def _two_widths(rng):
    v = 10_000
    fresh = [_pack(_core(rng, v, 30), packed_width(v)) for _ in range(3)]
    narrow = [_pack(_core(rng, 6_400, 30), 200) for _ in range(3)]
    return [fresh[0], narrow[0], fresh[1], narrow[1], narrow[2],
            fresh[2]], v


def _single_vertex(rng):
    v = 10_000
    return [_pack([i], packed_width(v))
            for i in (0, 31, 32, 9_999, int(rng.integers(v)))], v


def _mixed_dense_sparse(rng):
    v = 5000
    w = packed_width(v)
    dense = [np.packbits(rng.random(32 * w) < p, bitorder="little")
             .view(np.uint32) for p in (0.3, 0.05, 0.9)]
    sparse = [_pack(_core(rng, v, 25), w) for _ in range(3)]
    return [dense[0], sparse[0], sparse[1], dense[1], sparse[2],
            dense[2]], v


def _youtube_sparse(rng):
    v = YOUTUBE_V
    return [_pack(np.append(_core(rng, v, 400), v - 1), packed_width(v))
            for _ in range(3)], v


# case -> generator of (rows, vertex count)
CASES = {
    "v_not_multiple_of_32": _v_not_multiple_of_32,
    "bit31_int32": _bit31_int32,
    "all_ones": _all_ones,
    "bits_past_v": _bits_past_v,
    "two_widths": _two_widths,
    "single_vertex": _single_vertex,
    "mixed_dense_sparse": _mixed_dense_sparse,
    "youtube_sparse": _youtube_sparse,
}


def _collected(rows):
    """The (tti key -> (row, n_edges)) dict a drained query holds, keys
    in collection order."""
    return {(3 * i, 3 * i + 2): (row, 10 + i) for i, row in enumerate(rows)}


def _state(cls, stats, rows):
    qs = cls(np.arange(4), 5, 1, True, stats)
    qs.collected = _collected(rows)
    return qs


def oracle(collected, num_vertices):
    """The stacked unpack: (key -> (vertices, n_edges)), width groups in
    the order each width first appears."""
    groups = {}
    for key, (row, _) in collected.items():
        groups.setdefault(row.size, []).append(key)
    out = {}
    for width, keys in groups.items():
        bits = unpack_alive_u32(np.stack([collected[k][0] for k in keys]),
                                min(num_vertices, width * 32))
        for key, b in zip(keys, bits):
            out[key] = (np.nonzero(b)[0], collected[key][1])
    return out


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_results_equals_the_unpack_and_jax(case, seed):
    rows, v = CASES[case](np.random.default_rng([seed, len(case)]))
    qs = _state(QueryState, QueryStats(), rows)
    got = qs.decode_results(v)
    want = oracle(qs.collected, v)
    jgot = _state(JQueryState, JQueryStats(), rows).decode_results(v)

    assert list(got) == list(want) == list(jgot)
    for key, core in got.items():
        assert core.tti == key and core.k == 5
        assert core.vertices.dtype == np.int64
        np.testing.assert_array_equal(core.vertices, want[key][0])
        np.testing.assert_array_equal(core.vertices, jgot[key].vertices)
        assert core.n_edges == want[key][1] == jgot[key].n_edges
        assert core.vertices.size == 0 or core.vertices[-1] < v

    scanned = [np.asarray(r).view(np.uint32)[:-(-min(v, r.size * 32) // 32)]
               for r in rows]
    assert qs.stats.decode_words == sum(s.size for s in scanned)
    assert qs.stats.decode_words_set == sum(np.count_nonzero(s)
                                            for s in scanned)


def test_decode_at_youtube_width_holds_nothing_larger_than_the_rows():
    """Sparse cores at tcq-youtube's width: the decode's peak allocation
    stays under twice one row's words plus the answer (the stacked unpack
    took a byte a vertex, eight times all the rows' words, twice)."""
    rng = np.random.default_rng(7)
    rows = [_pack(_core(rng, YOUTUBE_V, 300), packed_width(YOUTUBE_V))
            for _ in range(8)]
    qs = _state(QueryState, QueryStats(), rows)
    tracemalloc.start()
    try:
        got = qs.decode_results(YOUTUBE_V)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    out_bytes = sum(c.vertices.nbytes for c in got.values())
    assert peak < 2 * rows[0].nbytes + out_bytes
    want = oracle(qs.collected, YOUTUBE_V)
    for key, core in got.items():
        np.testing.assert_array_equal(core.vertices, want[key][0])
    assert qs.stats.decode_words_set < qs.stats.decode_words // 100
