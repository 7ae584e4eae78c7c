"""The PyTorch port's wave step, segment sum and serial TCD against the JAX
package's.

The fused-step sweep is the one of ``tests/test_kernels.py``
(``_fuzz_fused_vs_composite``: 6 seeds x {plain, capacity-padded}, W rarely
a tile multiple, empty-window padding lanes, warm-start rows).  Each case
goes through JAX's composite, JAX's ``wave_peel_pallas`` in interpret mode
and the port's step on the CPU (the plain version of the CUDA kernel); all
six ``StepResult`` fields must be bit-identical.  The CUDA kernels are
held against these plain versions on the card by tests/test_torch_cuda.py.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import wave as jwave  # noqa: E402
from repro.core.graph import TemporalGraph as JGraph, pow2_capacity  # noqa: E402
from repro.graphs import planted_cores  # noqa: E402
from repro.kernels.segdeg.kernel import (banded_segsum_pallas,  # noqa: E402
                                         required_k_max)
from repro.kernels.segdeg.ref import banded_segsum_ref as jsegsum  # noqa: E402
from repro_torch.core import wave as twave  # noqa: E402
from repro_torch.core.graph import TemporalGraph as TGraph  # noqa: E402
from repro_torch.kernels.segdeg import ops as tsegdeg  # noqa: E402
from repro_torch.kernels.wave_peel import ops as tpeel  # noqa: E402
from test_kernels import _random_temporal_graph  # noqa: E402

# the packages' __init__ rebind ``core.tcd`` to the function of that name
jtcd_mod = importlib.import_module("repro.core.tcd")
ttcd_mod = importlib.import_module("repro_torch.core.tcd")

FIELDS = ("alive", "packed", "tti_lo", "tti_hi", "n_edges", "iters")


def _case(seed, capacity_padding):
    """The draws of tests/test_kernels.py::_fuzz_fused_vs_composite, in
    order: (reference graph, caps, V, w_tile, alive, ts, te, k, h)."""
    rng = np.random.default_rng(seed)
    g, tmax = _random_temporal_graph(rng)
    caps = {}
    nv = g.num_vertices
    if capacity_padding:
        nv = pow2_capacity(g.num_vertices)
        caps = dict(edge_capacity=pow2_capacity(g.num_edges),
                    pair_capacity=pow2_capacity(g.num_pairs),
                    vertex_capacity=nv)
    w_tile = int(rng.choice([4, 8]))
    W = int(rng.integers(1, 12))
    ts = rng.integers(0, tmax, W).astype(np.int32)
    te = (ts + rng.integers(0, tmax, W)).astype(np.int32)
    empty = rng.random(W) < 0.25
    ts[empty], te[empty] = 0, -1
    k = rng.integers(1, 5, W).astype(np.int32)
    h = rng.integers(1, 3, W).astype(np.int32)
    if rng.random() < 0.5:
        alive = rng.random((W, nv)) < 0.8
    else:
        alive = np.ones((W, nv), dtype=bool)
    return g, caps, nv, w_tile, alive, ts, te, k, h


def _port_tel(g, caps, device="cpu"):
    return TGraph.from_state(g.state_dict()).device_tel(device=device, **caps)


def _as_np(field, x):
    x = np.asarray(x.cpu().numpy() if torch.is_tensor(x) else x)
    return x.view("<u4") if field == "packed" and x.dtype == np.int32 else x


def _assert_steps_equal(got, want, ctx):
    for f in FIELDS:
        a, b = _as_np(f, getattr(got, f)), _as_np(f, getattr(want, f))
        assert a.dtype == b.dtype and a.shape == b.shape, (f, ctx)
        np.testing.assert_array_equal(a, b, err_msg=f"{f} ({ctx})")


_SWEEP = [(1000 + s, False) for s in range(6)] + \
    [(2000 + s, True) for s in range(6)]


@pytest.mark.parametrize("seed,padded", _SWEEP)
def test_plain_step_matches_both_jax_lowerings(seed, padded):
    g, caps, nv, w_tile, alive, ts, te, k, h = _case(seed, padded)
    jtel = g.device_tel(**caps)
    jargs = tuple(jnp.asarray(a) for a in (alive, ts, te, k, h))
    j_comp = jwave.make_wave_step_fn(jtel, nv, use_kernel=False)(*jargs)
    j_fused = jwave.make_wave_step_fn(jtel, nv, use_kernel=True,
                                      w_tile=w_tile)(*jargs)
    tel = _port_tel(g, caps)
    targs = tuple(torch.from_numpy(a) for a in (alive, ts, te, k, h))
    fused = twave.make_wave_step_fn(tel, nv, use_kernel=True)(*targs)
    comp = twave.make_wave_step_fn(tel, nv, use_kernel=False)(*targs)
    _assert_steps_equal(fused, j_comp, f"port fused-plain vs jax composite "
                        f"{seed}")
    _assert_steps_equal(fused, j_fused, f"port vs jax interpret kernel {seed}")
    _assert_steps_equal(comp, j_comp, f"port composite vs jax {seed}")
    # the non-donating step leaves the caller's buffer alone
    np.testing.assert_array_equal(targs[0].numpy(), alive)


@pytest.mark.parametrize("seed,padded", _SWEEP[::3])
def test_oracle_step_matches_plain_step(seed, padded):
    g, caps, nv, _, alive, ts, te, k, h = _case(seed, padded)
    tel = _port_tel(g, caps)
    targs = tuple(torch.from_numpy(a) for a in (alive, ts, te, k, h))
    _assert_steps_equal(twave.make_oracle_step_fn(tel, nv)(*targs),
                        twave.make_composite_step(tel, nv)(*targs),
                        f"oracle vs plain {seed}")


def test_donated_step_peels_in_place():
    g, caps, nv, _, alive, ts, te, k, h = _case(1003, True)
    tel = _port_tel(g, caps)
    buf = torch.from_numpy(alive.copy())
    res = twave.make_wave_step_fn(tel, nv, donate=True)(buf, ts, te, k, h)
    assert res.alive.data_ptr() == buf.data_ptr()
    want = twave.make_wave_step_fn(tel, nv)(torch.from_numpy(alive), ts, te,
                                            k, h)
    assert torch.equal(buf, want.alive)


@pytest.mark.parametrize("v", [1, 5, 31, 32, 33, 100])
def test_packed_round_trip_and_jax_layout(v):
    rng = np.random.default_rng(v)
    alive = rng.random((3, v)) < 0.5
    packed = twave.pack_alive_u32(torch.from_numpy(alive), num_vertices=v)
    assert packed.dtype == torch.int32
    assert packed.shape == (3, twave.packed_width(v))
    np.testing.assert_array_equal(twave.unpack_alive_u32(packed, v), alive)
    want = np.asarray(jwave.pack_alive_u32(jnp.asarray(alive),
                                           num_vertices=v))
    np.testing.assert_array_equal(packed.numpy().view("<u4"), want)


_SEGSUM_SHAPES = [(1, 1, 1), (100, 7, 3), (1000, 300, 17), (513, 129, 129),
                  (2048, 4, 8)]


@pytest.mark.parametrize("n,s,q", _SEGSUM_SHAPES)
def test_segsum_matches_reference(n, s, q):
    rng = np.random.default_rng(n + s + q)
    segs = np.sort(rng.integers(0, s + 2, n)).astype(np.int32)  # >= s drop
    # 0/1 values (all the wave step feeds it) are exact; floats differ
    # from a scatter only by summation order
    for vals, exact in (((rng.random((n, q)) < 0.5), True),
                        (rng.normal(0, 1, (n, q)), False)):
        vals = vals.astype(np.float32)
        got = tsegdeg.banded_segsum(torch.from_numpy(vals),
                                    torch.from_numpy(segs), s).numpy()
        ref = np.asarray(jsegsum(jnp.asarray(vals), jnp.asarray(segs), s))
        kern = np.asarray(banded_segsum_pallas(
            jnp.asarray(vals), jnp.asarray(segs), num_segments=s,
            k_max=required_k_max(segs, s), interpret=True))
        assert got.dtype == np.float32 and got.shape == (s, q)
        for want in (ref, kern):
            if exact:
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_tcd_wave_matches_reference():
    g = planted_cores(seed=5)
    jtel = g.device_tel()
    tel = _port_tel(g, {})
    ts, te = [1, 5, 10, 0], [40, 30, 25, -1]
    k, h = [3, 2, 3, 1], [1, 1, 2, 1]
    alive0 = np.ones((4, g.num_vertices), dtype=bool)
    sp, sv = jwave.make_segsum_fns(g, use_kernel=False)
    want = jwave.tcd_wave(jtel, jnp.asarray(alive0), jnp.asarray(ts),
                          jnp.asarray(te), jnp.asarray(k), jnp.asarray(h),
                          num_vertices=g.num_vertices, seg_pair=sp,
                          seg_vert=sv)
    tg = TGraph.from_state(g.state_dict())
    tsp, tsv = twave.make_segsum_fns(tg)
    via_segsum = twave.tcd_wave(tel, torch.from_numpy(alive0), ts, te,
                                torch.tensor(k), torch.tensor(h),
                                num_vertices=g.num_vertices, seg_pair=tsp,
                                seg_vert=tsv)
    via_step = twave.tcd_wave(tel, torch.from_numpy(alive0), ts, te, k, h,
                              num_vertices=g.num_vertices,
                              step_fn=twave.make_wave_step_fn(
                                  tel, g.num_vertices))
    for got in (via_segsum, via_step):
        for f in want._fields:
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_serial_tcd_and_coreness_match_reference(seed):
    rng = np.random.default_rng(seed)
    u, v, t = (rng.integers(0, 25, 220), rng.integers(0, 25, 220),
               rng.integers(1, 20, 220))
    jg = JGraph.from_edges(u, v, t)
    jtel, tel = jg.device_tel(), _port_tel(jg, {})
    nv = jg.num_vertices
    warm = rng.random(nv) < 0.9
    for ts, te, k, h, alive in [(1, 19, 2, 1, np.ones(nv, bool)),
                                (3, 12, 3, 1, warm), (2, 17, 2, 2, warm)]:
        want = jtcd_mod.tcd(jtel, jnp.asarray(alive), ts, te, k, h,
                            num_vertices=nv)
        got = ttcd_mod.tcd(tel, torch.from_numpy(alive), ts, te, k, h,
                           num_vertices=nv)
        for f in want._fields:
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f)
    np.testing.assert_array_equal(
        ttcd_mod.coreness(tel, 1, 19, num_vertices=nv, k_max=8).numpy(),
        np.asarray(jtcd_mod.coreness(jtel, 1, 19, num_vertices=nv,
                                     k_max=8)))
    alive = np.ones((3, nv), bool)
    want = jtcd_mod.tcd_batch(jtel, jnp.asarray(alive), jnp.asarray([1, 4, 9]),
                              jnp.asarray([19, 11, 15]), 2, 1,
                              num_vertices=nv)
    got = ttcd_mod.tcd_batch(tel, torch.from_numpy(alive), [1, 4, 9],
                             [19, 11, 15], 2, 1, num_vertices=nv)
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))


def test_wrappers_raise_off_cpu_without_a_kernel():
    """A tensor on a device with no kernel is refused, never sent to the
    plain version."""
    g, caps, nv, _, alive, ts, te, k, h = _case(1001, False)
    meta = _port_tel(g, caps, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tpeel.make_fused_wave_step(meta, nv)
    with pytest.raises(ValueError, match="unsupported device"):
        tsegdeg.banded_segsum(torch.zeros((4, 2), device="meta"),
                              torch.zeros(4, dtype=torch.int32,
                                          device="meta"), 3)


# ------------------------------------------- models of the CUDA kernels
# csrc/wave_peel.cu and csrc/segdeg.cu cannot run here.  The models below
# repeat their decompositions step for step in plain torch (numpy scalars
# for segdeg's float order), so the arithmetic each kernel relies on is
# held to the JAX package on the CPU; tests/test_torch_cuda.py holds the
# kernels themselves to the plain versions on the card.
_I32_MIN = int(np.iinfo(np.int32).min)
_I32_MAX = int(np.iinfo(np.int32).max)
_CLUSTER = 8            # wave_peel.cu: kCluster, blocks per lane


def _slice_vertices(v):
    """wave_peel.cu: slice_vertices, the vertices one block owns."""
    return max(32, (-(-v // _CLUSTER) + 31) // 32 * 32)


def _model_wave_peel(tel, nv, alive, ts, te, k, h):
    """Phases A-C of wave_peel.cu, one lane at a time."""
    bands = tpeel.tel_bands(tel, nv)
    poff, hoff = bands.poff.long(), bands.hoff.long()
    t, src, dst = tel.t.long(), tel.src.long(), tel.dst.long()
    key = tel.pair_id.long() * 2 ** 32 + (t - _I32_MIN)  # sorted: (pair, t)
    nh = int(hoff[-1])
    per = -(-nh // _CLUSTER)          # each block's share of the half-pairs
    w = alive.shape[0]
    fins, los, his, nes, its = [], [], [], [], []
    for lane in range(w):
        t0, t1, kl, hl = (int(x[lane]) for x in (ts, te, k, h))
        # A: each block's half-pairs, their window sub-bands, compacted
        recs = []
        for r in range(_CLUSTER):
            hs = min(r * per, nh)
            he = min(hs + per, nh)
            v = tel.hp_src[hs:he].long()
            p = tel.hp_pair[hs:he].long()
            u = tel.pair_u[p].long()
            o = torch.where(u == v, tel.pair_v[p].long(), u)
            a = torch.searchsorted(key, p * 2 ** 32 + (t0 - _I32_MIN))
            b = torch.searchsorted(key, p * 2 ** 32 + (t1 - _I32_MIN),
                                   right=True)
            assert bool(((a >= poff[p]) & (b <= poff[p + 1])).all())
            cnt = (b - a).clamp(min=0)
            keep = (cnt > 0) | (hl <= 0)
            recs.append((v[keep], o[keep], cnt[keep], a[keep]))
        v, o, cnt, a = (torch.cat(x) for x in zip(*recs))
        # B: Jacobi on the pair graph with the exact h formula; degrees
        # land on the blocks that own slices of _slice_vertices(nv)
        cur, it = alive[lane].clone(), 0
        assert not v.numel() or int(v.max()) < _CLUSTER * _slice_vertices(nv)
        while True:
            act = torch.where(cur[v] & cur[o], cnt, 0) >= hl
            deg = torch.zeros(nv, dtype=torch.long).index_add_(0, v,
                                                               act.long())
            new = cur & (deg >= kl)
            it += 1
            if torch.equal(new, cur):
                break
            cur = new
        # C: kept pairs with both ends alive, once each, plus orphan edges
        live = (cnt > 0) & (v < o) & cur[v] & cur[o]
        first, last = t[a[live]], t[a[live] + cnt[live] - 1]
        e0 = int(poff[-1])
        to = t[e0:]
        orph = (to >= t0) & (to <= t1) & cur[src[e0:]] & cur[dst[e0:]]
        ne = int(cnt[live].sum()) + int(orph.sum())
        lo = min([_I32_MAX] + first.tolist() + to[orph].tolist())
        hi = max([_I32_MIN] + last.tolist() + to[orph].tolist())
        fins.append(cur)
        los.append(lo)
        his.append(hi)
        nes.append(ne)
        its.append(it)
    fin = torch.stack(fins)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32)   # noqa: E731
    return twave.StepResult(fin, twave.pack_alive_u32(fin, num_vertices=nv),
                            i32(los), i32(his), i32(nes), i32(max(its)))


def _jax_steps(g, caps, nv, w_tile, alive, ts, te, k, h):
    jtel = g.device_tel(**caps)
    jargs = tuple(jnp.asarray(x) for x in (alive, ts, te, k, h))
    return (jwave.make_wave_step_fn(jtel, nv, use_kernel=False)(*jargs),
            jwave.make_wave_step_fn(jtel, nv, use_kernel=True,
                                    w_tile=w_tile)(*jargs))


def _hold_model(g, caps, nv, w_tile, alive, ts, te, k, h, ctx):
    tel = _port_tel(g, caps)
    got = _model_wave_peel(tel, nv, torch.from_numpy(alive), ts, te, k, h)
    for want, name in zip(_jax_steps(g, caps, nv, w_tile, alive, ts, te, k,
                                     h), ("composite", "interpret kernel")):
        _assert_steps_equal(got, want, f"model vs jax {name}, {ctx}")


@pytest.mark.parametrize("seed,padded", _SWEEP)
def test_wave_peel_model_matches_jax(seed, padded):
    g, caps, nv, w_tile, alive, ts, te, k, h = _case(seed, padded)
    _hold_model(g, caps, nv, w_tile, alive, ts, te, k, h, seed)


@pytest.mark.parametrize("h_all", [0, 3])
@pytest.mark.parametrize("seed,padded", _SWEEP[::4])
def test_wave_peel_model_h_extremes(seed, padded, h_all):
    """h <= 0 keeps every pair active, dead or not; h = 3 drops pairs with
    1-2 window edges from the degrees but not from n_edges."""
    g, caps, nv, w_tile, alive, ts, te, k, _ = _case(seed, padded)
    h = np.full(ts.shape, h_all, np.int32)
    _hold_model(g, caps, nv, w_tile, alive, ts, te, k, h, (seed, h_all))


def _hub_case(seed, hub_edges):
    """A random graph plus one pair of ``hub_edges`` edges; lanes with
    empty windows and with windows past every edge."""
    rng = np.random.default_rng(seed)
    v, e, tmax = 40, 600, 50
    u, w = rng.integers(0, v, e), rng.integers(0, v, e)
    u = np.concatenate([u, np.full(hub_edges, 3)])
    w = np.concatenate([w, np.full(hub_edges, 17)])
    t = rng.integers(0, tmax, u.size)
    g = JGraph.from_edges(u, w, t, num_vertices=v)
    W = 7
    ts = rng.integers(0, tmax, W).astype(np.int32)
    te = (ts + rng.integers(0, tmax, W)).astype(np.int32)
    ts[0], te[0] = 0, -1                       # pipeline padding lane
    ts[1], te[1] = tmax + 5, tmax + 9          # no edge in the window
    k = rng.integers(1, 6, W).astype(np.int32)
    h = rng.integers(1, 4, W).astype(np.int32)
    h[2] = 0
    alive = rng.random((W, v)) < 0.9
    return g, v, alive, ts, te, k, h


@pytest.mark.parametrize("padded", [False, True])
def test_wave_peel_model_hub_pair_and_empty_windows(padded):
    g, v, alive, ts, te, k, h = _hub_case(7, 4000)
    assert g.num_edges > 4000
    caps, nv = {}, v
    if padded:
        nv = pow2_capacity(v)
        caps = dict(edge_capacity=pow2_capacity(g.num_edges),
                    pair_capacity=pow2_capacity(g.num_pairs),
                    vertex_capacity=nv)
        alive = np.pad(alive, [(0, 0), (0, nv - v)], constant_values=True)
    _hold_model(g, caps, nv, 8, alive, ts, te, k, h, f"hub padded={padded}")


def test_wave_peel_model_counts_padding_edges_in_their_window():
    """A lane whose window starts at int32 min holds the capacity padding's
    sentinel edges: the composite counts them (between vertex 0 and
    itself) in n_edges and the TTI, so the kernel's orphan pass does."""
    g, caps, nv, w_tile, alive, ts, te, k, h = _case(2001, True)
    ts[0], te[0], alive[0, 0] = _I32_MIN, _I32_MAX, True
    k[0] = 0
    _hold_model(g, caps, nv, w_tile, alive, ts, te, k, h, "sentinel window")


def _model_segsum(values, seg, s, tile, threads=256):
    """segdeg.cu step for step: row tiles, chunk walkers, the per-column
    pass over chunks, per-tile shares of crossing runs, and the last
    block's sum of those shares in tile order; sums in float64, rounded
    to float32 once."""
    vals = np.asarray(values, np.float32)
    seg = np.asarray(seg)
    n, q = vals.shape
    off = np.searchsorted(seg, np.arange(s + 1))
    nvalid = int(off[s])
    chunks = max(1, min(32, threads // q))
    tiles = max(1, -(-n // tile))
    out = np.full((s, q), np.nan, np.float32)
    out[off[:-1] == off[1:]] = 0
    part = np.full((tiles, 2, q), np.nan, np.float64)
    f64 = np.float64
    for b in range(tiles):
        r0, r1 = b * tile, min(b * tile + tile, nvalid)
        if r0 >= r1:
            continue
        rows, ln = r1 - r0, -(-(r1 - r0) // chunks)
        from_prev = r0 > 0 and seg[r0 - 1] == seg[r0]
        into_next = r1 < nvalid and seg[r1] == seg[r1 - 1]

        def emit(i, total, c):
            h = from_prev and i == seg[r0]
            t = into_next and i == seg[r1 - 1]
            if not (h or t):
                out[i, c] = total
            if h:
                part[b, 0, c] = total
            if t:
                part[b, 1, c] = total

        for c in range(q):
            pieces = []             # (first id, first sum, last id, sum, multi)
            for g in range(chunks):
                c0, c1 = g * ln, min(rows, g * ln + ln)
                if c0 >= c1:
                    break
                cur, acc, head, multi = seg[r0 + c0], f64(0), f64(0), False
                for i in range(r0 + c0, r0 + c1):
                    if seg[i] != cur:
                        if multi:
                            out[cur, c] = acc
                        else:
                            head, multi = acc, True
                        cur, acc = seg[i], f64(0)
                    acc = f64(acc + vals[i, c])
                pieces.append((seg[r0 + c0], head if multi else acc, cur,
                               acc, multi))
            cid, csum = -1, f64(0)
            for fid, fsum, lid, lsum, multi in pieces:
                if fid == cid:
                    csum = f64(csum + fsum)
                else:
                    if cid >= 0:
                        emit(cid, csum, c)
                    cid, csum = fid, fsum
                if multi:
                    emit(cid, csum, c)
                    cid, csum = lid, lsum
            emit(cid, csum, c)
    for b in range(tiles):
        t0, t1 = b * tile, min(b * tile + tile, nvalid)
        if t0 >= t1:
            continue
        i = seg[t1 - 1]
        if off[i + 1] <= t1 or off[i] < t0:
            continue
        for c in range(q):
            total = part[b, 1, c]
            for u in range(b + 1, (off[i + 1] - 1) // tile + 1):
                total = f64(total + part[u, 0, c])
            out[i, c] = total
    assert not np.isnan(out).any()
    return out


def _segsum_case(n, s, q, seed, hub=0):
    rng = np.random.default_rng(seed)
    segs = rng.integers(0, s + 2, n)          # ids >= s are dropped
    if hub:
        segs = np.concatenate([segs, np.full(hub, s // 2)])
    segs = np.sort(segs).astype(np.int32)
    return segs, ((rng.random((segs.size, q)) < 0.5).astype(np.float32),
                  rng.normal(0, 1, (segs.size, q)).astype(np.float32))


@pytest.mark.parametrize("n,s,q,tile,hub", [
    (1, 1, 1, 1, 0), (100, 7, 3, 8, 0), (1000, 300, 17, 5, 0),
    (513, 129, 4, 64, 0), (2048, 4, 8, 3, 0), (300, 1000, 2, 7, 0),
    (777, 60, 5, 1024, 0), (40, 9, 129, 1, 0), (500, 30, 4, 16, 3000),
])
def test_segsum_model_matches_reference(n, s, q, tile, hub):
    """Runs that cross many tiles (small tiles), empty segments, ids >= S,
    a ragged last tile and a hub run of thousands of rows.

    0/1 values are exact against every reference.  Floats are held within
    rtol=atol=1e-5 to the same sums taken in float64; the float32
    references carry their own rounding error, about 3e-5 on a run of
    3,000 normal values, so they are held to that tolerance only where
    no run is that long."""
    segs, (ones, floats) = _segsum_case(n, s, q, n + s + q, hub)
    k_max = required_k_max(segs, s)
    exact64 = np.zeros((s + 2, q))
    np.add.at(exact64, segs, floats.astype(np.float64))
    exact64 = exact64[:s].astype(np.float32)
    for vals, exact in ((ones, True), (floats, False)):
        got = _model_segsum(vals, segs, s, tile)
        ref = tsegdeg.banded_segsum_ref(torch.from_numpy(vals),
                                        torch.from_numpy(segs), s).numpy()
        jref = np.asarray(jsegsum(jnp.asarray(vals), jnp.asarray(segs), s))
        kern = np.asarray(banded_segsum_pallas(
            jnp.asarray(vals), jnp.asarray(segs), num_segments=s,
            k_max=k_max, interpret=True))
        if exact:
            for want in (ref, jref, kern):
                np.testing.assert_array_equal(got, want)
            continue
        np.testing.assert_allclose(got, exact64, rtol=1e-5, atol=1e-5)
        for want in () if hub else (ref, jref, kern):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_segment_offsets_match_jax_bands():
    segs, _ = _segsum_case(600, 50, 1, 3)
    off = tsegdeg.segment_offsets(torch.from_numpy(segs), 50).numpy()
    from repro.kernels.wave_peel.kernel import segment_bounds
    starts, ends = (np.asarray(x) for x in segment_bounds(segs, 50))
    np.testing.assert_array_equal(off[:-1], starts)
    np.testing.assert_array_equal(off[1:], ends)


def _bad_tel(kind):
    g = planted_cores(seed=5)
    tel = _port_tel(g, {})
    f = {name: getattr(tel, name).clone() for name in tel._fields}
    nv = g.num_vertices
    pid = f["pair_id"]
    if kind == "t unsorted in a band":
        i = int(np.flatnonzero((pid[1:] == pid[:-1]).numpy()
                               & (f["t"][1:] != f["t"][:-1]).numpy())[0])
        f["t"][i], f["t"][i + 1] = f["t"][i + 1].clone(), f["t"][i].clone()
    elif kind == "pair_id unsorted":
        i = int(np.flatnonzero((pid[1:] != pid[:-1]).numpy())[0])
        f["pair_id"][i], f["pair_id"][i + 1] = pid[i + 1].clone(), \
            pid[i].clone()
    elif kind == "pair_u >= V":
        f["pair_u"][0] = nv
    elif kind == "pair_v >= V":
        f["pair_v"][-1] = nv + 3
    elif kind == "edge off its pair":
        f["dst"][0] = (f["dst"][0] + 1) % nv
    elif kind == "half-pair off its pair":
        f["hp_pair"][0] = (f["hp_pair"][0] + 1) % g.num_pairs
    return type(tel)(**f), nv


@pytest.mark.parametrize("kind", [
    "t unsorted in a band", "pair_id unsorted", "pair_u >= V", "pair_v >= V",
    "edge off its pair", "half-pair off its pair"])
def test_wave_peel_rejects_malformed_tel(kind):
    tel, nv = _bad_tel(kind)
    with pytest.raises(ValueError, match="canonical layout"):
        tpeel._check_tel(tel, nv)


@pytest.mark.parametrize("padded", [False, True])
def test_wave_peel_accepts_canonical_tels(padded):
    g, caps, nv, *_ = _case(2003 if padded else 1003, padded)
    tpeel._check_tel(_port_tel(g, caps), nv)
    hub, v, *_ = _hub_case(1, 3000)
    tpeel._check_tel(_port_tel(hub, {}), v)


@pytest.mark.parametrize("ids", [[-1, 0, 0, 2, 3], [0, 2, 1, 3, 3]])
def test_segment_offsets_refuses_negative_or_unsorted_ids(ids):
    seg = torch.tensor(ids, dtype=torch.int32)
    with pytest.raises(ValueError, match="sorted ascending and >= 0"):
        tsegdeg.segment_offsets(seg, 4)


def test_segsum_closure_refuses_another_id_tensor():
    segs, (_, vals) = _segsum_case(300, 20, 3, 5)
    seg = torch.from_numpy(segs)
    fn = tsegdeg.make_banded_segsum(20, seg)
    want = tsegdeg.banded_segsum_ref(torch.from_numpy(vals), seg, 20)
    assert torch.equal(fn(torch.from_numpy(vals), seg), want)
    with pytest.raises(ValueError, match="another"):
        fn(torch.from_numpy(vals), seg.clone())
    unbound = tsegdeg.make_banded_segsum(20)      # takes any id tensor
    assert torch.equal(unbound(torch.from_numpy(vals), seg.clone()), want)


@pytest.mark.parametrize("padded", [False, True])
def test_canonical_step_cost_counts_what_the_kernel_keeps(padded):
    """The wave_peel bound's operation count: per lane, every half-pair
    once, then per iteration the kept half-pairs (a pair with an edge in
    the window, every pair when h <= 0) and the vertices, then the kept
    half-pairs again; its bytes lie below the dense count's."""
    g, v, alive, ts, te, k, h = _hub_case(7, 4000)
    caps, nv = {}, v
    if padded:
        nv = pow2_capacity(v)
        caps = dict(edge_capacity=pow2_capacity(g.num_edges),
                    pair_capacity=pow2_capacity(g.num_pairs),
                    vertex_capacity=nv)
        alive = np.pad(alive, [(0, 0), (0, nv - v)], constant_values=True)
    tel = _port_tel(g, caps)
    bands = tpeel.tel_bands(tel, nv)
    nh = int(bands.hoff[-1])
    pid, t = tel.pair_id.numpy(), tel.t.numpy()
    want, its = 0, []
    for lane in range(ts.size):
        one = [x[lane:lane + 1] for x in (ts, te, k, h)]
        its.append(int(_model_wave_peel(tel, nv, torch.from_numpy(
            alive[lane:lane + 1]), *one).iters))
        inwin = (t >= ts[lane]) & (t <= te[lane]) & (pid < tel.num_pairs)
        kept = nh if h[lane] <= 0 else 2 * np.unique(pid[inwin]).size
        want += nh + its[-1] * (kept + nv) + kept
    cost = tpeel.canonical_step_cost(tel, bands, torch.from_numpy(ts),
                                     torch.from_numpy(te),
                                     torch.from_numpy(h), its, nv)
    assert cost["ops"] == want
    dense = tpeel.fused_step_cost(tel.t.shape[0], tel.num_pairs,
                                  tel.hp_src.shape[0], nv, its)
    assert 2 * ts.size * nv < cost["bytes"] < dense["bytes"]
