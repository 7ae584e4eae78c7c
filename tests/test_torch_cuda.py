"""The port's CUDA kernels and engine on the card, against the port's plain
PyTorch versions (which tests/test_torch_wave.py and test_torch_engine.py
hold against the JAX package on the CPU).

Every test here is marked ``cuda`` and skips where torch sees no CUDA
device.  This file imports nothing of JAX, so it also runs where JAX is
not installed: ``python -m pytest -q tests/test_torch_cuda.py`` on the
machine with the card.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (PHCIndex, TCQEngine,  # noqa: E402
                              TemporalGraph, iphc_query)
from repro_torch.core.wave import (PEEL_FIELDS,  # noqa: E402
                                   make_composite_step, make_wave_step_fn)
from repro_torch.graphs import planted_cores, powerlaw_temporal  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels.segdeg import ops as segdeg  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as scan  # noqa: E402
from repro_torch.kernels.wave_peel import ops as peel  # noqa: E402
from repro_torch.launch.steps import prefill_step, serve_step  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.ssm import mamba_mix  # noqa: E402

pytestmark = pytest.mark.cuda

# the fuzz cases chip_smoke.py holds the kernels to, from its one copy
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch sees no CUDA device")
    # full float32 products, so f32 models on the card match the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(seed, capacity_padding, dev):
    """A fuzz case drawn like tests/test_kernels.py's fused-vs-composite
    sweep (chip_smoke.fuzz_case): (tel, V, (alive, ts, te, k, h))."""
    tel, nv, *args = chip_smoke.fuzz_case(seed, capacity_padding, dev)
    return tel, nv, tuple(args)


def _assert_steps_equal(got, want, ctx):
    for name in PEEL_FIELDS:
        x, y = getattr(got, name), getattr(want, name)
        assert x.dtype == y.dtype and x.shape == y.shape, (name, ctx)
        assert torch.equal(x, y), (name, ctx)


@pytest.mark.parametrize("seed,padded", [(1000 + s, False) for s in range(6)]
                         + [(2000 + s, True) for s in range(6)])
def test_wave_peel_kernel_matches_plain_step(cuda, seed, padded):
    tel, nv, args = _case(seed, padded, cuda)
    n0 = peel.wave_peel.launches
    fused = make_wave_step_fn(tel, nv, use_kernel=True)(*args)
    assert peel.wave_peel.launches == n0 + 1
    plain = make_composite_step(tel, nv)(*args)
    comp = make_wave_step_fn(tel, nv, use_kernel=False)(*args)
    _assert_steps_equal(fused, plain, f"fused vs plain {seed}")
    _assert_steps_equal(comp, plain, f"composite (segdeg) vs plain {seed}")
    tel_c, nv_c, args_c = _case(seed, padded, "cpu")
    cpu = make_composite_step(tel_c, nv_c)(*args_c)
    on_cpu = type(fused)(*(getattr(fused, f).cpu() for f in PEEL_FIELDS))
    _assert_steps_equal(on_cpu, cpu, f"card vs CPU {seed}")


@pytest.mark.parametrize("n,s,q", [(1, 1, 1), (100, 7, 3), (1000, 300, 17),
                                   (513, 129, 129), (3000, 50, 5)])
def test_segdeg_kernel_matches_plain_version(cuda, n, s, q):
    rng = np.random.default_rng(n)
    seg = torch.from_numpy(np.sort(rng.integers(0, s + 2, n))
                           .astype(np.int32)).to(cuda)   # ids >= s drop
    ones = torch.from_numpy(rng.random((n, q)) < 0.5).to(cuda).float()
    n0 = segdeg.banded_segsum.launches
    got = segdeg.banded_segsum(ones, seg, s)
    assert segdeg.banded_segsum.launches == n0 + 1
    assert torch.equal(got, segdeg.banded_segsum_ref(ones, seg, s))
    floats = torch.from_numpy(rng.normal(0, 1, (n, q))
                              .astype(np.float32)).to(cuda)
    torch.testing.assert_close(segdeg.banded_segsum(floats, seg, s),
                               segdeg.banded_segsum_ref(floats, seg, s),
                               rtol=1e-5, atol=1e-5)


# a seeded graph with an optional hub pair and W lanes of random windows,
# k and h (chip_smoke.random_case): (tel, V, (alive, ts, te, k, h))
_wide_case = chip_smoke.random_case


@pytest.mark.parametrize("h", [0, 3])
@pytest.mark.parametrize("seed,padded", [(1000, False), (1002, False),
                                         (2001, True), (2004, True)])
def test_wave_peel_kernel_h_extremes(cuda, seed, padded, h):
    tel, nv, (alive, ts, te, k, _) = _case(seed, padded, cuda)
    args = (alive, ts, te, k, torch.full_like(ts, h))
    _assert_steps_equal(make_wave_step_fn(tel, nv, use_kernel=True)(*args),
                        make_composite_step(tel, nv)(*args), (seed, h))


@pytest.mark.parametrize("W", [1, 33, 64])
def test_wave_peel_kernel_wide_waves(cuda, W):
    tel, nv, args = _wide_case(W, cuda, v=300, e=3000, tmax=80, W=W)
    _assert_steps_equal(make_wave_step_fn(tel, nv, use_kernel=True)(*args),
                        make_composite_step(tel, nv)(*args), W)


def test_wave_peel_kernel_hub_pair(cuda):
    tel, nv, args = _wide_case(5, cuda, v=500, e=5000, tmax=200, W=8,
                               hub=50_000)
    assert int(tel.pair_id.bincount().max()) >= 50_000
    for donate in (False, True):
        buf = args[0].clone()
        got = make_wave_step_fn(tel, nv, use_kernel=True,
                                donate=donate)(buf, *args[1:])
        want = make_composite_step(tel, nv)(args[0], *args[1:])
        _assert_steps_equal(got, want, f"hub, donate={donate}")
        assert torch.equal(buf, want.alive if donate else args[0])


def test_wave_peel_refuses_more_vertices_than_it_holds(cuda):
    v = peel.max_vertices()
    assert v >= 300_000
    g = TemporalGraph.from_edges([0], [1], [5], num_vertices=v + 1)
    with pytest.raises(ValueError, match="shared"):
        peel.make_fused_wave_step(g.device_tel(device=cuda), v + 1)
    g = TemporalGraph.from_edges([0], [v - 1], [5], num_vertices=v)
    tel = g.device_tel(device=cuda)
    alive = torch.ones((2, v), dtype=torch.bool, device=cuda)
    _assert_steps_equal(
        make_wave_step_fn(tel, v, use_kernel=True)(alive, 0, 9, 1, 1),
        make_composite_step(tel, v)(alive, 0, 9, 1, 1), "largest V")


# ------------------------------- wave_peel's global-memory tier
def _global_step(tel, nv, donate=False):
    step = peel.make_global_wave_step(tel, nv, donate=donate)
    assert step.backend == "fused_global"
    return step


@pytest.mark.parametrize("seed,padded", [(1000 + s, False) for s in range(6)]
                         + [(2000 + s, True) for s in range(6)])
def test_global_tier_matches_plain_step(cuda, seed, padded):
    """Forced at a V both tiers take: bit-identical to the plain step on
    every StepResult field, iters included (empty windows, sentinel
    padding, warm rows), and one launch a step."""
    tel, nv, args = _case(seed, padded, cuda)
    n0 = peel.wave_peel_global.launches
    got = _global_step(tel, nv)(*args)
    assert peel.wave_peel_global.launches == n0 + 1
    _assert_steps_equal(got, make_composite_step(tel, nv)(*args),
                        f"global vs plain {seed}")
    _assert_steps_equal(got, make_wave_step_fn(tel, nv, use_kernel=True)(
        *args), f"global vs wave_peel {seed}")


@pytest.mark.parametrize("h", [0, 1, 2])
@pytest.mark.parametrize("seed", [1000, 2001, 2004])
def test_global_tier_h_and_mixed_k(cuda, seed, h):
    tel, nv, (alive, ts, te, _, _) = _case(seed, seed >= 2000, cuda)
    k = torch.arange(ts.shape[0], dtype=torch.int32, device=cuda) % 5
    args = (alive, ts, te, k, torch.full_like(ts, h))
    _assert_steps_equal(_global_step(tel, nv)(*args),
                        make_composite_step(tel, nv)(*args), (seed, h))


@pytest.mark.parametrize("W", [1, 5, 33])
def test_global_tier_wide_waves_and_hub(cuda, W):
    """Lanes past every edge, empty lanes, h in 0..3, a hub pair of 20,000
    edges whose half-pairs span blocks; donated and not."""
    tel, nv, args = _wide_case(W, cuda, v=500, e=5000, tmax=200, W=W,
                               hub=20_000)
    want = make_composite_step(tel, nv)(*args)
    for donate in (False, True):
        buf = args[0].clone()
        got = _global_step(tel, nv, donate=donate)(buf, *args[1:])
        _assert_steps_equal(got, want, f"W={W}, donate={donate}")
        assert torch.equal(buf, want.alive if donate else args[0])


def test_global_tier_above_the_smem_limit(cuda):
    """V = max_vertices() + 1, lanes with per-lane windows inside the
    engine's union-window TEL (its edges padded to a power of two), warm
    starts from the union window's cores and all-ones rows, h in
    {0, 1, 2}: the tier the default step takes there, equal to the
    composite over segdeg and to the plain step."""
    v = peel.max_vertices() + 1
    g = chip_smoke.boundary_graph(v)
    eng = TCQEngine(g)
    wt = eng._window_tel(100, 300)
    assert wt.step_fn.backend == "fused_global"
    tel = wt.tel
    w = 6
    ts = torch.tensor([100, 120, 150, 200, 301, 0], dtype=torch.int32)
    te = torch.tensor([300, 260, 250, 290, 400, -1], dtype=torch.int32)
    k = torch.tensor([2, 3, 1, 4, 2, 2], dtype=torch.int32)
    h = torch.tensor([1, 2, 0, 1, 1, 1], dtype=torch.int32)
    lanes = [x.to(cuda) for x in (ts, te, k, h)]
    wide = make_composite_step(tel, v)(
        torch.ones((w, v), dtype=torch.bool, device=cuda), 100, 300,
        lanes[2], 1).alive
    comp = make_wave_step_fn(tel, v, use_kernel=False)
    for alive in (wide, torch.ones_like(wide)):
        got = _global_step(tel, v)(alive, *lanes)
        _assert_steps_equal(got, comp(alive, *lanes), "global vs composite")
        _assert_steps_equal(got, make_composite_step(tel, v)(alive, *lanes),
                            "global vs plain")


def test_global_tier_step_does_not_sync(cuda):
    """A step reads nothing on the host: the fixpoint loop runs on the
    card in one launch."""
    tel, nv, args = _wide_case(3, cuda, v=500, e=5000, tmax=200, W=8)
    step = _global_step(tel, nv)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = step(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _assert_steps_equal(got, make_composite_step(tel, nv)(*args), "no sync")


@pytest.mark.parametrize("bad", ["int64 t", "t unsorted in a band"])
def test_global_tier_refuses_malformed_tels(cuda, bad):
    tel, nv, _ = _case(1000, False, cuda)
    if bad == "int64 t":
        tel, match = tel._replace(t=tel.t.long()), "contiguous 1-D int32"
    else:
        pid = tel.pair_id.cpu().numpy()
        i = int(np.flatnonzero(pid[1:] == pid[:-1])[0])
        t = tel.t.clone()
        t[i], t[i + 1] = tel.t[i + 1] + 1, tel.t[i]
        tel, match = tel._replace(t=t), "canonical layout"
    with pytest.raises(ValueError, match=match):
        peel.make_global_wave_step(tel, nv)


def _host_kept(tel, nv, ts, te, h):
    """For each lane, the half-pairs of real vertices whose pair has an
    edge in the lane's window, or all of them where h <= 0."""
    pid = tel.pair_id.cpu().numpy().astype(np.int64)
    t = tel.t.cpu().numpy()
    p = tel.num_pairs
    hp = tel.hp_pair.cpu().numpy()[tel.hp_src.cpu().numpy() < nv]
    out = []
    for a, b, hh in zip(ts.tolist(), te.tolist(), h.tolist()):
        has = np.zeros(p + 1, dtype=bool)
        has[pid[(t >= a) & (t <= b)]] = True
        out.append(hp.size if hh <= 0 else int(has[hp].sum()))
    return out


@pytest.mark.parametrize("h", [0, 1, 2])
@pytest.mark.parametrize("seed,padded", [(1000, False), (1003, False),
                                         (2001, True), (2004, True)])
def test_global_tier_counts_the_half_pairs_it_keeps(cuda, seed, padded, h):
    """``hp_kept`` is, lane by lane, the host's count of the half-pairs
    whose pair has an edge in the lane's window (all of them where
    h <= 0), ``hp_scanned`` the half-pairs of real vertices, and the
    peel is the plain step's; the shared-memory kernel counts nothing."""
    tel, nv, (alive, ts, te, k, _) = _case(seed, padded, cuda)
    hh = torch.full_like(ts, h)
    got = _global_step(tel, nv)(alive, ts, te, k, hh)
    _assert_steps_equal(got, make_composite_step(tel, nv)(alive, ts, te, k,
                                                          hh), (seed, h))
    assert got.hp_kept.dtype == torch.int32
    assert got.hp_kept.tolist() == _host_kept(tel, nv, ts, te, hh)
    assert got.hp_scanned == int((tel.hp_src < nv).sum())
    fused = make_wave_step_fn(tel, nv, use_kernel=True)(alive, ts, te, k, hh)
    assert fused.hp_kept is None and fused.hp_scanned == 0


def test_global_tier_counts_in_query_stats_and_the_recorder(cuda,
                                                            monkeypatch):
    """Above a lowered limit the engine's steps are the global tier: each
    query's ``hp_scanned`` is its lanes' walks of the half-pair table, its
    ``hp_kept`` at most that and above 0; armed, the recorder sums every
    lane of every step; the cores are the CPU port's."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import trace

    g = _serve_graph()
    monkeypatch.setattr(peel, "max_vertices", lambda: 8)
    reqs = [{"k": 3, "ts": 20, "te": 90}, {"k": 2, "ts": 150, "te": 230},
            {"k": 4, "ts": 60, "te": 200}]
    eng = TCQEngine(g)
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        got = eng.query_batch(reqs)
    counts = dict(trace.counters())
    trace.clear()
    want = TCQEngine(g, device="cpu").query_batch(reqs)
    nh = 2 * g.num_pairs
    for a, b in zip(got, want):
        assert _digest(a) == _digest(b)
        st = a.stats
        assert st.hp_scanned == nh * st.cells_evaluated > 0
        assert 0 < st.hp_kept <= st.hp_scanned
        assert b.stats.hp_scanned == b.stats.hp_kept == 0
    steps = got[0].stats.device_steps
    assert counts["wave.hp_scanned"] in {w * nh * steps
                                         for w in (4, 8, 16, 32, 64)}
    assert counts["wave.hp_kept"] == sum(r.stats.hp_kept for r in got)


@pytest.mark.parametrize("q", [1, 3, 4, 5, 64])
def test_segdeg_kernel_long_runs(cuda, q):
    """A run of 50,000 rows (across 49 to 782 row tiles) among short ones
    that end on both sides of most tile edges: exact on 0/1, floats
    within rtol=atol=1e-5 of the same sums in float64 (a float32 sum of
    50,000 values carries its own rounding error above that), and two
    calls equal bit for bit."""
    rng = np.random.default_rng(q)
    s = 3000
    ids = np.sort(np.concatenate([rng.integers(0, s + 2, 20_000),
                                  np.full(50_000, 1234)]))
    seg = torch.from_numpy(ids.astype(np.int32)).to(cuda)
    ones = torch.from_numpy(rng.random((ids.size, q)) < 0.5).to(cuda).float()
    floats = torch.from_numpy(rng.normal(0, 1, (ids.size, q))
                              .astype(np.float32)).to(cuda)
    got = segdeg.banded_segsum(ones, seg, s)
    assert torch.equal(got, segdeg.banded_segsum_ref(ones, seg, s))
    got = segdeg.banded_segsum(floats, seg, s)
    assert torch.equal(got, segdeg.banded_segsum(floats, seg, s))
    want = torch.zeros((s + 1, q), dtype=torch.float64, device=cuda)
    want = want.index_add_(0, seg.clamp(max=s).long(), floats.double())
    torch.testing.assert_close(got, want[:s].float(), rtol=1e-5, atol=1e-5)


def test_segdeg_offsets_held_once_per_id_tensor(cuda):
    rng = np.random.default_rng(4)
    seg = torch.from_numpy(np.sort(rng.integers(0, 60, 900))
                           .astype(np.int32)).to(cuda)
    vals = torch.from_numpy(rng.random((900, 4)) < 0.5).to(cuda).float()
    fn = segdeg.make_banded_segsum(50, seg)
    want = segdeg.banded_segsum_ref(vals, seg, 50)
    assert torch.equal(fn(vals, seg), want)
    with pytest.raises(ValueError, match="another"):
        fn(vals, seg.clone())                          # another id tensor


@pytest.mark.parametrize("ids", [[-1, 0, 0, 2, 3], [0, 2, 1, 3, 3]])
def test_segdeg_refuses_negative_or_unsorted_ids(cuda, ids):
    seg = torch.tensor(ids, dtype=torch.int32, device=cuda)
    vals = torch.ones((len(ids), 4), device=cuda)
    with pytest.raises(ValueError, match="sorted ascending and >= 0"):
        segdeg.banded_segsum(vals, seg, 4)
    with pytest.raises(ValueError, match="sorted ascending and >= 0"):
        segdeg.make_banded_segsum(4, seg)


def test_segdeg_ids_out_of_range_are_skipped(cuda):
    """With offsets that do not fit the ids (a negative id and ids near
    2**30 below off[S]) the kernel gives wrong sums at worst: it writes
    nothing far outside ``out`` (which would fault), and the next call
    on the stream is right."""
    seg = torch.tensor([-5, 1, 1 << 30, (1 << 30) + 1, 2, 2],
                       dtype=torch.int32, device=cuda)
    vals = torch.ones((6, 2), device=cuda)
    off = torch.tensor([0, 1, 2, 6], dtype=torch.int32, device=cuda)
    segdeg.banded_segsum(vals, seg, 3, offsets=off)
    torch.cuda.synchronize()
    good = torch.tensor([0, 1, 2, 2, 5], dtype=torch.int32, device=cuda)
    assert torch.equal(segdeg.banded_segsum(vals[:5], good, 3),
                       torch.tensor([[1.0, 1], [1, 1], [2, 2]], device=cuda))


def test_segdeg_two_streams_at_once(cuda):
    """Launches on two streams that overlap each keep their own ticket, so
    every result is whole and the next launch on either stream is too."""
    rng = np.random.default_rng(6)
    s = 2000
    seg = torch.from_numpy(np.sort(np.concatenate([
        rng.integers(0, s, 200_000), np.full(100_000, 77)]))
        .astype(np.int32)).to(cuda)
    vals = [torch.from_numpy(rng.random((seg.shape[0], 4)) < 0.5)
            .to(cuda).float() for _ in range(2)]
    want = [segdeg.banded_segsum_ref(v, seg, s) for v in vals]
    off = segdeg.segment_offsets(seg, s)
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(20):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(segdeg.banded_segsum(vals[i], seg, s,
                                                    offsets=off))
    torch.cuda.synchronize()
    for i in range(2):
        for got in outs[i]:
            assert torch.equal(got, want[i])
    assert torch.equal(segdeg.banded_segsum(vals[0], seg, s), want[0])


def _negative_t_graph():
    rng = np.random.default_rng(2)
    return TemporalGraph.from_edges(rng.integers(0, 20, 150),
                                    rng.integers(0, 20, 150),
                                    rng.integers(-9, 5, 150))


GRAPHS = {"planted": lambda: planted_cores(seed=7),
          "powerlaw": lambda: powerlaw_temporal(80, 900, 40, seed=4),
          "negative_t": _negative_t_graph}


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("graph", list(GRAPHS))
def test_engine_on_card_matches_cpu_engine(cuda, use_kernel, graph):
    g = GRAPHS[graph]()
    Ts, Te = g.span
    on_card = TCQEngine(g, use_kernel=use_kernel)
    assert on_card.device.type == "cuda"
    on_cpu = TCQEngine(g, device="cpu")
    reqs = [{"k": 2, "ts": Ts, "te": Te}, {"k": 3, "ts": Ts + 3, "te": Te}]
    for mode in ("serial", "wave"):
        got = on_card.query(3, Ts, Te, mode=mode)
        want = on_cpu.query(3, Ts, Te, mode=mode)
        assert got.by_tti().keys() == want.by_tti().keys()
        for key, c in want.by_tti().items():
            assert np.array_equal(got.by_tti()[key].vertices, c.vertices)
            assert got.by_tti()[key].n_edges == c.n_edges
        for f in ("cells_evaluated", "device_steps", "duplicates",
                  "peel_iters"):
            assert getattr(got.stats, f) == getattr(want.stats, f), f
    for got, want in zip(on_card.query_batch(reqs), on_cpu.query_batch(reqs)):
        assert got.by_tti().keys() == want.by_tti().keys()


@pytest.mark.parametrize("seed", [0, 1, 3])
def test_phc_index_on_card_matches_cpu_and_otcd(cuda, seed):
    """The PHC-Index built on the card (the default) equals the CPU
    build bit for bit, with the same TCD calls and peel iterations, and
    launches no kernel; iPHC on it equals OTCD serial and wave."""
    g = planted_cores(seed=seed)
    peel.wave_peel.launches = segdeg.banded_segsum.launches = 0
    on_card = PHCIndex(g, 3, 1, 40)
    assert (peel.wave_peel.launches, segdeg.banded_segsum.launches) == (0, 0)
    on_cpu = PHCIndex(g, 3, 1, 40, device="cpu")
    np.testing.assert_array_equal(on_card.core_time, on_cpu.core_time)
    np.testing.assert_array_equal(on_card.uts, on_cpu.uts)
    assert (on_card.tcd_calls, on_card.peel_iters, on_card.host_syncs) == \
        (on_cpu.tcd_calls, on_cpu.peel_iters, on_cpu.host_syncs)
    got = iphc_query(g, on_card, 3, 1, 40)
    eng = TCQEngine(g)
    for mode in ("serial", "wave"):
        chip_smoke.same_cores(got, eng.query(3, 1, 40, mode=mode), mode)


def test_degree_fn_on_card_runs_serial(cuda):
    """A custom degree runs on the card's tensors, serial even when wave
    mode is asked for: no wave_peel launch, the cache off."""
    from repro_torch.core.tcd import degrees

    seen = set()

    def edge_degree(tel, ea, h, *, num_vertices):
        seen.add(ea.device.type)
        w = ea.to(torch.int32)
        out = torch.zeros(num_vertices, dtype=torch.int32, device=w.device)
        return out.index_add_(0, tel.src, w).index_add_(0, tel.dst, w)

    g = powerlaw_temporal(80, 900, 40, seed=4)
    Ts, Te = g.span
    stock = TCQEngine(g, degrees, cache=True)
    assert stock.device.type == "cuda" and stock.core_cache is None
    custom = TCQEngine(g, edge_degree)
    peel.wave_peel.launches = segdeg.banded_segsum.launches = 0
    got = stock.query(3, Ts, Te, mode="wave")
    mine = custom.query(3, Ts, Te, mode="wave")
    assert (peel.wave_peel.launches, segdeg.banded_segsum.launches) == (0, 0)
    assert seen == {"cuda"}
    chip_smoke.same_cores(got, TCQEngine(g).query(3, Ts, Te, mode="wave"),
                          "stock")
    chip_smoke.same_cores(mine, TCQEngine(g, edge_degree, device="cpu")
                          .query(3, Ts, Te), "custom vs CPU")
    assert mine.stats.window_edges == g.num_edges
    assert mine.by_tti().keys() != got.by_tti().keys()


# ------------------------------------------------------- ssm_scan and LM
@pytest.mark.parametrize("b,s,f,dtype,layout", [
    (1, 1, 1, "float32", "contiguous"),
    (2, 1, 4099, "float32", "contiguous"),        # S = 1 (decode)
    (3, 37, 1000, "float32", "contiguous"),       # F % 256 != 0
    (2, 300, 700, "float32", "strided"),          # non-contiguous inputs
    (2, 64, 513, "bfloat16", "contiguous"),       # cast to f32 first
])
def test_ssm_scan_kernel_matches_plain_version(cuda, b, s, f, dtype,
                                               layout):
    """Tolerance of tests/test_kernels.py's ssm_scan test."""
    rng = np.random.default_rng(b * s + f)
    shape = (b, f, s) if layout == "strided" else (b, s, f)
    la = -np.abs(rng.normal(0.3, 0.5, shape))
    bx = rng.normal(0, 1, shape)
    s0 = rng.normal(0, 1, (b, f))
    la, bx, s0 = (torch.from_numpy(a.astype(np.float32)).to(cuda).to(
        getattr(torch, dtype)) for a in (la, bx, s0))
    if layout == "strided":
        la, bx = la.transpose(1, 2), bx.transpose(1, 2)
        assert not la.is_contiguous()
    n0 = scan.ssm_scan.launches
    got = scan.ssm_scan(la, bx, s0)
    assert scan.ssm_scan.launches == n0 + 1
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, s, f)
    torch.testing.assert_close(got, scan.ssm_scan_ref(la, bx, s0),
                               rtol=1e-5, atol=1e-5)


def test_ssm_scan_rejects_mismatched_shapes(cuda):
    la = torch.zeros((2, 3, 4), device=cuda)
    with pytest.raises(ValueError, match="expected log_a"):
        scan.ssm_scan(la, la[:, :2], torch.zeros((2, 4), device=cuda))
    with pytest.raises(ValueError, match="expected log_a"):
        scan.ssm_scan(la, la, torch.zeros((2, 3), device=cuda))


@pytest.mark.parametrize("b,s,f,s0_zero", [
    (1, 1, 1, False),
    (2, 1, 4099, False),           # S = 1
    (2, 3, 1000, True),            # S = 3, F % 256 != 0, s0 = 0
    (3, 37, 513, False),
    (2, 300, 700, False),
])
def test_ssm_scan_bwd_kernel_matches_plain_version(cuda, b, s, f, s0_zero):
    """The reverse scan's kernel against its plain loop, and both through
    ``ssm_scan``'s autograd: one forward and one backward launch."""
    rng = np.random.default_rng(b * s + f + 7)
    la = -np.abs(rng.normal(0.3, 0.5, (b, s, f)))
    bx = rng.normal(0, 1, (b, s, f))
    s0 = np.zeros((b, f)) if s0_zero else rng.normal(0, 1, (b, f))
    g = rng.normal(0, 1, (b, s, f))
    la, bx, s0, g = (torch.from_numpy(a.astype(np.float32)).to(cuda)
                     for a in (la, bx, s0, g))
    states = scan.ssm_scan_ref(la, bx, s0)
    n0 = scan.ssm_scan_bwd.launches
    got = scan.ssm_scan_bwd(la, states, s0, g)
    assert scan.ssm_scan_bwd.launches == n0 + 1
    want = scan.ssm_scan_bwd_ref(la, states, s0, g)
    for x, w in zip(got, want):
        assert x.dtype == torch.float32 and x.shape == w.shape
        scale = min(1.0, float(w.abs().max()))
        torch.testing.assert_close(x, w, rtol=1e-5, atol=1e-5 * scale)
    ins = [t.clone().requires_grad_(True) for t in (la, bx, s0)]
    n0, n1 = scan.ssm_scan.launches, scan.ssm_scan_bwd.launches
    out = scan.ssm_scan(*ins)
    assert out.grad_fn is not None
    out.backward(g)
    assert (scan.ssm_scan.launches, scan.ssm_scan_bwd.launches) == \
        (n0 + 1, n1 + 1)
    for t, w in zip(ins, want):
        scale = min(1.0, float(w.abs().max()))
        torch.testing.assert_close(t.grad, w, rtol=1e-5, atol=1e-5 * scale)


def test_ssm_scan_bwd_rejects_mismatched_shapes(cuda):
    la = torch.zeros((2, 3, 4), device=cuda)
    with pytest.raises(ValueError, match="expected log_a, states, g"):
        scan.ssm_scan_bwd(la, la[:, :2], torch.zeros((2, 4), device=cuda),
                          la)
    with pytest.raises(ValueError, match="expected log_a, states, g"):
        scan.ssm_scan_bwd(la, la, torch.zeros((2, 3), device=cuda), la)


def _smoke_jamba():
    cfg = get_smoke_config("jamba-1.5-large-398b").scaled(moe=None)
    return cfg, T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def test_mamba_mix_on_card_matches_cpu(cuda):
    cfg, params = _smoke_jamba()
    p = {k: v[0] for k, v in params["dec"]["sub0"]["mixer"].items()}
    m, d = cfg.mamba, cfg.d_model
    di = m.d_inner(d)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(0, 0.5, (2, 19, d)).astype(np.float32))
    st = (torch.from_numpy(rng.normal(0, 0.5, (2, di, m.d_state))
                           .astype(np.float32)),
          torch.from_numpy(rng.normal(0, 0.5, (2, m.d_conv - 1, di))
                           .astype(np.float32)))
    want = mamba_mix(p, x, cfg, st)
    n0 = scan.ssm_scan.launches
    got = mamba_mix({k: v.to(cuda) for k, v in p.items()}, x.to(cuda), cfg,
                    tuple(t.to(cuda) for t in st))
    assert scan.ssm_scan.launches == n0 + 1
    for g, w in ((got[0], want[0]), (got[1][0], want[1][0]),
                 (got[1][1], want[1][1])):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4)


def test_mamba_mix_gradients_on_card_match_cpu(cuda):
    """Every input's and parameter's gradient through mamba_mix: on the
    card through both scan kernels, on the CPU through both plain loops."""
    cfg, params = _smoke_jamba()
    m, d = cfg.mamba, cfg.d_model
    di = m.d_inner(d)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(0, 0.5, (2, 19, d)).astype(np.float32))
    s0 = torch.from_numpy(rng.normal(0, 0.5, (2, di, m.d_state))
                          .astype(np.float32))
    c0 = torch.from_numpy(rng.normal(0, 0.5, (2, m.d_conv - 1, di))
                          .astype(np.float32))
    runs = []
    for dev in ("cpu", cuda):
        p = {k: v[0].to(dev, copy=True).requires_grad_(True)
             for k, v in params["dec"]["sub0"]["mixer"].items()}
        ins = [t.to(dev, copy=True).requires_grad_(True)
               for t in (x, s0, c0)]
        n0 = scan.ssm_scan_bwd.launches
        out, (s1, c1) = mamba_mix(p, ins[0], cfg, (ins[1], ins[2]))
        (out.square().sum() + s1.sum() + c1.sum()).backward()
        assert scan.ssm_scan_bwd.launches - n0 == (0 if dev == "cpu" else 1)
        runs.append({**{k: v.grad.cpu() for k, v in p.items()},
                     **{n: t.grad.cpu() for n, t in zip("xsc", ins)}})
    cpu, card = runs
    for k, w in cpu.items():
        assert float(w.abs().max()) > 0, k
        scale = min(1.0, float(w.abs().max()))
        torch.testing.assert_close(card[k], w, rtol=1e-4, atol=1e-4 * scale,
                                   msg=k)


def test_train_step_on_card_matches_cpu(cuda):
    """One smoke Jamba train step (Mamba, attention, experts; Adafactor):
    loss, gradient norm and every parameter on the card within 1e-4 of
    the CPU; the scans launch 2 x (forward, recompute) and 1 x backward
    per Mamba layer."""
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch.steps import build_train_step

    cfg = get_smoke_config("jamba-1.5-large-398b")
    batch = SyntheticLMData(vocab=cfg.vocab, batch=2, seq=16,
                            seed=1).batch_at(0)
    n_mamba = sum(sp.mixer == "mamba" for sp in cfg.layer_specs())
    runs = []
    for dev in ("cpu", cuda):
        # the same seeded weights, drawn anew: a model on the CPU holds
        # (and trains) the very tensors it is given
        params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        model = T.Transformer(cfg, params, device=dev)
        step, opt = build_train_step(cfg)
        state = opt.init(model.params.tree())
        n0 = (scan.ssm_scan.launches, scan.ssm_scan_bwd.launches)
        state, m = step(model, state, {k: torch.from_numpy(v).to(dev)
                                       for k, v in batch.items()})
        n1 = (scan.ssm_scan.launches, scan.ssm_scan_bwd.launches)
        want = (0, 0) if dev == "cpu" else (2 * n_mamba, n_mamba)
        assert (n1[0] - n0[0], n1[1] - n0[1]) == want
        runs.append((float(m["loss"]), float(m["grad_norm"]),
                     [p.detach().cpu() for p in model.parameters()]))
    (lc, nc, pc), (lg, ng, pg) = runs
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    np.testing.assert_allclose(ng, nc, rtol=1e-4)
    for a, b in zip(pg, pc):
        scale = min(1.0, float(b.abs().max()))
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * scale)


def test_serve_step_on_card_matches_cpu(cuda):
    """Prefill, then teacher-forced decode steps, on the card (one
    ssm_scan launch per Mamba layer and pass) and on the CPU."""
    cfg, params = _smoke_jamba()
    rng = np.random.default_rng(3)
    b, s, n, s_max = 2, 12, 4, 20
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s + n)))
    n_mamba = sum(sp.mixer == "mamba" for sp in cfg.layer_specs())
    runs = []
    for dev in ("cpu", cuda):
        model = T.Transformer(cfg, params, device=dev)
        cache = T.init_cache(cfg, b, s_max, device=dev)
        t = tok.to(dev)
        n0 = scan.ssm_scan.launches
        logits, cache = prefill_step(model, {"tokens": t[:, :s]}, cache)
        nxt = []
        for i in range(n):
            got, cache = serve_step(model, cache, {
                "tokens": t[:, s + i:s + i + 1], "cache_index": s + i})
            nxt.append(got)
        launched = scan.ssm_scan.launches - n0
        assert launched == (0 if dev == "cpu" else n_mamba * (1 + n))
        runs.append((logits.cpu(), torch.cat(nxt, 1).cpu(),
                     {k: {n_: v.cpu() for n_, v in c.items()}
                      for k, c in cache.items()}))
    (lc, tc, cc), (lg, tg, cg) = runs
    torch.testing.assert_close(lg, lc, rtol=1e-4, atol=1e-4)
    assert torch.equal(tg, tc)
    for sub in cc:
        for name in cc[sub]:           # states of 1e-7: atol at their scale
            scale = min(1.0, float(cc[sub][name].abs().max()))
            torch.testing.assert_close(cg[sub][name], cc[sub][name],
                                       rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("arch", chip_smoke.FAMILY_SMOKE)
def test_family_on_card_matches_cpu(cuda, arch):
    """Each family's smoke model (f32; Jamba with its experts): prefill
    and teacher-forced decode logits on the card within 1e-4 of the CPU,
    caches included; only Mamba layers launch a kernel (ssm_scan)."""
    cfg = get_smoke_config(arch)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    b, s, n, s_max = 2, 12, 4, 20
    s_enc = 9 if cfg.encoder_layers else None
    rng = np.random.default_rng(4)
    prompt = chip_smoke.family_batch(cfg, b, s, s_enc, rng, "cpu")
    forced = chip_smoke.family_batch(cfg, b, n, None, rng, "cpu")
    n_mamba = sum(sp.mixer == "mamba" for sp in cfg.layer_specs())
    runs = []
    for dev in ("cpu", cuda):
        model = T.Transformer(cfg, params, device=dev)
        cache = T.init_cache(cfg, b, s_max, dev, s_enc=s_enc)
        n0 = scan.ssm_scan.launches
        logits = [prefill_step(model, {k: v.to(dev) for k, v in
                                       prompt.items()}, cache)[0]]
        with torch.inference_mode():
            for i in range(n):
                step = {k: forced[k][:, i:i + 1].to(dev)
                        for k in ("tokens", "embeds") if k in forced}
                h, _, cache = model({**step, "cache_index": s + i},
                                    mode="decode", cache=cache)
                logits.append(model.logits_from_hidden(h))
        launched = scan.ssm_scan.launches - n0
        assert launched == (0 if dev == "cpu" else n_mamba * (1 + n))
        runs.append((torch.cat(logits, 1).cpu(),
                     {k: {n_: v.cpu() for n_, v in c.items()}
                      for k, c in cache.items()}))
    (lc, cc), (lg, cg) = runs
    scale = min(1.0, float(lc.abs().max()))
    torch.testing.assert_close(lg, lc, rtol=1e-4, atol=1e-4 * scale)
    for sub in cc:
        for name in cc[sub]:
            scale = min(1.0, float(cc[sub][name].abs().max()))
            torch.testing.assert_close(cg[sub][name], cc[sub][name],
                                       rtol=1e-4, atol=1e-4 * scale)


# ------------------------------------------------------ serving on the card
def _serve_graph():
    return powerlaw_temporal(300, 4_000, 400, burst_periods=4, seed=11)


def _serve_reqs(g, n=10):
    rng = np.random.default_rng(3)
    uts = g.unique_ts
    out = []
    for _ in range(n):
        a = int(rng.integers(0, uts.size - 40))
        out.append({"k": int(rng.integers(2, 5)), "ts": int(uts[a]),
                    "te": int(uts[a + 39])})
    return out


def _digest(res):
    return sorted((key, tuple(c.vertices.tolist()), int(c.n_edges))
                  for key, c in res.by_tti().items())


def _service_run(g, reqs, batch=None, **kw):
    from repro_torch.core import TCQService

    svc = TCQService(g, **kw)
    tks = [svc.submit(r) for r in reqs[: len(reqs) // 2]]
    if batch is not None:
        svc.push_edges(*batch)
    tks += [svc.submit(r) for r in reqs[len(reqs) // 2:]]
    svc.run_until_idle()
    return svc, tks


def test_service_on_card_equals_query_batch(cuda):
    from repro_torch.core.wave import DegradationLadder

    g = _serve_graph()
    reqs = _serve_reqs(g)
    rng = np.random.default_rng(4)
    batch = (rng.integers(0, 300, 50), rng.integers(0, 300, 50),
             rng.integers(300, 400, 50))
    peel.wave_peel.launches = segdeg.banded_segsum.launches = 0
    svc, tks = _service_run(g, reqs, batch)
    assert svc.engine.device.type == "cuda"       # the default
    assert peel.wave_peel.launches > 0
    assert segdeg.banded_segsum.launches == 0
    assert not any(isinstance(wt.step_fn, DegradationLadder)
                   for wt in svc.engine._win_cache.values())
    assert svc.engine.resilience_events() == []
    g1 = g.add_edges(*batch)
    for snap, part in ((g, tks[:5]), (g1, tks[5:])):
        want = TCQEngine(snap).query_batch(
            [{"k": t.k, "ts": t.ts, "te": t.te} for t in part])
        for tk, w in zip(part, want):
            assert tk.status == "done" and _digest(tk.result) == _digest(w)
    # the same windows again: the cache serves them without a launch
    peel.wave_peel.launches = 0
    again = [svc.submit(r) for r in reqs[5:]]
    svc.run_until_idle()
    for tk, old in zip(again, tks[5:]):
        assert _digest(tk.result) == _digest(old.result)
    assert all(tk.result.stats.cells_evaluated == 0 for tk in again)
    assert peel.wave_peel.launches == 0


def test_ladder_fault_on_card_raises_and_is_logged(cuda):
    """On the card the ladder replays nothing elsewhere: an injected
    fused failure or a corruption the tripwire sees leaves
    ``run_until_idle`` as an exception, logged once, with no segdeg
    launch; the calls before it equal the healthy run's."""
    from repro_torch.core import (ResilienceConfig, StepDivergence,
                                  TCQService)
    from repro_torch.core.faultinject import (FaultPlan, KernelFault,
                                              rung_faults)

    g = _serve_graph()
    reqs = _serve_reqs(g, 6)
    for plan, every, reason, exc in (
            (FaultPlan(fail_at=(2,)), 0, "error", KernelFault),
            (FaultPlan(corrupt_at=(2,)), 1, "divergence", StepDivergence)):
        cfg = ResilienceConfig(tripwire_every=every,
                               rung_wrapper=rung_faults({"fused": plan}))
        svc = TCQService(g, cache=False, resilience=cfg)
        for r in reqs:
            svc.submit(r)
        segdeg.banded_segsum.launches = 0
        with pytest.raises(exc):
            svc.run_until_idle()
        assert [(e["rung"], e["reason"]) for e in
                svc.engine.resilience_events()] == [("fused", reason)]
        assert segdeg.banded_segsum.launches == 0
    # and with no fault the ladder (tripwire on every call) is invisible
    _, want = _service_run(g, reqs, cache=False)
    svc, got = _service_run(g, reqs, cache=False,
                            resilience=ResilienceConfig(tripwire_every=1))
    assert svc.engine.resilience_events() == []
    for a, b in zip(got, want):
        assert _digest(a.result) == _digest(b.result)


@pytest.mark.parametrize("use_kernel", [None, True])
def test_ladder_over_smem_limit_raises_on_card(cuda, monkeypatch,
                                               use_kernel):
    """Above the shared-memory kernel's limit the ladder on the card holds
    one rung, the global-memory tier, whether asked for by default or by
    ``use_kernel=True``, and logs nothing, since nothing was demoted; its
    answers are the CPU port's, with the tripwire on every call.  Only the
    shared-memory kernel asked for by name raises."""
    from repro_torch.core import ResilienceConfig

    g = _serve_graph()
    monkeypatch.setattr(peel, "max_vertices", lambda: 8)
    tel = g.device_tel(device=cuda)
    with pytest.raises(ValueError, match="V <= 8"):
        peel.make_fused_wave_step(tel, g.num_vertices)
    step = make_wave_step_fn(tel, g.num_vertices, use_kernel=use_kernel,
                             resilience=ResilienceConfig(tripwire_every=1))
    assert step.backend == "fused_global" and len(step.rungs) == 1
    assert step.events == []
    rng = np.random.default_rng(5)
    w, v = 4, g.num_vertices
    ts = rng.integers(0, 300, w).astype(np.int32)
    args = (rng.random((w, v)) < 0.9, ts, ts + 60,
            rng.integers(1, 4, w).astype(np.int32), np.ones(w, np.int32))
    segdeg.banded_segsum.launches = peel.wave_peel.launches = 0
    peel.wave_peel_global.launches = 0
    got = step(*(torch.from_numpy(a).to(cuda) for a in args))
    assert peel.wave_peel_global.launches == 1
    assert segdeg.banded_segsum.launches == peel.wave_peel.launches == 0
    want = make_composite_step(g.device_tel(device="cpu"), v)(
        *(torch.from_numpy(a) for a in args))
    _assert_steps_equal(type(want)(*(getattr(got, f).cpu()
                                      for f in PEEL_FIELDS)), want,
                        "ladder above the limit")
    assert step.events == []                # the tripwire held


def test_wave_peel_limit_equals_its_mirror(cuda):
    """The library's limit (shared memory queried on the card) equals the
    package's mirror of the kernel's arithmetic, which the dry run and the
    CPU tests use."""
    assert peel.max_vertices() == peel.mirror_max_vertices()
    assert peel.vertex_limit(cuda) == peel.max_vertices()


@pytest.mark.parametrize("above", [False, True])
def test_engine_and_service_at_the_smem_limit(cuda, above):
    """V = max_vertices(): the default engine and service take wave_peel;
    V + 1: its global-memory tier, and so does ``use_kernel=True``.  Both
    answer as ``use_kernel=False`` (the composite over segdeg) and the CPU
    port do."""
    from repro_torch.core import TCQService

    v = peel.max_vertices() + int(above)
    g = chip_smoke.boundary_graph(v)
    reqs = chip_smoke.boundary_requests(g, n=4)
    want = [_digest(r) for r in TCQEngine(g, device="cpu").query_batch(reqs)]
    kernels = [peel.wave_peel, peel.wave_peel_global, segdeg.banded_segsum]
    kernel = kernels[int(above)]
    for make in (lambda: TCQEngine(g).query_batch(reqs),
                 lambda: [tk.result for tk in _service_run(g, reqs)[1]],
                 lambda: TCQEngine(g, use_kernel=True).query_batch(reqs)):
        for k in kernels:
            k.launches = 0
        got = make()
        assert kernel.launches > 0
        assert sum(k.launches for k in kernels) == kernel.launches
        assert [_digest(r) for r in got] == want
    segdeg.banded_segsum.launches = 0
    assert [_digest(r) for r in TCQEngine(g, use_kernel=False).query_batch(
        reqs)] == want
    assert segdeg.banded_segsum.launches > 0


def test_recover_on_card(cuda, tmp_path):
    from repro_torch.core import TCQService

    g = _serve_graph()
    reqs = _serve_reqs(g, 6)
    d = str(tmp_path / "wal")
    svc = TCQService(g, wal_dir=d)
    tks = [svc.submit(r) for r in reqs]
    svc.push_edges([0, 1, 2], [3, 4, 5], [390, 391, 392])
    svc.run_until_idle()
    svc.wal.close()
    rec = TCQService.recover(d)
    assert rec.engine.device.type == "cuda" and rec.epoch == 1
    redo = {t.id: t for t in rec.run_until_idle()}
    for tk in tks:
        assert _digest(redo[tk.id].result) == _digest(tk.result)
    rec.wal.close()


# ----------------------------------------------- the sharded pipeline
@pytest.fixture
def nccl_unit_mesh(cuda, tmp_path):
    """A world of one rank over NCCL on the card: the unit mesh."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import Mesh, init_world

    init_world("nccl", init_method=f"file://{tmp_path}/rendezvous", rank=0,
               world_size=1, timeout_s=120)
    try:
        yield Mesh((1, 1), device=cuda)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("use_kernel,combine", [(True, "psum"),
                                                (False, "psum"),
                                                (False, "rs_ag")])
def test_unit_mesh_over_nccl_equals_plain_engine(nccl_unit_mesh, use_kernel,
                                                 combine):
    g = GRAPHS["powerlaw"]()
    Ts, Te = g.span
    reqs = [{"k": 2, "ts": Ts, "te": Te}, {"k": 3, "ts": Ts + 3, "te": Te},
            {"k": 2, "ts": Ts + 5, "te": Te - 5, "h": 2}]
    eng = TCQEngine(g, mesh=nccl_unit_mesh, use_kernel=use_kernel,
                    combine=combine)
    peel.wave_peel.launches = segdeg.banded_segsum.launches = 0
    got = eng.query_batch(reqs)
    assert (peel.wave_peel.launches > 0) == use_kernel
    assert (segdeg.banded_segsum.launches > 0) != use_kernel
    want = TCQEngine(g, use_kernel=use_kernel).query_batch(reqs)
    for a, b in zip(got, want):
        assert _digest(a) == _digest(b)
        assert (a.stats.device_steps, a.stats.peel_iters) == \
            (b.stats.device_steps, b.stats.peel_iters)
    d = eng.stats()["distributed"]
    assert d["backend"] == "nccl" and d["collective_bytes"] == 0


def test_gloo_mesh_without_a_device_computes_on_the_card(cuda, tmp_path):
    """Gloo is how several ranks share the card; a gloo mesh that names no
    device takes the card, and so does its engine."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import Mesh, init_world

    init_world("gloo", init_method=f"file://{tmp_path}/rendezvous", rank=0,
               world_size=1, timeout_s=120)
    try:
        mesh = Mesh((1, 1))
        assert mesh.device.type == "cuda" and mesh.host_staged
        eng = TCQEngine(GRAPHS["powerlaw"](), mesh=mesh)
        assert eng.device == mesh.device
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("use_kernel", [None, True])
def test_unit_mesh_kernel_that_declines_raises(nccl_unit_mesh, monkeypatch,
                                               use_kernel):
    """A unit mesh whose TEL the kernel cannot take runs the sharded
    composite over segdeg and answers as the CPU port does; only the
    kernel asked for by name raises."""
    g = GRAPHS["powerlaw"]()
    monkeypatch.setattr(peel, "max_vertices", lambda: 8)
    eng = TCQEngine(g, mesh=nccl_unit_mesh, use_kernel=use_kernel)
    if use_kernel:
        with pytest.raises(ValueError, match="V <= 8"):
            eng.query(3, *g.span, mode="wave")
        return
    peel.wave_peel.launches = segdeg.banded_segsum.launches = 0
    got = eng.query(3, *g.span, mode="wave")
    assert peel.wave_peel.launches == 0
    assert segdeg.banded_segsum.launches > 0
    assert _digest(got) == _digest(
        TCQEngine(g, device="cpu").query(3, *g.span, mode="wave"))


def test_unit_mesh_above_the_smem_limit(nccl_unit_mesh):
    """V = max_vertices() + 1 on the unit mesh over NCCL: the mesh has no
    global-memory tier, so the composite over segdeg, with the same cores
    as the CPU port and as the mesh-free engine's global tier; the
    shared-memory kernel by name raises."""
    v = peel.max_vertices() + 1
    g = chip_smoke.boundary_graph(v)
    reqs = chip_smoke.boundary_requests(g, n=3)
    eng = TCQEngine(g, mesh=nccl_unit_mesh)
    peel.wave_peel.launches = segdeg.banded_segsum.launches = 0
    peel.wave_peel_global.launches = 0
    got = eng.query_batch(reqs)
    assert peel.wave_peel.launches == peel.wave_peel_global.launches == 0
    assert segdeg.banded_segsum.launches > 0
    want = TCQEngine(g, device="cpu").query_batch(reqs)
    assert [_digest(r) for r in got] == [_digest(r) for r in want]
    solo = TCQEngine(g).query_batch(reqs)
    assert peel.wave_peel_global.launches > 0
    assert [_digest(r) for r in solo] == [_digest(r) for r in want]
    with pytest.raises(ValueError, match="shared memory"):
        TCQEngine(g, mesh=nccl_unit_mesh, use_kernel=True).query_batch(reqs)


def test_gloo_world_sharing_the_card(cuda, monkeypatch):
    """Two gloo ranks on cuda:0, their collectives through host memory:
    (2, 1) on the kernel, (1, 2) on the composite over segdeg."""
    import os

    from repro_torch.launch.world import run_world

    root = str(Path(__file__).resolve().parents[1])
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    g = GRAPHS["powerlaw"]()
    Ts, Te = g.span
    reqs = [{"k": 2, "ts": Ts, "te": Te}, {"k": 3, "ts": Ts + 3, "te": Te}]
    want = [chip_smoke.digest(r)
            for r in TCQEngine(g).query_batch(reqs)]
    outs = run_world("chip_smoke:mesh_rank", 2, args=(
        g.state_dict(), reqs, (((2, 1), "psum"), ((1, 2), "rs_ag")),
        "cuda:0"), backend="gloo", timeout_s=300)
    for o in outs:
        for key, kernel in (("2x1-psum", "wave_peel"),
                            ("1x2-rs_ag", "segdeg")):
            r = o[key]
            assert r["host_staged"] and r["cores"] == want, key
            assert r["launches"][kernel] > 0, key
            assert r["collective_bytes"] == r["want_bytes"], key


# ------------------------------------------------- sharded LM serving
def test_sharded_lm_on_unit_mesh_equals_unsharded(nccl_unit_mesh):
    """The smoke Jamba (with experts) on the unit mesh over NCCL: the
    sharded steps launch ssm_scan once per Mamba layer and pass and give
    the unsharded model's logits and tokens bit for bit."""
    cfg = get_smoke_config("jamba-1.5-large-398b")
    dev = nccl_unit_mesh.device
    out = []
    for mesh in (None, nccl_unit_mesh):
        model = T.Transformer(cfg, generator=torch.Generator(dev)
                              .manual_seed(0), device=None if mesh else dev,
                              mesh=mesh)
        cache = T.init_cache(cfg, 2, 32, None if mesh else dev, mesh=mesh)
        prompt = torch.arange(16, device=dev).reshape(2, 8) % cfg.vocab
        scan.ssm_scan.launches = 0
        last, cache = prefill_step(model, {"tokens": prompt}, cache)
        tok = last[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        toks = [tok]
        for i in range(4):
            tok, cache = serve_step(model, cache, {"tokens": tok,
                                                   "cache_index": 8 + i})
            toks.append(tok)
        n_mamba = sum(sp.mixer == "mamba" for sp in cfg.layer_specs())
        assert scan.ssm_scan.launches == 5 * n_mamba
        out.append((last.cpu(), torch.cat(toks, 1).cpu()))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])


def test_gloo_world_serves_sharded_lm_on_the_card(cuda, monkeypatch):
    """Two gloo ranks on cuda:0 serve the smoke Jamba with experts on
    (1, 2) (chip_smoke.lm_rank): each launches ssm_scan on its channel
    shard and gets the unsharded run's tokens."""
    import os

    from repro_torch.launch.world import run_world

    root = str(Path(__file__).resolve().parents[1])
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    cfg = get_smoke_config("jamba-1.5-large-398b")
    case = ("jamba_moe", cfg, {}, (1, 2), 16, 64, None, 4)
    want = chip_smoke.serve_case(case, dev=cuda)
    outs = run_world("chip_smoke:lm_rank", 2, args=((case,), "cuda:0"),
                     backend="gloo", timeout_s=300)
    n_mamba = want["n_mamba"]
    for (o,) in outs:
        assert o["host_staged"] and o["tokens"] == want["tokens"]
        assert o["launches_prefill"]["ssm_scan"] == n_mamba
        assert o["launches_decode"]["ssm_scan"] == 4 * n_mamba
        assert sum(o["sent"].values()) > 0 and o["layout"] > 0


# ------------------------------------------------ training on a mesh
def test_sharded_train_step_on_unit_mesh_equals_unsharded(nccl_unit_mesh):
    """The smoke Jamba (with experts) trained one step on the unit mesh
    over NCCL: the loss, the gradient norm and every parameter equal the
    mesh-free step's bit for bit (PyTorch's deterministic kernels on: the
    embedding's gradient adds in a fixed order), ssm_scan 4 and
    ssm_scan_bwd 2 per Mamba layer, no collective bytes."""
    from repro_torch.launch.steps import build_train_step

    cfg = get_smoke_config("jamba-1.5-large-398b")
    dev = nccl_unit_mesh.device
    batch = chip_smoke._train_batch(cfg, 2, 16, 1, 0, dev)
    n_mamba = sum(sp.mixer == "mamba" for sp in cfg.layer_specs())
    out = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for mesh in (None, nccl_unit_mesh):
            model = T.Transformer(cfg, generator=torch.Generator(dev)
                                  .manual_seed(0),
                                  device=None if mesh else dev, mesh=mesh)
            step, opt = build_train_step(cfg)
            state = opt.init(model.params.tree(), mesh=mesh,
                             pspecs=model.pspecs)
            scan.ssm_scan.launches = scan.ssm_scan_bwd.launches = 0
            state, m = step(model, state, batch)
            assert scan.ssm_scan.launches == 2 * n_mamba
            assert scan.ssm_scan_bwd.launches == n_mamba
            out.append((m["loss"], m["grad_norm"],
                        [p.detach().clone() for p in model.parameters()]))
    finally:
        torch.use_deterministic_algorithms(False)
    (l0, n0, p0), (l1, n1, p1) = out
    assert torch.equal(l0, l1) and torch.equal(n0, n1)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert sum(nccl_unit_mesh.sent_bytes.values()) == 0


def test_gloo_world_trains_sharded_on_the_card(cuda, monkeypatch, tmp_path):
    """Four gloo ranks on cuda:0 on (2, 2) (chip_smoke.mesh_smoke_rank):
    the smoke Jamba with experts and granite-moe trained one step, each
    gradient and parameter within 1e-4 relative of the unsharded port on
    the card; the Trainer failing, resized onto (1, 4) and resumed within
    1e-5 of an uninterrupted run; the compressed all-reduces of CUDA
    tensors equal to the CPU's.  Every rank launches the scans on its
    channel shard."""
    import os

    from repro_torch.launch.world import run_world

    root = str(Path(__file__).resolve().parents[1])
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    outs = run_world("chip_smoke:mesh_smoke_rank", 4,
                     args=("cuda:0", str(tmp_path)), backend="gloo",
                     timeout_s=600)
    for o in outs:
        jamba = o["jamba-1.5-large-398b"]
        assert jamba["grad_rel"] <= 1e-4 and jamba["param_rel"] <= 1e-4
        assert jamba["launches"]["ssm_scan"] > 0
        assert jamba["launches"]["ssm_scan_bwd"] > 0
        assert o["trainer"]["worst_rel"] <= 1e-5
        assert all(o["compressed"].values())


@pytest.mark.parametrize("kernel", ["ssm_scan", "ssm_scan_bwd"])
def test_scans_at_a_sharded_training_rank_shape(cuda, kernel):
    """Each scan kernel against its plain loop at the shape a rank of
    Jamba's (1, 2) mesh trains on: [2, 2,048, 131,072]."""
    g = torch.Generator(cuda).manual_seed(7)
    shp = (2, 2_048, 131_072)
    la = -torch.rand(shp, generator=g, device=cuda) * 0.1
    bx = torch.randn(shp, generator=g, device=cuda) * 0.1
    s0 = torch.zeros((2, shp[2]), device=cuda)
    if kernel == "ssm_scan":
        chip_smoke.hold_scan(la, bx, s0, "a sharded rank", 1, 1)
    else:
        states = scan.scan_forward(la, bx, s0)
        del bx
        gr = torch.randn(shp, generator=g, device=cuda)
        chip_smoke.hold_scan_bwd(la, states, s0, gr, "a sharded rank")
