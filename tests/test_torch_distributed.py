"""The port's sharded TCQ pipeline (``repro_torch.core.distributed``,
``launch/mesh.py``, ``TCQEngine``/``TCQService(mesh=)``,
``serve_distributed``) against the JAX package, on the CPU over gloo.

* The shard plan, the combine's byte model and choice, the dry-run
  stand-in and the placements are host-side: held bit for bit to JAX.
* The unit mesh runs in this process (a world of one rank); the JAX
  reference's one-shot engine runs beside it.
* Worlds of 2 and 4 ranks run as spawned processes
  (``tests/_torch_dist_worker.py``), concurrently with the JAX one-shot
  engine on a (2, 4) mesh of 8 host devices in a subprocess; every rank's
  results must agree and equal JAX's one-shot engine, JAX's *plain*
  engine and service (the JAX mesh engine's lane refill raises a
  ``ShardingTypeError`` on this JAX), and ``peel_window``.

Every spawned world has a timeout: a hang fails the test.
"""

import dataclasses
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_dist_worker as W  # noqa: E402
from repro.core import TCQEngine as JEngine  # noqa: E402
from repro.core import TCQService as JService  # noqa: E402
from repro.core import distributed as jdist  # noqa: E402
from repro.core.oracle import peel_window  # noqa: E402
from repro.core.scheduler import choose_combine as jchoose  # noqa: E402
from repro.graphs import planted_cores, powerlaw_temporal  # noqa: E402
from repro_torch.core import ResilienceConfig, TCQEngine, TCQService  # noqa: E402
from repro_torch.core import TemporalGraph as PGraph  # noqa: E402
from repro_torch.core import distributed as pdist  # noqa: E402
from repro_torch.core.scheduler import choose_combine  # noqa: E402
from repro_torch.launch import mesh as pmesh  # noqa: E402
from repro_torch.launch.world import run_world  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TESTS = str(Path(__file__).resolve().parent)
ALL = ("step", "engine", "service", "serve")
# (shape, combine, parts): every mesh with both combines; the extras
# (ladder, kernel rung, fault) and the deadline run where noted
W2 = [((2, 1), "psum", ALL + ("extras", "deadline")),
      ((2, 1), "rs_ag", ("step", "engine", "service")),
      ((1, 2), "psum", ALL),
      ((1, 2), "rs_ag", ALL + ("extras",))]
W4 = [((2, 2), "psum", ("step", "engine", "service")),
      ((2, 2), "rs_ag", ALL + ("extras",)),
      ((1, 4), "psum", ("step", "engine", "service", "serve")),
      ((1, 4), "rs_ag", ("step", "engine", "service"))]
CASES = {f"{s[0]}x{s[1]}-{c}": (n, parts)
         for n, cases in ((2, W2), (4, W4)) for s, c, parts in cases}
WORLD_TIMEOUT_S = 400

_JAX_2X4 = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np, jax
from repro.core.distributed import DistributedTCQ
from repro.graphs import planted_cores
g = planted_cores(seed=3)
mesh = jax.make_mesh((2, 4), ("data", "model"))
out = {}
for combine in ("psum", "rs_ag"):
    eng = DistributedTCQ(g, mesh, combine=combine)
    res = eng.query_wave([1, 5, 10, 1], [40, 30, 20, 15], 3)
    for name, x in zip(("alive", "lo", "hi", "ne"), res[:4]):
        out[f"{combine}_{name}"] = np.asarray(x)
np.savez(sys.argv[1], **out)
"""


def jax_graph_pair(g):
    return g, PGraph.from_state(g.state_dict())


# ------------------------------------------------------------ host side
def _appended(g, seed, rounds):
    rng = np.random.default_rng(seed)
    out = [g]
    for _ in range(rounds):
        n = int(rng.integers(10, 80))
        u, v = rng.integers(0, 60, n), rng.integers(0, 60, n)
        keep = u != v
        out.append(out[-1].add_edges(u[keep], v[keep],
                                     rng.integers(1, 128, n)[keep]))
    return out


_PLAN_FIELDS = ("src", "dst", "t", "pair_local", "hp_src", "hp_pair",
                "bounds")


@pytest.mark.parametrize("m", [1, 2, 4, 8])
@pytest.mark.parametrize("graph", ["powerlaw", "planted"])
def test_shard_plan_build_refresh_matches_jax(graph, m):
    jg = (powerlaw_temporal(60, 400, 64, seed=2) if graph == "powerlaw"
          else planted_cores(seed=4))
    jgs = _appended(jg, 100 + m, 3)
    pgs = [PGraph.from_state(x.state_dict()) for x in jgs]
    jp, pp = jdist.ShardPlan.build(jgs[0], m), pdist.ShardPlan.build(pgs[0],
                                                                     m)

    def same(a, b, ctx):
        for f in _PLAN_FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), (ctx, f)
        assert (a.num_vertices, a.p_cap, a.e_cap, a.epoch) == \
            (b.num_vertices, b.p_cap, b.e_cap, b.epoch), ctx

    same(pp, jp, "build")
    for i, (jx, px) in enumerate(zip(jgs[1:], pgs[1:])):
        assert pp.refresh(px) == jp.refresh(jx)
        same(pp, jp, f"refresh {i}")
    lo, hi = int(jgs[-1].t.min()), int(jgs[-1].t.max())
    ts, te = lo + (hi - lo) // 4, hi - (hi - lo) // 4
    for jx, px in ((jgs[-1], pgs[-1]), (jgs[1], pgs[1])):
        got = pp.window_arrays(px, ts, te) + pp.hp_arrays(px)
        want = jp.window_arrays(jx, ts, te) + jp.hp_arrays(jx)
        for x, y in zip(got, want):
            assert x.dtype == y.dtype and np.array_equal(x, y)


def test_pair_aligned_sharding_invariants():
    g = PGraph.from_state(powerlaw_temporal(80, 600, 50, seed=1)
                          .state_dict())
    for m in (2, 4, 8):
        plan = pdist.shard_graph(g, m)
        assert plan.src.shape[0] == m
        real = plan.t != np.iinfo(np.int32).min
        assert int(real.sum()) == g.num_edges
        assert int(plan.pair_local[real].max()) < plan.num_pairs_shard
        assert plan.num_vertices % (8 * m) == 0
        assert plan.e_cap & (plan.e_cap - 1) == 0
        assert plan.p_cap & (plan.p_cap - 1) == 0
        # both segment-id arrays sorted within every shard: segdeg's input
        for i in range(m):
            assert np.all(np.diff(plan.pair_local[i]) >= 0)
            assert np.all(np.diff(plan.hp_src[i]) >= 0)


def test_combine_bytes_and_choice_match_jax():
    for v in (8, 1000, 24_818, 1 << 20):
        for w in (1, 8, 32, 256):
            for m in (1, 2, 4, 8, 16):
                assert choose_combine(v, w, m) == jchoose(v, w, m)
                for c in ("psum", "rs_ag"):
                    assert pdist.combine_bytes_per_lane_iter(c, v, m) == \
                        jdist.combine_bytes_per_lane_iter(c, v, m)


@pytest.mark.parametrize("cfg", ["tcq-mathoverflow", "tcq-billion"])
def test_abstract_sharded_tel_matches_jax(cfg):
    from repro.configs import get_tcq_config as jcfg
    from repro_torch.configs import get_tcq_config, list_tcq_configs

    assert "tcq-billion" in list_tcq_configs()
    c = get_tcq_config(cfg)
    assert c == type(c)(**jcfg(cfg).__dict__)
    for m in (16, 256):
        got = pdist.abstract_sharded_tel(c.num_vertices, c.num_edges,
                                         c.num_pairs, m)
        want = jdist.abstract_sharded_tel(c.num_vertices, c.num_edges,
                                          c.num_pairs, m)
        for x, y in zip(got[:6], want[:6]):
            assert x.device.type == "meta" and x.dtype == torch.int32
            assert tuple(x.shape) == tuple(y.shape)
        assert got[6:] == want[6:]


@pytest.mark.parametrize("axes", [pmesh.AXES, pmesh.AXES_MULTI_POD])
def test_wave_shardings_match_jax_specs(axes):
    """Placement d of axis a is Shard(0) exactly where JAX's
    PartitionSpec puts a on dim 0."""
    from torch.distributed.tensor import Replicate, Shard

    class FakeMesh:       # the reference only reads axis names
        axis_names = axes

    jmesh = jax.make_mesh((1,) * len(axes), axes)
    want = jdist.wave_shardings(jmesh, 64, 1)
    got = pdist.wave_shardings(FakeMesh, 64, 1)
    assert got.keys() == want.keys()
    for key, sh in want.items():
        dim0 = sh.spec[0] if len(sh.spec) else None
        dim0 = set(dim0) if isinstance(dim0, tuple) else {dim0}
        assert got[key] == tuple(Shard(0) if a in dim0 else Replicate()
                                 for a in axes), key
    assert pmesh.dp_axes(FakeMesh) == tuple(a for a in axes
                                            if a != "model")


def test_mesh_needs_a_process_group_and_engine_a_mesh():
    g = PGraph.from_state(planted_cores(seed=1).state_dict())
    with pytest.raises(TypeError, match="Mesh"):
        TCQEngine(g, device="cpu", mesh=object())
    if not torch.distributed.is_initialized():
        with pytest.raises(RuntimeError, match="process group"):
            pmesh.Mesh((1, 1))
    with pytest.raises(ValueError, match="backend"):
        pmesh.init_world("mpi")


# --------------------------------------------------- worlds: hangs fail
@pytest.fixture()
def tests_on_path(monkeypatch):
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [TESTS] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))


def test_world_that_hangs_fails_within_its_timeout(tests_on_path):
    with pytest.raises(RuntimeError, match="timed out"):
        run_world("time:sleep", 2, args=(120,), timeout_s=5)


def test_world_with_a_failing_rank_fails(tests_on_path):
    with pytest.raises(RuntimeError, match="on purpose"):
        run_world("_torch_dist_worker:fail_on_rank", 2, args=(1,),
                  timeout_s=60)


# ------------------------------------------------------- the unit mesh
@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tests issue many small torch ops; with a thread pool each op
    waits for every pool thread, which crawls when the test workers share
    the host's cores.  One thread, as the spawned ranks use."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def unit_mesh():
    dist = torch.distributed
    started = not dist.is_initialized()
    pmesh.init_world("gloo")
    try:
        yield pmesh.make_host_mesh(1, device="cpu")
    finally:
        if started:
            dist.destroy_process_group()


def test_mesh_computes_on_the_card_unless_told_the_cpu(unit_mesh):
    """Over gloo as over NCCL, a mesh that names no device takes the card
    and raises without one; the CPU only when the caller names it."""
    assert unit_mesh.device == torch.device("cpu")
    if torch.cuda.is_available():
        assert pmesh.Mesh((1, 1)).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pmesh.Mesh((1, 1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pmesh.make_host_mesh(1)


@pytest.fixture(scope="module")
def jax_unit_mesh():
    return jax.make_mesh((1, 1), ("data", "model"))


@pytest.mark.parametrize("combine", ["psum", "rs_ag"])
def test_unit_mesh_step_and_one_shot_match_jax(unit_mesh, jax_unit_mesh,
                                               combine):
    jg, pg = jax_graph_pair(planted_cores(seed=3))
    ts, te = [c[0] for c in W.CELLS], [c[1] for c in W.CELLS]
    want = [np.asarray(x) for x in jdist.DistributedTCQ(
        jg, jax_unit_mesh, combine=combine, use_fused=False).query_wave(
            ts, te, 3)[:4]]
    for use_fused in (None, False):
        got = pdist.DistributedTCQ(pg, unit_mesh, combine=combine,
                                   use_fused=use_fused).query_wave(ts, te, 3)
        for x, y in zip(got[:4], want):
            assert np.array_equal(np.asarray(x), y), use_fused
    plan = pdist.shard_graph(pg, 1)
    step = pdist.make_sharded_step_fn(
        unit_mesh, pdist.rank_arrays(pdist.plan_arrays(plan), unit_mesh),
        num_vertices=plan.num_vertices, p_cap=plan.p_cap, combine=combine,
        donate=False)
    r = step(torch.ones((4, plan.num_vertices), dtype=torch.bool),
             np.array(ts, np.int32), np.array(te, np.int32), 3, 1)
    assert np.array_equal(r.alive.numpy(), want[0])
    for x, y in zip((r.tti_lo, r.tti_hi, r.n_edges), want[1:]):
        assert np.array_equal(x.numpy(), y)
    assert step.bytes_per_lane_iter == 0
    for i, (a, b) in enumerate(W.CELLS):
        em = peel_window(jg, a, b, 3)
        verts = (set(np.concatenate([jg.src[em], jg.dst[em]]).tolist())
                 if em.any() else set())
        assert set(np.flatnonzero(want[0][i]).tolist()) == verts


@pytest.mark.parametrize("combine", ["psum", "rs_ag"])
def test_unit_mesh_engine_matches_jax_plain(unit_mesh, jax_plain, combine):
    """query_batch before and after an ingest epoch; the ladder, the
    kernel rung and an injected kernel failure (which demotes)."""
    e = W._engine_case(unit_mesh, combine, True)
    assert e["plain"]["before"] == jax_plain["before"]
    assert e["plain"]["after"] == jax_plain["after"]
    dist = e["plain"]["distributed"]
    assert {"mesh", "devices", "lane_shards", "model_shards", "combine",
            "pool_runs", "device_steps", "collective_bytes"} <= dist.keys()
    assert dist["combine"] == combine and dist["collective_bytes"] == 0
    assert dist["pool_runs"] >= 1 and dist["device_steps"] >= 1
    for name in ("ladder", "kernel", "fault"):
        assert e[name]["before"] == jax_plain["before"][:3], name
    assert e["ladder"]["events"] == e["kernel"]["events"] == []
    assert e["fault"]["events"] == ["error"]


@pytest.mark.parametrize("resilience", [False, True])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_unit_mesh_counters_equal_the_unsharded_engine(unit_mesh, use_kernel,
                                                       resilience):
    """Every counter but the wall clock and the mesh's own equals the
    unsharded engine's: the same lanes, steps and iterations."""
    pg = PGraph.from_state(powerlaw_temporal(100, 900, 80, seed=7)
                           .state_dict())
    eng = TCQEngine(pg, mesh=unit_mesh, use_kernel=use_kernel,
                    resilience=ResilienceConfig() if resilience else None)
    skip = {"wall_time_s", "collective_bytes", "shard_occupancy"}
    for a, b in zip(eng.query_batch(W.REQS),
                    TCQEngine(pg, device="cpu").query_batch(W.REQS)):
        da, db = dataclasses.asdict(a.stats), dataclasses.asdict(b.stats)
        assert {k: v for k, v in da.items() if k not in skip} == \
            {k: v for k, v in db.items() if k not in skip}
        assert W.digest([a]) == W.digest([b])


def test_unit_mesh_ladder_demotes_and_stays_exact(unit_mesh, jax_plain):
    from repro_torch.core.faultinject import FaultPlan, rung_faults

    pg = PGraph.from_state(powerlaw_temporal(100, 900, 80, seed=7)
                           .state_dict())
    want = jax_plain["before"]
    for rung in ("fused", "composite"):
        eng = TCQEngine(pg, mesh=unit_mesh, use_kernel=True,
                        resilience=ResilienceConfig(
                            rung_wrapper=rung_faults(
                                {rung: FaultPlan(fail_at=(0,))})))
        assert W.digest(eng.query_batch(W.REQS)) == want, rung
        events = eng.resilience_events()
        assert [e["rung"] for e in events] == (
            ["fused"] if rung == "fused" else [])
    eng = TCQEngine(pg, mesh=unit_mesh, use_kernel=True,
                    resilience=ResilienceConfig(
                        tripwire_every=1, rung_wrapper=rung_faults(
                            {"fused": FaultPlan(corrupt_at=(1,))})))
    assert W.digest(eng.query_batch(W.REQS)) == want, "corrupt"
    assert [e["reason"] for e in eng.resilience_events()] == ["divergence"]


def test_unit_mesh_service_matches_jax_plain(unit_mesh, jax_plain):
    """Mid-flight admission and an ingest epoch, as the worlds run it."""
    s = W._service_case(unit_mesh, "psum")
    assert s["tickets"] == jax_plain["service"] and s["epoch"] == 1
    assert all(len(occ) == 1 for occ in s["shard_occupancy"])
    assert set(s["collective_bytes"]) == {0}
    assert s["distributed"]["lane_shards"] == 1


def test_unit_mesh_serve_distributed_matches_jax(unit_mesh, jax_plain):
    s = W._serve_case(unit_mesh, "psum")
    assert s["completed"] == 6 and s["controllers"] == 2
    plain = jax_plain["engine"]
    for (k, h, ts, te), cores in s["tickets"].items():
        assert cores == W.digest([plain.query(k, ts, te, h=h)])[0]


def test_unit_mesh_service_keeps_its_journal(unit_mesh, tmp_path):
    svc = TCQService(PGraph.from_state(planted_cores(seed=1).state_dict()),
                     mesh=unit_mesh, wal_dir=str(tmp_path))
    assert svc.wal is not None          # one rank: the journal is its own
    assert svc.now() > 0


# --------------------------------------------- worlds of 2 and 4 ranks
@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both gloo worlds and JAX's (2, 4) one-shot engine, concurrently."""
    out_npz = str(tmp_path_factory.mktemp("jax2x4") / "ref.npz")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [TESTS, str(ROOT / "src")] + [p for p in env.get(
            "PYTHONPATH", "").split(os.pathsep) if p])
    old = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = env["PYTHONPATH"]
    try:
        with ThreadPoolExecutor(3) as ex:
            jax_run = ex.submit(
                subprocess.run, [sys.executable, "-c", _JAX_2X4, out_npz],
                capture_output=True, text=True, cwd=str(ROOT), env=env,
                timeout=WORLD_TIMEOUT_S)
            runs = {n: ex.submit(run_world,
                                 "_torch_dist_worker:world_checks", n,
                                 args=(cases,), timeout_s=WORLD_TIMEOUT_S)
                    for n, cases in ((2, W2), (4, W4))}
            ranks = {n: f.result() for n, f in runs.items()}
            proc = jax_run.result()
    finally:
        if old is None:
            os.environ.pop("PYTHONPATH", None)
        else:
            os.environ["PYTHONPATH"] = old
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = dict(np.load(out_npz))
    return ranks, ref


@pytest.fixture(scope="module")
def jax_plain():
    """JAX's plain engine and service on the workers' inputs."""
    jg = powerlaw_temporal(100, 900, 80, seed=7)
    eng = JEngine(jg, cache=False)
    before = eng.query_batch(W.REQS)
    eng.update_graph(W.append(jg))
    after = eng.query_batch(W.REQS)
    serial = W.digest([eng.query(3, 20, 36, mode="serial")])

    svc = JService(jg, cache=False)
    rng = np.random.default_rng(0)
    u, v = rng.integers(0, 100, 40), rng.integers(0, 100, 40)
    keep = u != v
    extra = (u[keep], v[keep], rng.integers(1, 90, 40)[keep])
    for r in W.SVC_REQS:
        svc.submit(r)
    fired = []

    def poll(s):
        if not fired:
            fired.append(1)
            s.push_edges(*extra)
            for r in W.LATE:
                s.submit(r)

    out = svc.run_until_idle(poll)
    while svc.pending:
        out += svc.run_until_idle()
    return {"before": W.digest(before), "after": W.digest(after),
            "serial": serial, "service": {t.id: W.digest([t.result])[0] for t in out},
            "engine": JEngine(jg, cache=False)}


def _case(worlds, key):
    n, _ = CASES[key]
    ranks, ref = worlds
    outs = [r[key] for r in ranks[n]]
    return outs, ref


def _rows_equal(got, want, v):
    assert not got[:, v:].any()           # padded vertices never alive
    assert np.array_equal(got[:, :v], want[:, :v])


@pytest.mark.parametrize("key", list(CASES))
def test_world_ranks_agree(worlds, key):
    outs, _ = _case(worlds, key)
    for part in outs[0]:
        if part == "step":
            for o in outs[1:]:
                for x, y in zip(o["step"]["query_wave"],
                                outs[0]["step"]["query_wave"]):
                    assert np.array_equal(x, y)
                for x, y in zip(o["step"]["step"], outs[0]["step"]["step"]):
                    assert np.array_equal(x, y)
        else:
            assert all(o[part] == outs[0][part] for o in outs[1:]), part


@pytest.mark.parametrize("key", list(CASES))
def test_world_step_matches_jax_2x4(worlds, key):
    outs, ref = _case(worlds, key)
    combine = key.split("-")[1]
    v = planted_cores(seed=3).num_vertices
    want = [ref[f"{combine}_{n}"] for n in ("alive", "lo", "hi", "ne")]
    for o in outs:
        alive, lo, hi, ne = o["step"]["query_wave"]
        _rows_equal(alive, want[0], v)
        packed, slo, shi, sne = o["step"]["step"]
        from repro_torch.core.wave import unpack_alive_u32

        _rows_equal(unpack_alive_u32(packed, packed.shape[1] * 32),
                    want[0], v)
        a = o["step"]["step_rows_from"]
        rows = o["step"]["step_alive_rows"]
        _rows_equal(rows, want[0][a:a + rows.shape[0]], v)
        for x, y in ((lo, want[1]), (hi, want[2]), (ne, want[3]),
                     (slo, want[1]), (shi, want[2]), (sne, want[3])):
            assert np.array_equal(x, y)


@pytest.mark.parametrize("key", list(CASES))
def test_world_step_collective_bytes_measured(worlds, key):
    """The bytes each rank hands to the degree combine (Mesh.sent_bytes):
    one f32 [V, W/L] partial per fixpoint iteration of its lane group,
    all-reduced (psum) or reduce-scattered (rs_ag) over ``model``; none
    with one model shard.  Lane groups may stop at different iterations,
    so only a lane-only world pins the count to the world's maximum."""
    outs, _ = _case(worlds, key)
    n, _ = CASES[key]
    shape, combine = key.split("-")
    lanes, m = (int(x) for x in shape.split("x"))
    op, other = (("all_reduce", "reduce_scatter") if combine == "psum"
                 else ("reduce_scatter", "all_reduce"))
    for o in outs:
        s = o["step"]
        unit, got = s["step_partial_bytes"], s["step_sent"][op]
        assert s["step_sent"][other] == 0
        assert (s["step_sent"]["all_gather"] > 0) == (n > 1)
        if m == 1:
            assert got == 0
            continue
        assert got % unit == 0 and 0 < got <= unit * s["step_iters"]
        if lanes == 1:
            assert got == unit * s["step_iters"]


@pytest.mark.parametrize("key", list(CASES))
def test_world_engine_matches_jax_plain(worlds, jax_plain, key):
    outs, _ = _case(worlds, key)
    n, parts = CASES[key]
    for o in outs:
        e = o["engine"]["plain"]
        assert e["before"] == jax_plain["before"]
        assert e["after"] == jax_plain["after"]
        d = e["distributed"]
        shape = tuple(int(x) for x in key.split("-")[0].split("x"))
        assert (d["lane_shards"], d["model_shards"]) == shape
        assert d["devices"] == n and d["backend"] == "gloo"
        assert d["combine"] == key.split("-")[1]
        # the analytic wire model: bytes a lane-iteration x W x iterations
        assert e["bytes"] == e["want_bytes"]
        assert (min(e["bytes"]) > 0) == (shape[1] > 1)
        # edge shards only: no whole TEL on the device, for the graph or
        # any pool's window, until a serial query builds its own
        assert set(e["whole_tel"]) == {shape[1] == 1}
        assert e["serial"] == jax_plain["serial"]


@pytest.mark.parametrize("key", [k for k, (_, p) in CASES.items()
                                 if "extras" in p])
def test_world_ladder_kernel_rung_and_fault(worlds, jax_plain, key):
    outs, _ = _case(worlds, key)
    m = int(key.split("-")[0].split("x")[1])
    want = jax_plain["before"][:3]
    for o in outs:
        e = o["engine"]
        for name in ("ladder", "kernel", "fault"):
            assert e[name]["before"] == want, name
        assert e["ladder"]["events"] == []
        if m == 1:      # the kernel rung, demoted together at call 2
            assert e["kernel"]["events"] == []
            assert e["fault"]["events"] == ["error"]
        else:           # model-sharded: the composite is the path
            assert e["fault"]["events"] == ["multi_shard"]


@pytest.mark.parametrize("key", list(CASES))
def test_world_service_matches_jax_plain(worlds, jax_plain, key):
    outs, _ = _case(worlds, key)
    n, _ = CASES[key]
    lanes = int(key.split("x")[0])
    for o in outs:
        s = o["service"]
        assert s["epoch"] == 1
        assert s["tickets"] == jax_plain["service"]
        assert all(occ is not None and len(occ) == lanes
                   for occ in s["shard_occupancy"])
        m = n // lanes
        assert all((b > 0) == (m > 1) for b in s["collective_bytes"]
                   if b is not None)
        assert s["distributed"]["collective_bytes"] == sum(
            s["collective_bytes"])


@pytest.mark.parametrize("key", [k for k, (_, p) in CASES.items()
                                 if "serve" in p])
def test_world_serve_distributed_matches_jax(worlds, jax_plain, key):
    outs, _ = _case(worlds, key)
    plain = jax_plain["engine"]
    for o in outs:
        s = o["serve"]
        assert s["completed"] == 6 and s["controllers"] == 2
        for (k, h, ts, te), cores in s["tickets"].items():
            assert cores == W.digest([plain.query(k, ts, te, h=h)])[0]


def test_world_deadline_and_shed_on_rank_0s_clock(worlds):
    outs, _ = _case(worlds, "2x1-psum")
    d = outs[0]["deadline"]
    assert d["shed"] > 0 and "timeout" in d["statuses"]
    assert d["journal_refused"]         # the ranks would share one journal
    assert all(o["deadline"] == d for o in outs)
