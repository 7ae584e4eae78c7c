"""The wave step's capacity rule: the shared-memory wave_peel kernel for a
TEL whose vertex count fits it, the global-memory tier above it; the mesh
paths keep the composite over segdeg above the limit.

On the CPU every step is a plain version, whatever V, so the rule is held
on ``meta`` TELs (the dry run's device, which models the card) with the
kernel's limit monkeypatched low.  Beside it the JAX package's own
decision (its Pallas step above the VMEM budget gives way to the XLA
composite) and the step it leaves, held bit for bit to the port's plain
version on the CPU, which both kernel tiers are held to on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import TCQEngine as JEngine  # noqa: E402
from repro.core import wave as jwave  # noqa: E402
from repro.graphs import powerlaw_temporal  # noqa: E402
from repro_torch.core import TCQEngine, TemporalGraph  # noqa: E402
from repro_torch.core import distributed as pdist  # noqa: E402
from repro_torch.core import wave as twave  # noqa: E402
from repro_torch.core.wave import ResilienceConfig  # noqa: E402
from repro_torch.kernels.wave_peel import ops as tpeel  # noqa: E402
from repro_torch.launch.mesh import ShapeMesh  # noqa: E402
from test_torch_engine import (assert_same_cores,  # noqa: E402
                               assert_same_counters)
from test_torch_wave import _assert_steps_equal, _case, _port_tel  # noqa: E402

# phase 16 of chip_smoke.py draws the tcq-youtube shape with these
ALPHA, BURSTS, SEED = 0.9, 14, 11


def _graph():
    """A small graph drawn as phase 16 draws its own (the port's copy)."""
    ref = powerlaw_temporal(2_000, 12_000, 720, alpha=ALPHA,
                            burst_periods=BURSTS, seed=SEED)
    return TemporalGraph.from_state(ref.state_dict())


def _oracle_stub(tel, num_vertices):
    """The ladders' tripwire oracle copies the TEL to the host, which a
    ``meta`` TEL cannot do: a stand-in that is never called."""
    def step(*args):
        raise AssertionError("the oracle ran")

    step.backend, step.calls = "oracle", 0
    return step


@pytest.fixture
def limited(monkeypatch):
    """(graph, meta TEL, V), with the kernel's limit on ``meta`` set to V
    ("at") or V - 1 ("above") by the test's ``where``."""
    g = _graph()

    def at(where):
        v = g.num_vertices
        monkeypatch.setattr(tpeel, "mirror_max_vertices",
                            lambda: v if where == "at" else v - 1)
        monkeypatch.setattr(twave, "make_oracle_step_fn", _oracle_stub)
        monkeypatch.setattr(pdist, "make_oracle_step_fn", _oracle_stub)
        return g, g.device_tel(device="meta"), v

    return at


def _rule(g, tel, v, fits):
    meta = torch.device("meta")
    assert tpeel.fits(v, meta) == fits and tpeel.fits(v - 1, meta)
    assert tpeel.fits(10 ** 9, "cpu")           # plain versions: no limit
    assert tpeel.wants_kernel(None, v, meta) == fits
    assert tpeel.wants_kernel(True, v, meta)
    assert not tpeel.wants_kernel(False, v, meta)
    assert not tpeel.wants_kernel(None, v, "cpu")
    assert tpeel.wants_kernel(True, v, "cpu")
    assert (tpeel.declined(None, v, meta) is None) == fits
    assert tpeel.declined(True, v, meta) is None
    assert tpeel.declined(None, 10 ** 9, "cpu") is None
    # the single-device dispatchers' tiers
    tier = "fused" if fits else "fused_global"
    assert tpeel.kernel_tier(None, v, meta) == tier
    assert tpeel.kernel_tier(True, v, meta) == tier
    assert tpeel.kernel_tier(False, v, meta) is None
    assert tpeel.kernel_tier(None, v, "cpu") is None
    assert tpeel.kernel_tier(True, 10 ** 9, "cpu") == "fused"
    assert tpeel.kernel_tier(None, v - 1, meta) == "fused"


def _step(g, tel, v, fits):
    tier = "fused" if fits else "fused_global"
    assert twave.make_wave_step_fn(tel, v).backend == tier
    assert twave.make_wave_step_fn(tel, v, use_kernel=False).backend == \
        "composite"
    assert twave.make_wave_step_fn(tel, v, use_kernel=True).backend == tier
    if not fits:     # the shared-memory kernel by name still refuses V
        with pytest.raises(ValueError, match="shared memory"):
            tpeel.make_fused_wave_step(tel, v)
    assert tpeel.make_global_wave_step(tel, v).backend == "fused_global"


def _engine(g, tel, v, fits):
    Ts, Te = g.span
    tier = "fused" if fits else "fused_global"
    for resilience in (None, True):
        eng = TCQEngine(g, device="meta", resilience=resilience)
        for window in ((Ts, Te), (Ts + 40, Te - 40)):
            step = eng._window_tel(*window).step_fn
            assert step.backend == tier
            if resilience:
                assert step.events == []
    for use_kernel, backend in ((True, tier), (False, "composite")):
        step = TCQEngine(g, device="meta",
                         use_kernel=use_kernel)._window_tel(Ts, Te).step_fn
        assert step.backend == backend


def _ladder(g, tel, v, fits):
    tier = "fused" if fits else "fused_global"
    # a meta TEL demotes as CPU tensors do: the tier, then the plain rungs
    step = twave.make_wave_step_fn(tel, v, resilience=ResilienceConfig())
    assert [name for name, _ in step.rungs] == [tier, "composite", "oracle"]
    assert step.backend == tier and step.events == []    # nothing demoted
    step = twave.make_wave_step_fn(tel, v, use_kernel=False,
                                   resilience=ResilienceConfig())
    assert [name for name, _ in step.rungs] == ["composite", "oracle"]
    assert step.events == []


def _sharded(g, tel, v, fits):
    from repro_torch.core.distributed import (ShardPlan, plan_arrays,
                                              rank_arrays)

    for shape in ((1, 1), (2, 1)):
        mesh = ShapeMesh(shape)
        step = pdist.make_sharded_kernel_step(mesh, tel, v)
        assert (step is not None) == fits
        if fits:
            assert step.backend == "fused"
        else:
            with pytest.raises(ValueError, match="shared memory"):
                pdist.make_sharded_kernel_step(mesh, tel, v, use_kernel=True)
        plan = ShardPlan.build(g, 1, vertex_capacity=v)
        ladder = pdist.ShardedDegradationLadder(
            mesh, rank_arrays(plan_arrays(plan), mesh), tel, v,
            p_cap=plan.p_cap, use_kernel=None, config=ResilienceConfig())
        assert ladder.backend == ("fused" if fits else "composite")
        assert [(e["rung"], e["reason"]) for e in ladder.events] == \
            ([] if fits else [("fused", "smem_limit")])
    # a model-sharded mesh logs its own reason, whatever V
    mesh = ShapeMesh((1, 2))
    assert pdist.make_sharded_kernel_step(mesh, tel, v) is None
    plan = ShardPlan.build(g, 2, vertex_capacity=v)
    ladder = pdist.ShardedDegradationLadder(
        mesh, rank_arrays(plan_arrays(plan), mesh), None, v,
        p_cap=plan.p_cap, use_kernel=None, config=ResilienceConfig())
    assert [(e["rung"], e["reason"]) for e in ladder.events] == \
        [("fused", "multi_shard")]


def _service(g, tel, v, fits):
    from repro_torch.core import TCQService

    svc = TCQService(g, device="meta")
    Ts, Te = g.span
    assert svc.engine._window_tel(Ts + 40, Te - 40).step_fn.backend == \
        ("fused" if fits else "fused_global")


_CASES = {"rule": _rule, "step": _step, "engine": _engine,
          "ladder": _ladder, "sharded": _sharded, "service": _service}


@pytest.mark.parametrize("where", ["at", "above"])
@pytest.mark.parametrize("case", list(_CASES))
def test_capacity_rule_on_meta(limited, case, where):
    g, tel, v = limited(where)
    _CASES[case](g, tel, v, where == "at")


def test_mirror_of_the_kernel_limit():
    """The .cu's arithmetic on an H100 (227 KiB a block, 656 static
    bytes): 8 blocks x 46,336 vertex slots; the library's own value is
    held to it on the card (tests/test_torch_cuda.py)."""
    assert tpeel.mirror_max_vertices() == 8 * 46_336 == 370_688
    assert tpeel.vertex_limit("meta") == 370_688
    assert tpeel.vertex_limit("cpu") is None
    assert tpeel.fits(370_688, "meta") and not tpeel.fits(370_689, "meta")


@pytest.mark.parametrize("seed,padded", [(1001, False), (2004, True)])
def test_declined_step_matches_jax_declined_step(seed, padded):
    """JAX's Pallas step refused by its VMEM budget leaves the XLA
    composite (compiled mode: interpret mode skips the budget); its ladder
    logs ``vmem_budget``.  The step the port's rule leaves, the composite
    over the segment sums, gives the same StepResult bit for bit."""
    g, caps, nv, w_tile, alive, ts, te, k, h = _case(seed, padded)
    jtel = g.device_tel(**caps)
    jstep = jwave.make_wave_step_fn(jtel, nv, use_kernel=True,
                                    interpret=False, vmem_budget_bytes=1)
    assert jstep.backend == "xla"
    jladder = jwave.make_wave_step_fn(
        jtel, nv, use_kernel=True,
        resilience=jwave.ResilienceConfig(interpret=False,
                                          vmem_budget_bytes=1))
    assert jladder.backend == "xla"
    assert [e["reason"] for e in jladder.events] == ["vmem_budget"]
    want = jstep(*(jnp.asarray(a) for a in (alive, ts, te, k, h)))
    tel = _port_tel(g, caps)
    step = twave.make_wave_step_fn(tel, nv)       # the CPU: the composite
    assert step.backend == "composite"
    got = step(*(torch.from_numpy(a) for a in (alive, ts, te, k, h)))
    _assert_steps_equal(got, want, f"declined step, seed {seed}")


@pytest.mark.parametrize("mode", ["serial", "wave"])
def test_engine_on_phase16_draw_matches_jax(mode):
    """A small graph drawn with phase 16's alpha, bursts and seed: the
    port's engine on the CPU answers as the JAX engine, cores and counters
    bit for bit, in both modes and through query_batch."""
    ref = powerlaw_temporal(2_000, 12_000, 720, alpha=ALPHA,
                            burst_periods=BURSTS, seed=SEED)
    je = JEngine(ref)
    te = TCQEngine(TemporalGraph.from_state(ref.state_dict()), device="cpu")
    rng = np.random.default_rng(SEED)
    reqs = []
    for _ in range(3):
        ts = int(rng.integers(1, 720 - 20 + 2))
        reqs.append({"k": 3, "ts": ts, "te": ts + 19})
    for r in reqs:
        want = je.query(r["k"], r["ts"], r["te"], mode=mode)
        got = te.query(r["k"], r["ts"], r["te"], mode=mode)
        assert_same_cores(got, want, f"{mode} {r}")
        assert_same_counters(got, want, f"{mode} {r}")
    if mode == "wave":
        for got, want in zip(te.query_batch(reqs), je.query_batch(reqs)):
            assert_same_cores(got, want, "query_batch")
            assert_same_counters(got, want, "query_batch")


def test_global_tier_meta_charges_the_dense_count():
    """On ``meta`` the global-memory tier computes nothing, launches
    nothing and charges the dry run the dense count, as wave_peel does."""
    from repro_torch.launch.op_cost import OpCost

    g = _graph()
    v, w = g.num_vertices, 4
    tel = g.device_tel(device="meta")
    step = tpeel.make_global_wave_step(tel, v)
    launches = tpeel.wave_peel_global.launches
    alive = torch.empty((w, v), dtype=torch.bool, device="meta")
    with OpCost() as cost:
        r = step(alive, 0, 10, 2, 1)
    assert tuple(r.packed.shape) == (w, -(-v // 32))
    assert tpeel.wave_peel_global.launches == launches
    assert cost.kernels["wave_peel_global"]["bytes"] == \
        tpeel.fused_step_cost(tel.t.shape[0], tel.num_pairs,
                              tel.hp_src.shape[0], v, [0] * w)["bytes"]
    assert "wave_peel" not in cost.kernels


@pytest.mark.parametrize("bad", ["device", "dtype", "width", "no lanes",
                                 "donated view"])
def test_global_tier_refuses_what_wave_peel_refuses(bad):
    """The global tier's wrapper takes what wave_peel's takes: a TEL on a
    device with neither a kernel nor a plain version, and a lane buffer of
    another dtype, width or no lanes (or a view, when donated), raise.  The
    TEL's layout and dtypes are held on the card (tests/test_torch_cuda.py),
    where the kernel reads them."""
    from test_torch_wave import _Elsewhere

    g = _graph()
    v = g.num_vertices
    tel = g.device_tel(device="meta")
    if bad == "device":
        with pytest.raises(ValueError, match="unsupported device"):
            tpeel.make_global_wave_step(tel._replace(t=_Elsewhere()), v)
        return
    alive = {"dtype": torch.empty((4, v), dtype=torch.uint8),
             "width": torch.empty((4, v + 1), dtype=torch.bool),
             "no lanes": torch.empty((0, v), dtype=torch.bool),
             "donated view": torch.empty((v, 4), dtype=torch.bool).T,
             }[bad].to("meta")
    step = tpeel.make_global_wave_step(tel, v, donate=bad == "donated view")
    with pytest.raises(ValueError, match="alive must be"):
        step(alive, 0, 10, 2, 1)
