"""The PyTorch port's query engine against the JAX package's.

Both engines get the same graph (the port's built with ``from_state`` from
the reference's ``state_dict``) and must return the same cores — TTI keys,
vertex sets, edge counts — and the same schedule counters
(``cells_evaluated``, ``device_steps``, ``duplicates``, ``peel_iters``) at
the same ``(wave, depth)``, in both modes and both algorithms.  The port
runs on the CPU here (``device="cpu"``: the plain versions of its
kernels); tests/test_torch_cuda.py runs it on the card.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import TCQEngine as JEngine  # noqa: E402
from repro.core.graph import TemporalGraph as JGraph  # noqa: E402
from repro.core.oracle import peel_window  # noqa: E402
from repro.graphs import planted_cores, powerlaw_temporal  # noqa: E402
from repro_torch.core import TCQEngine, TemporalGraph  # noqa: E402
from repro_torch.core import temporal_kcore_query  # noqa: E402
from repro_torch.core.scheduler import QueryState  # noqa: E402
from repro_torch.core.results import QueryStats  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
COUNTERS = ("cells_evaluated", "device_steps", "duplicates", "peel_iters",
            "host_syncs", "bytes_synced", "lane_refills")


def _random_graph(seed, n_v=20, n_e=120, max_t=16, t0=1):
    rng = np.random.default_rng(seed)
    return JGraph.from_edges(rng.integers(0, n_v, n_e),
                             rng.integers(0, n_v, n_e),
                             rng.integers(t0, t0 + max_t, n_e),
                             num_vertices=n_v)


GRAPHS = {
    "planted": lambda: planted_cores(seed=7),
    "powerlaw": lambda: powerlaw_temporal(50, 400, 30, seed=4),
    "random0": lambda: _random_graph(0),
    "random1": lambda: _random_graph(1, n_v=16, n_e=150, max_t=12),
    "negative_t": lambda: _random_graph(2, max_t=14, t0=-9),
}
_engines = {}


def _engines_for(name):
    """(reference engine, port engine on the CPU) for one named graph,
    shared across this module's tests."""
    if name not in _engines:
        g = GRAPHS[name]()
        _engines[name] = (JEngine(g), TCQEngine(
            TemporalGraph.from_state(g.state_dict()), device="cpu"))
    return _engines[name]


def assert_same_cores(got, want, ctx=""):
    bg, bw = got.by_tti(), want.by_tti()
    assert bg.keys() == bw.keys(), ctx
    for key, cw in bw.items():
        assert np.array_equal(bg[key].vertices, cw.vertices), (ctx, key)
        assert bg[key].n_edges == cw.n_edges, (ctx, key)


def assert_same_counters(got, want, ctx=""):
    for f in COUNTERS:
        assert getattr(got.stats, f) == getattr(want.stats, f), (ctx, f)


@pytest.mark.parametrize("mode", ["serial", "wave"])
@pytest.mark.parametrize("algorithm", ["otcd", "tcd"])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_query_matches_reference(name, algorithm, mode):
    je, te = _engines_for(name)
    Ts, Te = je.graph.span
    for k, h in ((2, 1), (3, 2)):
        want = je.query(k, Ts, Te, h=h, algorithm=algorithm, mode=mode)
        got = te.query(k, Ts, Te, h=h, algorithm=algorithm, mode=mode)
        ctx = f"{name} {algorithm} {mode} k={k} h={h}"
        assert_same_cores(got, want, ctx)
        assert_same_counters(got, want, ctx)


@pytest.mark.parametrize("wave,depth", [(1, 1), (3, 1), (5, 3), (16, 2),
                                        ("auto", 2)])
def test_wave_counters_match_reference_at_each_width_and_depth(wave, depth):
    je, te = _engines_for("planted")
    want = je.query(3, 1, 40, mode="wave", wave=wave, depth=depth)
    got = te.query(3, 1, 40, mode="wave", wave=wave, depth=depth)
    assert_same_cores(got, want)
    assert_same_counters(got, want, f"wave={wave} depth={depth}")


@pytest.mark.parametrize("name", ["planted", "powerlaw"])
def test_query_batch_matches_reference(name):
    je, te = _engines_for(name)
    Ts, Te = je.graph.span
    mid = (Ts + Te) // 2
    reqs = [{"k": 2, "ts": Ts, "te": Te}, {"k": 3, "ts": Ts + 2, "te": mid},
            {"k": 2, "ts": mid, "te": Te, "h": 2},
            {"k": 4, "ts": Te + 5, "te": Te + 9}]     # empty window
    wants = je.query_batch(reqs, depth=3)
    gots = te.query_batch(reqs, depth=3)
    for i, (got, want) in enumerate(zip(gots, wants)):
        assert_same_cores(got, want, f"request {i}")
        assert_same_counters(got, want, f"request {i}")
        alone = te.query(reqs[i]["k"], reqs[i]["ts"], reqs[i]["te"],
                         h=reqs[i].get("h", 1), mode="wave")
        assert_same_cores(alone, got, f"request {i} alone")


def test_streaming_update_matches_reference():
    g = planted_cores(seed=2)
    je = JEngine(g)
    te = TCQEngine(TemporalGraph.from_state(g.state_dict()), device="cpu")
    rng = np.random.default_rng(3)
    for _ in range(2):
        n = 60
        batch = (rng.integers(0, 80, n), rng.integers(0, 80, n),
                 rng.integers(1, 50, n))           # new vertices and times
        g = g.add_edges(*batch)
        je.update_graph(g)
        te.update_graph(TemporalGraph.from_state(g.state_dict()))
        assert te.num_vertices == je.num_vertices
        for mode in ("serial", "wave"):
            want = je.query(3, 1, 50, mode=mode)
            got = te.query(3, 1, 50, mode=mode)
            assert_same_cores(got, want, mode)
            assert_same_counters(got, want, mode)
    assert te.stats()["epoch"] == je.stats()["epoch"] == 2
    assert te.retire_epochs([]) == je.retire_epochs([])


def test_warm_start_rows_survive_later_in_place_steps():
    """The lane buffer is peeled in place, so the warm-start row a query
    keeps must be a copy: after the pool drains (the lane having peeled
    later cells over that row), it must still be the core of the cell it
    was taken from."""
    je, te = _engines_for("planted")
    g = te.graph
    uts = g.unique_ts.astype(np.int64)
    pipe, _, _ = te.make_pool(int(uts[0]), int(uts[-1]), wave=2, depth=1)
    states = [QueryState(uts, k, 1, True, QueryStats(), qid=k)
              for k in (2, 3)]
    pipe.run_pool(states, QueryStats())
    for s in states:
        i, j, row = s.best_init
        em = peel_window(je.graph, int(uts[i]), int(uts[j]), s.k)
        want = np.zeros(g.num_vertices, bool)
        want[je.graph.src[em]] = want[je.graph.dst[em]] = True
        np.testing.assert_array_equal(row.numpy(), want)


def test_temporal_kcore_query_matches_reference():
    from repro.core import temporal_kcore_query as jquery

    g = planted_cores(seed=4)
    want = jquery(g, 3, 1, 40, mode="wave")
    got = temporal_kcore_query(TemporalGraph.from_state(g.state_dict()), 3,
                               1, 40, mode="wave", device="cpu")
    assert_same_cores(got, want)


def test_engine_defaults_to_cuda_and_raises_without_it():
    g = TemporalGraph.from_state(planted_cores(seed=1).state_dict())
    if torch.cuda.is_available():
        assert TCQEngine(g).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TCQEngine(g)
        with pytest.raises(RuntimeError, match="CUDA"):
            TCQEngine(g, device="cuda")


@pytest.mark.parametrize("option,value,item", [
    ("mesh", object(), "A11"), ("combine", "psum", "A11")])
def test_options_not_ported_raise(option, value, item):
    """The sharded pipeline (ROADMAP A11) is ported: a mesh must be a
    ``launch.mesh.Mesh`` (tests/test_torch_distributed.py drives real
    ones), and ``combine`` without a mesh is accepted and unused, as in
    the JAX package."""
    g = TemporalGraph.from_state(planted_cores(seed=1).state_dict())
    if option == "mesh":
        with pytest.raises(TypeError, match="launch.mesh.Mesh"):
            TCQEngine(g, device="cpu", **{option: value})
    else:
        eng = TCQEngine(g, device="cpu", **{option: value})
        assert eng.mesh is None and "distributed" not in eng.stats()
    with pytest.raises(ValueError, match="combine"):
        TCQEngine(g, device="cpu", combine="ring")


def _jax_edge_degree(tel, ea, h, *, num_vertices):
    """A custom degree: alive parallel edges per vertex (h unused)."""
    import jax

    w = ea.astype(np.int32)
    return (jax.ops.segment_sum(w, tel.src, num_segments=num_vertices)
            + jax.ops.segment_sum(w, tel.dst, num_segments=num_vertices))


def _torch_edge_degree(tel, ea, h, *, num_vertices):
    """The port's counterpart of :func:`_jax_edge_degree`."""
    w = ea.to(torch.int32)
    out = torch.zeros(num_vertices, dtype=torch.int32, device=w.device)
    return out.index_add_(0, tel.src, w).index_add_(0, tel.dst, w)


def _degree_fn_engines(name):
    g = GRAPHS[name]()
    return (g, JEngine(g, _jax_edge_degree),
            TCQEngine(TemporalGraph.from_state(g.state_dict()),
                      _torch_edge_degree, device="cpu"))


@pytest.mark.parametrize("mode", ["serial", "wave"])
@pytest.mark.parametrize("name", ["planted", "powerlaw"])
def test_degree_fn_query_matches_reference(name, mode):
    """A custom degree peels the same cores in both packages; a wave query
    runs serial on the full TEL (no pool, no window TEL)."""
    g, je, te = _degree_fn_engines(name)
    Ts, Te = g.span
    differs = False
    for k in (3, 5):
        want = je.query(k, Ts, Te, mode=mode)
        got = te.query(k, Ts, Te, mode=mode)
        ctx = f"{name} {mode} k={k}"
        assert_same_cores(got, want, ctx)
        assert_same_counters(got, want, ctx)
        assert got.stats.window_edges == g.num_edges, ctx
        assert got.stats.peel_iters == 0, ctx
        default = _engines_for(name)[0].query(k, Ts, Te)
        differs |= default.by_tti().keys() != got.by_tti().keys()
    assert te.stats()["window_tel"]["misses"] == 0
    assert differs, "the custom degree changed no core: a weak case"


def test_degree_fn_query_batch_and_wrapper_match_reference():
    g, je, te = _degree_fn_engines("powerlaw")
    Ts, Te = g.span
    mid = (Ts + Te) // 2
    reqs = [{"k": 4, "ts": Ts, "te": Te}, {"k": 3, "ts": Ts + 2, "te": mid},
            {"k": 5, "ts": mid, "te": Te, "h": 2},
            {"k": 4, "ts": Te + 5, "te": Te + 9}]     # empty window
    for i, (got, want) in enumerate(zip(te.query_batch(reqs),
                                        je.query_batch(reqs))):
        assert_same_cores(got, want, f"request {i}")
        assert_same_counters(got, want, f"request {i}")
    got = temporal_kcore_query(te.graph, 4, Ts, Te, mode="wave",
                               degree_fn=_torch_edge_degree, device="cpu")
    assert_same_cores(got, je.query(4, Ts, Te))


@pytest.mark.parametrize("mode", ["serial", "wave"])
def test_stock_degrees_as_degree_fn_equal_default_engine(mode):
    from repro_torch.core.tcd import degrees

    je, te = _engines_for("planted")
    custom = TCQEngine(te.graph, degrees, device="cpu", cache=True)
    assert custom.core_cache is None
    for k in (2, 3):
        got = custom.query(k, 1, 40, mode=mode)
        want = te.query(k, 1, 40)
        assert_same_cores(got, want, f"k={k}")
        assert got.stats.cells_evaluated == want.stats.cells_evaluated
        assert_same_cores(got, je.query(k, 1, 40), f"k={k} vs JAX")


@pytest.mark.parametrize("option,value", [("mesh", object()),
                                          ("combine", "psum")])
def test_degree_fn_engine_options_not_ported_raise(option, value):
    from repro_torch.core.tcd import degrees

    g = TemporalGraph.from_state(planted_cores(seed=1).state_dict())
    if option == "mesh":        # a mesh must be a launch.mesh.Mesh
        with pytest.raises(TypeError, match="launch.mesh.Mesh"):
            TCQEngine(g, degrees, device="cpu", **{option: value})
    else:                       # no mesh: combine is accepted and unused
        eng = TCQEngine(g, degrees, device="cpu", **{option: value})
        assert len(eng.query(2, 1, 40, mode="wave")) == \
            len(TCQEngine(g, degrees, device="cpu").query(2, 1, 40))


def _port_sources():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_import_neither_jax_nor_reference(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, n)


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20     # every module was imported
