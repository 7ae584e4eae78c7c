"""The port's CUDA kernels and engine on the card, against the port's plain
PyTorch versions (which tests/test_torch_wave.py and test_torch_engine.py
hold against the JAX package on the CPU).

Every test here is marked ``cuda`` and skips where torch sees no CUDA
device.  This file imports nothing of JAX, so it also runs where JAX is
not installed: ``python -m pytest -q tests/test_torch_cuda.py`` on the
machine with the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import TCQEngine, TemporalGraph  # noqa: E402
from repro_torch.core.graph import pow2_capacity  # noqa: E402
from repro_torch.core.wave import (make_composite_step,  # noqa: E402
                                   make_wave_step_fn)
from repro_torch.graphs import planted_cores, powerlaw_temporal  # noqa: E402
from repro_torch.kernels.segdeg import ops as segdeg  # noqa: E402
from repro_torch.kernels.wave_peel import ops as peel  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch sees no CUDA device")
    return torch.device("cuda")


def _case(seed, capacity_padding, dev):
    """A fuzz case drawn like tests/test_kernels.py's fused-vs-composite
    sweep: (tel, V, alive, ts, te, k, h) on ``dev``."""
    rng = np.random.default_rng(seed)
    v = int(rng.integers(3, 60))
    e = int(rng.integers(5, 400))
    tmax = int(rng.integers(4, 60))
    u, w = rng.integers(0, v, e), rng.integers(0, v, e)
    keep = u != w
    u, w = u[keep], w[keep]
    if u.size == 0:
        u, w = np.array([0]), np.array([v - 1])
    g = TemporalGraph.from_edges(u, w, rng.integers(0, tmax, u.size),
                                 num_vertices=v)
    nv, caps = g.num_vertices, {}
    if capacity_padding:
        nv = pow2_capacity(g.num_vertices)
        caps = dict(edge_capacity=pow2_capacity(g.num_edges),
                    pair_capacity=pow2_capacity(g.num_pairs),
                    vertex_capacity=nv)
    rng.choice([4, 8])                   # the TPU kernel's w_tile draw
    W = int(rng.integers(1, 12))
    ts = rng.integers(0, tmax, W).astype(np.int32)
    te = (ts + rng.integers(0, tmax, W)).astype(np.int32)
    empty = rng.random(W) < 0.25
    ts[empty], te[empty] = 0, -1
    k = rng.integers(1, 5, W).astype(np.int32)
    h = rng.integers(1, 3, W).astype(np.int32)
    alive = (rng.random((W, nv)) < 0.8 if rng.random() < 0.5
             else np.ones((W, nv), dtype=bool))
    args = tuple(torch.from_numpy(a).to(dev) for a in (alive, ts, te, k, h))
    return g.device_tel(device=dev, **caps), nv, args


def _assert_steps_equal(got, want, ctx):
    for name, x, y in zip(got._fields, got, want):
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
    _assert_steps_equal(type(fused)(*(x.cpu() for x in fused)), cpu,
                        f"card vs CPU {seed}")


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
