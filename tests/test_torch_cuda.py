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
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels.segdeg import ops as segdeg  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as scan  # noqa: E402
from repro_torch.kernels.wave_peel import ops as peel  # noqa: E402
from repro_torch.launch.steps import prefill_step, serve_step  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.ssm import mamba_mix  # noqa: E402

pytestmark = pytest.mark.cuda


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
