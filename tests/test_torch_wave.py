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
