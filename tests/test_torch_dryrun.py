"""The port's dry run (``launch/{analysis,op_cost,dryrun}.py``, the shape
mesh ``launch/mesh.py::ShapeMesh`` and the kernels' ``meta`` rules)
against the JAX package's pure functions and against live meshes.

The JAX dry run lowers no cell on this JAX (``tests/test_distributed.py::
test_dryrun_smoke_subprocess`` is red), so it is held three ways:

* ``analysis.py``'s ring factors, ``collective_summary`` and
  ``roofline_terms``, given the JAX module's constants, equal the JAX
  module's on tests/test_dryrun_and_cost.py's cases and on seeded random
  op lists;
* the cost counter's FLOPs against the torch twins of that file's scan
  and gradient chain, and a smoke dense train cell's against the
  arithmetic of 6·N·D with remat;
* on gloo worlds (1, 2) and (2, 2), the bytes the shape mesh records for
  each kind of collective, and its layout bytes, equal ``Mesh.sent_bytes``
  and ``Mesh.layout_bytes`` measured live on the same smoke Jamba train
  step, smoke prefill and single-iteration TCQ step, exactly.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import analysis as JA  # noqa: E402
from repro.launch.hlo_cost import Collective as JCollective  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import analysis as PA  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch.mesh import ShapeMesh  # noqa: E402
from repro_torch.launch.op_cost import OpCost  # noqa: E402
from repro_torch.launch.shapes import ShapeCell  # noqa: E402
from repro_torch.launch.world import run_world  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TESTS = str(Path(__file__).resolve().parent)
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")
#: the JAX module's rates in the port's form: one link rate for every
#: group (its ICI), so that the collective term is JAX's
JAX_HW = PA.Hardware(peak_flops=JA.PEAK_FLOPS, hbm_bw=JA.HBM_BW,
                     intra_node_bw=JA.ICI_LINKS * JA.ICI_BW,
                     inter_node_bw=JA.ICI_LINKS * JA.ICI_BW,
                     devices_per_node=1)


# ------------------------------------------------------------ analysis.py
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("g", [1, 2, 4, 16, 256])
def test_ring_factors_equal_jax(kind, g):
    op = PA.CollectiveOp(kind, 1000, g)
    assert op.ring_factor == JA.CollectiveOp(kind, 1000, g).ring_factor
    assert op.ring_factor == JCollective(kind, 1000, g).ring_factor
    assert op.wire_bytes == JA.CollectiveOp(kind, 1000, g).wire_bytes


def test_ring_factor_cases_of_the_jax_tests():
    assert PA.CollectiveOp("all-reduce", 100, 4).ring_factor == \
        pytest.approx(1.5)
    assert PA.CollectiveOp("all-gather", 100, 4).ring_factor == \
        pytest.approx(.75)
    assert PA.CollectiveOp("collective-permute", 100, 4).ring_factor == 1.0
    assert PA.CollectiveOp("all-reduce", 100, 1).ring_factor == 0.0


def _random_ops(seed: int):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 12))
    return [(KINDS[int(rng.integers(len(KINDS)))],
             int(rng.integers(0, 1 << 34)), int(rng.choice([1, 2, 8, 16,
                                                             256])))
            for _ in range(n)]


@pytest.mark.parametrize("seed", range(6))
def test_collective_summary_and_roofline_equal_jax(seed):
    ops = _random_ops(seed)
    rng = np.random.default_rng(100 + seed)
    mine = [PA.CollectiveOp(k, b, g, bool(rng.integers(2)))
            for k, b, g in ops]
    theirs = [JA.CollectiveOp(k, b, g) for k, b, g in ops]
    assert PA.collective_summary(mine) == JA.collective_summary(theirs)
    cost = {"flops": float(rng.uniform(0, 1e16)),
            "bytes accessed": float(rng.uniform(0, 1e13))}
    mf = float(rng.uniform(0, 1e16)) if seed % 2 else 0.0
    assert PA.roofline_terms(cost, mine, mf, hw=JAX_HW) == \
        JA.roofline_terms(cost, theirs, model_flops_per_device=mf)


def test_roofline_terms_case_of_the_jax_tests():
    ops = [PA.CollectiveOp("all-reduce", 8e9, 16)]
    t = PA.roofline_terms({"flops": 1e15, "bytes accessed": 1e12}, ops,
                          model_flops_per_device=5e14, hw=JAX_HW)
    assert t == JA.roofline_terms(
        {"flops": 1e15, "bytes accessed": 1e12},
        [JA.CollectiveOp("all-reduce", 8e9, 16)],
        model_flops_per_device=5e14)
    assert t["t_memory_s"] == pytest.approx(1e12 / 819e9)
    assert t["useful_compute_ratio"] == pytest.approx(0.5)
    assert 0 < t["roofline_fraction"] <= 1.0


def test_h100_terms_pick_the_link_by_node():
    """On the H100 a group inside one node moves at NVLink's rate, one
    that spans nodes at the network's; no TPU number enters."""
    inside = PA.CollectiveOp("all-gather", 9e9, 8, crosses_node=False)
    across = PA.CollectiveOp("all-gather", 9e9, 16, crosses_node=True)
    t = PA.roofline_terms({"flops": 989e12, "bytes accessed": 3.35e12},
                          [inside, across])
    assert t["t_compute_s"] == pytest.approx(1.0)
    assert t["t_memory_s"] == pytest.approx(1.0)
    assert t["t_collective_s"] == pytest.approx(
        inside.wire_bytes / 450e9 + across.wire_bytes / 50e9)


def test_shape_mesh_groups_and_nodes():
    m = ShapeMesh((16, 16), rank=17)
    assert m.coords == {"data": 1, "model": 1}
    assert m.model_group.ranks == tuple(range(16, 32))
    assert m.data_group.ranks == tuple(range(1, 256, 16))
    assert m.model_group.crosses_node and m.data_group.crosses_node
    small = ShapeMesh((1, 8), rank=3)
    assert not small.model_group.crosses_node
    multi = ShapeMesh((2, 16, 16), ("pod", "data", "model"), rank=300)
    assert multi.lane_group.ranks == tuple(range(300 % 16, 512, 16))
    assert multi.group_size(multi.group("pod")) == 2


# ------------------------------------------------------------ op_cost.py
def test_counter_counts_a_loop_n_times():
    """The twin of the JAX scan: 5 trips of [32, 64] @ [64, 64] count
    5·2·32·64·64 FLOPs, each trip because it runs."""
    ws = torch.empty((5, 64, 64), device="meta")
    x = torch.empty((32, 64), device="meta")
    with OpCost() as cost:
        c = x
        for w in ws:
            c = torch.tanh(c @ w)
        c.sum()
    expect = 5 * 2 * 32 * 64 * 64
    assert abs(cost.flops - expect) / expect < 0.01
    # a slice of the stack reads the slice, not the whole stack
    assert cost.bytes < 10 * ws.nbytes


def test_counter_grad_chain():
    """The twin of the JAX gradient chain: forward and backward of three
    [16, 128] @ [128, 128] layers, without the first layer's dx: 8/9."""
    ws = torch.randn((3, 128, 128), requires_grad=True)
    x = torch.randn((16, 128))
    with OpCost() as cost:
        h = x
        for i in range(3):
            h = torch.tanh(h @ ws[i])
        torch.autograd.grad((h ** 2).mean(), ws)
    full = 3 * 3 * 2 * 16 * 128 * 128
    assert 0.85 <= cost.flops / full <= 1.0


def test_counter_charges_kernels_their_bound_bytes():
    """Each kernel's ``meta`` rule computes nothing, counts no launch and
    charges the bytes behind its roofline bound."""
    from repro_torch.kernels.segdeg.ops import banded_segsum
    from repro_torch.kernels.ssm_scan.ops import (scan_forward, ssm_scan,
                                                  ssm_scan_bwd)

    b, s, f = 2, 64, 96
    la = torch.empty((b, s, f), device="meta")
    s0 = torch.empty((b, f), device="meta")
    vals = torch.empty((300, 4), device="meta")
    ids = torch.empty((300,), dtype=torch.int32, device="meta")
    before = (ssm_scan.launches, ssm_scan_bwd.launches,
              banded_segsum.launches)
    with OpCost() as cost:
        out = scan_forward(la, la, s0)
        grads = ssm_scan_bwd(la, out, s0, out)
        seg = banded_segsum(vals, ids, 50)
    assert out.shape == (b, s, f) and out.dtype == torch.float32
    assert [tuple(g.shape) for g in grads] == [(b, s, f), (b, s, f), (b, f)]
    assert tuple(seg.shape) == (50, 4)
    assert (ssm_scan.launches, ssm_scan_bwd.launches,
            banded_segsum.launches) == before
    assert cost.kernels["ssm_scan"] == {
        "calls": 1, "bytes": 4 * (3 * b * s * f + b * f)}
    assert cost.kernels["ssm_scan_bwd"] == {
        "calls": 1, "bytes": 4 * (5 * b * s * f + 2 * b * f)}
    n, q, nseg = 300, 4, 50
    assert cost.kernels["segdeg"] == {
        "calls": 1, "bytes": 4 * n * q + 4 * n + 4 * (nseg + 1)
        + 4 * nseg * q}
    assert cost.op_bytes == 0


def test_wave_peel_meta_rule_charges_the_dense_count():
    from repro_torch.core.graph import DeviceTEL
    from repro_torch.kernels.wave_peel.ops import (fused_step_cost,
                                                   make_fused_wave_step,
                                                   wave_peel)

    e, p, v, w = 500, 120, 64, 3

    def meta(n):
        return torch.empty((n,), dtype=torch.int32, device="meta")

    tel = DeviceTEL(meta(e), meta(e), meta(e), meta(e), meta(p), meta(p),
                    meta(2 * p), meta(2 * p))
    step = make_fused_wave_step(tel, v)
    launches = wave_peel.launches
    alive = torch.empty((w, v), dtype=torch.bool, device="meta")
    with OpCost() as cost:
        r = step(alive, 0, 10, 2, 1)
    assert tuple(r.packed.shape) == (w, 2) and wave_peel.launches == launches
    assert cost.kernels["wave_peel"]["bytes"] == fused_step_cost(
        tel.t.shape[0], tel.num_pairs, tel.hp_src.shape[0], v,
        [0] * w)["bytes"]


def test_smoke_dense_train_cell_flops_band():
    """A smoke dense train step's FLOPs, from the arithmetic of its
    matmuls (N_mm parameters in products, D tokens): at least 6·N_mm·D
    (each product forward once and backward twice), at most
    8·N_mm·D (remat runs every layer's forward a second time) plus the
    attention products' 4 passes; both as multiples of 6·N·D."""
    cfg = get_smoke_config("qwen2-7b")
    cell = ShapeCell("t", 128, 8, "train")
    cost, *_ = DR.lm_cost(cfg, cell, ShapeMesh((1, 1)), n_micro=1)
    d, hd, h, kvh = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    per_layer = d * hd * (2 * h + 2 * kvh) + 3 * d * cfg.d_ff
    n_mm = cfg.n_layers * per_layer + d * cfg.padded_vocab
    tokens = cell.batch * cell.seq
    attn_fwd = cfg.n_layers * cell.batch * 2 * 2 * cell.seq ** 2 * h * hd
    six_nd = 6 * cfg.active_param_count() * tokens
    lo, hi = 6 * n_mm * tokens, 8 * n_mm * tokens + 4 * attn_fwd
    assert lo <= cost.flops <= hi, (lo / six_nd, cost.flops / six_nd,
                                    hi / six_nd)


@pytest.mark.parametrize("arch,shape", [("gemma2-2b", "train_4k"),
                                        ("jamba-1.5-large-398b",
                                         "prefill_32k")])
@pytest.mark.parametrize("multi", [False, True])
def test_rank_0_and_the_last_rank_agree(arch, shape, multi):
    last = 511 if multi else 255
    a = DR.lower_cell(arch, shape, multi, smoke=True, rank=0)
    b = DR.lower_cell(arch, shape, multi, smoke=True, rank=last)
    for key in ("collectives", "sent_bytes", "layout_bytes"):
        assert a[key] == b[key], key
    for key in ("hlo_flops_per_device", "hlo_bytes_per_device", "kernels",
                "t_collective_s"):
        assert a["roofline"][key] == b["roofline"][key], key


@pytest.mark.parametrize("multi", [False, True])
def test_tcq_cell_records_jax_fields(multi):
    rec = DR.lower_tcq_cell("tcq-mathoverflow", multi, "rs_ag")
    last = DR.lower_tcq_cell("tcq-mathoverflow", multi, "rs_ag",
                             rank=511 if multi else 255)
    assert rec["collectives"] == last["collectives"]
    assert rec["roofline"]["hlo_bytes_per_device"] == \
        last["roofline"]["hlo_bytes_per_device"]
    r = rec["roofline"]
    assert r["kernels"]["segdeg"]["calls"] == 2      # one iteration
    assert set(rec["collectives"]) == {"reduce-scatter", "all-gather"}
    assert 0 < r["min_traffic_fraction"] <= 1
    assert rec["chips"] == (512 if multi else 256)


# ------------------------------------------------- against a live mesh
@pytest.fixture(scope="module")
def live_worlds():
    mp = pytest.MonkeyPatch()
    mp.setenv("PYTHONPATH", os.pathsep.join(
        [TESTS] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    try:
        yield {n: run_world("_torch_dist_worker:dryrun_bytes", n,
                            args=(cases,), backend="gloo", timeout_s=300)
               for n, cases in ((2, [((1, 2), "psum"), ((1, 2), "rs_ag")]),
                                (4, [((2, 2), "psum"), ((2, 2), "rs_ag")]))}
    finally:
        mp.undo()


@pytest.mark.parametrize("step", ["train", "prefill", "tcq"])
@pytest.mark.parametrize("n,key", [(2, "1x2-psum"), (2, "1x2-rs_ag"),
                                   (4, "2x2-psum"), (4, "2x2-rs_ag")])
def test_shape_mesh_bytes_equal_a_live_mesh(live_worlds, n, key, step):
    for out in live_worlds[n]:
        live, dry = out[key][step], out[key][f"{step}_dry"]
        assert live == dry, (out["rank"], live, dry)
        assert sum(live[0].values()) > 0


def test_dryrun_smoke_cli():
    """The port's twin of ``test_dryrun_smoke_subprocess``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--smoke",
         "--arch", "gemma2-2b", "--shape", "train_4k,decode_32k",
         "--mesh", "both"], capture_output=True, text=True, timeout=300,
        env=env, cwd=str(ROOT))
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1].endswith("0 failed")
    assert "4 ok" in r.stdout.strip().splitlines()[-1]
