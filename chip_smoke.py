#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with CUDA, ``nvcc`` and one
card.  It builds the CUDA kernels from ``src/repro_torch/kernels`` (into
``build/kernels/``), then:

1. prints the card's name and power limit (``nvidia-smi``);
2. holds each kernel against its plain PyTorch version on the card:
   ``wave_peel`` bit-identical on all six StepResult fields over a seeded
   fuzz sweep, with h in {0, 3}, W in {1, 33, 64} and a pair of 50,000
   edges; ``segdeg`` exact on 0/1 values and within 1e-5 on floats, with
   a run of 50,000 rows across many row tiles, Q in {1, 3, 4, 5, 64},
   and two calls equal bit for bit; the composite step with segdeg
   closures equal to the fused step; a small graph's cores equal to the
   brute-force oracle; then the capacity rule at wave_peel's limit: on a
   graph of V = ``max_vertices()`` vertices (equal to the package's
   mirror of the kernel's arithmetic) the default engine and
   ``use_kernel=True`` launch wave_peel alone, at V + 1 its global-memory
   tier (``wave_peel_global``) alone, all equal to ``use_kernel=False``
   (the composite over segdeg) and to the CPU port;
3. drives the main path at the published shape of SNAP sx-mathoverflow
   (24,818 vertices, 506,550 temporal edges, 2,350 days): one
   ``query_batch`` of 8 queries (cold, then warm), each query again
   through ``query`` in wave and serial mode, and the batch through the
   composite engine; all must agree.  Each path runs with the launch
   counters set to 0 just before it and read just after, and its counts
   must show it ran through its kernel and no other.  One full-size wave
   step must equal the plain step bit for bit;
4. profiles one more ``query_batch``: device time by kernel and the
   device's busy share;
5. times each kernel at the main path's shapes beside its plain version,
   its roofline bound and (segdeg) one PyTorch library call, and says
   whether segdeg beats ``index_add_`` and wave_peel its plain step.  A
   call's time comes from CUDA events around it (``ms``, which holds the
   wrapper's host work when the host is the slower), the kernel's own
   from ``torch.profiler`` (``device_ms``);
6. serves the Jamba-1.5-Large config at its published widths (layers cut
   72 -> 8, one scan period; experts removed) in bf16 with seeded random
   weights: a prefill of 2 prompts x 2,048 tokens into a 32,768-token
   cache, then 32 greedy decode steps, each path with the launch counters
   zeroed before it and read after it (ssm_scan: one launch per Mamba
   layer, 7 and 7 x 32).  It holds ssm_scan to its plain version on the
   card at the prefill and decode shapes, on the scan inputs those passes
   build, profiles one more prefill and four decode steps, and holds the
   smoke-size model on the card to the same model on the CPU;
7. serves TCQs on the phase-3 graph through ``launch/serve.py``: the
   closed loop (``serve_closed_loop``, concurrency 8, 32 requests, k=12,
   64-day windows) on the full graph, whose throughput is the service's
   capacity; the open loop (``serve_stream``, the same windows arriving
   at half that capacity) starting from the edges before day 2,200 while
   the rest arrive in 4 ``push_edges`` batches, with a write-ahead
   journal; the same windows again after the last ingest (core-cache
   hits, and a fully cached ticket launches nothing); recovery from the
   open loop's journal and from a crash mid-tape (``CrashingWAL``); and
   two chaos runs under the degradation ladder (a fused-kernel failure,
   a silent corruption caught by the tripwire), each of which must raise
   out of the service and be logged once, with no segdeg launch.  Every
   ticket equals a cache-free engine's ``query_batch`` on its pinned
   snapshot; the healthy paths hold no ladder and launch no segdeg;
8. puts the paper's comparison (Fig. 7) on the card, on the phase-3 graph
   and phase 3's first window (64 days at its k): builds the PHC-Index on
   the card against the full TEL (``PHCIndex``; build time, TCD calls,
   peel iterations, host reads, index bytes beside the TEL's), answers the
   window with ``iphc_query`` (Algorithm 1 on the host), with
   ``TCQEngine.query`` in serial and in wave mode, all three equal; holds
   the card's ``core_time`` bit for bit to a CPU build of the same window;
   and runs the window through ``TCQEngine(g, degrees)`` (the stock degree
   passed as a custom ``degree_fn``) in wave mode: equal to the default
   engine, serial (no wave_peel launch), its core cache off.  The build,
   the iPHC query and the ``degree_fn`` query launch no kernel;
9. serves the rest of the LM families in bf16 with seeded weights, each
   at its published widths (``FAMILY_RUNS``): granite-moe-1b-a400m (MoE,
   32 experts top-8), rwkv6-1.6b, whisper-small (1,500 encoder frames,
   a 448-position decoder cache), qwen2-vl-72b cut to 16 layers (patch
   embeddings with M-RoPE positions; each decode step feeds one seeded
   embedding) and Jamba cut to 2 layers with its experts (a Mamba + MoE
   layer): a prefill of 2 prompts, then 32 greedy ``serve_step``s, each
   path with the launch counters zeroed before it and read after it
   (only Jamba's Mamba layers launch a kernel: ssm_scan 2 and 64); every
   logit finite and every token below the vocabulary; RWKV's 64-token
   chunk held to 64 single-token steps at full width; and each family's
   smoke-size model on the card held to the CPU;
10. trains on the card, in the order (b), (c), (a), (d): (a) the reverse
   scan's kernel (``ssm_scan_bwd``) held to its plain loop at ragged
   shapes and at the training shape [2, 2,048, 262,144], and timed there;
   (b) the smoke Jamba (with experts), MoE and dense configs in f32 on
   the card against the CPU: ``loss_fn``, every gradient, and every
   parameter after one ``build_train_step`` step; (c) phase 6's Jamba at
   published widths trained in bf16 with Adafactor: a gradient pass
   (every gradient finite, every Mamba layer's in_proj, x_dbc and A_log
   gradient non-zero), 3 steps on 2 x 2,048 tokens, each with the launch
   counters zeroed (ssm_scan 14 and ssm_scan_bwd 7 a step), then a
   profiled 4th: step seconds, tokens/s, model-FLOP utilisation, peak
   memory, busy share and the scans' device time; (d) the ``Trainer`` on
   examples/train_lm.py's ``--full`` config: 24 steps, a checkpoint every
   6, a failure at step 15, every logged loss within 1e-5 relative of an
   uninterrupted run's, and a bf16 tree through ``CheckpointManager``
   bit for bit;
11. (run after phase 8) the sharded TCQ pipeline on phase 3's graph and
   queries: (a) the unit mesh, one rank over NCCL, through
   ``TCQEngine(g, mesh=)`` on the kernel rung (wave_peel) and on the
   composite with psum and with rs_ag (segdeg), cold then warm, each
   equal to phase 3 in cores, TTIs, edge counts and every counter, with
   no collective bytes; (b) ``TCQService(mesh=)`` draining phase 7's
   first 24 windows, every ticket equal to the unsharded service's, and
   ``serve_distributed`` with them arriving at half phase 7's closed-loop
   throughput; (c) worlds of 2 and 4 gloo ranks sharing the card through
   host memory (``launch/world.py``): (data, model) = (2, 1) on the
   kernel, (1, 2) with psum and rs_ag, (2, 2) with rs_ag, every rank
   equal to phase 3 and its collective bytes equal to the analytic
   model.  A rank that fails or outlives its timeout fails the phase;
12. (run after phase 9) serves the LM families sharded
   (``Transformer(cfg, mesh=)``, ``init_cache(..., mesh=)``, the sharded
   ``prefill_step``/``serve_step``), each from phase 6's or 9's seed and
   prompt: (a) phase 6's Jamba on the unit mesh over NCCL, 8 greedy
   steps, its tokens equal to phase 6's bit for bit; (b) the same on
   (data, model) = (1, 2), two gloo ranks sharing the card through host
   memory (heads, FFN and Mamba channels split, the 32,768-position cache
   split by sequence, ssm_scan on each rank's [2, 2,048, 131,072]); (c)
   phase 9's Jamba with experts (2 layers, 8 experts a rank) on (1, 2);
   (d) granite-moe, rwkv6, whisper-small and qwen2-vl (layers cut 80 ->
   2) on (2, 2), four gloo ranks; 2 teacher-forced steps in (b) and (c),
   1 in (d).  Each model of (b)-(d) is first served unsharded (its tokens
   equal to phase 6's or 9's) and each rank is held to it, each step fed
   the unsharded token: the same model in float32 (256 prompt tokens
   into a 512-position cache, then 2 decode steps that write the second
   half of the cache) gives the prefill's and every step's logits within
   1e-4 relative; the bf16 run's logit error and differing tokens are
   reported.  ssm_scan must launch once per Mamba layer and pass on every
   rank, and a rank of a larger mesh must hand bytes to the collectives;
   each rank reports its times, memory, collective bytes and the bytes of
   its layout gathers (Mamba's in_proj).  ssm_scan is held to its plain
   loop at the rank's shape;

13. (run after phases 10 and 12) trains on a mesh
   (``Transformer(cfg, mesh=)``, ``build_train_step``, the differentiable
   collectives): (a) phase 10c's model, batches and Adafactor, in a
   process of its own under PyTorch's deterministic kernels: 2 steps
   mesh-free, then 2 on the unit mesh over NCCL, whose losses, norms and
   every parameter after each step equal the mesh-free ones bit for bit;
   (b) the same on (data, model) = (1, 2), two gloo ranks sharing the
   card, 2 steps, the first traced, the second timed bare: each rank
   launches ssm_scan 14 and ssm_scan_bwd 7 a step on its channel shard
   [2, 2,048, 131,072], and reports its step seconds, tokens/s,
   model-FLOP utilisation (both ranks' work over one card's peak),
   memory, bytes to the collectives and the scans' device time (traced
   step); (c) float32 at published
   widths cut to a Mamba and an attention layer (the interleave 1:7 ->
   1:1), 2 x 128 tokens, on (1, 2): the loss, norm, every gradient and
   every updated parameter within 1e-4 relative of the unsharded port;
   (d) four gloo ranks on (2, 2): the smoke Jamba with experts and
   granite-moe the same way, the ``Trainer`` failing at step 3, resized
   onto (1, 4) and resumed (every loss within 1e-5 relative of an
   uninterrupted run's), and ``compressed_psum``/``_exact`` on CUDA
   tensors equal to the CPU world's.  Both scans are then held to their
   plain loops at a (b) rank's shape and timed;

14. (run after phase 13) the journal on a mesh of ranks: phase 7's crash
   tape, with a checkpoint after its second edge batch, through
   ``TCQService(mesh=, wal_dir=)`` on (data, model) = (2, 1) (wave_peel on
   each rank) and (1, 2) (the composite over segdeg), two gloo ranks
   sharing the card: uninterrupted, then killed after the journal record
   phase 7's crash drill names (rank 0's journal dies, every rank stops),
   then a new world recovers (``TCQService.recover(wal_dir, mesh=)``) and
   drains; every ticket equal to the uninterrupted world's and to phase
   7's unsharded recovered drain bit for bit, rank 0's recovery report on
   every rank, and no file written by another rank;
15. the dry run (``launch/dryrun.py``) held to the card: (a) 13b's cell on
   a shape-only mesh, each rank's bytes to each kind of collective and its
   layout bytes equal to what 13b's ranks measured a step in this run; (b)
   a single-iteration TCQ step of phase 3's graph live on a (1, 2) gloo
   world on the card (psum and rs_ag) against its dry run; (c) each
   kernel's dry-run charge at its timing shape (``dryrun_bytes`` in the
   kernels line) against the bytes behind its bound; (d) the roofline
   terms of a (16, 16) Jamba train cell and the tcq-mathoverflow cell, a
   model on datasheet rates, printed;
16. (run after phase 8, before any gloo world, whose traces lose kernel
   records) the main path at the repo's tcq-youtube shape: 3,276,800
   vertices, 9,437,184 edges after self-loops, 8.4 M pairs, a span of
   2^20 (``youtube_graph``), above wave_peel's shared memory, so every
   window step is its global-memory tier.  ``YOUTUBE_REQUESTS`` (8
   windows of 1/36 to 1/144 of the span, k >= 10, 1-200 cores each;
   ``python3 chip_smoke.py --pick-youtube`` picks them) through
   ``query_batch`` cold and warm, looped wave and serial queries,
   ``TCQService(g)`` and the composite over segdeg
   (``use_kernel=False``): every path's cores and schedule counters
   equal, wave_peel never launched, ``wave_peel_global`` once a device
   step on the wave paths (its launches printed by path) and never on the
   serial or composite ones, segdeg only on the composite, at least twice
   a peel iteration.  It prints W, steps, iterations, occupancy, each
   path's wall time, the card's busy share, where one wave query's host
   time goes, peak memory, segdeg's time at its two shapes against their
   bounds, and the global tier's step against its bound, the plain step
   and the composite;

and prints every kernel's registers, shared memory and spills (``ptxas
-v``) after the build, every kernel's numbers as one JSON line, then the
``{"ok": true, ...}`` line last.

Any failed check raises, and the script exits non-zero with no result
line; it also exits non-zero when no CUDA device is present.  It never
imports JAX or the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FUZZ_SEEDS = range(6)
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
# wave_peel and segdeg only compare and add int32.  H100 SXM INT32 rate
# outside the tensor cores: 132 SMs x 64 INT32 lanes x 1.98 GHz boost clock.
INT_OPS_PER_S = 132 * 64 * 1.98e9
F32_OPS_PER_S = 67e12           # H100 SXM float32, no tensor cores (ssm_scan)
JAMBA = "jamba-1.5-large-398b"


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------- timing
def time_ms(fn, reps: int, setup=None) -> float:
    """Median device time of ``fn`` over ``reps`` runs, from CUDA events
    around each run; ``setup`` runs before each, outside the events."""
    import torch

    fn() if setup is None else (setup(), fn())          # warm-up
    pairs = []
    for _ in range(reps):
        if setup is not None:
            setup()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    times = sorted(a.elapsed_time(b) for a, b in pairs)
    return times[len(times) // 2]


def device_ms(fn, reps: int, kernel: str, setup=None):
    """(mean device time, trace) of the kernel named ``kernel`` over
    ``reps`` runs, from ``torch.profiler`` (CUPTI): the kernel's own time,
    without the host's launch work that CUDA events around a call also
    hold when the host is slower than the kernel.  A trace that caught no
    kernel is logged and taken once more, tracing the host too; ``trace``
    says which reading the time is (1 or 2).  When both saw none the
    phase fails: no time is reported from a trace that saw nothing."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn() if setup is None else (setup(), fn())          # warm-up
    for trace, acts in ((1, [ProfilerActivity.CUDA]),
                        (2, [ProfilerActivity.CPU, ProfilerActivity.CUDA])):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            for _ in range(reps):
                if setup is not None:
                    setup()
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if kernel in e.key
                and e.device_type == torch.autograd.DeviceType.CUDA]
        count = sum(e.count for e in rows)
        if count:
            return (sum(e.self_device_time_total for e in rows) / 1e3
                    / count, trace)
        seen = sorted((e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA),
                      key=lambda e: -e.self_device_time_total)
        log(f"device_ms: trace {trace} of {reps} {kernel} runs caught no "
            f"such kernel; it saw {len(seen)} device kernels: "
            + "; ".join(f"{e.count} x {e.key[:60]}" for e in seen[:3]))
    raise AssertionError(f"device_ms: no trace of {reps} {kernel} runs "
                         "caught the kernel")


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def bound(nbytes: float, ops: float, ops_per_s: float = INT_OPS_PER_S):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over ``ops_per_s`` (the INT32 rate unless given)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------ phase 2: kernels
def random_temporal_graph(rng):
    """Same draws as tests/test_kernels.py::_random_temporal_graph."""
    import numpy as np
    from repro_torch.core.graph import TemporalGraph

    v = int(rng.integers(3, 60))
    e = int(rng.integers(5, 400))
    tmax = int(rng.integers(4, 60))
    u = rng.integers(0, v, e)
    w = rng.integers(0, v, e)
    keep = u != w
    u, w = u[keep], w[keep]
    if u.size == 0:
        u, w = np.array([0]), np.array([v - 1])
    t = rng.integers(0, tmax, u.size)
    return TemporalGraph.from_edges(u, w, t, num_vertices=v), tmax


def fuzz_case(seed: int, capacity_padding: bool, dev):
    """One case of the fused-vs-composite sweep of tests/test_kernels.py,
    drawn in the same order: (tel, V, alive, ts, te, k, h) on ``dev``."""
    import numpy as np
    import torch
    from repro_torch.core.graph import pow2_capacity

    rng = np.random.default_rng(seed)
    g, tmax = random_temporal_graph(rng)
    if capacity_padding:
        nv = pow2_capacity(g.num_vertices)
        tel = g.device_tel(edge_capacity=pow2_capacity(g.num_edges),
                           pair_capacity=pow2_capacity(g.num_pairs),
                           vertex_capacity=nv, device=dev)
    else:
        nv = g.num_vertices
        tel = g.device_tel(device=dev)
    rng.choice([4, 8])                   # the TPU kernel's w_tile draw
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
    t = lambda a: torch.from_numpy(a).to(dev)       # noqa: E731
    return tel, nv, t(alive), t(ts), t(te), t(k), t(h)


def max_err(a, b) -> float:
    """Largest |a - b| over the StepResult fields every lowering computes
    (0 when bit-identical)."""
    import torch

    from repro_torch.core.wave import PEEL_FIELDS

    return max(float((x.to(torch.int64) - y.to(torch.int64)).abs().max())
               if x.numel() else 0.0
               for x, y in ((getattr(a, f), getattr(b, f))
                            for f in PEEL_FIELDS))


def assert_steps_equal(got, want, ctx: str) -> None:
    import torch

    from repro_torch.core.wave import PEEL_FIELDS

    for name in PEEL_FIELDS:
        x, y = getattr(got, name), getattr(want, name)
        check(x.dtype == y.dtype and tuple(x.shape) == tuple(y.shape)
              and torch.equal(x, y), f"{ctx}: {name} differs")


def random_case(seed: int, dev, *, v: int, e: int, tmax: int, W: int,
                hub: int = 0):
    """A seeded graph of ``e`` random edges on ``v`` vertices, plus
    ``hub`` edges on one pair, and W lanes: random windows (one empty,
    one past every edge), k in 1..6, h in 0..3, warm or all-ones rows."""
    import numpy as np
    import torch
    from repro_torch.core.graph import TemporalGraph

    rng = np.random.default_rng(seed)
    u = np.concatenate([rng.integers(0, v, e), np.full(hub, 7)])
    w = np.concatenate([rng.integers(0, v, e), np.full(hub, 11)])
    g = TemporalGraph.from_edges(u, w, rng.integers(0, tmax, u.size),
                                 num_vertices=v)
    ts = rng.integers(0, tmax, W).astype(np.int32)
    te = (ts + rng.integers(0, tmax, W)).astype(np.int32)
    ts[0], te[0] = 0, -1
    if W > 1:
        ts[1], te[1] = tmax + 1, tmax + 5
    k = rng.integers(1, 7, W).astype(np.int32)
    h = rng.integers(0, 4, W).astype(np.int32)
    alive = (rng.random((W, v)) < 0.9 if rng.random() < 0.5
             else np.ones((W, v), dtype=bool))
    t = lambda a: torch.from_numpy(a).to(dev)       # noqa: E731
    return g.device_tel(device=dev), v, (t(alive), t(ts), t(te), t(k), t(h))


def hold_step(tel, nv, args, ctx: str, errs: dict) -> None:
    """One fused wave step against the plain step: bit-identical."""
    import torch
    from repro_torch.core.wave import make_composite_step, make_wave_step_fn

    rf = make_wave_step_fn(tel, nv, use_kernel=True)(*args)
    rp = make_composite_step(tel, nv)(*args)
    torch.cuda.synchronize()
    assert_steps_equal(rf, rp, f"wave_peel vs plain, {ctx}")
    errs["wave_peel"] = max(errs["wave_peel"], max_err(rf, rp))


def hold_segdeg(vals, seg, s: int, errs: dict, ctx: str,
                exact64: bool = False) -> float:
    """segdeg against its plain version: exact on 0/1 values; floats within
    rtol=atol=1e-5 of ``index_add_`` in float32 or, where runs are long
    enough for float32's own rounding to exceed that (``exact64``), of the
    same sums in float64; two calls equal bit for bit.  Returns the float
    max |diff| (0 for 0/1 values)."""
    import torch
    from repro_torch.kernels.segdeg.ops import banded_segsum, banded_segsum_ref

    got = banded_segsum(vals, seg, s)
    check(torch.equal(got, banded_segsum(vals, seg, s)),
          f"segdeg {ctx}: two calls differ")
    ones = bool(((vals == 0) | (vals == 1)).all())
    if exact64 and not ones:
        want = torch.zeros((s + 1, vals.shape[1]), dtype=torch.float64,
                           device=vals.device)
        want = want.index_add_(0, seg.clamp(max=s).long(),
                               vals.double())[:s].float()
    else:
        want = banded_segsum_ref(vals, seg, s)
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if ones:
        check(torch.equal(got, want), f"segdeg 0/1 {ctx}")
        errs["segdeg"] = max(errs["segdeg"], err)
        return 0.0
    check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
          f"segdeg float {ctx}: {err}")
    return err


def phase_kernels(dev) -> dict:
    import numpy as np
    import torch
    from repro_torch.core import TCQEngine, brute_force_query
    from repro_torch.core.wave import make_composite_step, make_wave_step_fn
    from repro_torch.graphs import planted_cores

    errs = {"wave_peel": 0.0, "segdeg": 0.0}
    for padded in (False, True):
        for s in FUZZ_SEEDS:
            seed = (2000 if padded else 1000) + s
            tel, nv, alive, *lanes = fuzz_case(seed, padded, dev)
            fused = make_wave_step_fn(tel, nv, use_kernel=True)
            comp = make_wave_step_fn(tel, nv, use_kernel=False)
            plain = make_composite_step(tel, nv)
            rf = fused(alive, *lanes)
            rp = plain(alive, *lanes)
            rc = comp(alive, *lanes)
            torch.cuda.synchronize()
            ctx = f"seed {seed}"
            assert_steps_equal(rf, rp, f"wave_peel vs plain, {ctx}")
            assert_steps_equal(rc, rf, f"composite(segdeg) vs fused, {ctx}")
            errs["wave_peel"] = max(errs["wave_peel"], max_err(rf, rp))
            if s < 3:                   # the same lanes with h = 0 and 3
                for h in (0, 3):
                    hold_step(tel, nv, (alive, *lanes[:3],
                                        torch.full_like(lanes[3], h)),
                              f"{ctx}, h={h}", errs)
    for W in (1, 33, 64):
        tel, nv, args = random_case(W, dev, v=300, e=3000, tmax=80, W=W)
        hold_step(tel, nv, args, f"W={W}", errs)
    tel, nv, args = random_case(5, dev, v=500, e=5000, tmax=200, W=8,
                                hub=50_000)
    hub = int((tel.pair_id == tel.pair_id.bincount().argmax()).sum())
    check(hub >= 50_000, f"hub pair has {hub} edges")
    hold_step(tel, nv, args, f"hub pair of {hub} edges", errs)
    log(f"wave_peel: bit-identical to the plain step on "
        f"{2 * len(FUZZ_SEEDS)} fuzz cases, 12 with h = 0 or 3, W = 1, 33 "
        f"and 64, and a pair of {hub} edges; composite with segdeg "
        "closures equal to the fused step")

    # 0/1 values (all the wave step feeds it) must be exact; floats may
    # differ from index_add_ by summation order: allclose rtol=atol=1e-5
    rng = np.random.default_rng(0)
    float_err = 0.0
    for n, s, q in [(1, 1, 1), (100, 7, 3), (1000, 300, 17), (513, 129, 129),
                    (4096, 1024, 64), (2048, 4, 8), (3000, 50, 5)]:
        seg = torch.from_numpy(np.sort(rng.integers(0, s + 2, n))
                               .astype(np.int32)).to(dev)  # ids >= s drop
        for vals in (rng.random((n, q)) < 0.5, rng.normal(0, 1, (n, q))):
            v = torch.from_numpy(vals.astype(np.float32)).to(dev)
            float_err = max(float_err, hold_segdeg(v, seg, s, errs,
                                                   f"({n},{s},{q})"))
    # a hub run of 50,000 rows (across 49 to 782 row tiles) among short
    # runs, which end on both sides of most tile edges
    s = 3000
    ids = np.concatenate([rng.integers(0, s + 2, 20_000),
                          np.full(50_000, 1234)])
    seg = torch.from_numpy(np.sort(ids).astype(np.int32)).to(dev)
    for q in (1, 3, 4, 5, 64):
        for vals in (rng.random((ids.size, q)) < 0.5,
                     rng.normal(0, 1, (ids.size, q))):
            v = torch.from_numpy(vals.astype(np.float32)).to(dev)
            float_err = max(float_err, hold_segdeg(
                v, seg, s, errs, f"hub run, Q={q}", exact64=True))
    log(f"segdeg: exact on 0/1 values, deterministic, with a run of 50,000 "
        f"rows and Q in 1, 3, 4, 5, 64; on floats max |diff| "
        f"{float_err:.3g} within allclose rtol=atol=1e-5")

    g = planted_cores(seed=9)
    oracle = brute_force_query(g, 3, 1, 40)
    for mode in ("wave", "serial"):
        got = TCQEngine(g).query(3, 1, 40, mode=mode).by_tti()
        check(got.keys() == oracle.keys(), f"oracle keys ({mode})")
        for key, c in got.items():
            check(set(c.vertices.tolist()) == oracle[key]["vertices"]
                  and c.n_edges == oracle[key]["n_edges"],
                  f"oracle core {key} ({mode})")
    log(f"planted_cores: {len(oracle)} cores equal to the brute-force "
        "oracle in wave and serial mode")
    return errs


# ------------------------------------- phase 2b: the wave step's boundary
def boundary_graph(v: int, seed: int = 5):
    """A graph of ``v`` vertices whose 4,000 edges join 300 seeded
    vertices, the 8 highest ids among them, over 400 days."""
    import numpy as np
    from repro_torch.core.graph import TemporalGraph

    rng = np.random.default_rng(seed)
    hot = np.concatenate([rng.choice(v - 8, 292, replace=False),
                          np.arange(v - 8, v)])
    u = hot[rng.integers(0, hot.size, 4_000)]
    w = hot[rng.integers(0, hot.size, 4_000)]
    return TemporalGraph.from_edges(u, w, rng.integers(1, 401, 4_000),
                                    num_vertices=v)


def boundary_requests(g, n: int = 4, seed: int = 3) -> list:
    import numpy as np

    rng = np.random.default_rng(seed)
    uts = g.unique_ts
    out = []
    for _ in range(n):
        a = int(rng.integers(0, uts.size - 40))
        out.append({"k": int(rng.integers(2, 5)), "ts": int(uts[a]),
                    "te": int(uts[a + 39])})
    return out


def phase_boundary(dev) -> dict:
    """The capacity rule at wave_peel's shared-memory limit: a default
    engine on a graph of V = ``max_vertices()`` vertices takes the
    shared-memory kernel, one of V + 1 the global-memory tier, and so does
    ``use_kernel=True`` there; all answer as ``use_kernel=False`` (the
    composite over segdeg) and the CPU port do.  The library's limit
    equals the package's mirror of the kernel's arithmetic."""
    import torch
    from repro_torch.core import TCQEngine
    from repro_torch.kernels.wave_peel import ops as peel

    limit = peel.max_vertices()
    check(limit == peel.mirror_max_vertices(),
          f"max_vertices() {limit} != the mirror "
          f"{peel.mirror_max_vertices()}")
    tcq = ("wave_peel", "wave_peel_global", "segdeg")
    by_path = {}
    for v, kernel, backend in ((limit, "wave_peel", "fused"),
                               (limit + 1, "wave_peel_global",
                                "fused_global")):
        g = boundary_graph(v)
        reqs = boundary_requests(g)
        for name, eng in (("", TCQEngine(g)),
                          ("_use_kernel", TCQEngine(g, use_kernel=True))):
            got, wall, n = run_path(lambda: eng.query_batch(reqs))
            got_backend = step_backend(eng)
            path = f"boundary_v{v}{name}"
            by_path[path] = n
            check(n[kernel] > 0 and sum(n[k] for k in tcq) == n[kernel],
                  f"{path}: launches {n}, want {kernel} alone")
            check(got_backend == backend, f"{path}: a {got_backend} step")
            for ref, what in ((TCQEngine(g, use_kernel=False),
                               "use_kernel=False"),
                              (TCQEngine(g, device="cpu"), "the CPU")):
                want = ref.query_batch(reqs)
                for i, (a, b) in enumerate(zip(got, want)):
                    check(digest(a) == digest(b),
                          f"{path}, request {i}: differs from {what}")
            log(f"boundary V={v}{name.replace('_', ' ')}: {got_backend} "
                f"step, {wall:.3f}s, {sum(len(r) for r in got)} cores of "
                f"{len(reqs)} requests equal to use_kernel=False and the "
                f"CPU port; launches {json.dumps(n)}")
            del eng
    torch.cuda.synchronize()
    log(f"boundary: max_vertices() {limit} = the mirror")
    return {"limit": limit, "by_path": by_path}


# ------------------------------------------------------ launch counters
def wrappers() -> dict:
    """Each kernel's wrapper, whose ``launches`` counts its launches."""
    from repro_torch.kernels.segdeg.ops import banded_segsum
    from repro_torch.kernels.ssm_scan.ops import ssm_scan, ssm_scan_bwd
    from repro_torch.kernels.wave_peel.ops import wave_peel, wave_peel_global

    return {"wave_peel": wave_peel, "wave_peel_global": wave_peel_global,
            "segdeg": banded_segsum, "ssm_scan": ssm_scan,
            "ssm_scan_bwd": ssm_scan_bwd}


# the TCQ kernels' counts on a path that runs none of them
NO_TCQ_LAUNCHES = {"wave_peel": 0, "wave_peel_global": 0, "segdeg": 0}


def run_path(fn):
    """Drive one path with every launch counter set to 0 just before it
    and read just after: (result, wall s, {kernel: launches})."""
    import torch

    sync = torch.cuda.synchronize if torch.cuda.is_available() else \
        (lambda: None)
    sync()
    for w in wrappers().values():
        w.launches = 0
    t0 = time.perf_counter()
    out = fn()
    sync()
    wall = time.perf_counter() - t0
    return out, wall, {k: w.launches for k, w in wrappers().items()}


# ---------------------------------------------------- phase 3: main path
def same_cores(a, b, ctx: str) -> None:
    import numpy as np

    ba, bb = a.by_tti(), b.by_tti()
    check(ba.keys() == bb.keys(), f"{ctx}: {len(ba)} vs {len(bb)} cores")
    for key, ca in ba.items():
        cb = bb[key]
        check(np.array_equal(ca.vertices, cb.vertices)
              and ca.n_edges == cb.n_edges, f"{ctx}: core {key} differs")


def pick_queries(eng, g, n: int = 8, span_uts: int = 64, seed: int = 11,
                 max_results: int = 200):
    """Seeded windows of ``span_uts`` unique timestamps, each with the
    smallest k in a ladder whose query returns 1..max_results cores."""
    import numpy as np

    uts = g.unique_ts
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(4 * n):
        if len(out) == n:
            break
        i = int(rng.integers(0, uts.size - span_uts))
        ts, te = int(uts[i]), int(uts[i + span_uts - 1])
        for k in (2, 3, 4, 5, 6, 8, 10, 12, 16, 20, 24, 32, 48, 64):
            m = len(eng.query(k, ts, te, mode="wave", wave="auto"))
            if m == 0:
                break
            if m <= max_results:
                out.append({"k": k, "ts": ts, "te": te, "cores": m})
                break
    check(len(out) == n, f"found {len(out)} of {n} valid queries")
    return out


def phase_main(dev) -> dict:
    from repro_torch.core import TCQEngine
    from repro_torch.graphs import powerlaw_temporal

    t0 = time.perf_counter()
    g = powerlaw_temporal(num_vertices=24_818, num_edges=506_550,
                          time_span=2_350, burst_periods=14, seed=11)
    log(f"graph: |V|={g.num_vertices} |E|={g.num_edges} |P|={g.num_pairs} "
        f"unique t={g.unique_ts.size} built in "
        f"{time.perf_counter() - t0:.1f}s")
    eng = TCQEngine(g)
    check(eng.device.type == "cuda", f"engine on {eng.device}, not CUDA")
    t0 = time.perf_counter()
    reqs = pick_queries(eng, g)
    log(f"queries ({time.perf_counter() - t0:.1f}s to pick): "
        + json.dumps(reqs))
    comp_eng = TCQEngine(g, use_kernel=False)

    # the first batch also builds the union-window TEL (cold); the second
    # reuses it from the engine's window LRU (warm)
    batch, cold_s, n_cold = run_path(lambda: eng.query_batch(reqs))
    batch2, warm_s, n_warm = run_path(lambda: eng.query_batch(reqs))
    waves, wave_s, n_wave = run_path(lambda: [
        eng.query(r["k"], r["ts"], r["te"], mode="wave") for r in reqs])
    serials, serial_s, n_serial = run_path(lambda: [
        eng.query(r["k"], r["ts"], r["te"], mode="serial") for r in reqs])
    comp, comp_s, n_comp = run_path(lambda: comp_eng.query_batch(reqs))
    by_path = {"query_batch_cold": n_cold, "query_batch_warm": n_warm,
               "wave": n_wave, "serial": n_serial, "composite_batch": n_comp}

    for i, r in enumerate(reqs):
        check(len(batch[i]) == r["cores"], f"query {i}: core count moved")
        same_cores(batch2[i], batch[i], f"query {i} warm vs cold batch")
        same_cores(waves[i], batch[i], f"query {i} wave vs batch")
        same_cores(serials[i], batch[i], f"query {i} serial vs batch")
        same_cores(comp[i], batch[i], f"query {i} composite vs batch")

    def expect(path: str, kernel: str, ok, want: str) -> None:
        n = by_path[path][kernel]
        check(ok(n), f"{path}: {kernel} launched {n} times, want {want}")

    for path, res in (("query_batch_cold", batch),
                      ("query_batch_warm", batch2)):
        steps = res[0].stats.device_steps
        expect(path, "wave_peel", lambda n: n >= steps, f">= {steps} steps")
        expect(path, "segdeg", lambda n: n == 0, "0")
    steps = sum(w.stats.device_steps for w in waves)
    expect("wave", "wave_peel", lambda n: n >= steps, f">= {steps} steps")
    expect("wave", "segdeg", lambda n: n == 0, "0")
    for kernel in ("wave_peel", "segdeg"):
        expect("serial", kernel, lambda n: n == 0, "0")
    for path in by_path:
        expect(path, "ssm_scan", lambda n: n == 0, "0")
        expect(path, "ssm_scan_bwd", lambda n: n == 0, "0")
    iters = comp[0].stats.peel_iters
    expect("composite_batch", "segdeg", lambda n: n >= 2 * iters,
           f">= 2 x {iters} peel iterations")
    expect("composite_batch", "wave_peel", lambda n: n == 0, "0")

    st = batch[0].stats
    log(f"main path: {len(reqs)} queries, "
        f"{sum(len(b) for b in batch)} cores, all equal across query_batch "
        "(cold and warm), wave, serial and the composite batch")
    log(f"query_batch: cold {cold_s:.3f}s wall ({len(reqs) / cold_s:.2f} "
        f"queries/s), warm {warm_s:.3f}s ({len(reqs) / warm_s:.2f} "
        f"queries/s); {st.device_steps} steps, {st.occupancy:.2f} mean "
        f"occupied lanes, {st.peel_iters} peel iterations, window edges "
        f"{st.window_edges}")
    log(f"looped wave: {wave_s:.3f}s ({steps} steps); looped serial: "
        f"{serial_s:.3f}s; composite batch: {comp_s:.3f}s "
        f"({iters} peel iterations)")
    log(f"launches by path: {json.dumps(by_path)}")
    return {"g": g, "eng": eng, "reqs": reqs, "by_path": by_path,
            "batch": batch, "comp": comp, "cold_s": cold_s,
            "warm_s": warm_s, "comp_s": comp_s}


# ------------------------------------------ phase 4: where the time goes
def profiled(fn, what: str, top: int = 6, cpu_ops: bool = True,
             kernels: dict = None):
    """Run ``fn`` once under ``torch.profiler`` and log the device's busy
    share of its wall time and the kernels that took the most of it.
    Returns the busy share (0-1), None when the profiler saw no device
    time.  ``cpu_ops=False`` traces the device alone: a path of tens of
    thousands of small operators then takes seconds to trace, not a
    minute, and the host runs at nearly its untraced pace.  ``kernels``,
    a dict, receives {kernel: (device ms, count)} of every kernel seen."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA]
    if cpu_ops:
        acts.append(ProfilerActivity.CPU)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    if kernels is not None:
        kernels.update({name: (ms, count) for name, ms, count in rows})
    if not rows:
        log(f"profile of {what}: the profiler saw no device time "
            "(not measured)")
        return None
    log(f"profile of {what}: wall {wall_ms:.1f} ms under the profiler, "
        f"device busy {busy:.1f} ms ({100 * busy / wall_ms:.1f}%)")
    for name, ms, count in rows[:top]:
        log(f"  {ms:9.2f} ms  {count:5d} x  {name[:90]}")
    return busy / wall_ms


def phase_profile(main: dict) -> None:
    """One more ``query_batch`` under ``torch.profiler``: device time by
    kernel and the device's busy share of the batch's wall time."""
    profiled(lambda: main["eng"].query_batch(main["reqs"]), "query_batch")


# ---------------------------------------- phase 5: full-size step + timing
def phase_timing(dev, main: dict, errs: dict) -> list:
    import numpy as np
    import torch
    from repro_torch.core import TCQEngine
    from repro_torch.core.scheduler import autotune_wave
    from repro_torch.core.wave import make_composite_step, make_wave_step_fn
    from repro_torch.kernels.segdeg.ops import (banded_segsum,
                                                banded_segsum_ref,
                                                segment_offsets)
    from repro_torch.kernels.wave_peel.ops import (_check_tel,
                                                   canonical_step_cost,
                                                   fused_step_cost, tel_bands,
                                                   wave_peel)

    eng, reqs = main["eng"], main["reqs"]
    lo = min(r["ts"] for r in reqs)
    hi = max(r["te"] for r in reqs)
    wt = eng._window_tel(lo, hi)                # the batch's union TEL
    tel, nv = wt.tel, wt.num_vertices
    # what a cold batch adds: building the union TEL and its wave step
    fresh = TCQEngine(main["g"])
    t0 = time.perf_counter()
    fresh._window_tel(lo, hi)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    _check_tel(tel, nv)
    check_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    tel_bands(tel, nv)
    torch.cuda.synchronize()
    bands_ms = (time.perf_counter() - t0) * 1e3
    log(f"union-window TEL build: {build_ms:.1f} ms host clock, of which "
        f"the layout check {check_ms:.1f} ms and the band tables "
        f"{bands_ms:.1f} ms")
    del fresh
    W = autotune_wave(nv, wt.window_edges, num_queries=len(reqs))
    pick = [reqs[i % len(reqs)] for i in range(W)]
    lanes = [torch.tensor([r[f] for r in pick], dtype=torch.int32,
                          device=dev) for f in ("ts", "te", "k")]
    lanes.append(torch.ones(W, dtype=torch.int32, device=dev))
    alive0 = torch.ones((W, nv), dtype=torch.bool, device=dev)

    fused = make_wave_step_fn(tel, nv, use_kernel=True)
    plain = make_composite_step(tel, nv)
    rf, rp = fused(alive0, *lanes), plain(alive0, *lanes)
    torch.cuda.synchronize()
    assert_steps_equal(rf, rp, "full-size wave step vs plain")
    errs["wave_peel"] = max(errs["wave_peel"], max_err(rf, rp))
    log(f"full-size step (W={W}, E={tel.t.shape[0]}, P={tel.num_pairs}, "
        f"V={nv}, iters={int(rf.iters)}): bit-identical to the plain step")

    buf = alive0.clone()
    refill = lambda: buf.copy_(alive0)          # noqa: E731
    *_, lane_iters = wave_peel(tel, fused.bands, buf, *lanes)
    refill()
    peel_ms = time_ms(lambda: wave_peel(tel, fused.bands, buf, *lanes), 20,
                      setup=refill)
    plain_ms = time_ms(lambda: plain(alive0, *lanes), 3)
    # where a launch's time goes: the same lanes with empty windows (no
    # window search, nothing kept), and with k above every degree (the
    # window counts, then two iterations)
    empty = [torch.zeros_like(lanes[0]), torch.full_like(lanes[1], -1),
             *lanes[2:]]
    huge_k = [*lanes[:2], torch.full_like(lanes[2], 1 << 30), lanes[3]]
    peel_dev, peel_trace = device_ms(
        lambda: wave_peel(tel, fused.bands, buf, *lanes), 20,
        "wave_peel_kernel", setup=refill)
    parts = {name: device_ms(lambda: wave_peel(tel, fused.bands, buf, *ln),
                             20, "wave_peel_kernel", setup=refill)[0]
             for name, ln in (("empty windows", empty),
                              ("k above every degree", huge_k))}
    log(f"wave_peel at W={W}: {peel_ms:.4f} ms a call (CUDA events), "
        f"device time {fmt_ms(peel_dev)} ({max(lane_iters.tolist())} "
        "iterations); device time of the same lanes with "
        + ", ".join(f"{n} {fmt_ms(ms)}" for n, ms in parts.items())
        + f"; plain step {plain_ms:.4f} ms, so the call is "
        f"{'not ' if peel_ms >= plain_ms else ''}below it and "
        f"{'not ' if peel_ms > 0.95 else ''}at or below 0.95 ms")
    # bound: what this kernel's pair-level formulation must move on this
    # run's data; beside it the TPU kernel's dense count (earlier rows)
    cost = canonical_step_cost(tel, fused.bands, lanes[0], lanes[1],
                               lanes[3], lane_iters.tolist(), nv)
    peel_bound, peel_by = bound(cost["bytes"], cost["ops"])
    dense = fused_step_cost(tel.t.shape[0], tel.num_pairs,
                            tel.hp_src.shape[0], nv, lane_iters.tolist())
    peel_dense, _ = bound(dense["bytes"], dense["ops"])
    log(f"wave_peel bound {peel_bound:.5f} ms ({peel_by}: {cost['bytes']} "
        f"bytes, {cost['ops']} operations); the dense count "
        f"{peel_dense:.5f} ms ({dense['bytes']} bytes, {dense['ops']} "
        "operations)")

    # segdeg at the composite's first pair-level reduction of this step
    win = (tel.t[None, :] >= lanes[0][:, None]) & \
        (tel.t[None, :] <= lanes[1][:, None])
    vals = (win & alive0[:, tel.src] & alive0[:, tel.dst]).T.to(
        torch.float32).contiguous()
    # offsets as the composite's closures hold them: once per TEL
    seg, S = tel.pair_id, tel.num_pairs
    off = segment_offsets(seg, S)
    got = banded_segsum(vals, seg, S, offsets=off)
    want = banded_segsum_ref(vals, seg, S)
    check(torch.equal(got, want), "segdeg at the main path's shape")
    errs["segdeg"] = max(errs["segdeg"], float((got - want).abs().max()))
    seg_ms = time_ms(lambda: banded_segsum(vals, seg, S, offsets=off), 50)
    seg_dev, seg_trace = device_ms(
        lambda: banded_segsum(vals, seg, S, offsets=off), 50,
        "segdeg_kernel")
    seg_plain_ms = time_ms(lambda: banded_segsum_ref(vals, seg, S), 50)
    clamped = seg.clamp(max=S)
    sink = torch.zeros((S + 1, W), dtype=torch.float32, device=dev)
    lib_ms = time_ms(lambda: sink.index_add_(0, clamped, vals), 50)
    # bound: the rows with an id below S (the kernel reads no other),
    # their ids, the offsets and the output; beside it every row's
    n, nvalid = vals.shape[0], int(off[-1])

    def seg_bytes(rows):
        return 4 * rows * W + 4 * rows + 4 * (S + 1) + 4 * S * W

    seg_bound, seg_by = bound(seg_bytes(nvalid), nvalid * W)
    seg_dense, _ = bound(4 * n * W + 4 * n + 4 * S * W, n * W)
    log(f"segdeg timed at values [{n}, {W}] -> [{S}, {W}]: {seg_ms:.4f} ms "
        f"a call (device time {fmt_ms(seg_dev)}), index_add_ {lib_ms:.4f} ms "
        f"({'not ' if seg_ms > lib_ms else ''}at or below it), plain "
        f"{seg_plain_ms:.4f} ms; bound {seg_bound:.5f} ms over the "
        f"{nvalid} rows with an id below {S}, {seg_dense:.5f} ms over all")

    return [
        {"name": "wave_peel", "route": "cuda",
         "source": "src/repro_torch/kernels/wave_peel/csrc/wave_peel.cu",
         "replaces": "src/repro/kernels/wave_peel/kernel.py:179",
         "max_abs_err": errs["wave_peel"], "ms": peel_ms,
         "device_ms": peel_dev, "device_trace": peel_trace,
         "plain_ms": plain_ms, "bound_ms": peel_bound,
         "bound_by": peel_by, "dense_bound_ms": peel_dense,
         "library_ms": None,
         "timing_shape": {"W": W, "E": tel.t.shape[0], "P": tel.num_pairs,
                          "V": nv, "HP": tel.hp_src.shape[0]},
         "bound_bytes_dense": dense["bytes"]},
        {"name": "segdeg", "route": "cuda",
         "source": "src/repro_torch/kernels/segdeg/csrc/segdeg.cu",
         "replaces": "src/repro/kernels/segdeg/kernel.py:109",
         "max_abs_err": errs["segdeg"], "ms": seg_ms, "device_ms": seg_dev,
         "device_trace": seg_trace,
         "plain_ms": seg_plain_ms, "bound_ms": seg_bound, "bound_by": seg_by,
         "dense_bound_ms": seg_dense, "library_ms": lib_ms,
         "timing_shape": {"N": n, "Q": W, "S": S},
         "bound_bytes_dense": seg_bytes(n)},
    ]


# ------------------------------------------- phase 6: Jamba serving path
def phase_lm_smoke(dev) -> None:
    """The smoke-size Jamba without experts (f32) with the same weights on
    the card (ssm_scan kernel) and on the CPU (plain loop): prefill logits
    and teacher-forced decode logits within rtol=atol=1e-4; the greedy
    tokens of both are reported."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import prefill_step, serve_step
    from repro_torch.models.transformer import (Transformer, init_cache,
                                                init_params)

    cfg = get_smoke_config(JAMBA).scaled(moe=None)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(5)
    b, s, n, s_max = 2, 16, 8, 32
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)))
    forced = torch.from_numpy(rng.integers(0, cfg.vocab, (b, n)))
    out = []                               # [(logits, tokens)]: CPU, card
    for where in ("cpu", dev):
        model = Transformer(cfg, params, device=where)
        d = model.device
        cache = init_cache(cfg, b, s_max, device=d)
        logits = [prefill_step(model, {"tokens": prompt.to(d)}, cache)[0]]
        with torch.inference_mode():
            for i in range(n):
                h, _, cache = model({"tokens": forced[:, i:i + 1].to(d),
                                     "cache_index": s + i}, mode="decode",
                                    cache=cache)
                logits.append(model.logits_from_hidden(h))
        last, cache = prefill_step(model, {"tokens": prompt.to(d)}, cache)
        tok = last.argmax(-1).to(torch.int32)
        toks = [tok]
        for i in range(n - 1):
            tok, cache = serve_step(model, cache,
                                    {"tokens": tok, "cache_index": s + i})
            toks.append(tok)
        out.append((torch.cat(logits, 1).cpu(), torch.cat(toks, 1).cpu()))
    (lc, tc), (lg, tg) = out
    err = float((lg - lc).abs().max())
    check(torch.isfinite(lg).all() and torch.allclose(
        lg, lc, rtol=1e-4, atol=1e-4),
        f"smoke Jamba: card vs CPU logits differ by {err}")
    log(f"smoke Jamba (f32, d_model {cfg.d_model}, {cfg.n_layers} layers): "
        f"prefill and {n} teacher-forced decode logits on the card within "
        f"rtol=atol=1e-4 of the CPU (max |diff| {err:.3g}); greedy tokens "
        f"card {tg.tolist()}, CPU {tc.tolist()} "
        f"({'equal' if torch.equal(tg, tc) else 'DIFFERENT'})")


def hold_scan(la, bx, s0, what: str, reps: int, plain_reps: int) -> dict:
    """ssm_scan against its plain version on the card at one shape:
    rtol=atol=1e-5 (tests/test_kernels.py's tolerance), then both timed
    and the kernel's byte bound."""
    import torch
    from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_ref

    got, want = ssm_scan(la, bx, s0), ssm_scan_ref(la, bx, s0)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
          f"ssm_scan at the {what} shape: max |diff| {err}")
    del got, want
    ms = time_ms(lambda: ssm_scan(la, bx, s0), reps)
    dev_ms, trace = device_ms(lambda: ssm_scan(la, bx, s0), reps,
                              "ssm_scan_kernel")
    plain_ms = time_ms(lambda: ssm_scan_ref(la, bx, s0), plain_reps)
    nb, ns, nf = la.shape
    nbytes = 4 * (3 * nb * ns * nf + nb * nf)
    bound_ms, bound_by = bound(nbytes, 3 * nb * ns * nf, F32_OPS_PER_S)
    log(f"ssm_scan at the {what} shape {list(la.shape)}: within "
        f"rtol=atol=1e-5 of the plain loop (max |diff| {err:.3g}); "
        f"{ms:.4f} ms a call (device time {fmt_ms(dev_ms)}), plain "
        f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "device_trace": trace,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "timing_shape": {"BSF": [nb, ns, nf]},
            "bound_bytes_dense": nbytes}


def phase_lm(dev) -> dict:
    """The Jamba serving path at full width: prefill, then greedy decode,
    each with the launch counters zeroed before it and read after it;
    ssm_scan held to its plain version on the inputs of those passes."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import prefill_step, serve_step
    from repro_torch.models.layers import norm
    from repro_torch.models.ssm import _ssm_inputs
    from repro_torch.models.transformer import Transformer, init_cache

    full = get_config(JAMBA)
    cfg = full.scaled(n_layers=8, moe=None)
    b, s, s_max, n_dec = 2, 2_048, 32_768, 32
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Transformer(cfg, generator=torch.Generator(dev).manual_seed(0),
                        device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    specs = [sp.mixer for sp in cfg.layer_specs()]
    log(f"jamba: {cfg.name} at its published widths (d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads x "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
        f"d_state {cfg.mamba.d_state}, d_inner "
        f"{cfg.mamba.d_inner(cfg.d_model)}); cuts: layers {full.n_layers} "
        f"-> {cfg.n_layers} (one scan period: {specs}), experts removed "
        f"(every FFN dense); {cfg.dtype}, {n_params / 1e9:.3f} B "
        f"parameters, seeded init on the card in "
        f"{time.perf_counter() - t0:.1f}s")

    rng = np.random.default_rng(17)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s))).to(dev)
    cache = init_cache(cfg, b, s_max, device=dev)

    def prefill():
        return prefill_step(model, {"tokens": prompt}, cache)

    def decode(tok, steps):
        toks = []
        for i in range(steps):
            tok, _ = serve_step(model, cache, {"tokens": tok,
                                               "cache_index": s + i})
            toks.append(tok)
        return torch.cat(toks, 1)

    def first_token(last):
        return last[:, -1].argmax(-1, keepdim=True).to(torch.int32)

    decode(first_token(prefill()[0]), 2)       # warm-up; prefill resets
    (last, _), pre_s, n_pre = run_path(prefill)
    tok0 = first_token(last)
    toks, dec_s, n_dec_run = run_path(lambda: decode(tok0, n_dec))
    peak = torch.cuda.max_memory_allocated()
    by_path = {"jamba_prefill": n_pre, "jamba_decode": n_dec_run}
    check(tuple(last.shape) == (b, 1, cfg.padded_vocab)
          and bool(torch.isfinite(last).all()), "prefill logits")
    check(tuple(toks.shape) == (b, n_dec) and int(toks.min()) >= 0
          and int(toks.max()) < cfg.vocab, "decoded tokens")
    n_mamba = specs.count("mamba")
    for path, want in (("jamba_prefill", n_mamba),
                       ("jamba_decode", n_mamba * n_dec)):
        got = by_path[path]
        check(got == {**NO_TCQ_LAUNCHES, "ssm_scan": want,
                      "ssm_scan_bwd": 0},
              f"{path}: launches {got}, want ssm_scan {want} and no other")
    log(f"jamba prefill: {b} x {s} tokens into a {s_max}-token cache in "
        f"{pre_s:.3f}s ({b * s / pre_s:.0f} tokens/s)")
    log(f"jamba decode: {n_dec} greedy steps of {b} tokens in {dec_s:.3f}s "
        f"({1e3 * dec_s / n_dec:.2f} ms per step of {b} tokens, "
        f"{b * n_dec / dec_s:.1f} tokens/s); first tokens "
        f"{toks[:, :8].tolist()}")
    log(f"jamba launches by path: {json.dumps(by_path)}; peak memory "
        f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated)")

    # ssm_scan on the inputs of the first Mamba layer in each pass
    p0 = model.params["dec"].select(0)["sub0"]
    di, ds = cfg.mamba.d_inner(cfg.d_model), cfg.mamba.d_state
    with torch.inference_mode():
        def scan_inputs(tokens, conv0):
            h = norm(model.params["embed"]["tok"][tokens], p0["ln1"],
                     cfg.norm)
            dta, bxx, *_ = _ssm_inputs(p0["mixer"], h, cfg, conv0)
            return (dta.reshape(b, tokens.shape[1], di * ds),
                    bxx.reshape(b, tokens.shape[1], di * ds))

        la, bx = scan_inputs(prompt, torch.zeros(
            (b, cfg.mamba.d_conv - 1, di), dtype=last.dtype, device=dev))
        s0 = torch.zeros((b, di * ds), dtype=torch.float32, device=dev)
        at_prefill = hold_scan(la, bx, s0, "prefill", 10, 3)
        del la, bx
        la, bx = scan_inputs(toks[:, -1:], cache["sub0"]["conv"][0])
        at_decode = hold_scan(la, bx, cache["sub0"]["ssm"][0].reshape(b, -1),
                              "decode", 200, 50)
    profiled(prefill, "jamba prefill", top=8)
    profiled(lambda: decode(tok0, 4), "4 jamba decode steps", top=8)
    entry = {"name": "ssm_scan", "route": "cuda",
             "source": "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu",
             "replaces": "src/repro/kernels/ssm_scan/kernel.py:67",
             **at_prefill,
             "max_abs_err": max(at_prefill["max_abs_err"],
                                at_decode["max_abs_err"]),
             "library_ms": None,
             "at_decode_shape": at_decode}
    return {"by_path": by_path, "entry": entry,
            "tokens": torch.cat([tok0, toks], 1).cpu()}


# ------------------------------------------- phase 7: TCQ serving path
SERVE_CUT_DAY = 2_200       # serving starts from the edges before this day
SERVE_BATCHES = 4           # the rest arrive as this many push_edges
SERVE_REQUESTS = 32         # windows a serving path answers (120 before
                            # phase 16 took its share of the time limit)


def ladders(svc) -> list:
    """The degradation ladders the service's engine holds (none without
    ``resilience``)."""
    from repro_torch.core.wave import DegradationLadder

    return [wt.step_fn for wt in svc.engine._win_cache.values()
            if isinstance(wt.step_fn, DegradationLadder)]


def digest(res):
    """A result's cores as comparable data: (TTI, vertices, edges)."""
    return sorted((key, tuple(c.vertices.tolist()), int(c.n_edges))
                  for key, c in res.by_tti().items())


def pcts(tickets, wall: float) -> dict:
    import numpy as np

    lat = np.array([tk.latency_s for tk in tickets]) if tickets else \
        np.array([0.0])
    return {"n": len(tickets), "qps": len(tickets) / wall if wall else 0.0,
            "p50_ms": 1e3 * float(np.quantile(lat, .50)),
            "p95_ms": 1e3 * float(np.quantile(lat, .95)),
            "p99_ms": 1e3 * float(np.quantile(lat, .99))}


def serve_tape(reqs, batches):
    """A poll-driven tape (no wall clock): the requests in order, one
    ingest batch after every quarter of them."""
    ops, step = [], max(1, len(reqs) // max(1, len(batches)))
    for i, r in enumerate(reqs):
        ops.append(("submit", {k: r[k] for k in ("k", "ts", "te")}))
        if (i + 1) % step == 0 and (i + 1) // step <= len(batches):
            ops.append(("edges", batches[(i + 1) // step - 1]))
    return ops


def drive_tape(svc, ops, tickets=None):
    """Feed ``ops`` to ``svc`` one per poll; returns {id: ticket}."""
    tickets = {} if tickets is None else tickets
    state = {"i": 0}

    def poll(s):
        if state["i"] < len(ops):
            op = ops[state["i"]]
            state["i"] += 1
            if op[0] == "submit":
                tk = s.submit(dict(op[1]))
                tickets[tk.id] = tk
            elif op[0] == "checkpoint":
                s.checkpoint()
            else:
                s.push_edges(*op[1])

    while state["i"] < len(ops) or svc.pending:
        svc.run_until_idle(poll)
    return tickets


def phase_serve(dev, g, *, cut_day: int = SERVE_CUT_DAY,
                n_requests: int = SERVE_REQUESTS, load: float = 0.5,
                k: int = 12, span: int = 64, seed: int = 11) -> dict:
    """The port's serving stack on ``dev`` through ``launch/serve.py``:
    the closed loop, whose throughput sets the open loop's rate (``load``
    times it), the open loop over a growing graph with a journal, a
    replay of its windows after the last ingest, recovery from the
    journal and from a crash mid-tape, and two chaos runs under the
    degradation ladder; every ticket held to a cache-free engine on its
    pinned snapshot."""
    import shutil
    import tempfile

    import numpy as np
    from repro_torch.core import (ResilienceConfig, StepDivergence,
                                  TCQEngine, TCQService, TemporalGraph,
                                  WriteAheadLog)
    from repro_torch.core.faultinject import (CrashingWAL, FaultPlan,
                                              InjectedCrash, KernelFault,
                                              rung_faults)
    from repro_torch.data import TCQRequestStream
    from repro_torch.launch.serve import serve_closed_loop, serve_stream

    on_card = dev.type == "cuda"
    keep = g.t < cut_day
    g0 = TemporalGraph.from_edges(g.src[keep], g.dst[keep], g.t[keep],
                                  num_vertices=g.num_vertices)
    rest = np.flatnonzero(~keep)
    rest = rest[np.argsort(g.t[rest], kind="stable")]
    batches = [(g.src[c], g.dst[c], g.t[c])
               for c in np.array_split(rest, SERVE_BATCHES)]
    snaps = [g0]                    # the snapshot of every epoch
    for u, v, t in batches:
        snaps.append(snaps[-1].add_edges(u, v, t))
    check(snaps[-1].num_edges == g.num_edges, "ingest lost edges")
    stream = TCQRequestStream(int(g0.unique_ts[0]),
                              t_max=int(g.unique_ts[-1]), k=k, span=span,
                              seed=seed)
    windows = list(stream.requests(n_requests))
    by_path = {}
    fresh = {}                      # epoch -> cache-free engine

    def reference(epoch: int, tickets) -> None:
        """Each ticket's cores equal a fresh cache-free engine's
        query_batch on the ticket's pinned snapshot."""
        eng = fresh.get(epoch)
        if eng is None:
            eng = fresh[epoch] = TCQEngine(snaps[epoch], device=dev)
        want = eng.query_batch([{"k": tk.k, "h": tk.h, "ts": tk.ts,
                                 "te": tk.te} for tk in tickets])
        for tk, w in zip(tickets, want):
            check(tk.status == "done" and digest(tk.result) == digest(w),
                  f"ticket {tk.id} (epoch {epoch}, [{tk.ts}, {tk.te}]) "
                  "differs from a cache-free engine on its snapshot")

    def held(tickets, what: str, epoch_of=lambda tk: tk.epoch) -> None:
        by_epoch = {}
        for tk in tickets:
            by_epoch.setdefault(epoch_of(tk), []).append(tk)
        for epoch, tks in sorted(by_epoch.items()):
            reference(epoch, tks)
        log(f"{what}: {len(tickets)} tickets over epochs "
            f"{sorted(by_epoch)}, every one equal to a cache-free engine "
            "on its pinned snapshot")

    def expect(path, launches, svc=None, *, peel=True):
        """A healthy path: its kernel ran (or, cached, did not), segdeg
        and the scans never, and the service holds no ladder."""
        by_path[path] = launches
        check(svc is None or not ladders(svc), f"{path}: a ladder")
        if not on_card:
            return
        check((launches["wave_peel"] > 0) == peel,
              f"{path}: wave_peel launched {launches['wave_peel']} times")
        check(launches["segdeg"] == 0,
              f"{path}: segdeg launched {launches['segdeg']} times")
        check(launches["ssm_scan"] == launches["ssm_scan_bwd"] == 0,
              f"{path}: a scan launched")

    def pool_report(svc, what: str, wall: float, tickets) -> None:
        occ = [p["occupancy"] for p in svc.pool_log if p["device_steps"]]
        cc = svc.engine.stats().get("core_cache") or {}
        p = pcts(tickets, wall)
        log(f"{what}: {p['n']} requests in {wall:.3f}s ({p['qps']:.2f} "
            f"qps sustained); latency p50 {p['p50_ms']:.1f} ms, p95 "
            f"{p['p95_ms']:.1f} ms, p99 {p['p99_ms']:.1f} ms; "
            f"{len(svc.pool_log)} pools, mean lane occupancy "
            f"{np.mean(occ) if occ else 0.0:.2f}, "
            f"{sum(q['admitted_midflight'] for q in svc.pool_log)} "
            f"mid-flight admissions; core cache hit rate "
            f"{cc.get('hit_rate', 0.0):.3f} ({cc.get('hits', 0)} hits, "
            f"{cc.get('dominance_hits', 0)} by dominance, "
            f"{cc.get('invalidated', 0)} invalidated, "
            f"{cc.get('rekeyed', 0)} re-keyed; {cc.get('n_cores', 0)} "
            f"cores in {cc.get('bytes', 0)} bytes and "
            f"{cc.get('n_cells', 0)} cells held, "
            f"{cc.get('evicted_cores', 0)} cores and "
            f"{cc.get('evicted_cells', 0)} cells evicted)")

    root = ROOT / "build"
    root.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="serve-", dir=root))
    try:
        # -- closed loop on the final graph: the service's capacity
        (csvc, ctk, crep), _, n = run_path(
            lambda: serve_closed_loop(snaps[-1], windows, concurrency=8,
                                      device=dev))
        check(crep["completed"] == n_requests and crep["shed"] == 0,
              f"closed loop: {crep['completed']} done, {crep['shed']} shed")
        expect("serve_closed_loop", n, csvc)
        log(f"closed loop (concurrency 8): {crep['completed']} of "
            f"{crep['offered']} in {crep['wall_s']:.3f}s "
            f"({crep['qps']:.2f} qps), shed rate {crep['shed_rate']:.3f}, "
            f"{crep['timeouts']} timeouts; latency p50 "
            f"{crep['p50_ms']:.1f} ms, p95 {crep['p95_ms']:.1f} ms, p99 "
            f"{crep['p99_ms']:.1f} ms")
        held(ctk, "closed loop", lambda tk: len(batches))
        if on_card:
            profiled(lambda: serve_closed_loop(snaps[-1], windows,
                                               concurrency=8, device=dev),
                     "the closed loop again")

        # -- open loop at a share of that capacity, with the journal,
        # ingest while requests fly
        qps = load * crep["qps"]
        reqs = list(stream.open_loop(n_requests, qps=qps))
        log(f"open loop: {g0.num_edges} edges before day {cut_day} at "
            f"start, {rest.size} more in {len(batches)} push_edges batches "
            f"while {n_requests} requests (k={k}, {span}-day windows) "
            f"arrive at {qps:.3f}/s ({load:g} x the closed loop's "
            "throughput)")
        wal_dir = str(tmp / "wal")
        (svc, served, wall), _, n = run_path(lambda: serve_stream(
            snaps[0], reqs, qps=qps, ingest=iter(batches), wal_dir=wal_dir,
            fsync="batch", device=dev))
        check(svc.engine.device.type == dev.type, "service off the card")
        check(len(served) == n_requests and svc.epoch == len(batches),
              f"open loop served {len(served)} at epoch {svc.epoch}")
        check(svc.engine.resilience_events() == [], "ladder events")
        expect("serve_open_loop", n, svc)
        pool_report(svc, "open loop", wall, served)
        held(served, "open loop")
        crash_image = str(tmp / "crash-image")
        shutil.copytree(wal_dir, crash_image)

        # -- the same windows again, after the last ingest
        cc0 = dict(svc.engine.core_cache.stats())
        (_, replay, rwall), _, n = run_path(lambda: serve_stream(
            None, reqs, qps=qps, svc=svc, warm=False))
        cc1 = svc.engine.core_cache.stats()
        hits = (cc1["hits"] + cc1["dominance_hits"]
                - cc0["hits"] - cc0["dominance_hits"])
        probes = hits + cc1["misses"] - cc0["misses"]
        check(hits > 0, "replay: no core-cache hit")
        expect("serve_replay", n, svc)
        pool_report(svc, "replay after the last ingest", rwall, replay)
        held(replay, "replay")
        full = [tk for tk in replay if tk.result.stats.cells_cached > 0
                and tk.result.stats.cells_evaluated == 0]
        log(f"replay: {hits} core-cache hits of {probes} probes (hit "
            f"rate {hits / max(1, probes):.3f}), {len(full)} of "
            f"{len(replay)} tickets served from the cache alone")
        check(full, "replay: no ticket served from the cache alone")
        tk0 = full[0]
        (one, _, n) = run_path(lambda: (
            svc.submit({"k": tk0.k, "ts": tk0.ts, "te": tk0.te}),
            svc.run_until_idle())[0])
        check(one.result.stats.cells_evaluated == 0, "cached ticket peeled")
        expect("serve_cached_ticket", n, svc, peel=False)
        check(digest(one.result) == digest(tk0.result), "cached ticket")

        # -- recovery from the open loop's journal
        (rsvc, _, n) = run_path(
            lambda: TCQService.recover(crash_image, device=dev))
        rep = rsvc.recovery_report
        check(rsvc.engine.device.type == dev.type, "recovered off the card")
        check(rsvc.epoch == len(batches) and rsvc.graph.fingerprint()
              == snaps[-1].fingerprint(), "recovered graph differs")
        log(f"recover: snapshot seq {rep['snapshot_seq']} + "
            f"{rep['wal_records']} journal records in "
            f"{1e3 * rep['recover_s']:.1f} ms, {rep['pending_after']} "
            "tickets re-queued")
        by_path["serve_recover"] = n
        (redo, _, n) = run_path(rsvc.run_until_idle)
        want = {tk.id: tk for tk in served}
        redo = [tk for tk in redo if tk.id in want]
        check(len(redo) == n_requests, f"recovered {len(redo)} tickets")
        for tk in redo:
            check(tk.epoch == want[tk.id].epoch and digest(tk.result)
                  == digest(want[tk.id].result), f"recovered {tk.id}")
        expect("serve_recovered_drain", n, rsvc)
        more = [{"k": r["k"], "ts": r["ts"] + 7, "te": r["te"] + 7}
                for r in reqs[:8]]
        got = [rsvc.submit(r) for r in more]
        rsvc.run_until_idle()
        base = [svc.submit(r) for r in more]
        svc.run_until_idle()
        check([digest(t.result) for t in got]
              == [digest(t.result) for t in base],
              "recovered service drains differ from the uninterrupted one")
        log(f"recovered drains: {len(redo)} re-queued tickets equal the "
            "open loop's, and 8 further requests equal the uninterrupted "
            "service's")
        rsvc.wal.close()
        svc.wal.close()

        # -- a crash mid-tape, then recovery
        ops = serve_tape(reqs[:16], batches)
        clean = drive_tape(TCQService(snaps[0], device=dev), ops)
        n_rec = sum(1 for op in ops if op[0] == "edges") + 10
        cdir = str(tmp / "crash")
        killer = CrashingWAL(WriteAheadLog(cdir, fsync="batch"),
                             crash_after_records=n_rec)
        seen = {}
        try:
            drive_tape(TCQService(snaps[0], device=dev, wal=killer), ops,
                       seen)
            check(False, "the injected crash never fired")
        except InjectedCrash:
            pass
        (csvc2, _, n) = run_path(
            lambda: TCQService.recover(cdir, device=dev))
        after = {tk.id: tk for tk in csvc2.run_until_idle()}
        done = {**{i: t for i, t in seen.items() if t.done}, **after}
        check(set(done) == set(range(len(done))) and len(done) > 0,
              f"crash recovery lost admissions: {sorted(done)}")
        for i, tk in done.items():
            check(tk.epoch == clean[i].epoch and digest(tk.result)
                  == digest(clean[i].result), f"crash-recovered {i}")
        by_path["serve_crash_recover"] = n
        log(f"crash after journal record {n_rec}: recover in "
            f"{1e3 * csvc2.recovery_report['recover_s']:.1f} ms, "
            f"{len(done)} admissions equal the uninterrupted tape's")
        csvc2.wal.close()
        # phase 14 runs this tape on meshes, held to these drains
        tape = {"g0": snaps[0].state_dict(), "ops": ops, "n_rec": n_rec,
                "clean": {i: digest(tk.result) for i, tk in clean.items()
                          if tk.status == "done"},
                "recovered": {i: digest(tk.result)
                              for i, tk in done.items()}}

        # -- chaos: one fused failure, then one silent corruption
        # eight overlapping windows around the open loop's richest one:
        # one cluster, so one pool and one ladder
        best = max(served, key=lambda tk: len(tk.result))
        chaos = [{"k": k, "ts": best.ts + 4 * (i - 4),
                  "te": best.ts + 4 * (i - 4) + span} for i in range(8)]
        healthy = TCQService(snaps[-1], device=dev, cache=False)

        def run_healthy():
            tks = [healthy.submit(r) for r in chaos]
            healthy.run_until_idle()
            return tks
        htk, hwall, n = run_path(run_healthy)
        expect("serve_chaos_healthy", n, healthy)
        log(f"chaos windows, healthy: {len(htk)} requests in one pool, "
            f"{hwall:.3f}s, launches {json.dumps(n)}")
        for name, plan, every, exc in (
                ("serve_chaos_fail", FaultPlan(fail_at=(3,)), 0,
                 KernelFault),
                ("serve_chaos_corrupt", FaultPlan(corrupt_at=(3,)), 1,
                 StepDivergence)):
            cfg = ResilienceConfig(tripwire_every=every,
                                   rung_wrapper=rung_faults({"fused": plan}))
            xsvc = TCQService(snaps[-1], device=dev, cache=False,
                              use_kernel=True, resilience=cfg)
            xtk = [xsvc.submit(r) for r in chaos]

            def run():
                try:
                    xsvc.run_until_idle()
                except exc as e:
                    return e
                return None
            err, xwall, n = run_path(run)
            by_path[name] = n
            ev = xsvc.engine.resilience_events()
            reason = "error" if plan.fail_at else "divergence"
            check([(e["rung"], e["reason"]) for e in ev]
                  == [("fused", reason)], f"{name}: events {ev}")
            # on the card the fault leaves the service as an exception;
            # the CPU's plain rungs demote and replay instead
            check((err is not None) == on_card,
                  f"{name}: {'no exception' if err is None else repr(err)}")
            finished = [tk for tk in xtk if tk.status == "done"]
            check(on_card or len(finished) == len(xtk),
                  f"{name}: {len(finished)} of {len(xtk)} done")
            for a, b in zip(xtk, htk):
                check(a.status != "done" or digest(a.result)
                      == digest(b.result),
                      f"{name}: ticket {a.id} differs from the healthy run")
            orc = sum(lad.oracle_calls for lad in ladders(xsvc))
            calls = ev[0]["call"]
            if on_card:
                check(n["segdeg"] == n["ssm_scan"] == n["ssm_scan_bwd"]
                      == 0, f"{name}: launches {n}")
                check(n["wave_peel"] == calls - (1 if plan.fail_at else 0),
                      f"{name}: {n['wave_peel']} wave_peel launches for "
                      f"{calls} calls")
                check(orc == (calls if every else 0),
                      f"{name}: {orc} oracle steps for {calls} calls")
            log(f"{name}: {ev[0]['rung']} {reason} at call {calls} "
                f"{'raised ' + type(err).__name__ if err else 'demoted'} "
                f"after {xwall:.3f}s, logged once; {len(finished)} of "
                f"{len(xtk)} tickets done before it, equal to the healthy "
                f"run; launches {json.dumps(n)}, {orc} oracle steps")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"serving launches by path: {json.dumps(by_path)}")
    return {"by_path": by_path, "capacity_qps": crep["qps"], "tape": tape}


# ------------------------------------------- phase 8: the paper's baseline
def phase_baseline(dev, g, req: dict) -> dict:
    """PHC-Index + iPHC (the paper's baseline) against OTCD on one window;
    see item 8 of the module docstring."""
    import numpy as np
    from repro_torch.core import PHCIndex, TCQEngine, iphc_query
    from repro_torch.core.tcd import degrees

    k, ts, te = req["k"], req["ts"], req["te"]
    on_card = dev.type == "cuda"
    idx, build_s, n_build = run_path(
        lambda: PHCIndex(g, k, ts, te, device=dev))
    n_uts = int(idx.uts.size)
    rows = int((idx.core_time < np.iinfo(np.int64).max).any(1).sum())
    log(f"PHC-Index (k={k}, [{ts}, {te}], {n_uts} days) built on {dev} in "
        f"{idx.build_time_s:.3f}s ({build_s:.3f}s wall): {idx.tcd_calls} "
        f"TCD calls on the {g.num_edges}-edge TEL, {idx.peel_iters} peel "
        f"iterations, {idx.host_syncs} host reads; {rows} of {n_uts} rows "
        f"hold a core; index {idx.nbytes()} bytes against the TEL's "
        f"{g.memory_bytes()}")
    iphc, iphc_s, n_iphc = run_path(lambda: iphc_query(g, idx, k, ts, te))
    eng = TCQEngine(g, device=dev)
    serial, serial_cold_s, _ = run_path(lambda: eng.query(k, ts, te))
    wave, wave_cold_s, n_wave = run_path(
        lambda: eng.query(k, ts, te, mode="wave"))
    _, serial_s, _ = run_path(lambda: eng.query(k, ts, te))
    _, wave_s, _ = run_path(lambda: eng.query(k, ts, te, mode="wave"))
    same_cores(iphc, serial, "iPHC vs OTCD serial")
    same_cores(wave, serial, "OTCD wave vs serial")
    check(len(iphc) == req["cores"],
          f"iPHC found {len(iphc)} cores, phase 3 {req['cores']}")
    st = iphc.stats
    log(f"iPHC online {iphc_s:.3f}s ({st.cells_evaluated} cells, "
        f"{st.duplicates} duplicates); OTCD serial {serial_s:.4f}s warm "
        f"({serial_cold_s:.4f}s cold), wave {wave_s:.4f}s warm "
        f"({wave_cold_s:.4f}s cold); {len(iphc)} cores, equal across the "
        f"three; iPHC / OTCD: {iphc_s / serial_s:.1f}x serial, "
        f"{iphc_s / wave_s:.1f}x wave (warm); with the build "
        f"{(build_s + iphc_s) / wave_s:.1f}x wave")

    t0 = time.perf_counter()
    ref = PHCIndex(g, k, ts, te, device="cpu")
    cpu_s = time.perf_counter() - t0
    check(np.array_equal(idx.core_time, ref.core_time)
          and np.array_equal(idx.uts, ref.uts), "core_time differs from "
          "the CPU build")
    check((idx.tcd_calls, idx.peel_iters) == (ref.tcd_calls, ref.peel_iters),
          f"build counters {idx.tcd_calls}/{idx.peel_iters} vs the CPU's "
          f"{ref.tcd_calls}/{ref.peel_iters}")
    log(f"PHC-Index on {dev}: core_time [{n_uts}, {g.num_vertices}] "
        f"bit-identical to the CPU build ({cpu_s:.3f}s)")

    stock = TCQEngine(g, degrees, device=dev, cache=True)
    check(stock.core_cache is None, "a degree_fn engine kept its cache")
    custom, custom_s, n_custom = run_path(
        lambda: stock.query(k, ts, te, mode="wave"))
    same_cores(custom, wave, "degree_fn=degrees vs the default engine")
    check(custom.stats.window_edges == g.num_edges
          and custom.stats.device_steps == custom.stats.cells_evaluated,
          "the degree_fn query did not run serial on the full TEL")
    log(f"degree_fn=degrees, mode='wave': {len(custom)} cores equal to the "
        f"default engine's, serial on the full TEL "
        f"({custom.stats.cells_evaluated} cells, {custom_s:.4f}s), "
        "core cache off")

    by_path = {"phc_build": n_build, "iphc_query": n_iphc,
               "degree_fn_query": n_custom}
    for path, n in by_path.items():
        check(not any(n.values()), f"{path}: launches {n}")
    steps = wave.stats.device_steps
    check(not on_card or n_wave["wave_peel"] >= steps,
          f"OTCD wave: {n_wave['wave_peel']} wave_peel launches for {steps} "
          "steps")
    log(f"baseline launches by path: {json.dumps(by_path)}")
    log("baseline: " + json.dumps({
        "k": k, "window": [ts, te], "days": n_uts, "cores": len(iphc),
        "build_s": idx.build_time_s, "tcd_calls": idx.tcd_calls,
        "peel_iters": idx.peel_iters, "host_syncs": idx.host_syncs,
        "index_bytes": idx.nbytes(), "tel_bytes": g.memory_bytes(),
        "iphc_s": iphc_s, "otcd_serial_s": serial_s,
        "otcd_wave_s": wave_s, "otcd_serial_cold_s": serial_cold_s,
        "otcd_wave_cold_s": wave_cold_s, "cpu_build_s": cpu_s,
        "degree_fn_s": custom_s}))
    return {"by_path": by_path}


# ---------------------------------------------- phase 9: the LM families
# (path, arch, cuts, prompt tokens, cache positions, encoder frames): each
# family the JAX package serves beyond phase 6's, at its published widths;
# a cut only where one card cannot hold the model.
FAMILY_RUNS = (
    ("granite_moe", "granite-moe-1b-a400m", {}, 2_048, 32_768, None),
    ("rwkv6", "rwkv6-1.6b", {}, 2_048, 32_768, None),
    # whisper's 30-s window is 1,500 encoder frames (n_audio_ctx) and its
    # decoder holds 448 positions (n_text_ctx), arXiv:2212.04356
    ("whisper", "whisper-small", {}, 64, 448, 1_500),
    # 80 layers are 133.1 GiB in bf16 (71.46 B parameters)
    ("qwen2_vl", "qwen2-vl-72b", {"n_layers": 16}, 2_048, 32_768, None),
    # one Mamba + dense and one Mamba + MoE layer (16 experts top-2); the
    # 8-layer period with its experts is 84.5 GiB in bf16
    ("jamba_moe", JAMBA, {"n_layers": 2}, 2_048, 32_768, None),
)
FAMILY_SMOKE = ("granite-moe-1b-a400m", "llama4-scout-17b-a16e", JAMBA,
                "rwkv6-1.6b", "whisper-small", "qwen2-vl-72b")


def family_batch(cfg, b: int, s: int, s_enc, rng, dev) -> dict:
    """A seeded prompt as the JAX package's batch_specs lays it out:
    tokens, or patch embeddings with M-RoPE positions [3, B, S] (two
    32 x 32 frames: time, row, column); encoder frames for whisper."""
    import numpy as np
    import torch

    batch = {}
    if cfg.input_mode == "embeds":
        batch["embeds"] = torch.from_numpy(rng.normal(
            0, 1, (b, s, cfg.d_model)).astype(np.float32)).to(dev)
    else:
        batch["tokens"] = torch.from_numpy(
            rng.integers(0, cfg.vocab, (b, s))).to(dev)
    if s_enc:
        batch["enc_embeds"] = torch.from_numpy(rng.normal(
            0, 1, (b, s_enc, cfg.d_model)).astype(np.float32)).to(dev)
    if cfg.pos == "mrope":
        i = torch.arange(s, dtype=torch.int32)
        pos = torch.stack([i // 1024, (i // 32) % 32, i % 32])
        batch["positions"] = pos[:, None].expand(3, b, s).contiguous().to(dev)
    return batch


def decode_inputs(cfg, b: int, n: int, rng, dev) -> list:
    """The input of each decode step past the first: None (feed the
    greedy token back) or, for an embeds-input model, a seeded embedding
    [B, 1, d] (its stub frontend has no token table)."""
    import numpy as np
    import torch

    if cfg.input_mode != "embeds":
        return [None] * n
    e = torch.from_numpy(rng.normal(0, 1, (n, b, 1, cfg.d_model)).astype(
        np.float32)).to(dev)
    return list(e)


def greedy(model, cache, tok, start: int, feeds: list):
    """serve_step from position ``start``: each step's input is the last
    greedy token, or the embedding ``feeds`` gives.  Returns the tokens
    [B, len(feeds)]."""
    import torch
    from repro_torch.launch.steps import serve_step

    toks = []
    for i, e in enumerate(feeds):
        step = {"tokens": tok} if e is None else {"embeds": e}
        tok, _ = serve_step(model, cache, {**step, "cache_index": start + i})
        toks.append(tok)
    return torch.cat(toks, 1)


def phase_families_smoke(dev) -> None:
    """Each family's smoke-size model (f32) with the same weights on the
    card and on the CPU: prefill logits and 8 teacher-forced decode steps'
    logits within rtol=1e-4, atol=1e-4 x min(1, max|CPU|)
    (tests/test_torch_lm.py's ``_close``); the greedy tokens of both are
    reported."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import decode_logits, prefill_step
    from repro_torch.models.transformer import (Transformer, init_cache,
                                                init_params)

    b, s, n, s_max = 2, 16, 8, 32
    t0 = time.perf_counter()
    for arch in FAMILY_SMOKE:
        cfg = get_smoke_config(arch)
        s_enc = 12 if cfg.encoder_layers else None
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        rng = np.random.default_rng(5)
        prompt = family_batch(cfg, b, s, s_enc, rng, "cpu")
        forced = family_batch(cfg, b, n, None, rng, "cpu")
        feeds = decode_inputs(cfg, b, n, rng, "cpu")
        out = []
        for where in ("cpu", dev):
            model = Transformer(cfg, params, device=where)
            d = model.device
            at = {k: v.to(d) for k, v in prompt.items()}
            cache = init_cache(cfg, b, s_max, d, s_enc=s_enc)
            logits = [prefill_step(model, at, cache)[0]]
            for i in range(n):
                step = {k: forced[k][:, i:i + 1].to(d)
                        for k in ("tokens", "embeds") if k in forced}
                logits.append(decode_logits(
                    model, cache, {**step, "cache_index": s + i})[0])
            last, cache = prefill_step(model, at, cache)
            tok = last.argmax(-1).to(torch.int32)
            toks = greedy(model, cache, tok, s,
                          [None if e is None else e.to(d) for e in feeds])
            out.append((torch.cat(logits, 1).cpu(), toks.cpu()))
            del model, cache
        (lc, tc), (lg, tg) = out
        err = float((lg - lc).abs().max())
        atol = 1e-4 * min(1.0, float(lc.abs().max()))
        check(bool(torch.isfinite(lg).all()) and torch.allclose(
            lg, lc, rtol=1e-4, atol=atol),
            f"smoke {arch}: card vs CPU logits differ by {err}")
        log(f"smoke {arch} (f32, d_model {cfg.d_model}, {cfg.n_layers} "
            f"layers): prefill and {n} teacher-forced decode logits on the "
            f"card within rtol=1e-4, atol={atol:.3g} of the CPU (max |diff| "
            f"{err:.3g}); greedy tokens "
            f"{'equal' if torch.equal(tg, tc) else 'DIFFERENT'}")
    log(f"smoke families on the card vs the CPU: {time.perf_counter() - t0:.1f}s")


def hold_rwkv_chunks(model, tokens) -> None:
    """RWKV at its published width: layer 0's time mix over the first 64
    prompt tokens in one 64-token chunk against 64 one-token steps, both
    from a zero state with the state carried in float32.  The two forms
    differ by bf16 rounding only: each within a relative (Frobenius)
    error of 1e-2, 2.6 units of bf16 rounding (2**-8)."""
    import torch
    from repro_torch.models.layers import norm
    from repro_torch.models.rwkv import rwkv_time_mix, rwkv_time_mix_step
    from repro_torch.models.transformer import _zero_state

    cfg = model.cfg
    p0 = model.params["dec"].select(0)["sub0"]
    with torch.inference_mode():
        x = norm(model.params["embed"]["tok"][tokens[:, :64]], p0["ln1"],
                 cfg.norm)
        st = _zero_state(cfg, cfg.layer_specs()[0], x)
        y, (S, _) = rwkv_time_mix(p0["mixer"], x, cfg, st, chunk=64)
        ys = []
        for i in range(64):
            yi, st = rwkv_time_mix_step(p0["mixer"], x[:, i:i + 1], cfg, st)
            ys.append(yi)
        y1 = torch.cat(ys, 1)

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    ry, rs = rel(y1, y), rel(st[0], S)
    check(ry <= 1e-2 and rs <= 1e-2 and bool(torch.isfinite(y).all()),
          f"rwkv chunk 64 vs 64 steps: relative error {ry} (out), "
          f"{rs} (state)")
    log(f"rwkv6 layer 0 at d_model {cfg.d_model} ({cfg.dtype}): one "
        f"64-token chunk vs 64 single-token steps from a zero state: "
        f"relative error {ry:.3g} (out, max |diff| "
        f"{float((y1.float() - y.float()).abs().max()):.3g}), {rs:.3g} "
        f"(f32 state), within 1e-2")


def phase_families(dev, runs=FAMILY_RUNS, n_dec: int = 32) -> dict:
    """Each config of ``runs`` at its published widths in bf16, seeded
    weights drawn on the card: a prefill of 2 prompts into its cache, then
    ``n_dec`` greedy ``serve_step``s, each path with the launch counters
    zeroed before it and read after it; only the Mamba layers launch a
    kernel (ssm_scan, one per layer and pass).  Each model is freed before
    the next is built."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import prefill_step
    from repro_torch.models.transformer import Transformer, init_cache

    on_card = dev.type == "cuda"
    by_path, summary, tokens = {}, {}, {}
    b = 2
    for name, arch, cuts, s, s_max, s_enc in runs:
        t_run = time.perf_counter()
        full = get_config(arch)
        cfg = full.scaled(**cuts)
        t0 = time.perf_counter()
        model = Transformer(cfg, generator=torch.Generator(dev).manual_seed(0),
                            device=dev)
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        specs = [sp.mixer + ("+moe" if sp.mlp == "moe" else "")
                 for sp in cfg.layer_specs()]
        cut = ", ".join(f"{k} {getattr(full, k)} -> {v}"
                        for k, v in cuts.items()) or "none"
        widths = (f"d_model {cfg.d_model}, {cfg.n_layers} layers "
                  f"{sorted(set(specs))}, d_ff {cfg.d_ff}, vocab {cfg.vocab}")
        if cfg.moe:
            widths += (f", {cfg.moe.num_experts} experts top-"
                       f"{cfg.moe.top_k} d_expert {cfg.moe.d_expert}"
                       f"{' + shared' if cfg.moe.shared_expert else ''}")
        if cfg.encoder_layers:
            widths += f", {cfg.encoder_layers} encoder layers"
        log(f"{name}: {arch} ({widths}); cuts: {cut}; {cfg.dtype}, "
            f"{n_params / 1e9:.3f} B parameters "
            f"({n_params * 2 / 2**30:.1f} GiB), seeded init on the card in "
            f"{init_s:.1f}s")

        rng = np.random.default_rng(17)
        prompt = family_batch(cfg, b, s, s_enc, rng, dev)
        feeds = decode_inputs(cfg, b, n_dec, rng, dev)
        cache = init_cache(cfg, b, s_max, dev, s_enc=s_enc)

        def prefill():
            return prefill_step(model, prompt, cache)[0]

        def first_token(last):
            return last[:, -1].argmax(-1, keepdim=True).to(torch.int32)

        greedy(model, cache, first_token(prefill()), s, feeds[:2])  # warm-up
        last, pre_s, n_pre = run_path(prefill)
        tok0 = first_token(last)
        toks, dec_s, n_dec_run = run_path(
            lambda: greedy(model, cache, tok0, s, feeds))
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        check(tuple(last.shape) == (b, 1, cfg.padded_vocab)
              and bool(torch.isfinite(last).all()),
              f"{name}: prefill logits")
        check(tuple(toks.shape) == (b, n_dec) and int(toks.min()) >= 0
              and int(toks.max()) < cfg.vocab, f"{name}: decoded tokens")
        n_mamba = sum(sp.mixer == "mamba" for sp in cfg.layer_specs())
        for path, n, want in ((f"{name}_prefill", n_pre, n_mamba),
                              (f"{name}_decode", n_dec_run,
                               n_mamba * n_dec)):
            by_path[path] = n
            if on_card:
                check(n == {**NO_TCQ_LAUNCHES, "ssm_scan": want,
                            "ssm_scan_bwd": 0},
                      f"{path}: launches {n}, want ssm_scan {want} and no "
                      "other")
        if name == "rwkv6":
            hold_rwkv_chunks(model, prompt["tokens"])
        t_prof = time.perf_counter()
        busy_pre = profiled(prefill, f"{name} prefill", top=4,
                            cpu_ops=False)
        busy_dec = profiled(lambda: greedy(model, cache, tok0, s, feeds[:4]),
                            f"4 {name} decode steps", top=4, cpu_ops=False)
        t_prof = time.perf_counter() - t_prof
        summary[name] = {
            "arch": arch, "cuts": cuts, "params": n_params,
            "prefill_tokens": b * s, "cache_positions": s_max,
            "encoder_frames": s_enc, "prefill_s": pre_s,
            "prefill_tokens_per_s": b * s / pre_s,
            "decode_ms_per_step": 1e3 * dec_s / n_dec,
            "peak_gib": peak / 2**30, "prefill_busy": busy_pre,
            "decode_busy": busy_dec}
        tokens[name] = torch.cat([tok0, toks], 1).cpu()
        log(f"{name}: prefill {b} x {s} tokens"
            f"{f' (encoder {b} x {s_enc} frames)' if s_enc else ''} into a "
            f"{s_max}-position cache in {pre_s:.3f}s ({b * s / pre_s:.0f} "
            f"tokens/s); {n_dec} greedy steps of {b} in {dec_s:.3f}s "
            f"({1e3 * dec_s / n_dec:.2f} ms a step); peak "
            f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated since "
            f"the weights were drawn); first tokens {toks[:, :6].tolist()}; "
            f"launches prefill {n_pre}, decode {n_dec_run}; {name} took "
            f"{time.perf_counter() - t_run:.1f}s ({t_prof:.1f}s profiling)")
        del model, cache, prompt, feeds, last, toks
        if on_card:
            torch.cuda.empty_cache()
    log("families: " + json.dumps(summary))
    return {"by_path": by_path, "tokens": tokens}


# ------------------------------------------- phase 10: training on the card
# H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet, 700 W): the
# denominator of model-FLOP utilisation
BF16_PEAK_FLOPS = 989e12
TRAIN_SMOKE = (JAMBA, "granite-moe-1b-a400m", "qwen2-7b")
TRAIN_DIR = ROOT / "build" / "chip_smoke_train"


def hold_scan_bwd(la, states, s0, g, what: str, reps: int = 0,
                  plain_reps: int = 0) -> dict:
    """The reverse scan's kernel against its plain loop on the card at one
    shape: each output within rtol=1e-5 and atol=1e-5 x min(1, max|want|)
    (the model tests' scaling); with ``reps``, both timed beside the
    kernel's byte bound."""
    import torch
    from repro_torch.kernels.ssm_scan import ssm_scan_bwd, ssm_scan_bwd_ref

    got = ssm_scan_bwd(la, states, s0, g)
    want = ssm_scan_bwd_ref(la, states, s0, g)
    torch.cuda.synchronize()
    err = 0.0
    for name, x, w in zip(("dlog_a", "dbx", "ds0"), got, want):
        e = float((x - w).abs().max())
        scale = min(1.0, float(w.abs().max()))
        check(torch.allclose(x, w, rtol=1e-5, atol=1e-5 * scale),
              f"ssm_scan_bwd at {what}: {name} max |diff| {e}")
        err = max(err, e)
    del got, want
    if not reps:
        log(f"ssm_scan_bwd at {what}: within rtol=1e-5 (atol scaled) of "
            f"the plain loop (max |diff| {err:.3g})")
        return {"max_abs_err": err}
    ms = time_ms(lambda: ssm_scan_bwd(la, states, s0, g), reps)
    dev_ms, trace = device_ms(lambda: ssm_scan_bwd(la, states, s0, g), reps,
                              "ssm_scan_bwd_kernel")
    plain_ms = time_ms(lambda: ssm_scan_bwd_ref(la, states, s0, g),
                       plain_reps)
    nb, ns, nf = la.shape
    # reads log_a, states, g (and s0) once, writes dlog_a, dbx (and ds0)
    # once; an exp, three multiplies and an add per element
    nbytes = 4 * (5 * nb * ns * nf + 2 * nb * nf)
    bound_ms, bound_by = bound(nbytes, 5 * nb * ns * nf, F32_OPS_PER_S)
    log(f"ssm_scan_bwd at {what}: within rtol=1e-5 (atol scaled) of the "
        f"plain loop (max |diff| {err:.3g}); {ms:.4f} ms a call (device "
        f"time {fmt_ms(dev_ms)}), plain {plain_ms:.3f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by})")
    return {"max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "device_trace": trace, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "timing_shape": {"BSF": [nb, ns, nf]},
            "bound_bytes_dense": nbytes}


SCAN_RANK_SHAPE = (2, 2_048, 131_072)   # a (1, 2) rank's channel shard


def phase_scan_timing(dev) -> dict:
    """The scans' standalone holds and times taken before any gloo world
    has used the card (after one, ``torch.profiler`` in this process
    loses kernel records: PERF.md §7): ssm_scan_bwd at the training
    shape [2, 2,048, 262,144] (s0 = 0, as the model starts; 10a's), and
    both scans at a (1, 2) rank's shard (12b's and 13b's), each on states
    the forward kernel computed."""
    import torch
    from repro_torch.kernels.ssm_scan.ops import scan_forward

    gen = torch.Generator(dev).manual_seed(23)
    out = {}
    for key, shp in (("bwd_train", (2, 2_048, 262_144)),
                     ("rank", SCAN_RANK_SHAPE)):
        la = -0.1 * torch.rand(shp, generator=gen, device=dev)
        bx = 0.1 * torch.randn(shp, generator=gen, device=dev)
        s0 = torch.zeros((shp[0], shp[2]), device=dev)
        if key == "rank":
            out["fwd_rank"] = hold_scan(la, bx, s0, "(1, 2) rank's", 10, 3)
        states = scan_forward(la, bx, s0)
        del bx
        g = torch.randn(shp, generator=gen, device=dev)
        out["bwd_rank" if key == "rank" else key] = hold_scan_bwd(
            la, states, s0, g, f"{list(shp)}", 10, 2)
        del la, states, g, s0
        torch.cuda.empty_cache()
    return out


def phase_train_kernel(dev, at_train: dict) -> dict:
    """10a: the reverse scan's kernel held to its plain loop at ragged
    shapes (F not a multiple of 256, S = 1 and S = 3, s0 != 0), on states
    the forward kernel computed; its hold and times at the training shape
    [2, 2,048, 262,144] are ``at_train`` (``phase_scan_timing``)."""
    import torch
    from repro_torch.kernels.ssm_scan.ops import scan_forward

    gen = torch.Generator(dev).manual_seed(23)

    def inputs(b, s, f, s0_zero):
        la = -2.0 * torch.rand((b, s, f), generator=gen, device=dev)
        bx = torch.randn((b, s, f), generator=gen, device=dev)
        s0 = (torch.zeros((b, f), device=dev) if s0_zero else
              torch.randn((b, f), generator=gen, device=dev))
        g = torch.randn((b, s, f), generator=gen, device=dev)
        return la, scan_forward(la, bx, s0), s0, g

    err = 0.0
    for b, s, f in ((2, 1, 1_000), (2, 3, 4_099), (3, 37, 513)):
        err = max(err, hold_scan_bwd(*inputs(b, s, f, False),
                                     f"[{b}, {s}, {f}], s0 != 0")
                  ["max_abs_err"])
    return {"name": "ssm_scan_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu",
            "replaces": "src/repro/kernels/ssm_scan/kernel.py:67",
            "note": "the adjoint of ssm_scan_pallas; the TPU package "
                    "differentiates a plain chunked scan through XLA",
            **at_train, "max_abs_err": max(err, at_train["max_abs_err"]),
            "library_ms": None}


def _named_grads(model, batch):
    """(loss, {name: gradient}) of ``loss_fn`` over every parameter."""
    import torch
    from repro_torch.models.transformer import loss_fn

    model.requires_grad_(True)
    named = list(model.named_parameters())
    loss, _ = loss_fn(model, batch)
    grads = torch.autograd.grad(loss, [p for _, p in named],
                                allow_unused=True)
    return loss.detach(), {n: (torch.zeros_like(p) if g is None else g)
                           for (n, p), g in zip(named, grads)}


def _train_batch(cfg, b, s, seed, step, dev) -> dict:
    import torch
    from repro_torch.data import SyntheticLMData

    data = SyntheticLMData(vocab=cfg.vocab, batch=b, seq=s, seed=seed,
                           input_mode=cfg.input_mode, d_model=cfg.d_model,
                           encoder=cfg.encoder_layers > 0,
                           mrope=cfg.pos == "mrope")
    return {k: torch.from_numpy(v).to(dev)
            for k, v in data.batch_at(step).items()}


def phase_train_smoke(dev) -> dict:
    """10b: the smoke Jamba (with experts), MoE and dense configs in f32
    with the same weights on the card and on the CPU: ``loss_fn`` and
    every gradient within rtol=1e-4 (atol 1e-4 x the leaf's scale), then
    one ``build_train_step`` step and every parameter (Adafactor at the
    same tolerance; AdamW, whose first steps move a parameter by about lr
    whatever |g|, to rtol=1e-4 and atol 5% of lr, as
    tests/test_torch_train_step.py holds it to the JAX package)."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.transformer import Transformer, init_params

    by_path = {}
    for arch in TRAIN_SMOKE:
        cfg = get_smoke_config(arch)
        runs = []
        for where in ("cpu", dev):
            def run():
                # the same seeded weights, drawn anew: a model on the CPU
                # holds (and trains) the very tensors it is given
                params = init_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu")
                model = Transformer(cfg, params, device=where)
                batch = _train_batch(cfg, 2, 16, 1, 0, where)
                loss, grads = _named_grads(model, batch)
                step, opt = build_train_step(cfg)
                state = opt.init(model.params.tree())
                state, m = step(model, state, batch)
                return (loss.cpu(), {k: g.cpu() for k, g in grads.items()},
                        float(m["loss"]), opt,
                        {n: p.detach().cpu()
                         for n, p in model.named_parameters()})
            out, _, n = run_path(run)
            runs.append(out)
        (lc, gc, sc, opt, pc), (lg, gg, sg, _, pg) = runs
        n_mamba = sum(sp.mixer == "mamba" for sp in cfg.layer_specs())
        want = {**NO_TCQ_LAUNCHES, "ssm_scan": 4 * n_mamba,
                "ssm_scan_bwd": 2 * n_mamba}
        check(dev.type != "cuda" or n == want,
              f"{arch} smoke training: launches {n}, want {want}")
        by_path[f"{arch}_smoke_train"] = n
        check(torch.allclose(lg, lc, rtol=1e-4, atol=1e-4)
              and abs(sg - sc) <= 1e-4 * abs(sc),
              f"{arch} smoke: loss card {float(lg)} / {sg}, CPU "
              f"{float(lc)} / {sc}")
        adamw = type(opt).__name__ == "AdamW"
        worst = {"grad": 0.0, "param": 0.0}
        for kind, got, ref in (("grad", gg, gc), ("param", pg, pc)):
            for name, w in ref.items():
                scale = min(1.0, float(w.abs().max()))
                atol = 0.05 * opt.lr if kind == "param" and adamw else \
                    1e-4 * scale
                e = float((got[name] - w).abs().max())
                check(torch.allclose(got[name], w, rtol=1e-4, atol=atol),
                      f"{arch} smoke: {kind} {name} max |diff| {e}")
                worst[kind] = max(worst[kind], e)
        log(f"{arch} smoke training (f32, {len(gc)} parameters, "
            f"{type(opt).__name__}): loss on the card {float(lg):.6f}, CPU "
            f"{float(lc):.6f}; every gradient (max |diff| "
            f"{worst['grad']:.3g}) and, after one train step, every "
            f"parameter (max |diff| {worst['param']:.3g}) within tolerance "
            f"of the CPU; launches {json.dumps(n)}")
    return by_path


def phase_train(dev) -> dict:
    """10c: Jamba-1.5-Large at its published widths (8 layers, experts
    removed; phase 6's model) trained on the card in bf16 with its config's
    Adafactor: one gradient pass (every gradient finite, every Mamba
    layer's in_proj, x_dbc and A_log gradient non-zero), then 3
    ``build_train_step`` steps on ``SyntheticLMData`` batches of 2 x 2,048
    tokens, each with the launch counters zeroed before it (with remat,
    ssm_scan 2 and ssm_scan_bwd 1 per Mamba layer), then a 4th step under
    the profiler."""
    import re

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.transformer import Transformer

    cfg = get_config(JAMBA).scaled(n_layers=8, moe=None)
    b, s = 2, 2_048
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = Transformer(cfg, generator=torch.Generator(dev).manual_seed(0),
                        device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    n_mamba = sum(sp.mixer == "mamba" for sp in cfg.layer_specs())
    step, opt = build_train_step(cfg, n_micro=1, lr=3e-4)
    batches = [_train_batch(cfg, b, s, 0, i, dev) for i in range(4)]
    log(f"jamba training: {cfg.name}, 8 layers at published widths, "
        f"experts removed, {cfg.dtype}, {n_params / 1e9:.3f} B parameters, "
        f"{type(opt).__name__}(lr={opt.lr}); batches {b} x {s} tokens")

    (loss0, grads), grad_s, n_grad = run_path(
        lambda: _named_grads(model, batches[0]))
    check(bool(torch.isfinite(loss0)), f"jamba gradient pass: loss {loss0}")
    mamba = re.compile(
        r"params\.dec\.sub(\d+)\.mixer\.(in_proj|x_dbc|A_log)$")
    seen = 0
    for name, g in grads.items():
        check(bool(torch.isfinite(g).all()), f"jamba: {name} gradient")
        if mamba.search(name):
            seen += 1
            check(bool((g != 0).any()), f"jamba: {name} gradient is zero")
    check(seen == 3 * n_mamba, f"jamba: {seen} Mamba gradients checked")
    del grads
    want = {**NO_TCQ_LAUNCHES, "ssm_scan": 2 * n_mamba,
            "ssm_scan_bwd": n_mamba}
    on_card = dev.type == "cuda"
    check(not on_card or n_grad == want,
          f"jamba gradient pass: launches {n_grad}")
    log(f"jamba gradient pass: loss {float(loss0):.4f}, every gradient "
        f"finite, the {seen} in_proj, x_dbc and A_log gradients of the "
        f"{n_mamba} Mamba layers non-zero; {grad_s:.2f}s; launches "
        f"{json.dumps(n_grad)}")

    state = opt.init(model.params.tree())
    walls, total = [], {k: 0 for k in want}
    for i in range(3):
        (state, m), wall, n = run_path(
            lambda i=i, st=state: step(model, st, batches[i]))
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        check(not on_card or n == want,
              f"jamba train step {i}: launches {n}, want {want}")
        check(math.isfinite(loss) and math.isfinite(gnorm) and gnorm > 0,
              f"jamba train step {i}: loss {loss}, grad norm {gnorm}")
        total = {k: total[k] + n[k] for k in total}
        walls.append(wall)
        log(f"jamba train step {i}: loss {loss:.4f}, grad norm "
            f"{gnorm:.4f}, {wall:.3f}s")
    kern = {}
    busy = profiled(lambda: step(model, state, batches[3]),
                    "a 4th jamba train step", top=10, cpu_ops=False,
                    kernels=kern)
    peak = torch.cuda.max_memory_allocated()
    steady = sum(walls[1:]) / len(walls[1:])
    tokens = b * s
    flops = 6.0 * n_params * tokens
    scans = {k: tuple(map(sum, zip(*[v for n_, v in kern.items()
                                     if k in n_])))
             for k in ("ssm_scan_kernel", "ssm_scan_bwd_kernel")}
    log(f"jamba training: steps {', '.join(f'{w:.3f}' for w in walls)} s; "
        f"steady (steps 1-2) {steady:.3f} s a step, "
        f"{tokens / steady:.0f} tokens/s; model-FLOP utilisation "
        f"{100 * flops / steady / BF16_PEAK_FLOPS:.2f}% (6 x {n_params} "
        f"parameters x {tokens} tokens = {flops:.4g} FLOP a step over the "
        f"H100 SXM dense bf16 peak of 989 TFLOP/s, NVIDIA data sheet); "
        f"peak memory {peak / 2**30:.2f} GiB; device busy "
        + ("not measured" if busy is None else f"{100 * busy:.1f}%")
        + " of the profiled step; scan device time in it: "
        + ", ".join(f"{k} {v[0]:.2f} ms over {v[1]} launches"
                    if v else f"{k} not measured" for k, v in scans.items()))
    del model, state, batches
    torch.cuda.empty_cache()
    # each scan's device time a launch inside the profiled step
    per_launch = {name: v[0] / v[1] for name, v in
                  (("ssm_scan", scans["ssm_scan_kernel"]),
                   ("ssm_scan_bwd", scans["ssm_scan_bwd_kernel"])) if v}
    return {"by_path": {"jamba_grad_pass": n_grad, "jamba_train": total},
            "scan_ms_in_step": per_launch}


def phase_trainer(dev) -> dict:
    """10d: the Trainer's lifecycle on examples/train_lm.py's ``--full``
    config (qwen2 family, 12 layers, d_model 768, f32, AdamW), batches of
    8 x 512: 24 steps, a checkpoint every 6, a failure injected at step 15
    (resumed from step 12); the loss falls, and every logged loss is within
    1e-5 relative of an uninterrupted run's (CUDA's unordered
    embedding-gradient adds may move the last bits); then a bf16 tree
    through ``CheckpointManager`` comes back bit for bit."""
    import shutil

    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.examples.train_lm import full_config
    from repro_torch.models.transformer import init_params
    from repro_torch.runtime import FaultInjector, Trainer, TrainerConfig

    cfg, b, s = full_config()
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    runs, by_path = {}, {}
    for name, fail in (("trainer_faulty", {15: "injected node loss"}),
                       ("trainer_clean", {})):
        tr = Trainer(cfg, SyntheticLMData(vocab=cfg.vocab, batch=b, seq=s,
                                          seed=0),
                     TrainerConfig(steps=24, ckpt_every=6,
                                   ckpt_dir=str(TRAIN_DIR / name),
                                   lr=3e-4),
                     FaultInjector(fail_at=fail), device=dev)
        out, wall, n = run_path(tr.run)
        check(not any(n.values()), f"{name}: launches {n}")
        by_path[name] = n
        runs[name] = (tr, out)
        log(f"{name}: {cfg.param_count() / 1e6:.1f} M parameters, {b} x "
            f"{s} tokens a step: {out} in {wall:.1f}s; checkpoints "
            f"{tr.ckpt.steps()}")
    (tr, out), (clean, _) = runs["trainer_faulty"], runs["trainer_clean"]
    seen = [m["step"] for m in tr.metrics]
    check(out["restarts"] == 1 and seen == list(range(15))
          + list(range(12, 24)), f"trainer: restarts {out['restarts']}, "
          f"steps {seen}")
    first, last = tr.metrics[0]["loss"], tr.metrics[-1]["loss"]
    check(last < first, f"trainer: loss {first} -> {last}")
    want = {m["step"]: m["loss"] for m in clean.metrics}
    worst = max(abs(m["loss"] - want[m["step"]]) / abs(want[m["step"]])
                for m in tr.metrics)
    check(worst <= 1e-5, f"trainer: losses {worst:.3g} relative from the "
          "uninterrupted run's")
    log(f"trainer: loss {first:.4f} -> {last:.4f}; restarts 1, steps 12-14 "
        f"replayed from the step-12 checkpoint; every logged loss within "
        f"{worst:.3g} relative of the uninterrupted run's")

    bcfg = get_smoke_config(JAMBA).scaled(dtype="bfloat16")
    tree = {"params": init_params(bcfg, torch.Generator(dev).manual_seed(3),
                                  dev)}
    mgr = CheckpointManager(str(TRAIN_DIR / "bf16"))
    mgr.save(1, tree)
    back = mgr.restore(tree, device=dev)

    def bits_equal(x, y):
        if isinstance(x, dict):
            return all(bits_equal(x[k], y[k]) for k in x)
        return x.dtype == y.dtype == torch.bfloat16 and torch.equal(
            x.view(torch.int16), y.view(torch.int16))

    check(bits_equal(tree, back), "bf16 checkpoint roundtrip")
    log("bf16 tree (the smoke Jamba's parameters) saved and restored "
        "through CheckpointManager: bit for bit")
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    return {"by_path": by_path}


# ------------------------------------- phase 11: the sharded pipeline
MESH_WINDOWS = 24           # phase 7's first windows, served on the mesh
# several ranks sharing the one card over gloo: (world, ((shape, combine)))
GLOO_WORLDS = ((2, (((2, 1), "psum"), ((1, 2), "psum"), ((1, 2), "rs_ag"))),
               (4, (((2, 2), "rs_ag"),)))


def counters(results) -> list:
    """Each result's stats but the wall clock and the mesh's own fields."""
    import dataclasses

    skip = {"wall_time_s", "collective_bytes", "shard_occupancy"}
    return [{k: v for k, v in dataclasses.asdict(r.stats).items()
             if k not in skip} for r in results]


def step_backend(eng) -> str:
    """The backend of the step an engine's newest window pinned."""
    return getattr(next(reversed(eng._win_cache.values())).step_fn,
                   "backend", "?")


def mesh_rank(state, reqs, cases, device: str) -> dict:
    """One rank of a gloo world on the card (``launch/world.py``): phase
    3's batch through ``TCQEngine(g, mesh=)`` for each (shape, combine),
    cold then warm, with the launch counters zeroed around each run; the
    bytes this rank handed to each collective in the cold run, and its
    peak and resident device memory (engine built, both runs)."""
    import gc

    import torch
    from repro_torch.core import TCQEngine, TemporalGraph
    from repro_torch.core.distributed import combine_bytes_per_lane_iter
    from repro_torch.core.scheduler import autotune_wave
    from repro_torch.launch.mesh import Mesh

    g = TemporalGraph.from_state(state)
    out = {}
    on_card = torch.device(device).type == "cuda"
    for shape, combine in cases:
        mesh = Mesh(shape, device=device)
        if on_card:
            torch.cuda.reset_peak_memory_stats(mesh.device)
        eng = TCQEngine(g, mesh=mesh, combine=combine)
        cold, cold_s, n_cold = run_path(lambda: eng.query_batch(reqs))
        sent = dict(mesh.sent_bytes)
        warm, warm_s, n_warm = run_path(lambda: eng.query_batch(reqs))
        peak, resident = ((torch.cuda.max_memory_allocated(mesh.device),
                           torch.cuda.memory_allocated(mesh.device))
                          if on_card else (0, 0))
        st = cold[0].stats
        wave = autotune_wave(eng.num_vertices, st.window_edges,
                             num_queries=len(reqs),
                             lane_shards=mesh.lane_shards)
        out[f"{shape[0]}x{shape[1]}-{combine}"] = {
            "rank": mesh.rank, "backend": mesh.backend,
            "host_staged": mesh.host_staged,
            "cores": [digest(r) for r in cold],
            "warm_cores": [digest(r) for r in warm],
            "cold_s": cold_s, "warm_s": warm_s,
            "launches": n_cold, "warm_launches": n_warm,
            "steps": st.device_steps, "peel_iters": st.peel_iters,
            "wave": wave, "collective_bytes": st.collective_bytes,
            "want_bytes": combine_bytes_per_lane_iter(
                eng.stats()["distributed"]["combine"], eng.num_vertices,
                mesh.model_shards) * wave * st.peel_iters,
            "shard_occupancy": st.shard_occupancy,
            "backend_step": step_backend(eng),
            "sent_bytes": sent, "peak_bytes": peak,
            "resident_bytes": resident,
        }
        del eng, cold, warm
        gc.collect()
    return out


def phase_mesh(dev, g, main_run: dict, capacity_qps: float) -> dict:
    """Phase 11: the sharded pipeline on the card.  11a the unit mesh over
    NCCL (kernel rung, then the composite with psum and with rs_ag), 11b
    serving on it (a TCQService drain, then serve_distributed), 11c
    worlds of 2 and 4 gloo ranks sharing the card through host memory."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch.distributed as dist
    from repro_torch.core import TCQEngine, TCQService
    from repro_torch.data import TCQRequestStream
    from repro_torch.launch.mesh import Mesh, init_world
    from repro_torch.launch.serve import serve_distributed
    from repro_torch.launch.world import run_world

    t11 = time.perf_counter()
    on_card = dev.type == "cuda"      # launch checks apply on the card
    reqs = main_run["reqs"]
    want = [digest(r) for r in main_run["batch"]]
    by_path, times = {}, {}
    rdzv = Path(tempfile.mkdtemp(prefix="mesh-", dir=ROOT / "build"))
    backend = "nccl" if dev.type == "cuda" else "gloo"   # (CPU rehearsal)
    init_world(backend, init_method=f"file://{rdzv}/rendezvous", rank=0,
               world_size=1, timeout_s=300)
    try:
        mesh = Mesh((1, 1), device=dev)
        log(f"11a: {mesh} (one rank: no collective runs)")
        runs = (("kernel", {}, "batch"),
                ("psum", {"use_kernel": False, "combine": "psum"}, "comp"),
                ("rs_ag", {"use_kernel": False, "combine": "rs_ag"}, "comp"))
        for name, kw, ref in runs:
            eng = TCQEngine(g, mesh=mesh, **kw)
            cold, cold_s, n_cold = run_path(lambda: eng.query_batch(reqs))
            warm, warm_s, n_warm = run_path(lambda: eng.query_batch(reqs))
            for what, res in (("cold", cold), ("warm", warm)):
                check([digest(r) for r in res] == want,
                      f"11a {name} {what}: cores differ from phase 3's")
                check(counters(res) == counters(main_run[ref]),
                      f"11a {name} {what}: counters differ from phase 3's "
                      f"{'batch' if ref == 'batch' else 'composite batch'}")
            d = eng.stats()["distributed"]
            check(d["collective_bytes"] == 0 and d["backend"] == backend,
                  f"11a {name}: {d}")
            steps, iters = cold[0].stats.device_steps, \
                cold[0].stats.peel_iters
            for n in (n_cold, n_warm) if on_card else ():
                if name == "kernel":
                    check(n["wave_peel"] >= steps and n["segdeg"] == 0,
                          f"11a kernel rung launches {n}")
                else:
                    check(n["segdeg"] >= 2 * iters and n["wave_peel"] == 0,
                          f"11a {name} launches {n}")
                check(n["ssm_scan"] == n["ssm_scan_bwd"] == 0,
                      f"11a {name}: a scan launched")
            by_path[f"mesh_unit_{name}_cold"] = n_cold
            by_path[f"mesh_unit_{name}_warm"] = n_warm
            times[name] = (cold_s, warm_s)
            log(f"11a unit mesh, {name} ({step_backend(eng)} step): "
                f"cold {cold_s:.3f}s, warm {warm_s:.3f}s (phase 3: "
                f"{main_run['cold_s']:.3f} / {main_run['warm_s']:.3f}s "
                f"fused, composite {main_run['comp_s']:.3f}s); {steps} "
                f"steps, {iters} peel iterations; launches cold "
                f"{json.dumps(n_cold)}; equal to phase 3 in cores, TTIs, "
                "edge counts and counters; 0 collective bytes")

        # -- 11b: serving on the unit mesh
        stream = TCQRequestStream(int(g.unique_ts[0]),
                                  t_max=int(g.unique_ts[-1]), k=12, span=64,
                                  seed=11)
        windows = list(stream.requests(MESH_WINDOWS))

        def drain(**kw):
            svc = TCQService(g, **kw)
            for r in windows:
                svc.submit({k: r[k] for k in ("k", "ts", "te")})
            return svc, {tk.id: tk for tk in svc.run_until_idle()}

        (_, plain_tk), plain_s, n_plain = run_path(lambda: drain(device=dev))
        (msvc, mesh_tk), mesh_s, n_mesh = run_path(lambda: drain(mesh=mesh))
        check(mesh_tk.keys() == plain_tk.keys(), "11b: ticket ids differ")
        for tid, tk in mesh_tk.items():
            check(tk.status == "done" and digest(tk.result)
                  == digest(plain_tk[tid].result),
                  f"11b: ticket {tid} differs from the unsharded service's")
        check(all(len(p["shard_occupancy"]) == 1
                  and p["collective_bytes"] == 0 for p in msvc.pool_log),
              "11b: pool log without one shard's occupancy")
        check(not on_card or (n_mesh["wave_peel"] > 0
                              and n_mesh["segdeg"] == 0),
              f"11b drain launches {n_mesh}")
        by_path["mesh_unit_service"] = n_mesh
        log(f"11b TCQService(mesh=unit) drained {len(mesh_tk)} windows in "
            f"{mesh_s:.3f}s (unsharded {plain_s:.3f}s), every ticket equal "
            f"to the unsharded service's; {len(msvc.pool_log)} pools, "
            f"shard occupancy "
            f"{[p['shard_occupancy'] for p in msvc.pool_log][:4]}")
        qps = 0.5 * capacity_qps
        open_reqs = list(stream.open_loop(MESH_WINDOWS, qps=qps))
        (_, served, rep), _, n_sd = run_path(lambda: serve_distributed(
            g, open_reqs, mesh=mesh, controllers=2))
        plain = {(tk.k, tk.ts, tk.te): digest(tk.result)
                 for tk in plain_tk.values()}
        check(len(served) == MESH_WINDOWS and all(
            digest(tk.result) == plain[(tk.k, tk.ts, tk.te)]
            for tk in served), "11b: serve_distributed tickets differ")
        check(not on_card or (n_sd["wave_peel"] > 0
                              and n_sd["segdeg"] == 0),
              f"11b serve_distributed launches {n_sd}")
        by_path["mesh_unit_serve_distributed"] = n_sd
        log(f"11b serve_distributed (unit mesh, 2 controllers, "
            f"{MESH_WINDOWS} windows offered at {qps:.3f}/s, half phase "
            f"7's closed-loop {capacity_qps:.3f}/s): {rep['completed']} "
            f"done in {rep['wall_s']:.3f}s ({rep['qps']:.3f} qps), p50 "
            f"{rep['p50_ms']:.1f} ms, p95 {rep['p95_ms']:.1f} ms, p99 "
            f"{rep['p99_ms']:.1f} ms, shed rate 0.000 (no admission gate); "
            f"every ticket equal to the unsharded service's")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(rdzv, ignore_errors=True)

    # -- 11c: several ranks on the one card, over gloo through host memory
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    state = g.state_dict()
    for world, cases in GLOO_WORLDS:
        t0 = time.perf_counter()
        outs = run_world("chip_smoke:mesh_rank", world,
                         args=(state, reqs, cases,
                               "cuda:0" if dev.type == "cuda" else "cpu"),
                         backend="gloo",
                         timeout_s=600)
        log(f"11c: a world of {world} gloo ranks on cuda:0 (collectives "
            f"through host memory, not NCCL) ran in "
            f"{time.perf_counter() - t0:.1f}s, process start included")
        for shape, combine in cases:
            key = f"{shape[0]}x{shape[1]}-{combine}"
            per = [o[key] for o in outs]
            total = {k: sum(p["launches"][k] for p in per)
                     for k in per[0]["launches"]}
            for p in per:
                check(p["host_staged"] == (dev.type == "cuda")
                      and p["backend"] == "gloo",
                      f"11c {key}: rank {p['rank']} not gloo via the host")
                check(p["cores"] == want and p["warm_cores"] == want,
                      f"11c {key}: rank {p['rank']} differs from phase 3")
                check(p["collective_bytes"] == p["want_bytes"],
                      f"11c {key}: rank {p['rank']} counted "
                      f"{p['collective_bytes']} collective bytes, want "
                      f"{p['want_bytes']}")
                op = "all_reduce" if combine == "psum" else "reduce_scatter"
                check((p["sent_bytes"][op] > 0) == (shape[1] > 1),
                      f"11c {key}: rank {p['rank']} handed "
                      f"{p['sent_bytes']} to the collectives")
                n = p["launches"]
                if not on_card:
                    pass
                elif shape[1] == 1:
                    check(n["wave_peel"] > 0 and n["segdeg"] == 0,
                          f"11c {key}: rank {p['rank']} launches {n}")
                else:
                    check(n["segdeg"] > 0 and n["wave_peel"] == 0,
                          f"11c {key}: rank {p['rank']} launches {n}")
                log(f"11c {key} rank {p['rank']} ({p['backend_step']} "
                    f"step): cold {p['cold_s']:.3f}s, warm "
                    f"{p['warm_s']:.3f}s, {p['steps']} steps of W="
                    f"{p['wave']}, {p['peel_iters']} peel iterations, "
                    f"{p['collective_bytes']} collective bytes (= "
                    f"{p['want_bytes']}, the analytic ring bytes of the "
                    f"degree combine), operand bytes handed to the "
                    f"collectives {json.dumps(p['sent_bytes'])}, peak "
                    f"{p['peak_bytes']} B and resident "
                    f"{p['resident_bytes']} B of device memory, shard "
                    f"occupancy "
                    f"{[round(x, 3) for x in p['shard_occupancy']]}, "
                    f"launches {json.dumps(p['launches'])}")
            by_path[f"mesh_gloo_{key}"] = total
    log(f"phase 11 took {time.perf_counter() - t11:.1f}s; launches by "
        f"path: {json.dumps(by_path)}")
    return {"by_path": by_path, "times": times}


# -------------------------------------------- phase 12: sharded LM serving
# sub-phase -> (name, arch, cuts, mesh (data, model), prompt tokens, cache
# positions, encoder frames, decode steps).  Each serves phase 6's or phase
# 9's model from the same seed and prompt, sharded over the mesh.
SHARDED_LM = {
    "12a": (("jamba", JAMBA, {"n_layers": 8, "moe": None}, (1, 1), 2_048,
             32_768, None, 8),),
    # gloo through host memory moves ~0.36 GB/s a rank on one H100 host:
    # a (1, 2) Jamba decode step, its 7 in_proj gathers (1.88 GB), takes
    # ~5 s, so for the script's time the gloo worlds' bf16 decode steps are
    # cut, 8 -> 2 in (b) and (c) and 1 in (d), and qwen2-vl's layers 80 ->
    # 2 (phase 9 serves 16, so its unsharded reference is served here)
    "12b": (("jamba", JAMBA, {"n_layers": 8, "moe": None}, (1, 2), 2_048,
             32_768, None, 2),),
    "12c": (("jamba_moe", JAMBA, {"n_layers": 2}, (1, 2), 2_048, 32_768,
             None, 2),),
    "12d": (("granite_moe", "granite-moe-1b-a400m", {}, (2, 2), 2_048,
             32_768, None, 1),
            ("rwkv6", "rwkv6-1.6b", {}, (2, 2), 2_048, 32_768, None, 1),
            ("whisper", "whisper-small", {}, (2, 2), 64, 448, 1_500, 1),
            ("qwen2_vl_2", "qwen2-vl-72b", {"n_layers": 2}, (2, 2), 2_048,
             32_768, None, 1)),
}
# each model of a sharded sub-phase is also served in float32: at most 256
# prompt tokens into a cache of twice that, then 2 decode steps, so that on
# a cache split by sequence the steps write the second rank's block and
# attend across both: the check of the sharded arithmetic, prefill and
# decode, which bf16 rounding hides (``hold_sharded``)
F32_PROMPT, F32_STEPS = 256, 2


def f32_twin(case) -> tuple:
    name, arch, cuts, shape, s, _, s_enc, _ = case
    p = min(s, F32_PROMPT)
    return (name + "_f32", arch, {**cuts, "dtype": "float32"}, shape, p,
            2 * p, s_enc, F32_STEPS)


def serve_case(case, mesh=None, dev=None, forced=None,
               logits: bool = False) -> dict:
    """One config of ``SHARDED_LM`` served through ``prefill_step`` and
    ``serve_step``: on ``mesh`` (sharded), else unsharded on ``dev``.
    Seeded weights drawn on the card (one full leaf at a time on a mesh),
    phase 9's prompt and feeds (``default_rng(17)``), a warm-up, then the
    prefill and the greedy steps, each with the launch counters zeroed
    before it and read after it.  With ``forced`` (the unsharded run's
    tokens) the steps are teacher-forced: each is fed the unsharded run's
    token, and the warm-up is a 64-token prefill.  A float32 model steps
    through ``decode_logits`` (``serve_step``'s forward, with its logits)
    and records each step's logits, as a bfloat16 model does with
    ``logits``.  Returns plain values: tokens (the
    prefill's greedy token, then each step's), the prefill's last logits
    and the steps' (the vocabulary, not its padding), times,
    launches, the bytes this rank handed to collectives and gathered for
    layouts, and its device memory."""
    import gc

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import decode_logits, prefill_step
    from repro_torch.models.transformer import Transformer, init_cache

    name, arch, cuts, shape, s, s_max, s_enc, n_dec = case
    cfg = (get_config(arch) if isinstance(arch, str) else arch).scaled(
        **cuts)                       # (a config object: a CPU rehearsal)
    dev = mesh.device if mesh is not None else torch.device(dev)
    on_card = dev.type == "cuda"
    b = 2
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = Transformer(cfg, generator=torch.Generator(dev).manual_seed(0),
                        device=None if mesh is not None else dev, mesh=mesh)
    if on_card:
        torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(17)
    prompt = family_batch(cfg, b, s, s_enc, rng, dev)
    feeds = decode_inputs(cfg, b, 32, rng, dev)[:n_dec]
    cache = init_cache(cfg, b, s_max, None if mesh is not None else dev,
                       s_enc=s_enc, mesh=mesh)

    def prefill():
        return prefill_step(model, prompt, cache)[0]

    def first_token(last):
        return last[:, -1].argmax(-1, keepdim=True).to(torch.int32)

    def logit_steps(tok, ref):
        """decode_logits from ``tok``, step i fed ``ref[:, i]`` where given,
        else the last step's argmax: (tokens, each step's logits)."""
        toks, logits = [], []
        for i in range(n_dec):
            x = ref[:, i:i + 1] if ref is not None else tok
            step = {"tokens": x} if feeds[i] is None else {"embeds": feeds[i]}
            out, _ = decode_logits(model, cache, {**step,
                                                  "cache_index": s + i})
            tok = first_token(out)
            toks.append(tok)
            logits.append(out[:, -1, :cfg.vocab].float().cpu())
        return torch.cat(toks, 1), logits

    if forced is None:                                       # warm-up
        tok = first_token(prefill())
        if n_dec:
            greedy(model, cache, tok, s, feeds[:2])
    else:      # a short prefill: the first calls' set-up
        w = min(s, 64)
        prefill_step(model, {k: v[:, :, :w] if k == "positions" and
                             v.dim() == 3 else v[:, :w] if k != "enc_embeds"
                             else v for k, v in prompt.items()}, cache)
    if mesh is not None:
        for k in mesh.sent_bytes:
            mesh.sent_bytes[k] = 0
        mesh.layout_bytes = 0
    last, pre_s, n_pre = run_path(prefill)
    sent_pre = dict(mesh.sent_bytes) if mesh is not None else {}
    layout_pre = mesh.layout_bytes if mesh is not None else 0
    tok0 = first_token(last)
    ref = (torch.tensor(forced, dtype=torch.int32, device=dev)
           if forced is not None else None)
    step_logits = None
    if cfg.dtype == "float32" or logits:
        (toks, step_logits), dec_s, n_dec_run = run_path(
            lambda: logit_steps(tok0, ref))
    elif ref is not None:       # each step fed the unsharded run's token
        toks, dec_s, n_dec_run = run_path(lambda: torch.cat([
            greedy(model, cache, ref[:, i:i + 1], s + i, feeds[i:i + 1])
            for i in range(n_dec)], 1))
    else:
        toks, dec_s, n_dec_run = run_path(
            lambda: greedy(model, cache, tok0, s, feeds))
    out = {
        "name": name, "rank": mesh.rank if mesh is not None else 0,
        "backend": mesh.backend if mesh is not None else None,
        "host_staged": mesh is not None and mesh.host_staged,
        "params": sum(p.numel() for p in model.parameters()),
        "n_mamba": sum(sp.mixer == "mamba" for sp in cfg.layer_specs()),
        "tokens": torch.cat([tok0, toks], 1).cpu().tolist(),
        "dtype": cfg.dtype,
        "last": last[:, -1, :cfg.vocab].float().cpu(),
        "step_logits": step_logits,
        "init_s": init_s, "prefill_s": pre_s, "decode_s": dec_s,
        "prefill_tokens": b * s, "n_dec": n_dec,
        "launches_prefill": n_pre, "launches_decode": n_dec_run,
        "sent_prefill": sent_pre,
        "sent": dict(mesh.sent_bytes) if mesh is not None else {},
        "layout_prefill": layout_pre,
        "layout": mesh.layout_bytes if mesh is not None else 0,
        "peak_bytes": torch.cuda.max_memory_allocated(dev) if on_card else 0,
        "resident_bytes": torch.cuda.memory_allocated(dev) if on_card else 0,
    }
    del model, cache, prompt, feeds, last, toks
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return out


def lm_rank(cases, device: str, forced=None) -> list:
    """One rank of a gloo world on the card (``launch/world.py``): each
    case of ``cases`` served on its mesh, one model at a time, teacher-
    forced with ``forced[i]`` first where given."""
    from repro_torch.launch.mesh import Mesh

    forced = forced or [None] * len(cases)
    return [serve_case(c, Mesh(c[3], device=device), forced=f)
            for c, f in zip(cases, forced)]


# a float32 sharded run's logits against the unsharded one's, the
# prefill's and each teacher-forced decode step's: within 1e-4 relative
# (the CPU tests' float32 tolerance).  bfloat16 runs get no bound: their
# partial sums round differently, RWKV's 24 layers carry that to 12% of
# the logits (PERF.md §6), and a greedy token can follow the rounding
# where the top two logits are within a few bf16 steps
SHARD_F32_REL = 1e-4


def rel_err(a, b) -> float:
    """|a - b| / |b| over whole tensors (Frobenius)."""
    return float((a - b).norm() / b.norm())


def hold_sharded(sub: str, name: str, p: dict, ref: dict) -> dict:
    """One rank's run against the unsharded run of the same model, each
    step fed the unsharded run's token.  In float32 the prefill's last
    logits and every decode step's are held within ``SHARD_F32_REL``
    relative; in bfloat16 their error and the steps whose greedy token
    differs are reported.  Returns the errors (prefill first) and the
    (step, row) of each differing token."""
    import torch

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    errs = [rel(p["last"], ref["last"])]
    if p["dtype"] == "float32":
        check(len(p["step_logits"]) == len(ref["step_logits"]) == p["n_dec"]
              >= F32_STEPS, f"{sub} {name}: rank {p['rank']} has "
              f"{len(p['step_logits'])} float32 decode steps, want "
              f"{p['n_dec']} >= {F32_STEPS}")
        errs += [rel(a, b) for a, b in zip(p["step_logits"],
                                           ref["step_logits"])]
        check(all(bool(torch.isfinite(x).all()) for x in p["step_logits"])
              and max(errs) <= SHARD_F32_REL,
              f"{sub} {name}: rank {p['rank']} float32 logits relative "
              f"errors (prefill, then each decode step) {errs} exceed "
              f"{SHARD_F32_REL}")
    flips = [(j, row) for row, (got, want) in enumerate(
        zip(p["tokens"], ref["tokens"])) for j, (x, y) in enumerate(
        zip(got, want)) if x != y]
    return {"logits_rel_err": errs, "token_flips": flips}


def phase_sharded_lm(dev, want: dict) -> dict:
    """Phase 12: every LM family served sharded.  12a phase 6's Jamba on
    the unit mesh over NCCL; 12b the same on (1, 2), two gloo ranks
    sharing the card; 12c phase 9's Jamba with experts on (1, 2); 12d
    granite-moe, rwkv6, whisper-small and qwen2-vl (2 layers) on (2, 2),
    four gloo ranks.  ``want[name]`` holds phase 6's and 9's tokens.
    12a must give them bit for bit.  For 12b-12d each model is first
    served unsharded here (its tokens must equal phase 6's or 9's; qwen2-vl
    at 2 layers has none) and every rank is held to that run: its float32
    twin's prefill and decode logits within ``SHARD_F32_REL``, its bf16
    tokens reported (``hold_sharded``).  ssm_scan must launch once per Mamba layer and
    pass on every rank (on its channel shard), and a rank of a larger
    mesh must hand bytes to the collectives."""
    import os
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import Mesh, init_world
    from repro_torch.launch.world import run_world

    t12 = time.perf_counter()
    on_card = dev.type == "cuda"
    by_path, summary, refs = {}, {}, {}
    drift, sharded_drift = {}, {}
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    device = "cuda:0" if on_card else "cpu"
    for sub, cases in SHARDED_LM.items():
        t_sub = time.perf_counter()
        if cases[0][3] != (1, 1):
            cases = cases + tuple(f32_twin(c) for c in cases)
        if on_card:
            torch.cuda.empty_cache()
        world = cases[0][3][0] * cases[0][3][1]
        if world == 1:
            rdzv = Path(tempfile.mkdtemp(prefix="lm-", dir=ROOT / "build"))
            init_world("nccl" if on_card else "gloo",
                       init_method=f"file://{rdzv}/rendezvous", rank=0,
                       world_size=1, timeout_s=300)
            try:
                outs = [[serve_case(c, Mesh(c[3], device=dev))
                         for c in cases]]
            finally:
                dist.destroy_process_group()
                shutil.rmtree(rdzv, ignore_errors=True)
        else:
            for c in cases:
                if c[0] in refs:
                    continue
                t0 = time.perf_counter()
                refs[c[0]] = r = serve_case(c, dev=dev)
                if c[0] in want:
                    check(r["tokens"] == [row[:c[7] + 1]
                                          for row in want[c[0]]],
                          f"{sub} {c[0]}: the unsharded run's tokens "
                          f"{r['tokens']} differ from the earlier phase's")
                log(f"{sub} {c[0]}: served unsharded ({c[2] or 'no cuts'})"
                    f" in {time.perf_counter() - t0:.1f}s, tokens "
                    f"{r['tokens']}{' (= phase 6/9)' if c[0] in want else ''}")
            for c in cases:
                if c[0].endswith("_f32") or c[0] in drift:
                    continue
                # the unsharded bf16 model's own drift from its float32
                # twin, at the twin's prompt, steps fed the twin's tokens
                twin = f32_twin(c)
                short = (c[0] + "_bf16",) + tuple(twin[1:2]) + (c[2],) \
                    + tuple(twin[3:])
                p = serve_case(short, dev=dev, forced=refs[twin[0]][
                    "tokens"], logits=True)
                ref = refs[twin[0]]
                drift[c[0]] = [rel_err(p["last"], ref["last"])] + [
                    rel_err(a, b) for a, b in zip(p["step_logits"],
                                                  ref["step_logits"])]
            outs = run_world("chip_smoke:lm_rank", world,
                             args=(cases, device,
                                   [refs[c[0]]["tokens"] for c in cases]),
                             backend="gloo", timeout_s=900)
        for i, c in enumerate(cases):
            name, shape = c[0], c[3]
            per = [o[i] for o in outs]
            for p in per:
                log(f"{sub} {name} on {dict(zip(('data', 'model'), shape))} "
                    f"rank {p['rank']} ({p['backend']}"
                    f"{', host-staged' if p['host_staged'] else ''}, "
                    f"{p['dtype']}): {p['params'] / 1e9:.3f} B parameters "
                    f"held, drawn in {p['init_s']:.1f}s; prefill "
                    f"{p['prefill_tokens']} tokens in {p['prefill_s']:.3f}s "
                    f"({p['prefill_tokens'] / p['prefill_s']:.0f} tokens/s),"
                    f" {c[7]} greedy steps at "
                    f"{1e3 * p['decode_s'] / max(1, c[7]):.2f} ms a step; "
                    f"tokens {p['tokens']}; bytes to the collectives "
                    f"{json.dumps(p['sent'])} (prefill "
                    f"{json.dumps(p['sent_prefill'])}); layout gathers "
                    f"{p['layout']} B (prefill {p['layout_prefill']} B); "
                    f"device memory resident {p['resident_bytes']} B, peak "
                    f"{p['peak_bytes']} B; launches prefill "
                    f"{json.dumps(p['launches_prefill'])}, decode "
                    f"{json.dumps(p['launches_decode'])}")
                if world == 1:
                    ref = [row[:c[7] + 1] for row in want[name]]
                    check(p["tokens"] == ref,
                          f"{sub} {name}: tokens {p['tokens']} != phase "
                          f"6's {ref}")
                else:
                    held = hold_sharded(sub, name, p, refs[name])
                    log(f"{sub} {name} rank {p['rank']} against the "
                        f"unsharded run: {json.dumps(held)}")
                    if p["dtype"] != "float32":
                        sharded_drift[name] = max(
                            sharded_drift.get(name, 0.0),
                            held["logits_rel_err"][0])
                n_m = p["n_mamba"]
                for path, got, n in (("prefill", p["launches_prefill"], n_m),
                                     ("decode", p["launches_decode"],
                                      n_m * c[7])):
                    if on_card:
                        check(got == {**NO_TCQ_LAUNCHES,
                                      "ssm_scan": n, "ssm_scan_bwd": 0},
                              f"{sub} {name} {path}: rank {p['rank']} "
                              f"launches {got}, want ssm_scan {n}")
                check(world == 1 or sum(p["sent"].values()) > 0,
                      f"{sub} {name}: rank {p['rank']} sent no bytes")
            for path in ("prefill", "decode"):
                by_path[f"sharded_{sub}_{name}_{path}"] = {
                    k: sum(p[f"launches_{path}"][k] for p in per)
                    for k in per[0][f"launches_{path}"]}
            summary[f"{sub}_{name}"] = {
                "mesh": shape, "prefill_s": max(p["prefill_s"] for p in per),
                "decode_ms": max(1e3 * p["decode_s"] / max(1, c[7])
                                 for p in per),
                "peak_bytes": [p["peak_bytes"] for p in per],
                "resident_bytes": [p["resident_bytes"] for p in per],
                "sent": [p["sent"] for p in per],
                "layout": [p["layout"] for p in per]}
        log(f"{sub} took {time.perf_counter() - t_sub:.1f}s, process "
            "start included")
    for name, errs in drift.items():
        log(f"12 bf16 drift of {name}: the unsharded bf16 model's logits "
            f"from its float32 twin's ({F32_PROMPT}-token prompt, then "
            f"{F32_STEPS} steps fed the twin's tokens; relative, prefill "
            f"first) {[round(e, 5) for e in errs]}; the sharded bf16 "
            f"model's prefill logits from the unsharded bf16 model's (the "
            f"full prompt), worst rank {sharded_drift.get(name, 0.0):.5f}")
    log("sharded LM: " + json.dumps(summary))
    log(f"phase 12 took {time.perf_counter() - t12:.1f}s; launches by "
        f"path: {json.dumps(by_path)}")
    return {"by_path": by_path}


# ------------------------------------------- phase 13: training on a mesh
JAMBA8 = {"n_layers": 8, "moe": None}         # phase 10c's model
UNIT_MESH_STEPS = 2                           # 13a: phase 10c's first steps
# 13b: phase 10c's model on (data, model) = (1, 2), two gloo ranks sharing
# the card: its first batches, its Adafactor; 2 steps (~50 s each, gloo
# through host memory), the first traced, the second timed bare
MESH_TRAIN = ("jamba", JAMBA8, (1, 2), 2, 2_048, 2)
# 13c: float32 at published widths, cut in depth to the fewest layers that
# hold a Mamba and an attention sub-layer.  Jamba's 1:7 interleave puts
# its first attention layer 8th, and those 8 float32 layers (36.5 GB) do
# not train beside their gradients on one card, so the interleave is cut
# to 1:1 as well: a Mamba layer, then an attention layer
F32_TRAIN = {"n_layers": 2, "attn_every": 2, "moe": None,
             "dtype": "float32"}
F32_TRAIN_ROWS = (2, 128)                     # 256 tokens
MESH_TRAIN_SMOKE = (JAMBA, "granite-moe-1b-a400m")     # 13d, f32, (2, 2)
MESH_TRAIN_DIR = ROOT / "build" / "chip_smoke_mesh_train"
# a sharded gradient or updated parameter against the unsharded port's:
# the norm of the difference over the norm of the reference, per leaf
SHARD_TRAIN_REL = 1e-4


def _named_blocks(model):
    """{name: this rank's block} of every parameter."""
    return {n: p.detach() for n, p in model.named_parameters()}


def _named(tree: dict, prefix: str = "params") -> list:
    """[(parameter name, leaf)] of a nested dict, in its own order."""
    return [x for k, v in tree.items()
            for x in (_named(v, f"{prefix}.{k}") if isinstance(v, dict)
                      else [(f"{prefix}.{k}", v)])]


def _grads_by_name(model, grads):
    """{parameter name: gradient} of ``grads_of``'s list, which follows
    ``params.tree()``'s leaf order (each level's sub-trees first)."""
    order = [n for n, _ in _named(model.params.tree())]
    check(len(order) == len(grads), "one gradient a parameter")
    return dict(zip(order, grads))


def unit_mesh_rank(device: str) -> dict:
    """13a, one NCCL rank in a process of its own (``launch/world.py``), so
    that PyTorch's deterministic kernels (an operator without one raises)
    and a fixed cuBLAS workspace hold here and nowhere else in the script:
    phase 10c's model, first ``UNIT_MESH_STEPS`` batches and Adafactor,
    first mesh-free, then on the unit mesh (``Transformer(cfg, mesh=)``,
    ``build_train_step``).  On one rank every collective is the identity,
    so each step's loss, gradient norm and every parameter after it must
    equal the mesh-free step's bit for bit."""
    # read at the process's first matrix product: set before any
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.transformer import Transformer

    torch.use_deterministic_algorithms(True)
    # the only rank on the host: its copies use every core
    torch.set_num_threads(os.cpu_count() or 1)
    mesh = Mesh((1, 1), device=device)
    dev = mesh.device
    cfg = get_config(JAMBA).scaled(**JAMBA8)
    batches = [_train_batch(cfg, 2, 2_048, 0, i, dev)
               for i in range(UNIT_MESH_STEPS)]
    ref, out = [], {"steps": [], "host_s": 0.0}
    for on_mesh in (False, True):
        model = Transformer(cfg, generator=torch.Generator(dev).manual_seed(0),
                            **({"mesh": mesh} if on_mesh else {"device": dev}))
        step, opt = build_train_step(cfg, n_micro=1, lr=3e-4)
        state = (opt.init(model.params.tree(), mesh=mesh, pspecs=model.pspecs)
                 if on_mesh else opt.init(model.params.tree()))
        for i, batch in enumerate(batches):
            (state, m), wall, n = run_path(
                lambda st=state, b=batch: step(model, st, b))
            t0 = time.perf_counter()
            if not on_mesh:
                # the mesh-free steps' parameters, kept on the host (host
                # buffers are not filled first: they are written whole)
                torch.utils.deterministic.fill_uninitialized_memory = False
                ref.append({"loss": m["loss"].cpu(),
                            "grad_norm": m["grad_norm"].cpu(),
                            "params": {k: p.detach().to("cpu", copy=True)
                                       for k, p in model.named_parameters()},
                            "wall": wall, "launches": n})
                torch.utils.deterministic.fill_uninitialized_memory = True
                out["host_s"] += time.perf_counter() - t0
                continue
            r = ref[i]
            differ = [k for k, p in model.named_parameters()
                      if not torch.equal(p, r["params"][k].to(dev))]
            out["host_s"] += time.perf_counter() - t0
            out["steps"].append({
                "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "ref_loss": float(r["loss"]),
                "ref_grad_norm": float(r["grad_norm"]),
                "same": (torch.equal(m["loss"].cpu(), r["loss"])
                         and torch.equal(m["grad_norm"].cpu(),
                                         r["grad_norm"])),
                "params": len(r["params"]), "differ": differ[:3],
                "n_differ": len(differ), "wall": wall, "ref_wall": r["wall"],
                "launches": n, "ref_launches": r["launches"]})
            r["params"] = None
        del model, state, step, opt
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    out.update(backend=mesh.backend, sent=sum(mesh.sent_bytes.values()),
               layout=mesh.layout_bytes)
    return out


def phase_train_unit_mesh(dev) -> dict:
    """13a: ``unit_mesh_rank`` in a world of one NCCL rank; each unit-mesh
    step launches ssm_scan 2 and ssm_scan_bwd 1 a Mamba layer, and equals
    the mesh-free step bit for bit, with no collective bytes."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.world import run_world

    t = time.perf_counter()
    on_card = dev.type == "cuda"
    cfg = get_config(JAMBA).scaled(**JAMBA8)
    n_mamba = sum(sp.mixer == "mamba" for sp in cfg.layer_specs())
    want = {**NO_TCQ_LAUNCHES, "ssm_scan": 2 * n_mamba,
            "ssm_scan_bwd": n_mamba}
    if on_card:
        torch.cuda.empty_cache()
    (o,) = run_world("chip_smoke:unit_mesh_rank", 1,
                     args=("cuda:0" if on_card else "cpu",),
                     backend="nccl" if on_card else "gloo", timeout_s=600)
    total = {k: 0 for k in want}
    for i, st in enumerate(o["steps"]):
        check(not on_card or (st["launches"] == want
                              and st["ref_launches"] == want),
              f"13a step {i}: launches {st['launches']} (mesh-free "
              f"{st['ref_launches']}), want {want}")
        check(st["same"] and st["n_differ"] == 0,
              f"13a step {i}: loss {st['loss']!r}, grad norm "
              f"{st['grad_norm']!r}; mesh-free {st['ref_loss']!r}, "
              f"{st['ref_grad_norm']!r}; {st['n_differ']} parameters "
              f"differ, e.g. {st['differ']}")
        total = {k: total[k] + st["launches"][k] for k in total}
        log(f"13a step {i} on the unit mesh ({o['backend']}, deterministic "
            f"kernels): loss {st['loss']:.6f}, grad norm "
            f"{st['grad_norm']:.6f}, {st['wall']:.3f}s (mesh-free "
            f"{st['ref_wall']:.3f}s); the loss, the norm and all "
            f"{st['params']} parameters equal the mesh-free step's bit for "
            f"bit; launches {json.dumps(st['launches'])}")
    check(o["sent"] == 0 and o["layout"] == 0,
          f"13a: collective bytes {o['sent']}, layout {o['layout']}")
    log(f"13a took {time.perf_counter() - t:.1f}s, process start included, "
        f"{o['host_s']:.1f}s of it keeping and comparing parameters")
    return {"sharded_train_13a": total}


def _scan_shapes():
    """Record the shape of every scan launch: (forward shapes, backward
    shapes), sets filled as the kernels run (each kernel's dispatcher
    checks its CUDA inputs through ``ops._check`` before it launches)."""
    from repro_torch.kernels.ssm_scan import ops

    seen = {"ssm_scan": set(), "ssm_scan_bwd": set()}
    check_inputs = ops._check

    def recorded(name, names, big, small):
        check_inputs(name, names, big, small)
        seen[name].add(tuple(big[0].shape))

    ops._check = recorded
    return seen["ssm_scan"], seen["ssm_scan_bwd"]


def mesh_train_rank(case, device: str) -> dict:
    """One rank of 13b (``launch/world.py``): phase 10c's model, drawn from
    its seed one full leaf at a time, trained sharded on ``case``'s mesh
    through ``build_train_step`` on phase 10c's batches.  The first step
    runs under the profiler (device only), the rest are timed bare; each
    with the launch counters zeroed before it and read after it, and the
    bytes this rank hands to the collectives counted."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.transformer import Transformer, param_template

    name, cuts, shape, b, s, n_steps = case
    mesh = Mesh(shape, device=device)
    dev = mesh.device
    on_card = dev.type == "cuda"
    cfg = get_config(JAMBA).scaled(**cuts)
    fwd, bwd = _scan_shapes()
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = Transformer(cfg, generator=torch.Generator(dev).manual_seed(0),
                        mesh=mesh)
    if on_card:
        torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    n_params = sum(math.prod(p.shape) for _, p in _named(
        param_template(cfg)))
    step, opt = build_train_step(cfg, n_micro=1, lr=3e-4)
    state = opt.init(model.params.tree(), mesh=mesh, pspecs=model.pspecs)
    steps = []
    for i in range(n_steps):
        batch = _train_batch(cfg, b, s, 0, i, dev)
        for k in mesh.sent_bytes:
            mesh.sent_bytes[k] = 0
        mesh.layout_bytes = 0
        kern, busy = {}, None
        if i == 0 and on_card:
            box = {}
            (_, wall, n) = run_path(lambda st=state, bt=batch: box.update(
                busy=profiled(lambda: box.update(r=step(model, st, bt)),
                              f"13b step 0, rank {mesh.rank}", top=6,
                              cpu_ops=False, kernels=kern)))
            (state, m), busy = box["r"], box["busy"]
        else:
            (state, m), wall, n = run_path(
                lambda st=state, bt=batch: step(model, st, bt))
        scans = {k: v for k, v in kern.items() if "ssm_scan" in k}
        steps.append({"loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"]), "wall": wall,
                      "launches": n, "sent": dict(mesh.sent_bytes),
                      "layout": mesh.layout_bytes, "busy": busy,
                      "scan_device_ms": scans,
                      "peak_bytes": torch.cuda.max_memory_allocated(dev)
                      if on_card else 0,
                      "resident_bytes": torch.cuda.memory_allocated(dev)
                      if on_card else 0})
    held = sum(p.numel() for p in model.parameters())
    m = cfg.mamba
    return {"rank": mesh.rank, "backend": mesh.backend, "dtype": cfg.dtype,
            "host_staged": mesh.host_staged, "init_s": init_s,
            "params": n_params, "held": held, "tokens": b * s,
            "n_mamba": sum(sp.mixer == "mamba" for sp in cfg.layer_specs()),
            "shard": (b, s, m.d_inner(cfg.d_model) // shape[-1] * m.d_state),
            "steps": steps, "fwd_shapes": sorted(fwd),
            "bwd_shapes": sorted(bwd)}


def _rel_by_leaf(mesh, pairs: dict, specs: dict) -> dict:
    """{name: |got - want| / |want|} over each whole leaf, from the
    blocks of every rank (each block counted once, as the gradient norm
    counts it)."""
    import torch
    import torch.distributed as dist
    from repro_torch.models.sharding import replicated_axes

    names = sorted(pairs)
    sq = torch.zeros((len(names), 2), dtype=torch.float64)
    for i, k in enumerate(names):
        got, want = pairs[k]
        if all(mesh.coords[a] == 0 for a in replicated_axes(specs[k], mesh)):
            sq[i, 0] = float(((got.double() - want.double()) ** 2).sum())
            sq[i, 1] = float((want.double() ** 2).sum())
    dist.all_reduce(sq)
    return {k: float((sq[i, 0] / sq[i, 1].clamp(min=1e-300)).sqrt())
            for i, k in enumerate(names)}


def sharded_vs_unsharded(cfg, batch: dict, mesh, what: str,
                         shapes=()) -> dict:
    """One train step of ``cfg`` (seed 0 on the mesh's device), unsharded
    and sharded on ``mesh``, held together: the loss and gradient norm,
    and every leaf's gradient and updated parameter within
    ``SHARD_TRAIN_REL`` (``_rel_by_leaf``).  The ranks compute the
    unsharded step one at a time, each keeping only its blocks of the
    result, so the card holds one unsharded model at a time.  Each step
    runs with the launch counters zeroed before it and read after it; on
    the card the sharded step must launch ssm_scan 2 and ssm_scan_bwd 1 a
    Mamba layer.  ``shapes`` (``_scan_shapes``' sets) are emptied just
    before the sharded step, so they hold its scans' shapes alone."""
    import gc

    import torch
    import torch.distributed as dist
    from repro_torch.launch.steps import apply_grads, grads_of
    from repro_torch.models.sharding import block, mesh_coords
    from repro_torch.models.transformer import Transformer, param_pspecs
    from repro_torch.optim import make_optimizer

    dev = mesh.device
    coords = mesh_coords(mesh)
    specs = dict(_named(param_pspecs(cfg, mesh)))
    n_mamba = sum(sp.mixer == "mamba" for sp in cfg.layer_specs())
    want = {**NO_TCQ_LAUNCHES, "ssm_scan": 2 * n_mamba,
            "ssm_scan_bwd": n_mamba}
    ref = ref_n = None
    for r in range(mesh.size):
        if r == mesh.rank:
            model = Transformer(cfg, generator=torch.Generator(dev)
                                .manual_seed(0), device=dev)
            (loss, grads), _, ref_n = run_path(lambda: grads_of(model, batch))
            opt = make_optimizer(cfg)
            state = opt.init(model.params.tree())
            full = _grads_by_name(model, grads)
            ref = {"loss": float(loss),
                   "grads": {k: block(t, specs[k], mesh, coords)
                             for k, t in full.items()}}
            del full
            state, gnorm = apply_grads(model, opt, state, grads)
            del grads, state
            ref["grad_norm"] = float(gnorm)
            ref["params"] = {k: block(t, specs[k], mesh, coords)
                             for k, t in _named_blocks(model).items()}
            del model
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        dist.barrier()
    model = Transformer(cfg, generator=torch.Generator(dev).manual_seed(0),
                        mesh=mesh)
    opt = make_optimizer(cfg)
    state = opt.init(model.params.tree(), mesh=mesh, pspecs=model.pspecs)
    for seen in shapes:
        seen.clear()

    def sharded_step():
        # the gradients are held to the reference's before the update
        # (the collectives of the check launch no kernel)
        loss, grads = grads_of(model, batch)
        got_g = _grads_by_name(model, grads)
        rel_g = _rel_by_leaf(mesh, {k: (got_g[k], ref["grads"][k])
                                    for k in got_g}, specs)
        del got_g
        _, gnorm = apply_grads(model, opt, state, grads)
        return loss, gnorm, rel_g

    (loss, gnorm, rel_g), wall, n = run_path(sharded_step)
    check(dev.type != "cuda" or n == want,
          f"{what}: rank {mesh.rank}'s sharded step launched {n}, want "
          f"{want}")
    rel_p = _rel_by_leaf(mesh, {k: (p, ref["params"][k]) for k, p in
                                _named_blocks(model).items()}, specs)
    worst_g = max(rel_g, key=rel_g.get)
    worst_p = max(rel_p, key=rel_p.get)
    loss_rel = abs(float(loss) - ref["loss"]) / abs(ref["loss"])
    norm_rel = abs(float(gnorm) - ref["grad_norm"]) / ref["grad_norm"]
    check(max(loss_rel, norm_rel, rel_g[worst_g], rel_p[worst_p])
          <= SHARD_TRAIN_REL,
          f"{what}: rank {mesh.rank} relative errors: loss {loss_rel:.3g}, "
          f"norm {norm_rel:.3g}, gradient {worst_g} {rel_g[worst_g]:.3g}, "
          f"parameter {worst_p} {rel_p[worst_p]:.3g}")
    out = {"loss": float(loss), "loss_rel": loss_rel, "norm_rel": norm_rel,
           "grad_rel": rel_g[worst_g], "grad_worst": worst_g,
           "param_rel": rel_p[worst_p], "param_worst": worst_p,
           "leaves": len(rel_g), "launches": n, "wall": wall,
           "ref_launches": ref_n}
    del model, state, ref
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def mesh_check_rank(cuts: dict, shape, rows, device: str) -> dict:
    """One rank of 13c: phase 10c's model in float32 cut to ``cuts``, one
    step on ``rows`` of phase 10c's first batch, sharded on ``shape``
    against the unsharded port on the card (``sharded_vs_unsharded``);
    the launches of the sharded step's scans and their shapes."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import Mesh

    mesh = Mesh(shape, device=device)
    cfg = get_config(JAMBA).scaled(**cuts)
    batch = _train_batch(cfg, *rows, 0, 0, mesh.device)
    fwd, bwd = _scan_shapes()
    on_card = mesh.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(mesh.device)
    t0 = time.perf_counter()
    out = sharded_vs_unsharded(cfg, batch, mesh, "13c", shapes=(fwd, bwd))
    m = cfg.mamba
    return {**out, "rank": mesh.rank, "total_s": time.perf_counter() - t0,
            "shard": (*rows, m.d_inner(cfg.d_model) // shape[-1] * m.d_state),
            "fwd_shapes": sorted(fwd), "bwd_shapes": sorted(bwd),
            "peak_bytes": torch.cuda.max_memory_allocated(mesh.device)
            if on_card else 0,
            "sent": dict(mesh.sent_bytes), "layout": mesh.layout_bytes}


def mesh_smoke_rank(device: str, root: str) -> dict:
    """One rank of 13d, on (2, 2) and four gloo ranks sharing the card:
    the smoke Jamba with experts and granite-moe in float32 against the
    unsharded port (``sharded_vs_unsharded``); the ``Trainer`` on (2, 2)
    with a failure at step 3 and no restart budget, resized onto (1, 4)
    and resumed from its checkpoint, against an uninterrupted (2, 2) run;
    ``compressed_psum`` and ``compressed_psum_exact`` of CUDA tensors
    against the same calls on the CPU over the same gloo world."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch.mesh import Mesh
    from repro_torch.optim import compressed_psum, compressed_psum_exact
    from repro_torch.runtime import FaultInjector, Trainer, TrainerConfig

    mesh = Mesh((2, 2), device=device)
    dev = mesh.device
    out = {"rank": mesh.rank}
    for arch in MESH_TRAIN_SMOKE:
        cfg = get_smoke_config(arch)
        batch = _train_batch(cfg, 4, 16, 1, 0, dev)
        out[arch] = sharded_vs_unsharded(cfg, batch, mesh, f"13d {arch}")

    cfg = get_smoke_config(JAMBA)
    data = SyntheticLMData(vocab=cfg.vocab, batch=4, seq=16, seed=0)

    def trainer(name, fail):
        return Trainer(cfg, data,
                       TrainerConfig(steps=4, ckpt_every=2, lr=1e-3,
                                     ckpt_dir=f"{root}/{name}",
                                     max_restarts=0),
                       FaultInjector(fail_at=fail), mesh=mesh)

    def to_failure():
        try:
            faulty.run()
        except RuntimeError:
            return True
        return False

    # each run with the launch counters zeroed before it and read after
    # it: on the card every step it logs launches ssm_scan 2 and
    # ssm_scan_bwd 1 a Mamba layer, and nothing else does
    n_mamba = sum(sp.mixer == "mamba" for sp in cfg.layer_specs())
    clean = trainer("clean", {})
    (_, clean_s, n_clean) = run_path(clean.run)
    faulty = trainer("faulty", {3: "injected node loss"})
    raised, _, n_failed = run_path(to_failure)
    n_logged = len(faulty.metrics)
    faulty.resize(Mesh((1, 4), device=device))
    _, resumed_s, n_resumed = run_path(faulty.run)
    for run, n, steps in (("uninterrupted", n_clean, len(clean.metrics)),
                          ("to the failure", n_failed, n_logged),
                          ("resized", n_resumed,
                           len(faulty.metrics) - n_logged)):
        want = {**NO_TCQ_LAUNCHES,
                "ssm_scan": 2 * n_mamba * steps,
                "ssm_scan_bwd": n_mamba * steps}
        check(dev.type != "cuda" or n == want,
              f"13d trainer {run}: rank {mesh.rank} launched {n} in "
              f"{steps} steps, want {want}")
    want = {m["step"]: m["loss"] for m in clean.metrics}
    seen = [m["step"] for m in faulty.metrics]
    worst = max(abs(m["loss"] - want[m["step"]]) / abs(want[m["step"]])
                for m in faulty.metrics)
    check(raised and seen == [0, 1, 2, 2, 3] and worst <= 1e-5
          and faulty.model.mesh.shape == (1, 4),
          f"13d trainer: rank {mesh.rank} raised {raised}, steps {seen}, "
          f"losses {worst:.3g} relative from the uninterrupted run's")
    out["trainer"] = {"steps": seen, "worst_rel": worst,
                      "clean_s": clean_s, "resumed_s": resumed_s,
                      "launches": {k: n_failed[k] + n_resumed[k]
                                   for k in n_failed},
                      "clean_launches": n_clean,
                      "losses": [m["loss"] for m in faulty.metrics]}

    cpu = Mesh((2, 2), device="cpu")
    rng = np.random.default_rng(100 + mesh.rank)
    x = torch.from_numpy(rng.normal(0, 10.0 ** (mesh.rank - 2), (64, 129))
                         .astype(np.float32))
    e = torch.from_numpy(rng.normal(0, 1e-3, (64, 129)).astype(np.float32))
    same = {}
    for fname, fn in (("compressed_psum", compressed_psum),
                      ("compressed_psum_exact", compressed_psum_exact)):
        for axis in ("data", "model"):
            on_card = fn(x.to(dev), axis, e.to(dev), mesh=mesh)
            on_cpu = fn(x, axis, e, mesh=cpu)
            ok = all(torch.equal(a.cpu(), b) for a, b in zip(on_card,
                                                              on_cpu))
            check(ok, f"13d {fname} over {axis}: rank {mesh.rank}'s CUDA "
                  "result differs from the CPU world's")
            same[f"{fname}/{axis}"] = ok
    out["compressed"] = same
    return out


def phase_mesh_train(dev, early: dict) -> dict:
    """Phase 13: training on a mesh.  13a phase 10c's model on the unit
    mesh against its mesh-free steps (``phase_train_unit_mesh``); 13b the
    same model on (data, model) = (1, 2), two gloo ranks sharing the card,
    each running ssm_scan and its backward on its channel shard [2, 2,048,
    131,072]; 13c float32 at published widths on (1, 2) against the
    unsharded port; 13d smoke widths on (2, 2): two models' gradients, the
    Trainer's resize, the compressed all-reduces on CUDA tensors.  Both
    scans' standalone times at a 13b rank's shape are ``early``'s
    (``phase_scan_timing``, taken before any gloo world used the
    card)."""
    import os
    import shutil

    import torch
    from repro_torch.launch.world import run_world

    t13 = time.perf_counter()
    on_card = dev.type == "cuda"
    device = "cuda:0" if on_card else "cpu"
    by_path = {}
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    by_path.update(phase_train_unit_mesh(dev))

    t = time.perf_counter()
    if on_card:
        torch.cuda.empty_cache()
    name, cuts, shape, b, s, n_steps = MESH_TRAIN
    outs = run_world("chip_smoke:mesh_train_rank", math.prod(shape),
                     args=(MESH_TRAIN, device), backend="gloo",
                     timeout_s=900)
    shard = outs[0]["shard"]
    for o in outs:
        n_m = o["n_mamba"]
        want = {**NO_TCQ_LAUNCHES, "ssm_scan": 2 * n_m,
                "ssm_scan_bwd": n_m}
        check(not on_card or (o["fwd_shapes"] == [shard]
                              and o["bwd_shapes"] == [shard]),
              f"13b rank {o['rank']}: scan shapes {o['fwd_shapes']} / "
              f"{o['bwd_shapes']}, want {shard}")
        for i, st in enumerate(o["steps"]):
            check(not on_card or st["launches"] == want,
                  f"13b rank {o['rank']} step {i}: launches "
                  f"{st['launches']}, want {want}")
            check(math.isfinite(st["loss"]) and st["grad_norm"] > 0,
                  f"13b rank {o['rank']} step {i}: loss {st['loss']}")
            check(sum(st["sent"].values()) > 0 and st["layout"] > 0,
                  f"13b rank {o['rank']} step {i} sent nothing")
            flops = 6.0 * o["params"] * o["tokens"]
            log(f"13b {name} on {dict(zip(('data', 'model'), shape))} rank "
                f"{o['rank']} ({o['backend']}, host-staged "
                f"{o['host_staged']}, {o['dtype']}) step {i}"
                f"{' (the first, traced)' if i == 0 else ' (untraced)'}: "
                f"loss {st['loss']:.4f}, "
                f"grad norm {st['grad_norm']:.4f}, {st['wall']:.2f}s, "
                f"{o['tokens'] / st['wall']:.1f} tokens/s, model-FLOP "
                f"utilisation {100 * flops / st['wall'] / BF16_PEAK_FLOPS:.3f}"
                f"% (6 x {o['params']} parameters x {o['tokens']} tokens, "
                f"both ranks' work, over one card's 989 TFLOP/s); held "
                f"{o['held']} parameters, drawn in {o['init_s']:.1f}s; "
                f"memory resident {st['resident_bytes']} B, peak "
                f"{st['peak_bytes']} B; bytes to the collectives "
                f"{json.dumps(st['sent'])}, layout {st['layout']} B; "
                f"launches {json.dumps(st['launches'])}"
                + ("; device busy " + ("not measured" if st["busy"] is None
                                       else f"{100 * st['busy']:.1f}%")
                   + "; scans' device time " + (json.dumps(
                       st["scan_device_ms"]) if st["scan_device_ms"]
                       else "not measured") if i == 0 else ""))
    train_outs = outs
    losses = {tuple(round(st["loss"], 6) for st in o["steps"])
              for o in outs}
    check(len(losses) == 1, f"13b: the ranks' losses differ: {losses}")
    by_path["sharded_train_13b"] = {k: sum(st["launches"][k] for o in outs
                                           for st in o["steps"])
                                    for k in wrappers()}
    log(f"13b took {time.perf_counter() - t:.1f}s, process start included")

    t = time.perf_counter()
    if on_card:
        torch.cuda.empty_cache()
    outs = run_world("chip_smoke:mesh_check_rank", 2,
                     args=(F32_TRAIN, (1, 2), F32_TRAIN_ROWS, device),
                     backend="gloo", timeout_s=600)
    for o in outs:
        check(not on_card or (o["fwd_shapes"] == [o["shard"]]
                              and o["bwd_shapes"] == [o["shard"]]),
              f"13c rank {o['rank']}: the sharded step's scan shapes "
              f"{o['fwd_shapes']} / {o['bwd_shapes']}, want {o['shard']}")
        log(f"13c (float32, {F32_TRAIN}, {F32_TRAIN_ROWS[0]} x "
            f"{F32_TRAIN_ROWS[1]} tokens) rank {o['rank']}: against the "
            f"unsharded port on the card, loss {o['loss']:.6f} "
            f"({o['loss_rel']:.3g} relative), grad norm "
            f"{o['norm_rel']:.3g}, worst gradient {o['grad_worst']} "
            f"{o['grad_rel']:.3g}, worst parameter {o['param_worst']} "
            f"{o['param_rel']:.3g} over {o['leaves']} leaves (limit "
            f"{SHARD_TRAIN_REL}); the sharded step's scan shapes "
            f"{o['fwd_shapes']} / {o['bwd_shapes']}, launches "
            f"{json.dumps(o['launches'])} (the unsharded gradient pass's "
            f"{json.dumps(o['ref_launches'])}); peak {o['peak_bytes']} B; "
            f"collectives {json.dumps(o['sent'])}, layout {o['layout']} B; "
            f"sharded step with its check {o['wall']:.1f}s, with the "
            f"reference {o['total_s']:.1f}s")
    by_path["sharded_train_13c"] = {k: sum(o["launches"][k] for o in outs)
                                    for k in wrappers()}
    log(f"13c took {time.perf_counter() - t:.1f}s, process start included")

    t = time.perf_counter()
    shutil.rmtree(MESH_TRAIN_DIR, ignore_errors=True)
    outs = run_world("chip_smoke:mesh_smoke_rank", 4,
                     args=(device, str(MESH_TRAIN_DIR)), backend="gloo",
                     timeout_s=600)
    shutil.rmtree(MESH_TRAIN_DIR, ignore_errors=True)
    for o in outs:
        for arch in MESH_TRAIN_SMOKE:
            r = o[arch]
            log(f"13d {arch} smoke (f32) on (2, 2) rank {o['rank']}: loss "
                f"{r['loss']:.6f} ({r['loss_rel']:.3g}), norm "
                f"{r['norm_rel']:.3g}, worst gradient {r['grad_rel']:.3g} "
                f"({r['grad_worst']}), worst parameter {r['param_rel']:.3g}"
                f" ({r['param_worst']}); the sharded step's launches "
                f"{json.dumps(r['launches'])} (the unsharded gradient "
                f"pass's {json.dumps(r['ref_launches'])})")
        tr = o["trainer"]
        log(f"13d trainer rank {o['rank']}: (2, 2), failure at step 3, "
            f"resize onto (1, 4), resumed: steps {tr['steps']}, losses "
            f"within {tr['worst_rel']:.3g} relative of the uninterrupted "
            f"(2, 2) run's; {tr['clean_s']:.1f}s clean, "
            f"{tr['resumed_s']:.1f}s resumed; launches to the failure and "
            f"resumed {json.dumps(tr['launches'])} (the uninterrupted "
            f"run's {json.dumps(tr['clean_launches'])}); compressed "
            f"all-reduces on CUDA = CPU: {json.dumps(o['compressed'])}")
    by_path["sharded_train_13d"] = {
        k: sum(o[a]["launches"][k] for o in outs for a in MESH_TRAIN_SMOKE)
        for k in wrappers()}
    by_path["sharded_trainer_13d"] = {
        k: sum(o["trainer"]["launches"][k] for o in outs) for k in wrappers()}
    log(f"13d took {time.perf_counter() - t:.1f}s, process start included")
    # each 13b rank's bytes to the collectives and layout bytes, a step
    sent_13b = {o["rank"]: [(st["sent"], st["layout"]) for st in o["steps"]]
                for o in train_outs}
    if not on_card:
        return {"by_path": by_path, "at_shard": {}, "sent_13b": sent_13b}

    fwd, bwd = early["fwd_rank"], early["bwd_rank"]
    check(fwd["timing_shape"]["BSF"] == list(shard) and
          bwd["timing_shape"]["BSF"] == list(shard),
          f"13b: the scans were timed at {fwd['timing_shape']}, a rank's "
          f"shard is {shard}")
    log(f"phase 13 took {time.perf_counter() - t13:.1f}s; launches "
        f"by path: {json.dumps(by_path)}")
    # each rank's launches in each 13b step, as counted there
    per_step = {k: [[st["launches"][k] for st in o["steps"]]
                    for o in sorted(train_outs, key=lambda o: o["rank"])]
                for k in ("ssm_scan", "ssm_scan_bwd")}
    return {"by_path": by_path, "sent_13b": sent_13b, "at_shard": {
        "ssm_scan": {"shape": list(shard),
                     "launches_per_rank_step": per_step["ssm_scan"], **fwd},
        "ssm_scan_bwd": {"shape": list(shard),
                         "launches_per_rank_step": per_step["ssm_scan_bwd"],
                         **bwd}}}


# ------------------------------ phase 14: the journal on a mesh of ranks
# (data, model) meshes of two gloo ranks sharing the card: wave_peel's
# fused rung on each rank, then the composite over segdeg
MESH_WAL_CASES = (((2, 1), "psum"), ((1, 2), "psum"))


def mesh_wal_tape(tape) -> list:
    """Phase 7's crash tape with a checkpoint after its second edge batch
    (the checkpoint seals a segment and writes no record)."""
    ops, edges = [], 0
    for op in tape["ops"]:
        ops.append(op)
        edges += op[0] == "edges"
        if op[0] == "edges" and edges == 2:
            ops.append(("checkpoint",))
    return ops


def _wal_dir(base: str, key: str, life: str, rank: int) -> str:
    """Rank 0 journals under ``base/key/life``; every other rank is handed
    a directory of its own, which it must leave untouched."""
    return os.path.join(base, key, life if rank == 0 else
                        f"{life}-rank{rank}")


def mesh_wal_rank(state, ops, cases, base: str, device: str, stage: str,
                  kill_after: int) -> dict:
    """One rank of phase 14 (``launch/world.py``).  ``stage`` "write": on
    each (shape, combine) case, ``TCQService(mesh=, wal_dir=)`` runs the
    tape uninterrupted, then again with rank 0's journal dying after
    record ``kill_after`` (every rank stops there); "recover": a new world
    recovers the killed journal (``TCQService.recover(wal_dir, mesh=)``)
    and drains it, each with the launch counters zeroed around it."""
    from repro_torch.core import TCQService, TemporalGraph, WriteAheadLog
    from repro_torch.core.faultinject import CrashingWAL, InjectedCrash
    from repro_torch.launch.mesh import Mesh

    g = TemporalGraph.from_state(state)
    out = {}
    for shape, combine in cases:
        mesh = Mesh(shape, device=device)
        key = f"{shape[0]}x{shape[1]}-{combine}"
        got = {"rank": mesh.rank}
        if stage == "write":
            svc = TCQService(g, mesh=mesh, combine=combine, wal_dir=_wal_dir(
                base, key, "full", mesh.rank))
            tks, wall, n = run_path(lambda: drive_tape(svc, ops))
            got["full"] = {i: digest(tk.result) for i, tk in tks.items()}
            got["full_s"], got["full_launches"] = wall, n
            got["full_stats"] = svc.wal.stats()
            svc.wal.close()
            d = _wal_dir(base, key, "kill", mesh.rank)
            wal = (CrashingWAL(WriteAheadLog(d), crash_after_records=kill_after)
                   if mesh.rank == 0 else None)
            svc = TCQService(g, mesh=mesh, combine=combine, wal=wal,
                             wal_dir=d)
            seen = {}
            try:
                drive_tape(svc, ops, seen)
                got["crashed"] = False
            except InjectedCrash:
                got["crashed"] = True
            svc.wal.close()
            got["precrash"] = {i: digest(tk.result) for i, tk in seen.items()
                               if tk.status == "done"}
        else:
            d = _wal_dir(base, key, "kill", mesh.rank)
            rsvc, _, n = run_path(lambda: TCQService.recover(
                d, mesh=mesh, combine=combine))
            got["report"] = dict(rsvc.recovery_report)
            got["recover_launches"] = n
            drained, wall, n = run_path(rsvc.run_until_idle)
            got["drained"] = {tk.id: digest(tk.result) for tk in drained}
            got["drain_s"], got["drain_launches"] = wall, n
            got["stats"] = rsvc.wal.stats()
            rsvc.wal.close()
        got["files"] = sorted(os.path.relpath(os.path.join(r, f), base)
                              for r, _, fs in os.walk(os.path.join(base, key))
                              for f in fs)
        out[key] = got
    return out


def phase_mesh_wal(dev, tape: dict) -> dict:
    """Phase 14: phase 7's crash tape through ``TCQService(mesh=,
    wal_dir=)`` on (2, 1) (wave_peel on each rank) and (1, 2) (the
    composite over segdeg), two gloo ranks sharing the card: uninterrupted,
    then killed after the journal record phase 7's crash drill names, the
    world ended, and a new world recovered from rank 0's journal and
    drained.  Every ticket must equal the uninterrupted world's and phase
    7's unsharded recovered drain, bit for bit; only rank 0 writes."""
    import shutil
    import tempfile

    from repro_torch.launch.world import run_world

    t14 = time.perf_counter()
    on_card = dev.type == "cuda"
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    ops = mesh_wal_tape(tape)
    kill = tape["n_rec"]
    base = tempfile.mkdtemp(prefix="mesh-wal-", dir=ROOT / "build")
    device = "cuda:0" if on_card else "cpu"
    by_path = {}
    try:
        lives = {}
        for stage in ("write", "recover"):
            t0 = time.perf_counter()
            lives[stage] = run_world(
                "chip_smoke:mesh_wal_rank", 2,
                args=(tape["g0"], ops, MESH_WAL_CASES, base, device, stage,
                      kill), backend="gloo", timeout_s=600)
            log(f"14 {stage}: a world of 2 gloo ranks on {device} in "
                f"{time.perf_counter() - t0:.1f}s, process start included")
    finally:
        shutil.rmtree(base, ignore_errors=True)
    want = tape["recovered"]
    for shape, combine in MESH_WAL_CASES:
        key = f"{shape[0]}x{shape[1]}-{combine}"
        wrote = [o[key] for o in lives["write"]]
        rec = [o[key] for o in lives["recover"]]
        for w, r in zip(wrote, rec):
            full = w["full"]
            check(full.keys() == tape["clean"].keys() and all(
                full[i] == tape["clean"][i] for i in full),
                f"14 {key}: rank {w['rank']}'s uninterrupted world differs "
                "from phase 7's uninterrupted tape")
            check(w["crashed"], f"14 {key}: the kill never fired")
            resolved = {**w["precrash"], **r["drained"]}
            check(resolved.keys() == want.keys(),
                  f"14 {key}: rank {r['rank']} resolved tickets "
                  f"{sorted(resolved)}, phase 7's recovery {sorted(want)}")
            for i, cores in resolved.items():
                check(cores == want[i] and cores == full[i],
                      f"14 {key}: rank {r['rank']} ticket {i} differs from "
                      "the uninterrupted world or phase 7's recovery")
            check(r["report"] == rec[0]["report"] and r["stats"]
                  == rec[0]["stats"], f"14 {key}: rank {r['rank']}'s "
                  "recovery report or journal stats are not rank 0's")
            check(not [f for f in r["files"] if "-rank" in f],
                  f"14 {key}: a rank other than 0 wrote {r['files']}")
        n = {k: sum(r["drain_launches"][k] for r in rec) for k in wrappers()}
        if on_card:
            fused = shape[1] == 1
            check((n["wave_peel"] > 0) == fused and (n["segdeg"] > 0)
                  != fused and n["ssm_scan"] == n["ssm_scan_bwd"] == 0,
                  f"14 {key}: the recovered drain launched {n}")
        by_path[f"mesh_wal_{key}_drain"] = n
        by_path[f"mesh_wal_{key}_recover"] = {
            k: sum(r["recover_launches"][k] for r in rec) for k in wrappers()}
        rep = rec[0]["report"]
        log(f"14 {key}: the tape "
            f"uninterrupted in {wrote[0]['full_s']:.2f}s ({json.dumps(wrote[0]['full_stats'])}); "
            f"killed after journal record {kill}; recovered from snapshot "
            f"seq {rep['snapshot_seq']} + {rep['wal_records']} records in "
            f"{1e3 * rep['recover_s']:.1f} ms (rank 0), {rep['pending_after']} "
            f"tickets re-queued; drained in {rec[0]['drain_s']:.2f}s, "
            f"launches {json.dumps(n)}; {len(want)} admissions equal to the "
            f"uninterrupted world and to phase 7's unsharded recovery; only "
            f"rank 0 wrote ({len(rec[0]['files'])} files)")
    log(f"phase 14 took {time.perf_counter() - t14:.1f}s; launches by path: "
        f"{json.dumps(by_path)}")
    return {"by_path": by_path}


# ------------------------------------ phase 15: the dry run on the card
def tcq_dry_rank(state, reqs, cases, q: int, device: str) -> dict:
    """One rank of 15b: a single-iteration TCQ step
    (``build_wave_step(single_iteration=True)``) of phase 3's graph and
    ``q`` of its queries, live on the card, beside the dry run of the same
    step on a ``ShapeMesh`` rank: each one's bytes to the collectives."""
    import numpy as np
    import torch
    from repro_torch.core import TemporalGraph
    from repro_torch.core.distributed import (build_wave_step, plan_arrays,
                                              rank_arrays, shard_graph)
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import Mesh, ShapeMesh

    g = TemporalGraph.from_state(state)
    out = {}
    for shape, combine in cases:
        mesh = Mesh(shape, device=device)
        plan = shard_graph(g, mesh.model_shards)
        arrays = rank_arrays(plan_arrays(plan), mesh)
        step = build_wave_step(mesh, num_vertices=plan.num_vertices,
                               combine=combine, p_s=plan.num_pairs_shard,
                               single_iteration=True)
        pick = [reqs[i % len(reqs)] for i in range(q)]
        ts = np.array([r["ts"] for r in pick])
        te = np.array([r["te"] for r in pick])
        alive = torch.ones((q, plan.num_vertices), dtype=torch.bool,
                           device=mesh.device)
        step(*arrays, alive, ts, te, pick[0]["k"], 1)      # warm-up
        for k in mesh.sent_bytes:
            mesh.sent_bytes[k] = 0
        res, wall, n = run_path(lambda: step(*arrays, alive, ts, te,
                                             pick[0]["k"], 1))
        cost, *_ = DR.tcq_cost(DR.meta_tel(plan), q, ShapeMesh(
            shape, rank=mesh.rank), combine)
        out[f"{shape[0]}x{shape[1]}-{combine}"] = {
            "rank": mesh.rank, "live": dict(mesh.sent_bytes),
            "dry": cost.sent_bytes, "dry_segdeg": dict(cost.kernels["segdeg"]),
            "launches": n, "wall": wall, "iters": int(res[4]),
            "E_s": int(plan.src.shape[1]), "V": int(plan.num_vertices)}
    return out


def kernel_dryrun_bytes(kernels: list) -> None:
    """Each kernel entry's ``dryrun_bytes``: what the dry run's cost
    counter charges one call of the kernel at its timing shape (its
    dispatcher's ``meta`` rule), held to the bytes behind its bound (the
    dense count for the two TCQ kernels, whose bounds count this run's
    data, which a ``meta`` tensor does not carry)."""
    import torch
    from repro_torch.core.graph import DeviceTEL
    from repro_torch.kernels.segdeg.ops import banded_segsum
    from repro_torch.kernels.ssm_scan.ops import scan_forward, ssm_scan_bwd
    from repro_torch.kernels.wave_peel.ops import make_fused_wave_step
    from repro_torch.launch.op_cost import OpCost

    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    for k in kernels:
        sh = k["timing_shape"]
        with OpCost() as cost:
            if k["name"] == "wave_peel":
                e, p, v, w = sh["E"], sh["P"], sh["V"], sh["W"]
                i32 = torch.int32
                tel = DeviceTEL(meta(e, dtype=i32), meta(e, dtype=i32),
                                meta(e, dtype=i32), meta(e, dtype=i32),
                                meta(p, dtype=i32), meta(p, dtype=i32),
                                meta(sh["HP"], dtype=i32),
                                meta(sh["HP"], dtype=i32))
                make_fused_wave_step(tel, v)(meta(w, v, dtype=torch.bool),
                                             0, 0, 0, 0)
            elif k["name"] == "segdeg":
                banded_segsum(meta(sh["N"], sh["Q"]),
                              meta(sh["N"], dtype=torch.int32), sh["S"])
            elif k["name"] == "ssm_scan":
                x = meta(*sh["BSF"])
                scan_forward(x, x, meta(sh["BSF"][0], sh["BSF"][2]))
            else:
                x = meta(*sh["BSF"])
                ssm_scan_bwd(x, x, meta(sh["BSF"][0], sh["BSF"][2]), x)
        k["dryrun_bytes"] = cost.kernels[k["name"]]["bytes"]
        check(cost.kernels[k["name"]]["calls"] == 1 and k["dryrun_bytes"]
              == k["bound_bytes_dense"],
              f"{k['name']}: the dry run charges {k['dryrun_bytes']} bytes "
              f"at {sh}, its bound's bytes are {k['bound_bytes_dense']}")
        log(f"15c {k['name']} at {json.dumps(sh)}: the dry run charges "
            f"{k['dryrun_bytes']} bytes a call = the bytes behind its bound"
            + (" (every row, every table: the dense count)"
               if k["name"] in ("wave_peel", "segdeg") else ""))


def phase_dryrun(dev, state, reqs, sent_13b: dict, kernels: list) -> dict:
    """Phase 15: the dry run (``launch/dryrun.py``) held to the card.
    15a 13b's cell (phase 10c's Jamba, Adafactor, 2 x 2,048 tokens, (1,
    2)) on a ``ShapeMesh``: each rank's bytes to each kind of collective
    and layout bytes equal to what 13b's ranks measured a step in this
    run; 15b a single-iteration TCQ step live on a gloo (1, 2) world on
    the card, psum and rs_ag, against its dry run; 15c each kernel's
    dry-run charge at its timing shape against its bound's bytes; 15d the
    roofline terms (a model on datasheet rates, not a measurement) of a
    (16, 16) Jamba train cell and of the tcq-mathoverflow cell."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import ShapeMesh
    from repro_torch.launch.shapes import SHAPES, ShapeCell
    from repro_torch.launch.world import run_world

    t15 = time.perf_counter()
    on_card = dev.type == "cuda"
    name, cuts, shape, b, s, _ = MESH_TRAIN
    cfg = get_config(JAMBA).scaled(**cuts)
    for rank, steps in sorted(sent_13b.items()):
        cost, _, t_build, t_run = DR.lm_cost(
            cfg, ShapeCell("13b", s, b, "train"),
            ShapeMesh(shape, rank=rank), n_micro=1)
        for i, (sent, layout) in enumerate(steps):
            check(cost.sent_bytes == sent and cost.layout_bytes == layout,
                  f"15a rank {rank} step {i}: the dry run records "
                  f"{cost.sent_bytes} and layout {cost.layout_bytes} B, "
                  f"13b measured {sent} and {layout} B")
        log(f"15a 13b's cell on a ShapeMesh{shape} rank {rank} (built "
            f"{t_build:.1f}s, meta step {t_run:.1f}s on the host): bytes to "
            f"the collectives {json.dumps(cost.sent_bytes)}, layout "
            f"{cost.layout_bytes} B = 13b's measured bytes in each of its "
            f"{len(steps)} steps; kernels charged "
            f"{json.dumps(dict(cost.kernels))}")
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    q = 8
    cases = (((1, 2), "psum"), ((1, 2), "rs_ag"))
    outs = run_world("chip_smoke:tcq_dry_rank", 2,
                     args=(state, reqs, cases, q,
                           "cuda:0" if on_card else "cpu"),
                     backend="gloo", timeout_s=600)
    by_path = {}
    for shape_, combine in cases:
        key = f"{shape_[0]}x{shape_[1]}-{combine}"
        for o in outs:
            r = o[key]
            check(r["live"] == r["dry"], f"15b {key} rank {r['rank']}: live "
                  f"{r['live']}, dry run {r['dry']}")
            check(not on_card or r["launches"]["segdeg"]
                  == r["dry_segdeg"]["calls"] == 2,
                  f"15b {key} rank {r['rank']}: launches {r['launches']}, "
                  f"dry run {r['dry_segdeg']}")
            log(f"15b single-iteration TCQ step, {key}, rank {r['rank']} "
                f"(W={q}, E_s={r['E_s']}, V={r['V']}, {r['iters']} "
                f"iteration): live bytes to the collectives "
                f"{json.dumps(r['live'])} = the dry run's; "
                f"{r['wall'] * 1e3:.1f} ms; launches "
                f"{json.dumps(r['launches'])}, the dry run charges segdeg "
                f"{json.dumps(r['dry_segdeg'])}")
        by_path[f"dryrun_tcq_{key}"] = {
            k: sum(o[key]["launches"][k] for o in outs) for k in wrappers()}
    kernel_dryrun_bytes(kernels)
    cell = SHAPES["train_4k"]
    t0 = time.perf_counter()
    cost, mem, *_ = DR.lm_cost(cfg, cell, DR.production_mesh(False))
    tokens = cell.batch * cell.seq
    terms = DR._cost_record(cost, cfg.model_flops(tokens) / 256)
    terms.pop("top_ops")
    log(f"15d dry-run roofline (H100 datasheet rates, a model, not a "
        f"measurement) of phase 10c's Jamba (8 layers, no experts) at "
        f"train_4k ({cell.batch} x {cell.seq} tokens) on (16, 16), rank 0, "
        f"in {time.perf_counter() - t0:.1f}s: {json.dumps(terms)}; "
        f"collectives {json.dumps(DR.analysis.collective_summary(cost.collectives))}")
    rec = DR.lower_tcq_cell("tcq-mathoverflow", False, "rs_ag")
    rec["roofline"].pop("top_ops")
    log(f"15d dry-run roofline of tcq-mathoverflow on (16, 16), rs_ag, one "
        f"iteration: {json.dumps(rec['roofline'])}; collectives "
        f"{json.dumps(rec['collectives'])}")
    log(f"phase 15 took {time.perf_counter() - t15:.1f}s")
    return {"by_path": by_path}


# ------------------------------- phase 16: the tcq-youtube shape on the card
# ``powerlaw_temporal`` at tcq-youtube's vertices and span: alpha puts the
# distinct pairs near the config's 8,388,608; more edges are drawn than the
# config's 9,437,184 so that as many remain after self-loops
YOUTUBE = "tcq-youtube"
YOUTUBE_ALPHA = 0.9
YOUTUBE_DRAWN = 9_457_184
YOUTUBE_SPANS = (36, 72, 144)   # window spans tried, as 1/n of the span
YOUTUBE_N = 8                   # queries phase 16 answers
# (k, ts, te, cores) of phase 16's queries, as ``python3 chip_smoke.py
# --pick-youtube`` picks them (``pick_youtube_queries``, 3 minutes on an
# H100, so not in the phase).  At this shape 23 of the 24 windows of 1/36
# of the span it tried had more than 200 cores even at their largest k
# with a core, so each window takes the widest span, then the smallest
# k >= 10, whose query gives 1 to 200
YOUTUBE_REQUESTS = (
    (15, 138_353, 152_915, 200), (23, 505_869, 513_149, 130),
    (21, 132_298, 161_424, 12), (10, 780_034, 787_314, 166),
    (15, 1_009_418, 1_016_698, 38), (10, 644_902, 652_182, 68),
    (10, 896_146, 903_426, 50), (10, 532_260, 539_540, 102))


def count_cores(eng, g, k: int, ts: int, te: int, cap: int) -> int:
    """Distinct cores of the query (k, [ts, te]) through the engine's lane
    pool, or ``cap + 1`` once the count passes ``cap`` (the query is
    cancelled there)."""
    import numpy as np
    from repro_torch.core.results import QueryStats
    from repro_torch.core.scheduler import QueryState

    uts = g.unique_ts
    uts = uts[(uts >= ts) & (uts <= te)].astype(np.int64)
    if uts.size == 0:
        return 0
    pipe, _, _ = eng.make_pool(int(uts[0]), int(uts[-1]))
    qs = QueryState(uts, k, 1, True, QueryStats(n_timestamps=int(uts.size)))

    def admit():
        if len(qs.collected) > cap:
            qs.cancel()
        return []

    pipe.run_pool([qs], QueryStats(), admit=admit)
    return min(len(qs.collected), cap + 1)


def pick_youtube_queries(eng, g, n: int, k0: int, seed: int = 11,
                         max_results: int = 200) -> list:
    """``n`` query windows for phase 16 (``python3 chip_smoke.py
    --pick-youtube`` prints them): centred at seeded times, each of the
    widest span of ``YOUTUBE_SPANS`` with a k >= k0 whose query returns
    1..max_results cores, at the smallest such k, found walking k down
    from the largest k whose core of the whole window is not empty until
    the count passes max_results (the count falls as k rises).  A centre
    where no span does is drawn again."""
    import numpy as np
    import torch
    from repro_torch.core import tcd

    rng = np.random.default_rng(seed)
    t_lo, t_hi = int(g.unique_ts[0]), int(g.unique_ts[-1])
    total = t_hi - t_lo + 1
    ones = torch.ones(eng.num_vertices, dtype=torch.bool, device=eng.device)
    out = []
    for _ in range(6 * n):
        if len(out) == n:
            break
        mid = int(rng.integers(t_lo + total // 72, t_hi - total // 72))
        for div in YOUTUBE_SPANS:
            span = total // div
            ts = mid - span // 2
            te = ts + span - 1
            alive, top = ones, k0 - 1
            while True:             # warm-started: a k-core holds the next
                r = tcd(eng.tel, alive, ts, te, top + 1, 1,
                        num_vertices=eng.num_vertices)
                if int(r.n_edges) == 0:
                    break
                alive, top = r.alive, top + 1
            best = None
            for k in range(top, k0 - 1, -1):
                m = count_cores(eng, g, k, ts, te, max_results)
                if m > max_results:
                    break
                best = {"k": k, "ts": ts, "te": te, "cores": m,
                        "span": f"1/{div}"}
            log(f"pick: centre {mid}, span 1/{div}: largest k {top}, "
                f"{best}")
            if best is not None:
                out.append(best)
                break
    check(len(out) == n, f"found {len(out)} of {n} valid queries")
    return out


def youtube_graph():
    """(config, graph, build seconds) of phase 16: ``powerlaw_temporal``
    at tcq-youtube's vertices and span, its pairs held within 5% of the
    config's and at least its edges left after self-loops."""
    import numpy as np
    from repro_torch.configs import get_tcq_config
    from repro_torch.graphs import powerlaw_temporal

    cfg = get_tcq_config(YOUTUBE)
    t0 = time.perf_counter()
    g = powerlaw_temporal(num_vertices=cfg.num_vertices,
                          num_edges=YOUTUBE_DRAWN, time_span=cfg.time_span,
                          alpha=YOUTUBE_ALPHA, burst_periods=14, seed=11)
    build_s = time.perf_counter() - t0
    deg = np.bincount(np.concatenate([g.pair_u, g.pair_v]),
                      minlength=g.num_vertices)
    log(f"16 graph ({YOUTUBE} shape, alpha {YOUTUBE_ALPHA}, "
        f"{YOUTUBE_DRAWN} edges drawn): |V|={g.num_vertices} "
        f"|E|={g.num_edges} |P|={g.num_pairs} (config {cfg.num_pairs}, "
        f"{100 * (g.num_pairs / cfg.num_pairs - 1):+.2f}%), largest degree "
        f"{int(deg.max())} distinct neighbours, unique t "
        f"{g.unique_ts.size}, built in {build_s:.1f}s")
    check(g.num_vertices == cfg.num_vertices, "vertex count")
    check(g.num_edges >= cfg.num_edges,
          f"{g.num_edges} edges after self-loops < {cfg.num_edges}")
    check(abs(g.num_pairs - cfg.num_pairs) <= 0.05 * cfg.num_pairs,
          f"{g.num_pairs} pairs: not within 5% of {cfg.num_pairs}")
    return cfg, g, build_s


def pick_youtube() -> int:
    """``python3 chip_smoke.py --pick-youtube``: print phase 16's queries
    (``YOUTUBE_REQUESTS``) as ``pick_youtube_queries`` finds them."""
    import torch
    from repro_torch.core import TCQEngine

    cfg, g, _ = youtube_graph()
    eng = TCQEngine(g)
    t0 = time.perf_counter()
    reqs = pick_youtube_queries(eng, g, YOUTUBE_N, cfg.k)
    torch.cuda.synchronize()
    log(f"picked in {time.perf_counter() - t0:.1f}s")
    print(json.dumps(reqs))
    return 0


def phase_youtube(dev) -> dict:
    """The main path at the repo's tcq-youtube shape (3,276,800 vertices,
    9,437,184 edges, a span of 2^20): above wave_peel's shared memory, so
    every window step is its global-memory tier.  ``query_batch`` cold
    and warm, looped wave and serial queries, ``TCQService`` and the
    composite over segdeg (``use_kernel=False``) answer
    ``YOUTUBE_REQUESTS``, each path with the launch counters zeroed
    before it; all equal.  Then the global tier's step is timed against
    its bound and the plain step (PERF.md's kernel table, row 1b)."""
    import torch
    from repro_torch.core import TCQEngine, TCQService
    from repro_torch.core.scheduler import autotune_wave
    from repro_torch.core.wave import make_composite_step
    from repro_torch.kernels.segdeg.ops import (banded_segsum,
                                                segment_offsets)
    from repro_torch.kernels.wave_peel.ops import (canonical_step_cost,
                                                   max_vertices, tel_bands,
                                                   wave_peel_global)

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"     # (a CPU rehearsal counts no launch)
    torch.cuda.reset_peak_memory_stats()
    cfg, g, build_s = youtube_graph()
    check(g.num_vertices > max_vertices(), "the graph fits wave_peel")

    t0 = time.perf_counter()
    eng = TCQEngine(g)
    torch.cuda.synchronize()
    install_s = time.perf_counter() - t0
    check(eng.device == dev, f"engine on {eng.device}, not {dev}")
    tel_bytes = sum(x.numel() * x.element_size() for x in eng.tel)
    reqs = [{"k": k, "ts": ts, "te": te} for k, ts, te, _ in
            YOUTUBE_REQUESTS[:YOUTUBE_N]]
    log(f"16 engine installed in {install_s:.2f}s (whole TEL "
        f"{tel_bytes} bytes on the card); {len(reqs)} queries (k, ts, te, "
        "cores as picked): " + json.dumps(YOUTUBE_REQUESTS[:YOUTUBE_N]))

    batch, cold_s, n_cold = run_path(lambda: eng.query_batch(reqs))
    batch2, warm_s, n_warm = run_path(lambda: eng.query_batch(reqs))
    waves, wave_s, n_wave = run_path(lambda: [
        eng.query(r["k"], r["ts"], r["te"], mode="wave") for r in reqs])
    serials, serial_s, n_serial = run_path(lambda: [
        eng.query(r["k"], r["ts"], r["te"], mode="serial") for r in reqs])

    def serve():
        svc = TCQService(g)
        tks = [svc.submit({"k": r["k"], "ts": r["ts"], "te": r["te"]})
               for r in reqs]
        svc.run_until_idle()
        return svc, tks

    (svc, tks), svc_s, n_svc = run_path(serve)
    comp_eng = TCQEngine(g, use_kernel=False)
    comps, comp_s, n_comp = run_path(lambda: comp_eng.query_batch(reqs))
    by_path = {"youtube_batch_cold": n_cold, "youtube_batch_warm": n_warm,
               "youtube_wave": n_wave, "youtube_serial": n_serial,
               "youtube_service": n_svc, "youtube_composite_batch": n_comp}
    log(f"16 launches by path: {json.dumps(by_path)}")
    log("16 wave_peel_global launches by path: " + json.dumps(
        {path: n["wave_peel_global"] for path, n in by_path.items()}))

    for i, (k, _, _, cores) in enumerate(YOUTUBE_REQUESTS[:YOUTUBE_N]):
        want = digest(batch[i])
        check(len(batch[i]) == cores and 1 <= cores <= 200 and k >= cfg.k,
              f"16 query {i}: {len(batch[i])} cores at k={k}, picked "
              f"{cores}")
        for what, res in (("warm batch", batch2[i]), ("wave", waves[i]),
                          ("serial", serials[i]),
                          ("service", tks[i].result),
                          ("composite batch", comps[i])):
            check(res is not None and digest(res) == want,
                  f"16 query {i}: {what} differs from the cold batch")
    check(counters(batch) == counters(batch2) == counters(comps),
          "16: warm or composite batch's schedule counters differ from the "
          "cold one's")
    tier = "fused_global" if on_card else "composite"   # the CPU: plain
    for e, want_backend in ((eng, tier), (svc.engine, tier),
                            (comp_eng, "composite")):
        backends = {getattr(wt.step_fn, "backend", "?")
                    for wt in e._win_cache.values()}
        check(backends == {want_backend}, f"16: window steps {backends}")

    def expect(path, kernel, ok, want):
        got = by_path[path][kernel]
        check(not on_card or ok(got), f"16 {path}: {kernel} launched {got} "
              f"times, want {want}")

    steps = {"youtube_batch_cold": batch[0].stats.device_steps,
             "youtube_batch_warm": batch2[0].stats.device_steps,
             "youtube_wave": sum(w.stats.device_steps for w in waves),
             "youtube_service": max(tk.result.stats.device_steps
                                    for tk in tks)}
    for path in by_path:
        expect(path, "wave_peel", lambda n: n == 0, "0")
        expect(path, "ssm_scan", lambda n: n == 0, "0")
        expect(path, "ssm_scan_bwd", lambda n: n == 0, "0")
    for path, st in steps.items():      # one launch a step, nothing else
        expect(path, "wave_peel_global", lambda n: n >= st,
               f">= {st} device steps")
        expect(path, "segdeg", lambda n: n == 0, "0")
    expect("youtube_wave", "wave_peel_global",
           lambda n: n == steps["youtube_wave"],
           f"{steps['youtube_wave']}, one a step")
    it = comps[0].stats.peel_iters
    expect("youtube_composite_batch", "segdeg", lambda n: n >= 2 * it,
           f">= 2 x {it} peel iterations")
    for path in ("youtube_serial", "youtube_composite_batch"):
        expect(path, "wave_peel_global", lambda n: n == 0, "0")
    expect("youtube_serial", "segdeg", lambda n: n == 0, "0")

    st = batch[0].stats
    W = autotune_wave(eng.num_vertices, st.window_edges,
                      num_queries=len(reqs))
    log(f"16 main path: {len(reqs)} queries, "
        f"{sum(len(b) for b in batch)} cores, equal across query_batch "
        "(cold, warm), looped wave, looped serial, TCQService and the "
        "composite batch; their schedule counters equal; every window step "
        f"the global tier; composite batch {comp_s:.3f}s")
    log(f"16 query_batch: W={W} (autotune_wave), union window "
        f"{st.window_edges} edges; cold {cold_s:.3f}s, warm {warm_s:.3f}s "
        f"({len(reqs) / warm_s:.3f} queries/s); {st.device_steps} device "
        f"steps, {st.peel_iters} peel iterations, {st.occupancy:.2f} mean "
        f"occupied lanes; looped wave {wave_s:.3f}s "
        f"({sum(w.stats.device_steps for w in waves)} steps, "
        f"{sum(w.stats.peel_iters for w in waves)} peel iterations); "
        "looped serial "
        f"{serial_s:.3f}s ({sum(x.stats.cells_evaluated for x in serials)} "
        f"cells); TCQService {svc_s:.3f}s")
    del svc, tks, waves, serials, batch2, comps, comp_eng

    busy = profiled(lambda: eng.query_batch(reqs), "16 query_batch (warm)",
                    cpu_ops=False)
    peak = torch.cuda.max_memory_allocated()
    # where the host's time goes: one wave query under cProfile
    import cProfile
    import pstats

    prof = cProfile.Profile()
    r0 = reqs[0]
    prof.enable()
    eng.query(r0["k"], r0["ts"], r0["te"], mode="wave")
    torch.cuda.synchronize()
    prof.disable()
    rows = sorted(pstats.Stats(prof).stats.items(), key=lambda kv: -kv[1][2])
    log("16 host time of query 0 in wave mode by function (cProfile, own "
        "time): " + "; ".join(
            f"{fn[2]} ({Path(fn[0]).name}:{fn[1]}) {st[2]:.3f}s x {st[1]}"
            for fn, st in rows[:8]))
    log(f"16 device: busy share {busy if busy is None else round(busy, 4)}"
        f"; peak memory {peak} bytes; whole TEL {tel_bytes} bytes")

    # segdeg at the composite's two reductions on the batch's union TEL:
    # [E, W] edges -> [P, W] pairs, [2P, W] half-pairs -> [V, W] vertices
    lo = min(r["ts"] for r in reqs)
    hi = max(r["te"] for r in reqs)
    wt = eng._window_tel(lo, hi)
    tel = wt.tel
    gen = torch.Generator(device=dev).manual_seed(16)
    seg_rows = {}
    for name, ids, s in (("edges to pairs", tel.pair_id, tel.num_pairs),
                         ("half-pairs to vertices", tel.hp_src,
                          wt.num_vertices)):
        vals = (torch.rand((ids.shape[0], W), generator=gen, device=dev)
                < 0.5).to(torch.float32)
        off = segment_offsets(ids, s)
        got = banded_segsum(vals, ids, s, offsets=off)
        want = torch.zeros((s + 1, W), dtype=torch.float32, device=dev)
        want = want.index_add_(0, ids.clamp(max=s).long(), vals)[:s]
        check(torch.equal(got, want), f"16 segdeg {name}: not exact")
        ms = time_ms(lambda: banded_segsum(vals, ids, s, offsets=off), 10)
        dev_ms, trace = device_ms(lambda: banded_segsum(vals, ids, s,
                                                        offsets=off),
                                  10, "segdeg_kernel")
        nvalid = int(off[-1])
        b_ms, b_by = bound(4 * nvalid * W + 4 * nvalid + 4 * (s + 1)
                           + 4 * s * W, nvalid * W)
        n = int(ids.shape[0])
        seg_rows[name] = {"N": n, "Q": W, "S": s, "ms": ms,
                          "device_ms": dev_ms, "device_trace": trace,
                          "bound_ms": b_ms, "bound_by": b_by}
        log(f"16 segdeg, {name}: values [{n}, {W}] -> [{s}, {W}], exact; "
            f"{ms:.4f} ms a call (CUDA events), device time "
            f"{fmt_ms(dev_ms)} (trace {trace}); bound {b_ms:.5f} ms ({b_by}, the {nvalid} "
            f"rows with an id below {s})")

    # row 1b: the global tier's step at the batch's union TEL, W lanes of
    # the requests' windows from all-ones rows
    pick = [reqs[i % len(reqs)] for i in range(W)]
    lanes = [torch.tensor([r[f] for r in pick], dtype=torch.int32,
                          device=dev) for f in ("ts", "te", "k")]
    lanes.append(torch.ones(W, dtype=torch.int32, device=dev))
    alive0 = torch.ones((W, wt.num_vertices), dtype=torch.bool, device=dev)
    step = wt.step_fn
    check(step.backend == tier, f"16: a {step.backend} step")
    bands = getattr(step, "bands", None) or tel_bands(tel, wt.num_vertices)
    plain = make_composite_step(tel, wt.num_vertices)
    rg, rp = step(alive0.clone(), *lanes), plain(alive0, *lanes)
    torch.cuda.synchronize()
    assert_steps_equal(rg, rp, "16 global tier vs plain step")
    iters = int(rg.iters)
    buf = alive0.clone()
    refill = lambda: buf.copy_(alive0)          # noqa: E731
    glob_ms = time_ms(lambda: wave_peel_global(tel, bands, buf, *lanes),
                      10, setup=refill)
    glob_dev, glob_trace = device_ms(
        lambda: wave_peel_global(tel, bands, buf, *lanes), 10,
        "wave_peel_global_kernel", setup=refill)
    plain_ms = time_ms(lambda: plain(alive0, *lanes), 3)
    comp_step = TCQEngine(g, use_kernel=False)._window_tel(lo, hi).step_fn
    comp_ms = time_ms(lambda: comp_step(alive0.clone(), *lanes), 3)
    cost = canonical_step_cost(tel, bands, lanes[0], lanes[1], lanes[3],
                               [iters] * W, wt.num_vertices)
    g_bound, g_by = bound(cost["bytes"], cost["ops"])
    glob_row = {"W": W, "E": int(tel.t.shape[0]), "P": tel.num_pairs,
                "V": wt.num_vertices, "HP": int(tel.hp_src.shape[0]),
                "iters": iters, "ms": glob_ms, "device_ms": glob_dev,
                "device_trace": glob_trace, "bound_ms": g_bound,
                "bound_by": g_by, "plain_ms": plain_ms,
                "composite_ms": comp_ms}
    log(f"16 wave_peel_global at W={W}, E={tel.t.shape[0]}, "
        f"P={tel.num_pairs}, V={wt.num_vertices} ({iters} iterations): "
        f"bit-identical to the plain step; {glob_ms:.4f} ms a call (CUDA "
        f"events), device time {fmt_ms(glob_dev)} (trace {glob_trace}); "
        f"bound {g_bound:.5f} ms ({g_by}: {cost['bytes']} bytes, "
        f"{cost['ops']} operations); plain step {plain_ms:.4f} ms, the "
        f"composite over segdeg {comp_ms:.4f} ms")
    phase_s = time.perf_counter() - t_phase
    log(f"phase 16 took {phase_s:.1f}s")
    return {"by_path": by_path, "segdeg": seg_rows,
            "wave_peel_global": glob_row}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    if sys.argv[1:] == ["--pick-youtube"]:
        return pick_youtube()
    t_start = time.perf_counter()
    dev = torch.device("cuda")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(smi.splitlines()[0])
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    from repro_torch.kernels._build import (library, library_path,
                                            resource_usage)

    t0 = time.perf_counter()
    library()
    log(f"kernels built in {time.perf_counter() - t0:.1f}s: "
        f"{library_path().relative_to(ROOT)}")
    for name, usage in sorted(resource_usage().items()):
        log(f"ptxas -v: {name}: {usage}")

    # full float32 matrix products, so the f32 model on the card can be
    # held to the CPU at 1e-4
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def done(phase: str) -> None:
        log(f"-- {phase} done at {time.perf_counter() - t_start:.1f}s")

    errs = phase_kernels(dev)
    bounds = phase_boundary(dev)
    done("phase 2 (kernels, and the wave step's boundary)")
    main_run = phase_main(dev)
    done("phase 3 (main path)")
    phase_profile(main_run)
    kernels = phase_timing(dev, main_run, errs)
    done("phases 4-5 (profile, timing)")
    g = main_run.pop("g")
    del main_run["eng"]
    phase_lm_smoke(dev)
    lm = phase_lm(dev)
    kernels.append(lm["entry"])
    early = phase_scan_timing(dev)
    lm["entry"]["at_sharded_shape"] = early["fwd_rank"]
    done("phase 6 (Jamba, and the scans' standalone times)")
    torch.cuda.empty_cache()
    served = phase_serve(dev, g)
    done("phase 7 (serving)")
    base = phase_baseline(dev, g, main_run["reqs"][0])
    done("phase 8 (baseline)")
    # before any gloo world: traces taken after one lose kernel records
    youtube = phase_youtube(dev)
    for k in kernels:
        if k["name"] == "segdeg":
            k["at_youtube_shape"] = youtube["segdeg"]
    torch.cuda.empty_cache()
    done("phase 16 (the tcq-youtube shape)")
    meshed = phase_mesh(dev, g, main_run, served["capacity_qps"])
    done("phase 11 (the sharded pipeline)")
    for key in ("batch", "comp"):
        del main_run[key]
    g_state = g.state_dict()
    del g
    torch.cuda.empty_cache()
    t9 = time.perf_counter()
    phase_families_smoke(dev)
    fam = phase_families(dev)
    log(f"phase 9 took {time.perf_counter() - t9:.1f}s")
    done("phase 9 (LM families)")
    torch.cuda.empty_cache()
    sharded = phase_sharded_lm(dev, {"jamba": lm["tokens"].tolist(),
                                     **{k: v.tolist() for k, v in
                                        fam["tokens"].items()}})
    done("phase 12 (sharded LM serving)")
    torch.cuda.empty_cache()
    t10 = time.perf_counter()
    train_smoke = phase_train_smoke(dev)
    trained = phase_train(dev)
    # after 10c: in two runs with 10a first, right after phase 9's traces,
    # 10a's own traces recorded no device kernel at all
    kernels.append(phase_train_kernel(dev, early["bwd_train"]))
    lifecycle = phase_trainer(dev)
    for k in kernels:
        if k["name"] in trained["scan_ms_in_step"]:
            k["train_step_device_ms"] = trained["scan_ms_in_step"][k["name"]]
    log(f"phase 10 took {time.perf_counter() - t10:.1f}s")
    done("phase 10 (training)")
    torch.cuda.empty_cache()
    mesh_train = phase_mesh_train(dev, early)
    for k in kernels:
        if k["name"] in mesh_train["at_shard"]:
            k["at_sharded_train_shape"] = mesh_train["at_shard"][k["name"]]
    done("phase 13 (training on a mesh)")
    mesh_wal = phase_mesh_wal(dev, served["tape"])
    done("phase 14 (the journal on a mesh)")
    dry = phase_dryrun(dev, g_state, main_run["reqs"],
                       mesh_train["sent_13b"], kernels)
    done("phase 15 (the dry run)")
    by_path = {**bounds["by_path"], **main_run["by_path"], **lm["by_path"], **served["by_path"],
               **base["by_path"], **meshed["by_path"], **fam["by_path"],
               **sharded["by_path"], **train_smoke, **trained["by_path"],
               **lifecycle["by_path"], **mesh_train["by_path"],
               **mesh_wal["by_path"], **dry["by_path"],
               **youtube["by_path"]}
    for k in kernels:       # ``launches`` sums the per-path counts
        per = {path: n[k["name"]] for path, n in by_path.items()}
        k["launches"], k["launches_by_path"] = sum(per.values()), per
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
