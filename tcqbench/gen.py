"""The benchmark's inputs, made from seeds: graphs and request windows.

``powerlaw_edges`` is a frozen copy of ``repro_torch.graphs.generators.
powerlaw_temporal`` that returns the raw ``(u, v, t)`` arrays: the same
draws, so a graph the program built from them is that function's graph.
It is copied, not imported, so that a change to the program cannot change
what the benchmark asks of it; ``tests/test_tcqbench_gen.py`` holds it to
recorded digests and to the original.

``graph_edges`` caches the arrays of a configuration under
``build/tcqbench/`` in the checkout, keyed by this file's hash, the
configuration's generator parameters and its graph seed.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
_GOLDEN = (5 ** 0.5 - 1) / 2
CACHE_DIR = ROOT / "build" / "tcqbench"


def powerlaw_edges(num_vertices: int, num_edges: int, time_span: int,
                   alpha: float = 1.5, burst_periods: int = 6,
                   burst_frac: float = 0.5, seed: int = 0):
    """Skewed degrees and bursty timestamps: ``num_edges`` draws of
    ``(u, v, t)``, self-loops included (the graph drops them)."""
    rng = np.random.default_rng(seed)
    w = (np.arange(1, num_vertices + 1, dtype=np.float64)) ** (-alpha)
    w /= w.sum()
    u = rng.choice(num_vertices, size=num_edges, p=w)
    v = rng.choice(num_vertices, size=num_edges, p=w)
    n_burst = int(num_edges * burst_frac)
    t_bg = rng.integers(1, time_span + 1, num_edges - n_burst)
    centers = rng.integers(1, time_span + 1, burst_periods)
    which = rng.integers(0, burst_periods, n_burst)
    width = max(1, time_span // (burst_periods * 8))
    t_b = centers[which] + rng.integers(-width, width + 1, n_burst)
    t = np.clip(np.concatenate([t_bg, t_b]), 1, time_span)
    return u, v, t


def _cache_key(graph: dict) -> str:
    h = hashlib.sha256(Path(__file__).read_bytes())
    h.update(json.dumps(graph, sort_keys=True).encode())
    return h.hexdigest()[:16]


def graph_edges(name: str, graph: dict):
    """``(u, v, t)`` int64 arrays of a configuration's ``graph`` entry
    (``powerlaw_edges`` keyword arguments), through the cache."""
    path = CACHE_DIR / f"{name}-{_cache_key(graph)}.npz"
    if path.exists():
        with np.load(path) as z:
            return z["u"], z["v"], z["t"]
    u, v, t = powerlaw_edges(**graph)
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp.npz")
    np.savez(tmp, u=u.astype(np.int32), v=v.astype(np.int32),
             t=t.astype(np.int32))
    tmp.replace(path)
    return u, v, t


def batch_requests(spec: dict, seed: int, b: int, t_min: int,
                   t_max: int) -> list:
    """The ``b``-th batch of a request spec, drawn from ``seed``.

    ``stratified``: ``per_batch`` windows of ``span``, the starts of window ``j`` of the run
    at ``frac(phase + j / golden ratio)`` of the range, the phase drawn
    from ``seed``: every window fresh, and every run's windows spread
    evenly over the range, so every seed asks about the same work.
    ``shifted``: the spec's fixed ``windows`` ``[k, ts, te]``, each moved
    by an offset within ``1/shift_div`` of its span, k kept, in an order
    drawn from ``seed``.  The offsets are drawn from the spec's
    ``shift_seed`` and the batch's number, so no two batches of a run ask
    identical windows, and every seed asks the same windows in another
    order: the same work.
    """
    h = int(spec.get("h", 1))
    if spec["kind"] == "stratified":
        # starts on a golden-ratio rotation with a seeded phase: every
        # window fresh, and any run's windows cover the span evenly
        n = int(spec["per_batch"])
        span = int(spec["span"])
        total = max(1, t_max - t_min - span)
        phase = np.random.default_rng(
            np.random.SeedSequence([seed, 8])).random()
        j = np.arange(n * b, n * (b + 1), dtype=np.float64)
        starts = t_min + np.floor(np.mod(phase + j * _GOLDEN, 1.0) * total)
        return [{"k": int(spec["k"]), "h": h, "ts": int(ts),
                 "te": int(ts) + span} for ts in starts]
    if spec["kind"] == "shifted":
        wins = spec["windows"]
        shift = np.random.default_rng(
            np.random.SeedSequence([int(spec["shift_seed"]), b, 4]))
        moved = []
        for k, ts, te in ((int(x) for x in w) for w in wins):
            m = (te - ts + 1) // int(spec["shift_div"])
            off = int(shift.integers(-m, m + 1))
            moved.append({"k": k, "h": h, "ts": ts + off, "te": te + off})
        order = np.random.default_rng(np.random.SeedSequence([seed, b, 4]))
        return [moved[i] for i in order.permutation(len(moved))]
    raise ValueError(f"unknown request kind {spec['kind']!r}")
