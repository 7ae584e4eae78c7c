"""Data pipelines (PyTorch port of ``repro.data.pipeline``; host-side numpy
with the same seeded draws, so both packages generate the same batches and
request tapes).

``SyntheticLMData.batch_at(step)`` is a pure function of (seed, step,
host_id): after a failure and restart, resuming at step k replays exactly
the batch the crashed run would have seen (no iterator state to
checkpoint).  Its batches are numpy; the trainer moves them to its device.

``TCQRequestStream`` generates temporal k-core query workloads: windows
with a controllable span over a graph's time range, optionally tagged
with open-loop arrival times.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass
class SyntheticLMData:
    vocab: int
    batch: int
    seq: int
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1
    input_mode: str = "tokens"       # tokens | embeds
    d_model: int = 0                 # for embeds mode
    encoder: bool = False
    mrope: bool = False

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))
        b = self.batch // self.n_hosts
        out: Dict[str, np.ndarray] = {}
        toks = rng.integers(0, self.vocab, (b, self.seq + 1),
                            dtype=np.int64).astype(np.int32)
        if self.input_mode == "embeds":
            out["embeds"] = rng.normal(
                0, 0.02, (b, self.seq, self.d_model)).astype(np.float32)
        else:
            out["tokens"] = toks[:, :-1]
        out["labels"] = toks[:, 1:]
        if self.encoder:
            out["enc_embeds"] = rng.normal(
                0, 0.02, (b, self.seq, self.d_model)).astype(np.float32)
        if self.mrope:
            pos = np.broadcast_to(np.arange(self.seq, dtype=np.int32),
                                  (3, b, self.seq)).copy()
            out["positions"] = pos
        return out


@dataclasses.dataclass
class TCQRequestStream:
    """Query workload: (k, ts, te) windows over a graph's time span."""
    t_min: int
    t_max: int
    k: int = 2
    span: int = 3 * 86_400
    seed: int = 0

    def requests(self, n: int, start: int = 0):
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, start]))
        span_total = max(1, self.t_max - self.t_min - self.span)
        for i in range(n):
            ts = int(self.t_min + rng.integers(0, span_total))
            yield {"id": start + i, "k": self.k, "ts": ts,
                   "te": ts + self.span}

    def open_loop(self, n: int, qps: float, start: int = 0):
        """Open-loop arrival process: the same request stream, each tagged
        with an ``arrive_s`` offset (seconds from t=0) drawn from a seeded
        exponential inter-arrival at rate ``qps`` — the serving loop
        submits a request once its wall clock passes ``arrive_s``,
        independent of service completions (so queueing is visible)."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, start, 1]))
        clock = 0.0
        for r in self.requests(n, start):
            clock += float(rng.exponential(1.0 / max(qps, 1e-9)))
            r["arrive_s"] = clock
            yield r
