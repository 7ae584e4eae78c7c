"""Query workloads for the TCQ serving launcher (PyTorch port of
``repro.data.pipeline::TCQRequestStream``; host-side numpy with the same
seeded draws, so both packages generate the same request tapes).

``TCQRequestStream`` generates temporal k-core query workloads: windows
with a controllable span over a graph's time range, optionally tagged
with open-loop arrival times.
"""

from __future__ import annotations

import dataclasses

import numpy as np


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
