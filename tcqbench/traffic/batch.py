"""Back-to-back ``TCQEngine.query_batch`` calls: an analyst's batches.

Set-up builds the graph and the engine (engine defaults, no core cache)
and answers ``warmup_batches`` batches drawn apart from the window's.  The
window then answers one batch after another until ``seconds`` have
passed; ``tcq_qps`` is every query answered over the time from the start
of the window to the end of the last batch that began inside it.

Cell parameters: ``requests`` (a ``gen.batch_requests`` spec),
``warmup_batches``, ``warmup_per_batch`` (how many of a warm-up batch's
requests to ask, the narrowest first; all by default) and
``check_queries`` (the size of the seeded sample of answers the reference
checks).
"""

from __future__ import annotations

import time

from tcqbench import cell, gen
from tcqbench.check import program_cores

# the window's batches are numbered from 0, the warm-up's from here
_WARMUP_BASE = 1 << 30


class Driver:
    def __init__(self, workload: dict, config: dict, seed: int, device):
        self.p = workload["params"]
        self.config = config
        self.seed = int(seed)
        self.device = device
        self.sample = cell.Reservoir(self.p["check_queries"], seed)
        self.batches = []

    def setup(self) -> None:
        from repro_torch.core import TCQEngine

        clock = cell.Stages()
        self.u, self.v, self.t = cell.edges(self.config)
        clock("edges")
        g = cell.program_graph(self.u, self.v, self.t,
                               self.config["graph"]["num_vertices"])
        self.t_min, self.t_max = int(g.t.min()), int(g.t.max())
        clock("graph")
        self.eng = TCQEngine(g, device=self.device)
        clock("engine")
        n = self.p.get("warmup_per_batch")
        for b in range(int(self.p["warmup_batches"])):
            # the narrowest windows first: the same warm-up for every seed
            reqs = sorted(self._batch(_WARMUP_BASE + b),
                          key=lambda r: (r["te"] - r["ts"], r["ts"]))
            self.eng.query_batch(reqs[:n] if n else reqs)
        clock("warmup")
        self.stages = clock.seconds

    def _batch(self, b: int) -> list:
        return gen.batch_requests(self.p["requests"], self.seed, b,
                                  self.t_min, self.t_max)

    def window(self, seconds: float, spans) -> dict:
        t0 = time.perf_counter()
        b = done = 0
        while time.perf_counter() - t0 < seconds:
            reqs = self._batch(b)
            with spans("query_batch"):
                res = self.eng.query_batch(reqs)
            self._record(reqs, res, spans.items[-1])
            done += len(reqs)
            b += 1
        t1 = time.perf_counter()
        self.attempted = done
        self.window_s = t1 - t0
        return {"tcq_qps": done / (t1 - t0)}

    def _record(self, reqs, res, span) -> None:
        st = [r.stats for r in res]
        self.batches.append({
            "queries": len(reqs),
            "seconds": span[2] - span[1],
            "device_steps": max(s.device_steps for s in st),
            "occupancy": max(s.occupancy for s in st),
            "windows": [(r["ts"], r["te"]) for r in reqs],
            "cells_evaluated": sum(s.cells_evaluated for s in st),
            "cores": sum(len(r) for r in res),
            "cores_max": max(len(r) for r in res),
            "over_200": sum(len(r) > 200 for r in res),
        })
        for req, r in zip(reqs, res):
            slot = self.sample.wants()
            if slot >= 0:
                self.sample.put(slot, (req, program_cores(r)))

    def record(self) -> dict:
        return {"batches": self.batches, "edges": (self.u, self.v, self.t)}

    def failed(self) -> int:
        return 0

    def release(self) -> None:
        self.eng = None

    def check(self) -> dict:
        return cell.check_sample(self.sample.items,
                                 (self.u, self.v, self.t), self.device)

    def info(self) -> dict:
        """Counts for the run's log: cores each batch returned."""
        return {"setup_stages_s": self.stages,
                "batches": len(self.batches),
                "cores_per_batch": [b["cores"] for b in self.batches],
                "seconds_per_batch": [round(b["seconds"], 4)
                                      for b in self.batches],
                "queries_over_200_cores": sum(b["over_200"]
                                              for b in self.batches),
                "cores_max": max(b["cores_max"] for b in self.batches),
                "device_steps": sum(b["device_steps"]
                                    for b in self.batches)}
