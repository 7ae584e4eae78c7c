"""What the traffic drivers share: the graph of a configuration, the
seeded sample of answers that the reference checks, and that check."""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from tcqbench import gen


def edges(config: dict):
    """The configuration's raw ``(u, v, t)`` arrays; their count after
    self-loops is held to the configuration's."""
    u, v, t = gen.graph_edges(config["name"], config["graph"])
    want = config.get("edges_after_self_loops")
    got = int(np.count_nonzero(u != v))
    if want is not None and got != int(want):
        raise RuntimeError(f"{config['name']}: {got} edges after self-loops,"
                           f" the configuration states {want}: the "
                           "generator's draws changed")
    return u, v, t


def program_graph(u, v, t, num_vertices: int):
    """The program's graph of the arrays, through ``TemporalGraph.
    from_edges``."""
    from repro_torch.core import TemporalGraph

    return TemporalGraph.from_edges(u, v, t, num_vertices)


class Stages:
    """Seconds of each named stage of a set-up, for the run's log."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self._t = time.perf_counter()

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self._t
        self._t = now


class Reservoir:
    """A uniform sample of at most ``size`` items of a stream, drawn from
    ``seed`` (reservoir sampling): the answers the reference checks."""

    def __init__(self, size: int, seed: int):
        self.size = int(size)
        self.items: List = []
        self.seen = 0
        self._rng = np.random.default_rng(np.random.SeedSequence([seed, 5]))

    def wants(self) -> int:
        """Slot for the next item, or -1 when it is not sampled.  Call
        once per item, then ``put`` the item when the slot is >= 0."""
        self.seen += 1
        if len(self.items) < self.size:
            return len(self.items)
        j = int(self._rng.integers(0, self.seen))
        return j if j < self.size else -1

    def put(self, slot: int, item) -> None:
        if slot == len(self.items):
            self.items.append(item)
        else:
            self.items[slot] = item


def check_sample(sample, edges: tuple, device) -> Dict[str, dict]:
    """Run the reference over each sampled answer ``(request, program
    cores)`` on the raw ``edges`` arrays and count the cores that
    differ."""
    from tcqbench.check import differing
    from tcqbench.reference.otcd import EdgeList, otcd

    ref_device = "cuda" if str(device).startswith("cuda") else "cpu"
    el = EdgeList(*edges, device=ref_device)
    bad = 0
    for req, got in sample:
        want = otcd(el, req["k"], req["ts"], req["te"], h=req.get("h", 1))
        bad += differing(got, want)
    return {"cores_differing": {"value": bad, "limit": 0},
            "queries_checked": {"value": len(sample), "at_least": 1}}
