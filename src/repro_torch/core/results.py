"""Result containers for temporal k-core queries."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class CoreResult:
    """One distinct temporal k-core.

    Identity is its TTI (paper Property 2: cores are identical iff their
    tightest time intervals are equal, for a fixed k and graph).
    """

    k: int
    tti: Tuple[int, int]
    vertices: np.ndarray  # sorted vertex ids
    n_edges: int

    @property
    def span(self) -> int:
        return self.tti[1] - self.tti[0]

    @property
    def n_vertices(self) -> int:
        return int(self.vertices.size)

    def __repr__(self) -> str:  # compact for logs
        return (f"Core(k={self.k}, tti=[{self.tti[0]},{self.tti[1]}], "
                f"|V|={self.n_vertices}, |E|={self.n_edges})")


@dataclasses.dataclass
class QueryStats:
    """Per-query schedule/pipeline counters.

    For queries served through ``TCQEngine.query_batch`` the pipeline is
    shared, so the device-side counters (device_steps, host_syncs,
    bytes_synced, peel_iters, lane_refills, occupancy, wall_time_s)
    describe the whole batch and are reported identically on every
    member query; schedule counters (cells_*, pruned_*, duplicates)
    remain query-local.
    """

    n_timestamps: int = 0
    cells_total: int = 0          # n*(n+1)/2 schedule cells (unique-ts space)
    cells_evaluated: int = 0      # TCD operations actually executed
    cells_trivial: int = 0        # skipped host-side (provably empty)
    cells_cached: int = 0         # resolved from the TTI core cache
    duplicates: int = 0           # re-induced cores (0 for serial OTCD)
    por_triggers: int = 0
    pou_triggers: int = 0
    pol_triggers: int = 0
    pruned_por: int = 0           # cells pruned by each rule
    pruned_pou: int = 0
    pruned_pol: int = 0
    pruned_empty: int = 0
    device_steps: int = 0
    host_syncs: int = 0           # blocking device->host sync points
    bytes_synced: int = 0         # total device->host result payload
    lane_refills: int = 0         # in-place lane buffer refills (wave mode)
    admissions: int = 0           # queries admitted mid-flight (live pool)
    peel_iters: int = 0           # shared fixpoint iterations (wave mode)
    window_edges: int = 0         # edges in the windowed TEL actually peeled
    occupancy: float = 0.0        # mean occupied lanes per device step (wave)
    batch_size: int = 0           # queries sharing the pipeline (query_batch)
    wall_time_s: float = 0.0
    collective_bytes: int = 0     # degree-combine wire bytes (sharded pools)
    shard_occupancy: Optional[List[float]] = None  # per-lane-shard occupancy

    def absorb_pool(self, pool_stats: "QueryStats", *, window_edges: int,
                    batch_size: int) -> None:
        """Copy the shared lane pool's device-side counters onto one
        member query's stats (used by ``query_batch`` and the streaming
        service — the single place the pool->member field list lives)."""
        self.window_edges = window_edges
        self.batch_size = batch_size
        self.device_steps = pool_stats.device_steps
        self.host_syncs = pool_stats.host_syncs
        self.bytes_synced = pool_stats.bytes_synced
        self.peel_iters = pool_stats.peel_iters
        self.lane_refills = pool_stats.lane_refills
        self.admissions = pool_stats.admissions
        self.occupancy = pool_stats.occupancy
        self.collective_bytes = pool_stats.collective_bytes
        self.shard_occupancy = pool_stats.shard_occupancy

    @property
    def pruned_total(self) -> int:
        return self.pruned_por + self.pruned_pou + self.pruned_pol

    def pruned_pct(self) -> float:
        if self.cells_total == 0:
            return 0.0
        return 100.0 * self.pruned_total / self.cells_total


@dataclasses.dataclass
class TCQResult:
    cores: List[CoreResult]
    stats: QueryStats

    def by_tti(self) -> Dict[Tuple[int, int], CoreResult]:
        return {c.tti: c for c in self.cores}

    def filter_span(self, min_span: Optional[int] = None,
                    max_span: Optional[int] = None) -> "TCQResult":
        """Paper §6.2 time-span constraint, applied on the fly or post-hoc."""
        out = [c for c in self.cores
               if (min_span is None or c.span >= min_span)
               and (max_span is None or c.span <= max_span)]
        return TCQResult(out, self.stats)

    def top_n_shortest_span(self, n: int) -> List[CoreResult]:
        return sorted(self.cores, key=lambda c: (c.span, c.tti))[:n]

    def __len__(self) -> int:
        return len(self.cores)
