"""Dynamic-graph feed (paper §6.1): batched edge arrival over an ArrayTEL.

The paper appends single edges to its linked-list TEL in O(1).  The array
equivalent is a stream of timestamp-ordered batches; each ``push`` is an
incremental sorted-run merge-append (`TemporalGraph.add_edges`,
O(E + B log B)) producing a *new epoch* — an immutable snapshot.  In-flight
queries pinned to an older epoch keep their snapshot; subscribers (the
streaming ``TCQService`` / ``TCQEngine.update_graph``) install the new
epoch for everything admitted afterwards.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional, Tuple

import numpy as np

from repro_torch.core.graph import TemporalGraph


class EdgeStream:
    """Replays a temporal graph as arrival batches, or accepts live pushes."""

    def __init__(self, initial: Optional[TemporalGraph] = None):
        self.graph = initial if initial is not None else TemporalGraph.from_edges(
            np.zeros(0), np.zeros(0), np.zeros(0), 0)
        self._subscribers: list[Callable[[TemporalGraph], None]] = []

    def subscribe(self, fn: Callable[[TemporalGraph], None]) -> None:
        self._subscribers.append(fn)

    def push(self, u, v, t) -> TemporalGraph:
        """Merge-append one arrival batch; notify subscribers of the new
        epoch.  Returns the new snapshot (the old one stays valid)."""
        self.graph = self.graph.add_edges(u, v, t)
        for fn in self._subscribers:
            fn(self.graph)
        return self.graph

    @staticmethod
    def replay(graph: TemporalGraph, n_batches: int
               ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Split a graph into n timestamp-ordered arrival batches."""
        order = np.argsort(graph.t, kind="stable")
        for chunk in np.array_split(order, n_batches):
            if chunk.size:
                yield graph.src[chunk], graph.dst[chunk], graph.t[chunk]
