"""TCQ-engine workload configs — the paper's system as dry-run peers.

Shapes mirror the paper's Table 2 datasets (vertices/edges/span); the wave
width Q is the batched-engine lever.  These drive the distributed TCQ
dry-run (edges sharded on `model`, query lanes on `data`×`pod`) and the
engine's roofline rows in EXPERIMENTS.md.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TCQConfig:
    name: str
    num_vertices: int
    num_edges: int
    num_pairs: int          # distinct (u,v) links (<= num_edges)
    time_span: int
    wave: int               # query cells peeled per device step
    k: int = 10
    max_peel_iters: int = 32
    notes: str = ""


CONFIGS = {
    # paper Table 2 shape classes
    "tcq-collegemsg": TCQConfig(
        "tcq-collegemsg", num_vertices=2_048, num_edges=20_480,
        num_pairs=16_384, time_span=16_384, wave=256, k=2),
    "tcq-mathoverflow": TCQConfig(
        "tcq-mathoverflow", num_vertices=24_576, num_edges=507_904,
        num_pairs=262_144, time_span=65_536, wave=256, k=2),
    "tcq-youtube": TCQConfig(
        "tcq-youtube", num_vertices=3_276_800, num_edges=9_437_184,
        num_pairs=8_388_608, time_span=1_048_576, wave=64, k=10),
    "tcq-stackoverflow": TCQConfig(
        "tcq-stackoverflow", num_vertices=2_621_440, num_edges=66_060_288,
        num_pairs=50_331_648, time_span=1_048_576, wave=64, k=2),
    # the "billion-edge TEL needs a distributed cluster" case from §7.2
    "tcq-billion": TCQConfig(
        "tcq-billion", num_vertices=134_217_728, num_edges=1_073_741_824,
        num_pairs=805_306_368, time_span=4_194_304, wave=32, k=10,
        notes="hypothetical billion-edge graph: the paper's motivation for a "
              "distributed memory cluster"),
}
