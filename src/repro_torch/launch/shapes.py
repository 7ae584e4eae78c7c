"""Assigned input shapes of the LM substrate (data only).

Four LM shape cells:
    train_4k     seq 4096,    global batch 256   -> train step
    prefill_32k  seq 32768,   global batch 32    -> prefill_step
    decode_32k   seq 32768 KV, global batch 128  -> serve_step (1 new token)
    long_500k    seq 524288 KV, global batch 1   -> serve_step; only for
                 sub-quadratic archs (SSM/hybrid).

A copy of the data of ``repro.launch.shapes``; its JAX abstract input specs
(``batch_specs``, ``cache_specs``) have no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq: int
    batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


def cell_is_applicable(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    if shape == "long_500k" and not cfg.supports_long_context:
        return False, ("full-attention architecture: 500k dense decode is "
                       "the quadratic regime this cell excludes (DESIGN.md "
                       "§Arch-applicability)")
    return True, ""
