"""Assigned input shapes of the LM substrate and their per-(arch x shape)
input specs.

Four LM shape cells:
    train_4k     seq 4096,    global batch 256   -> train step
    prefill_32k  seq 32768,   global batch 32    -> prefill_step
    decode_32k   seq 32768 KV, global batch 128  -> serve_step (1 new token)
    long_500k    seq 524288 KV, global batch 1   -> serve_step; only for
                 sub-quadratic archs (SSM/hybrid).

The counterpart of ``repro.launch.shapes``: ``batch_specs`` and
``cache_specs`` give every input of a cell as ``meta`` tensors (shape and
dtype, no storage) beside its spec on a mesh (anything with
``axis_names`` and ``shape``), and ``microbatches`` the train step's
gradient-accumulation factor.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.launch.mesh import _axsize, dp_axes
from repro_torch.models import transformer as T
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


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _entry(axes):
    """A spec entry over ``axes``: one axis stands alone, as a JAX
    ``PartitionSpec`` keeps it."""
    if axes is None:
        return None
    return axes[0] if len(axes) == 1 else axes


def batch_specs(cfg: ModelConfig, cell: ShapeCell, mesh):
    """(abstract_batch, batch_pspecs) for the model inputs of one cell:
    the batch over the dp axes where it splits evenly (and is > 1)."""
    dp = dp_axes(mesh)
    b = cell.batch
    s = 1 if cell.kind == "decode" else cell.seq
    dpb = dp if b % max(1, _axsize(mesh, dp)) == 0 else None
    bspec = _entry(dpb) if b > 1 else None
    batch: Dict[str, Any] = {}
    specs: Dict[str, Any] = {}
    if cfg.input_mode == "embeds":
        batch["embeds"] = _meta((b, s, cfg.d_model), torch.bfloat16)
        specs["embeds"] = (bspec, None, None)
    else:
        batch["tokens"] = _meta((b, s), torch.int32)
        specs["tokens"] = (bspec, None)
    if cfg.encoder_layers and cell.kind != "decode":
        batch["enc_embeds"] = _meta((b, cell.seq, cfg.d_model),
                                    torch.bfloat16)
        specs["enc_embeds"] = (bspec, None, None)
    if cfg.pos == "mrope":
        batch["positions"] = _meta((3, b, s), torch.int32)
        specs["positions"] = (None, bspec, None)
    elif cell.kind == "decode":
        batch["positions"] = _meta((b, s), torch.int32)
        specs["positions"] = (bspec, None)
    if cell.kind == "train":
        batch["labels"] = _meta((b, s), torch.int32)
        specs["labels"] = (bspec, None)
    if cell.kind == "decode":
        batch["cache_index"] = _meta((), torch.int32)
        specs["cache_index"] = ()
    return batch, specs


def cache_specs(cfg: ModelConfig, cell: ShapeCell, mesh):
    """(abstract cache, cache pspecs) of one cell: its decode cache of
    ``cell.seq`` positions (and as many encoder frames, for an
    encoder-decoder model)."""
    s_enc = cell.seq if cfg.encoder_layers else None
    abstract = T._map(lambda p: _meta(p.shape, T._dtype(cfg)),
                      T.cache_template(cfg, cell.batch, cell.seq, s_enc))
    return abstract, T.cache_pspecs(cfg, mesh, cell.batch, cell.seq, s_enc)


def microbatches(cfg: ModelConfig, cell: ShapeCell, mesh) -> int:
    """Gradient-accumulation factor: bound live activation memory to roughly
    one sequence per data shard per microbatch for the big configs."""
    if cell.kind != "train":
        return 1
    dp = _axsize(mesh, dp_axes(mesh))
    per_shard = max(1, cell.batch // dp)
    if cfg.n_micro_override:
        return min(per_shard, cfg.n_micro_override)
    if cfg.param_count() > 3e10:
        return min(per_shard, 8)
    if cfg.param_count() > 5e9:
        return min(per_shard, 2)
    return 1
