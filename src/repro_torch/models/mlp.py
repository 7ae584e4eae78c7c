"""Dense MLP variants: SwiGLU / GeGLU / plain (GPT-BigCode).  The RWKV
channel-mix comes with the RWKV slice (ROADMAP A12)."""

from __future__ import annotations

import torch

from repro_torch.models.layers import activation


def mlp(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    if cfg.glu:
        return (activation(x @ p["wg"], cfg.act) * (x @ p["wu"])) @ p["wd"]
    return activation(x @ p["wu"], cfg.act) @ p["wd"]
