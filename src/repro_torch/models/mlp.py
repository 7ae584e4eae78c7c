"""Dense MLP variants: SwiGLU / GeGLU / plain (GPT-BigCode) / RWKV
channel-mix (PyTorch counterparts of ``repro.models.mlp``)."""

from __future__ import annotations

import torch

from repro_torch.models.layers import activation


def mlp(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    if cfg.glu:
        return (activation(x @ p["wg"], cfg.act) * (x @ p["wu"])) @ p["wd"]
    return activation(x @ p["wu"], cfg.act) @ p["wd"]


def rwkv_channel_mix(p: dict, x: torch.Tensor, shift_state, cfg):
    """RWKV channel-mix with token shift.  x: [B,S,d]; shift_state: [B,d]
    (last token of the previous call).  Returns (out, new_state)."""
    prev = torch.cat([shift_state[:, None, :].to(x.dtype), x[:, :-1, :]],
                     dim=1)
    xx = prev - x
    xk = x + xx * p["mu_k"]
    xr = x + xx * p["mu_r"]
    k = activation(xk @ p["wu"], "relu_sq")
    r = torch.clamp(xr @ p["wr"], -60.0, 60.0)
    out = (k @ p["wd"]) * (1.0 / (1.0 + torch.exp(-r)))
    return out, x[:, -1, :]
