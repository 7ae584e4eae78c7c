"""Dense MLP variants: SwiGLU / GeGLU / plain (GPT-BigCode) / RWKV
channel-mix (PyTorch counterparts of ``repro.models.mlp``).

On a mesh (``tp``, ``models/sharding.py``) ``wu``/``wg`` are
column-parallel and ``wd`` row-parallel over ``model`` when ``d_ff``
splits, followed by a sum over ``model``; RWKV's receptance ``wr`` holds
a column block of ``d``, whose output is gathered."""

from __future__ import annotations

import torch

from repro_torch.models.layers import activation
from repro_torch.models.sharding import NO_TP, TP


def mlp(p: dict, x: torch.Tensor, cfg, tp: TP = NO_TP) -> torch.Tensor:
    if cfg.glu:
        out = (activation(x @ p["wg"], cfg.act) * (x @ p["wu"])) @ p["wd"]
    else:
        out = activation(x @ p["wu"], cfg.act) @ p["wd"]
    return tp.reduce(out, p["wd"].shape[0] < cfg.d_ff)


def rwkv_channel_mix(p: dict, x: torch.Tensor, shift_state, cfg,
                     tp: TP = NO_TP):
    """RWKV channel-mix with token shift.  x: [B,S,d]; shift_state: [B,d]
    (last token of the previous call).  Returns (out, new_state)."""
    prev = torch.cat([shift_state[:, None, :].to(x.dtype), x[:, :-1, :]],
                     dim=1)
    xx = prev - x
    xk = x + xx * p["mu_k"]
    xr = x + xx * p["mu_r"]
    k = activation(xk @ p["wu"], "relu_sq")
    r = torch.clamp(tp.full(xr @ p["wr"], -1, x.shape[-1]), -60.0, 60.0)
    kv = tp.reduce(k @ p["wd"], p["wd"].shape[0] < cfg.d_ff)
    out = kv * (1.0 / (1.0 + torch.exp(-r)))
    return out, x[:, -1, :]
