"""Shared model layers: norms, rotary embeddings (incl. M-RoPE), softcaps.

PyTorch counterparts of ``repro.models.layers``, with the same dtype
handling: statistics in float32, results cast back to the input's type.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))
    return out.to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * scale.to(torch.float32) + bias.to(torch.float32)
    return out.to(x.dtype)


def norm(x, params, kind: str):
    if kind == "rmsnorm":
        return rmsnorm(x, params["scale"])
    return layernorm(x, params["scale"], params["bias"])


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def _rope_angles(positions: torch.Tensor, dim: int, theta: float) -> Tuple:
    """positions [..., S] -> cos/sin [..., S, dim/2] in f32."""
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                          device=positions.device) / dim))
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections: Optional[Tuple[int, ...]] = None
               ) -> torch.Tensor:
    """Rotary embedding.  x: [B, S, H, hd]; positions: [B, S] or [3, B, S]
    (M-RoPE: temporal/height/width position streams, each rotating its own
    section of the head dimension)."""
    hd = x.shape[-1]
    if positions.dim() == 3:  # M-RoPE
        secs = mrope_sections
        if secs is None or sum(secs) != hd // 2:
            raise ValueError(f"M-RoPE sections {secs} must sum to {hd // 2}")
        cos_parts, sin_parts = [], []
        start = 0
        for si, sec in enumerate(secs):
            freqs = 1.0 / (theta ** ((torch.arange(
                start, start + sec, dtype=torch.float32,
                device=positions.device) * 2) / hd))
            ang = positions[si].to(torch.float32)[..., None] * freqs
            cos_parts.append(torch.cos(ang))
            sin_parts.append(torch.sin(ang))
            start += sec
        cos = torch.cat(cos_parts, -1)[:, :, None, :]
        sin = torch.cat(sin_parts, -1)[:, :, None, :]
    else:
        cos, sin = _rope_angles(positions, hd, theta)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    if kind == "relu":
        return F.relu(x)
    if kind == "relu_sq":  # RWKV channel-mix
        r = F.relu(x)
        return r * r
    raise ValueError(kind)


def group_rmsnorm(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 64e-5) -> torch.Tensor:
    """Per-head group norm (RWKV output norm). x: [B, S, H, hd]."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.to(torch.float32)
    return out.to(x.dtype)
