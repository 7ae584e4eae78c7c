"""Symmetric per-tensor int8 quantization of gradients.

PyTorch port of ``repro.optim.compression``'s ``quantize_int8`` and
``dequantize_int8``; both round half to even, as ``jnp.round`` does.  The
compressed all-reduces built on them (``compressed_psum``,
``compressed_psum_exact``) are collectives and wait for training on a
mesh (ROADMAP A11c).
"""

from __future__ import annotations

from typing import Tuple

import torch


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization.  Returns (q, scale)."""
    xf = x.to(torch.float32)
    amax = torch.max(torch.abs(xf))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)
