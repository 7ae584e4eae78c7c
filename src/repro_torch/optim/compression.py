"""Gradient compression: int8 quantized all-reduce with error feedback.

PyTorch port of ``repro.optim.compression``.  ``quantize_int8`` and
``dequantize_int8`` round half to even, as ``jnp.round`` does.
``compressed_psum`` and ``compressed_psum_exact`` are the JAX package's
``shard_map`` collectives over a group of a ``launch.mesh.Mesh``: each
rank quantizes its tensor (plus the residual carried from the last call),
the int8 payloads are summed as int32, and the residual between the
tensor and its quantized self comes back for the next call.  As in the
JAX package no trainer calls them; they are the primitive for a
data-parallel all-reduce that moves a quarter of bf16's bytes.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist


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


def compressed_psum(x: torch.Tensor, axis, error: torch.Tensor, *,
                    mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 all-reduce with error feedback over ``mesh``'s group ``axis``
    (a mesh axis name, or a tuple of them).

    x: this rank's tensor; error: its residual from the last call (same
    shape).  Returns (the mean over the group, the new residual).  Every
    rank quantizes with its own scale; the int32 sum of the payloads is
    dequantized with the mean of the scales, which is exact when the scales
    agree and otherwise off by at most max/min scale - 1 relative, a bias
    the error feedback absorbs."""
    group = mesh.group(axis)
    n = dist.get_world_size(group)
    target = x.to(torch.float32) + error.to(torch.float32)
    q, scale = quantize_int8(target)
    new_error = (target - q.to(torch.float32) * scale).to(error.dtype)
    # accumulate in int32 (exact for <= 2^23 summands), share the scales
    acc = mesh.all_reduce(q.to(torch.int32), dist.ReduceOp.SUM, group)
    mean_scale = mesh.all_reduce(scale, dist.ReduceOp.SUM, group) / n
    out = acc.to(torch.float32) * mean_scale / n
    return out.to(x.dtype), new_error


def compressed_psum_exact(x: torch.Tensor, axis, error: torch.Tensor, *,
                          mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """``compressed_psum`` with one scale agreed over the group first (the
    max of every rank's max |x + error|): an exact dequantize for one
    more scalar all-reduce before the payload."""
    group = mesh.group(axis)
    n = dist.get_world_size(group)
    target = x.to(torch.float32) + error.to(torch.float32)
    amax = mesh.all_reduce(torch.max(torch.abs(target)), dist.ReduceOp.MAX,
                           group)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(target / scale), -127, 127).to(torch.int8)
    new_error = (target - q.to(torch.float32) * scale).to(error.dtype)
    acc = mesh.all_reduce(q.to(torch.int32), dist.ReduceOp.SUM, group)
    out = acc.to(torch.float32) * scale / n
    return out.to(x.dtype), new_error
