"""Mamba selective SSM block (arXiv:2312.00752) for the Jamba hybrid.

The diagonal recurrence
    s_t = exp(dt_t A) s_{t-1} + dt_t B_t x_t
over the [d_inner, d_state] state is one call of
``kernels.ssm_scan.ssm_scan``: the hand-written CUDA kernel on the card,
the plain loop on the CPU, and in the backward pass the reverse scan
(its CUDA kernel or its plain loop).  The JAX package's chunked lowerings
(``cfg.mamba_scan``, ``cfg.mamba_chunk``) compute the same states and are
not ported.  The conv1d frontend is a causal depthwise convolution with a
(d_conv-1)-token carry for decode.

On a mesh (``tp``, ``models/sharding.py``) a rank holds a contiguous block
of the d_inner channels ("mamba" over ``model``): conv, dt, A and D are
local, ``x_dbc`` is row-parallel (its partial [dt, B, C] is summed over
``model``, since every channel needs all of B and C), ``out_proj`` is
row-parallel, and the scan runs on the rank's [B, S, (d_inner/m) x
d_state].  ``in_proj``'s JAX block ("mamba2x": a contiguous block of the
2 x d_inner columns) is not "x channels r and z channels r", so it is
gathered over ``model`` first, as GSPMD would, and the rank takes its x
and z slices.  Training runs the same code: the gather's gradient is
reduce-scattered back to the JAX blocks, and the scan's forward and
backward kernels run on the rank's channel shard.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssm_scan import ssm_scan
from repro_torch.models.sharding import NO_TP, TP


def _causal_conv(x, w, b, carry):
    """x: [B,S,di]; w: [K,di] depthwise; carry: [B,K-1,di] (previous tokens).
    Returns (y [B,S,di], new_carry)."""
    k = w.shape[0]
    xp = torch.cat([carry.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
            for i in range(k))
    new_carry = xp[:, -(k - 1):, :] if k > 1 else carry
    return y + b[None, None, :], new_carry


def _ssm_inputs(p: dict, x: torch.Tensor, cfg, conv0, tp: TP = NO_TP):
    """Everything ``mamba_mix`` computes before the scan, in the JAX
    package's dtypes: (dtA, bx) [B,S,d_inner,d_state] float32 (the rank's
    channels on a mesh), the scan's inputs, and (Cm, xc, z, conv1) for
    after it."""
    ds = cfg.mamba.d_state
    di = cfg.mamba.d_inner(cfg.d_model)
    di_loc = p["conv_w"].shape[1]
    if p["in_proj"].shape[1] == 2 * di and di_loc == di:
        xz = x @ p["in_proj"]
        xr, z = torch.chunk(xz, 2, dim=-1)
    else:
        w = tp.full(p["in_proj"], 1, 2 * di)
        c0 = tp.offset(di_loc, di)
        xr = x @ w[:, c0:c0 + di_loc]
        z = x @ w[:, di + c0:di + c0 + di_loc]
        del w
    xc, conv1 = _causal_conv(xr, p["conv_w"], p["conv_b"], conv0)
    xc = F.silu(xc)

    dbc = tp.reduce(xc @ p["x_dbc"], di_loc < di)
    dt_rank = p["dt_proj"].shape[0]
    dt_raw, Bm, Cm = torch.split(dbc, [dt_rank, ds, ds], dim=-1)
    dt = F.softplus(dt_raw @ p["dt_proj"]
                    + p["dt_bias"][None, None, :])           # [B,S,di]
    A = -torch.exp(p["A_log"].to(torch.float32))             # [di,ds]
    dtA = dt.to(torch.float32)[..., None] * A[None, None]    # [B,S,di,ds]
    bx = (dt.to(torch.float32) * xc.to(torch.float32))[..., None] \
        * Bm.to(torch.float32)[:, :, None, :]                # [B,S,di,ds]
    return dtA, bx, Cm, xc, z, conv1


def mamba_mix(p: dict, x: torch.Tensor, cfg, state: Tuple,
              tp: TP = NO_TP):
    """x: [B,S,d].  state: (ssm [B,di,ds], conv [B,K-1,di]), the rank's
    channels on a mesh.  Returns (out [B,S,d], new_state); the new ssm
    state has the old one's dtype, as in the JAX package."""
    b, s, _ = x.shape
    s0, conv0 = state
    dtA, bx, Cm, xc, z, conv1 = _ssm_inputs(p, x, cfg, conv0, tp)
    di, ds = dtA.shape[2], dtA.shape[3]
    f = di * ds
    states = ssm_scan(dtA.reshape(b, s, f), bx.reshape(b, s, f),
                      s0.reshape(b, f))
    del dtA, bx                      # [B,S,F] f32 each: free before the next
    s_fin = states[:, -1].clone().reshape(b, di, ds)
    y = torch.einsum("bsdn,bsn->bsd", states.reshape(b, s, di, ds),
                     Cm.to(torch.float32))
    del states
    y = y + p["D"].to(torch.float32)[None, None] * xc.to(torch.float32)
    out = (y.to(x.dtype) * F.silu(z)) @ p["out_proj"]
    out = tp.reduce(out, p["out_proj"].shape[0] < cfg.mamba.d_inner(
        cfg.d_model))
    return out, (s_fin.to(s0.dtype), conv1)
