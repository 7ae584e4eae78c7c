"""Plain PyTorch versions of the diagonal SSM scan kernels."""

from __future__ import annotations

import torch


def ssm_scan_ref(log_a: torch.Tensor, bx: torch.Tensor,
                 s0: torch.Tensor) -> torch.Tensor:
    """s_t = exp(log_a_t) * s_{t-1} + bx_t, returning all states.

    log_a/bx: [B, S, F] (<= 0 decays); s0: [B, F].  Out: [B, S, F] float32.
    A loop over S on [B, F] tensors, in float32."""
    la = log_a.to(torch.float32)
    b = bx.to(torch.float32)
    out = torch.empty(la.shape, dtype=torch.float32, device=la.device)
    cur = s0.to(torch.float32)
    for t in range(la.shape[1]):
        cur = torch.exp(la[:, t]) * cur + b[:, t]
        out[:, t] = cur
    return out


def ssm_scan_bwd_ref(log_a: torch.Tensor, states: torch.Tensor,
                     s0: torch.Tensor, g: torch.Tensor):
    """The adjoint of :func:`ssm_scan_ref`: (dlog_a, dbx [B, S, F], ds0
    [B, F]), float32, for the states it returned and their gradient g.

    A reverse loop over S on [B, F] tensors, in the kernel's order:
    c_t = g_t + exp(log_a_{t+1}) * c_{t+1} (c_{S-1} = g_{S-1}), dbx_t = c_t,
    dlog_a_t = c_t * exp(log_a_t) * s_{t-1} (s_{-1} = s0), ds0 = exp(log_a_0)
    * c_0."""
    la, st, gf = (t.to(torch.float32) for t in (log_a, states, g))
    s0f = s0.to(torch.float32)
    dla = torch.empty(la.shape, dtype=torch.float32, device=la.device)
    dbx = torch.empty_like(dla)
    carry = torch.zeros_like(s0f)
    a_next = torch.zeros_like(s0f)
    for t in range(la.shape[1] - 1, -1, -1):
        c = gf[:, t] + a_next * carry
        a = torch.exp(la[:, t])
        prev = st[:, t - 1] if t > 0 else s0f
        dbx[:, t] = c
        dla[:, t] = c * a * prev
        carry, a_next = c, a
    return dla, dbx, a_next * carry
