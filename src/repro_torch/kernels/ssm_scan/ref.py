"""Plain PyTorch version of the diagonal SSM scan kernel."""

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
