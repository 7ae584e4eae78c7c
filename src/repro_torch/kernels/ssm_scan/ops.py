"""Diagonal SSM scan: the dispatcher between the plain version and the
CUDA kernel.

``ssm_scan(log_a, bx, s0) -> [B, S, F] float32`` computes every state of
``s_t = exp(log_a_t) * s_{t-1} + bx_t``: the Mamba recurrence of
``models/ssm.py::mamba_mix``.  On CPU tensors it runs the plain version
(:func:`ref.ssm_scan_ref`); on CUDA tensors it launches the kernel in
``csrc/ssm_scan.cu`` or raises — nothing falls back.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._build import bind, check
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref


def _launcher():
    return bind("ssm_scan_launch", frozenset({3, 4, 5}), 8)


def ssm_scan(log_a: torch.Tensor, bx: torch.Tensor,
             s0: torch.Tensor) -> torch.Tensor:
    """log_a/bx: [B, S, F]; s0: [B, F] -> all states [B, S, F] float32.
    Inputs of any float type are cast to float32 first, as the TPU
    kernel casts them."""
    if log_a.device.type == "cpu":
        return ssm_scan_ref(log_a, bx, s0)
    if log_a.device.type != "cuda":
        raise ValueError(f"ssm_scan: unsupported device {log_a.device}")
    if log_a.dim() != 3 or bx.shape != log_a.shape or \
            tuple(s0.shape) != (log_a.shape[0], log_a.shape[2]):
        raise ValueError("ssm_scan: expected log_a, bx [B, S, F] and s0 "
                         f"[B, F], got {tuple(log_a.shape)}, "
                         f"{tuple(bx.shape)} and {tuple(s0.shape)}")
    if bx.device != log_a.device or s0.device != log_a.device:
        raise ValueError("ssm_scan: log_a, bx and s0 must share a device")
    la, b, s0f = (t.to(torch.float32).contiguous() for t in (log_a, bx, s0))
    nb, ns, nf = la.shape
    out = torch.empty((nb, ns, nf), dtype=torch.float32, device=la.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(la.device).cuda_stream
    check(_launcher()(la.data_ptr(), b.data_ptr(), s0f.data_ptr(), nb, ns,
                      nf, out.data_ptr(), stream), "ssm_scan")
    ssm_scan.launches += 1
    return out


ssm_scan.launches = 0
