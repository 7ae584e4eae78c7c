"""Diagonal SSM scan: the dispatchers between the plain versions and the
CUDA kernels, and the autograd Function that joins them.

``ssm_scan(log_a, bx, s0) -> [B, S, F] float32`` computes every state of
``s_t = exp(log_a_t) * s_{t-1} + bx_t``: the Mamba recurrence of
``models/ssm.py::mamba_mix``.  It goes through :class:`SSMScan`, so its
output keeps its inputs' gradients: the forward is :func:`scan_forward`,
the backward :func:`ssm_scan_bwd` (the reverse scan).  Each dispatcher
runs its plain version (``ref.py``) on CPU tensors and on CUDA tensors
launches its kernel in ``csrc/ssm_scan.cu`` or raises — nothing falls
back.  ``ssm_scan.launches`` and ``ssm_scan_bwd.launches`` count the
kernels' launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._build import bind, check
from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref, ssm_scan_ref


def _check(name: str, names: str, big, small) -> None:
    """[B, S, F] tensors ``big`` (called ``names``) and [B, F] ``small``
    (s0), on one CUDA device."""
    la = big[0]
    if la.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {la.device}")
    if la.dim() != 3 or any(t.shape != la.shape for t in big) or \
            tuple(small.shape) != (la.shape[0], la.shape[2]):
        raise ValueError(f"{name}: expected {names} [B, S, F] and s0 "
                         f"[B, F], got {[tuple(t.shape) for t in big]} and "
                         f"{tuple(small.shape)}")
    if any(t.device != la.device for t in (*big, small)):
        raise ValueError(f"{name}: every tensor must share a device")


def _f32(*ts):
    return tuple(t.to(torch.float32).contiguous() for t in ts)


def scan_forward(log_a: torch.Tensor, bx: torch.Tensor,
                 s0: torch.Tensor) -> torch.Tensor:
    """The forward scan without autograd: the plain loop on the CPU, the
    kernel on CUDA.  Inputs of any float type are cast to float32 first,
    as the TPU kernel casts them."""
    if log_a.device.type == "cpu":
        return ssm_scan_ref(log_a, bx, s0)
    _check("ssm_scan", "log_a, bx", (log_a, bx), s0)
    la, b, s0f = _f32(log_a, bx, s0)
    nb, ns, nf = la.shape
    out = torch.empty((nb, ns, nf), dtype=torch.float32, device=la.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(la.device).cuda_stream
    launch = bind("ssm_scan_launch", frozenset({3, 4, 5}), 8)
    check(launch(la.data_ptr(), b.data_ptr(), s0f.data_ptr(), nb, ns, nf,
                 out.data_ptr(), stream), "ssm_scan")
    ssm_scan.launches += 1
    return out


def ssm_scan_bwd(log_a: torch.Tensor, states: torch.Tensor,
                 s0: torch.Tensor, g: torch.Tensor):
    """The reverse scan: (dlog_a, dbx [B, S, F], ds0 [B, F]) float32 for
    the ``states`` that :func:`scan_forward` returned from (log_a, ., s0)
    and their gradient ``g``.  The plain loop on the CPU, the kernel on
    CUDA."""
    if log_a.device.type == "cpu":
        return ssm_scan_bwd_ref(log_a, states, s0, g)
    _check("ssm_scan_bwd", "log_a, states, g", (log_a, states, g), s0)
    la, st, s0f, gf = _f32(log_a, states, s0, g)
    nb, ns, nf = la.shape
    dla = torch.empty((nb, ns, nf), dtype=torch.float32, device=la.device)
    dbx = torch.empty_like(dla)
    if dla.numel() == 0:
        return dla, dbx, torch.zeros_like(s0f)
    ds0 = torch.empty_like(s0f)
    stream = torch.cuda.current_stream(la.device).cuda_stream
    launch = bind("ssm_scan_bwd_launch", frozenset({4, 5, 6}), 11)
    check(launch(la.data_ptr(), st.data_ptr(), s0f.data_ptr(), gf.data_ptr(),
                 nb, ns, nf, dla.data_ptr(), dbx.data_ptr(), ds0.data_ptr(),
                 stream), "ssm_scan_bwd")
    ssm_scan_bwd.launches += 1
    return dla, dbx, ds0


class SSMScan(torch.autograd.Function):
    """``ssm_scan`` with its adjoint: the forward saves log_a, the states
    it returns and s0; the backward runs the reverse scan on them."""

    @staticmethod
    def forward(ctx, log_a, bx, s0):
        out = scan_forward(log_a, bx, s0)
        ctx.save_for_backward(log_a, out, s0)
        ctx.dtypes = (log_a.dtype, bx.dtype, s0.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        log_a, out, s0 = ctx.saved_tensors
        grads = ssm_scan_bwd(log_a, out, s0, g)
        return tuple(d.to(dt) for d, dt in zip(grads, ctx.dtypes))


def ssm_scan(log_a: torch.Tensor, bx: torch.Tensor,
             s0: torch.Tensor) -> torch.Tensor:
    """log_a/bx: [B, S, F]; s0: [B, F] -> all states [B, S, F] float32,
    differentiable in all three inputs."""
    return SSMScan.apply(log_a, bx, s0)


ssm_scan.launches = 0
ssm_scan_bwd.launches = 0
