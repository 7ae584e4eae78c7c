"""Sorted-segment sum: the plain PyTorch version and the CUDA kernel's wrapper.

``banded_segsum(values [N, Q], seg_ids [N], num_segments) -> [S, Q] f32``
sums the rows of ``values`` that share a (sorted) segment id and drops ids
``>= num_segments``.  It is the composite wave step's two degree
reductions (``core/wave.py::wave_degrees_from_ea``).  On a CPU tensor it
runs :func:`banded_segsum_ref`; on a CUDA tensor it launches the kernel in
``csrc/segdeg.cu`` or raises — there is no band cap and no fallback.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels._build import bind, check


def banded_segsum_ref(values: torch.Tensor, seg_ids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """Plain version: ``index_add_`` into one extra trash segment that takes
    every id ``>= num_segments``.  Returns [num_segments, Q] float32."""
    vals = values.to(torch.float32)
    out = torch.zeros((num_segments + 1,) + tuple(vals.shape[1:]),
                      dtype=torch.float32, device=vals.device)
    out.index_add_(0, seg_ids.clamp(max=num_segments), vals)
    return out[:num_segments]


def _launcher():
    return bind("segdeg_launch", frozenset({2, 3, 4}), 7)


def banded_segsum(values: torch.Tensor, seg_ids: torch.Tensor,
                  num_segments: int) -> torch.Tensor:
    """values: [N, Q] float; seg_ids: [N] int32 sorted ascending.  Returns
    [num_segments, Q] float32 with out[s, q] = sum of values[i, q] over
    seg_ids[i] == s."""
    if values.device.type == "cpu":
        return banded_segsum_ref(values, seg_ids, num_segments)
    if values.device.type != "cuda":
        raise ValueError(f"banded_segsum: unsupported device {values.device}")
    if values.dim() != 2 or seg_ids.dim() != 1 or \
            seg_ids.shape[0] != values.shape[0]:
        raise ValueError("banded_segsum: expected values [N, Q] and "
                         f"seg_ids [N], got {tuple(values.shape)} and "
                         f"{tuple(seg_ids.shape)}")
    if seg_ids.dtype != torch.int32 or seg_ids.device != values.device:
        raise ValueError("banded_segsum: seg_ids must be int32 on the "
                         "values' device")
    vals = values.to(torch.float32).contiguous()
    seg = seg_ids.contiguous()
    n, q = vals.shape
    out = torch.empty((int(num_segments), q), dtype=torch.float32,
                      device=vals.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    check(_launcher()(vals.data_ptr(), seg.data_ptr(), n, q,
                      int(num_segments), out.data_ptr(), stream),
          "segdeg")
    banded_segsum.launches += 1
    return out


banded_segsum.launches = 0


def make_banded_segsum(num_segments: int):
    """Segment-sum closure ``fn(values, seg_ids)`` for one segment count.
    It dispatches on the values' device at call time: the kernel on CUDA,
    the plain version on the CPU.  Unlike the JAX package's, it needs no
    host-side band analysis of the ids, since the kernel has no band
    cap."""
    return functools.partial(banded_segsum, num_segments=int(num_segments))
