"""Sorted-segment sum: the plain PyTorch version and the CUDA kernel's wrapper.

``banded_segsum(values [N, Q], seg_ids [N], num_segments) -> [S, Q] f32``
sums the rows of ``values`` that share a (sorted) segment id and drops ids
``>= num_segments``.  It is the composite wave step's two degree
reductions (``core/wave.py::wave_degrees_from_ea``).  On a CPU tensor it
runs :func:`banded_segsum_ref`; on a CUDA tensor it launches the kernel in
``csrc/segdeg.cu`` or raises — there is no band cap and no fallback.  On a
``meta`` tensor (a dry run) it computes nothing and returns the output's
shape, charging the dry run's cost counter the kernel's bytes.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._build import bind, check
from repro_torch.launch.op_cost import charge_kernel, tensor_bytes

MAX_COLUMNS = 1024            # Q above this needs > 48 KB of shared memory
_TILE_VALUES = 4096           # values one block stages (tile rows x Q)
_tickets: dict = {}           # (device, stream) -> zeroed ticket counter


def segment_offsets(seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """CSR form of a sorted, non-negative int32 segment-id tensor, on its
    device: [num_segments + 1] int32 where segment s owns rows ``[off[s],
    off[s + 1])``.  Ids >= ``num_segments`` sort past ``off[S]``.  Raises
    on ids out of order or below 0 (one host read)."""
    bad = torch.stack([(seg_ids[1:] < seg_ids[:-1]).any(),
                       (seg_ids[:1] < 0).any()]).tolist()
    if any(bad):
        raise ValueError("segment ids must be sorted ascending and >= 0"
                         + (" (they are not sorted)" if bad[0] else
                            " (an id is negative)"))
    idx = torch.arange(int(num_segments) + 1, dtype=torch.int32,
                       device=seg_ids.device)
    return torch.searchsorted(seg_ids, idx, out_int32=True)


def banded_segsum_ref(values: torch.Tensor, seg_ids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """Plain version: ``index_add_`` into one extra trash segment that takes
    every id ``>= num_segments``.  Returns [num_segments, Q] float32."""
    vals = values.to(torch.float32)
    out = torch.zeros((num_segments + 1,) + tuple(vals.shape[1:]),
                      dtype=torch.float32, device=vals.device)
    out.index_add_(0, seg_ids.clamp(max=num_segments), vals)
    return out[:num_segments]


def _ticket(device, stream: int) -> torch.Tensor:
    """The kernel's ticket counter for launches on one stream: they run one
    after another, and the last block of each resets it to 0."""
    t = _tickets.get((device, stream))
    if t is None:
        t = _tickets[(device, stream)] = torch.zeros(1, dtype=torch.int32,
                                                     device=device)
    return t


def banded_segsum(values: torch.Tensor, seg_ids: torch.Tensor,
                  num_segments: int, *,
                  offsets: torch.Tensor = None) -> torch.Tensor:
    """values: [N, Q] float; seg_ids: [N] int32 sorted ascending.  Returns
    [num_segments, Q] float32 with out[s, q] = sum of values[i, q] over
    seg_ids[i] == s.  On CUDA, ``offsets`` is ``segment_offsets(seg_ids,
    num_segments)`` when the caller holds it (computed, and the ids
    checked, here otherwise).  The kernel writes no row outside ``out``
    whatever ``offsets`` says."""
    if values.device.type == "cpu":
        return banded_segsum_ref(values, seg_ids, num_segments)
    if values.device.type == "meta":
        # the ids cannot be read here, so every row is charged as one the
        # kernel reads (an id below S), with the float32 values, the ids,
        # the [S + 1] offsets and the output
        out = torch.empty((int(num_segments),) + tuple(values.shape[1:]),
                          dtype=torch.float32, device="meta")
        charge_kernel("segdeg", 4 * values.numel() + tensor_bytes(seg_ids)
                      + 4 * (int(num_segments) + 1) + tensor_bytes(out))
        return out
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
    n, q = values.shape
    s = int(num_segments)
    if q > MAX_COLUMNS:
        raise ValueError(f"banded_segsum: Q = {q} columns; the kernel takes "
                         f"at most {MAX_COLUMNS}")
    out = torch.empty((s, q), dtype=torch.float32, device=values.device)
    if out.numel() == 0:
        return out
    tile = max(1, min(1024, _TILE_VALUES // q))     # rows one block takes
    vals = values.to(torch.float32).contiguous()
    seg = seg_ids.contiguous()
    if offsets is None:
        offsets = segment_offsets(seg, s)
    elif offsets.shape != (s + 1,) or offsets.dtype != torch.int32 or \
            offsets.device != vals.device:
        raise ValueError(f"banded_segsum: offsets must be [{s + 1}] int32 "
                         "on the values' device")
    part = torch.empty((max(1, -(-n // tile)), 2, q), dtype=torch.float64,
                       device=vals.device)
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    check(bind("segdeg_launch", frozenset({3, 4, 5, 6}), 11)(
        vals.data_ptr(), seg.data_ptr(), offsets.contiguous().data_ptr(), n,
        q, s, tile, out.data_ptr(), part.data_ptr(),
        _ticket(vals.device, stream).data_ptr(), stream), "segdeg")
    banded_segsum.launches += 1
    return out


banded_segsum.launches = 0


def make_banded_segsum(num_segments: int, seg_ids: torch.Tensor = None):
    """Segment-sum closure ``fn(values, ids)`` for one segment count.  It
    dispatches on the values' device at call time: the kernel on CUDA,
    the plain version on the CPU.  Given the id tensor the closure will be
    called with (a TEL's ``pair_id`` or ``hp_src``), it checks that
    tensor and takes its segment offsets once, here, and raises if it is
    called with any other id tensor; without it, every call takes them."""
    s = int(num_segments)
    offsets = None
    if seg_ids is not None and seg_ids.device.type == "cuda":
        offsets = segment_offsets(seg_ids, s)

    def fn(values, ids):
        if seg_ids is not None and ids is not seg_ids:
            raise ValueError("segment-sum closure: built for one id tensor, "
                             "called with another")
        return banded_segsum(values, ids, s, offsets=offsets)

    return fn
