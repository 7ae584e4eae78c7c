"""Fused wave step: the CUDA kernel's wrapper, its band tables and its cost.

``make_fused_wave_step`` builds the band tables of one TEL once (on the
TEL's device, from the canonical sort) and returns ``step(alive, ts, te,
k, h) -> StepResult``, bit-identical to the composite lowering.  On a CUDA
TEL every call is one launch of ``csrc/wave_peel.cu``; on a CPU TEL the
step is the plain version, ``core.wave.make_composite_step`` over the plain
segment sum.  Any other device, or a TEL the kernel cannot take, raises:
unlike the JAX package, there is no size budget and no fallback.
"""

from __future__ import annotations

import torch

from repro_torch.core.graph import DeviceTEL
from repro_torch.core.wave import StepResult, lanes, make_composite_step
from repro_torch.kernels._build import bind, check

_INT_ARGS = frozenset({7, 11, 14, 18, 23})


def segment_bounds(seg_ids: torch.Tensor, num_segments: int):
    """Band table of a *sorted* int32 segment-id tensor, on its device:
    segment s owns exactly rows ``[starts[s], ends[s])``.  Sentinel ids
    >= ``num_segments`` sort past every real segment and fall outside
    every range."""
    idx = torch.arange(int(num_segments), dtype=torch.int32,
                       device=seg_ids.device)
    starts = torch.searchsorted(seg_ids, idx, out_int32=True)
    ends = torch.searchsorted(seg_ids, idx, right=True, out_int32=True)
    return starts, ends


def fused_step_cost(num_edges: int, num_pairs: int, num_halfpairs: int,
                    num_vertices: int, lane_iters) -> dict:
    """Least work of one fused step, the roofline's numerator.

    ``bytes``: every input read once (the TEL's t/src/dst, hp_pair, the
    four band tables, the per-lane scalars, the alive mask) and every
    output written once (alive, packed words, lo/hi/ne/iters).
    ``ops``: one integer compare or add per table element an iteration
    visits — each lane's fixpoint iterations (``lane_iters``, per lane,
    data dependent) times E + P + 2P + V — plus the final edge and pack
    passes.
    """
    e, p, hp, v = (int(num_edges), int(num_pairs), int(num_halfpairs),
                   int(num_vertices))
    its = [int(i) for i in lane_iters]
    w = len(its)
    words = -(-max(v, 1) // 32)
    bytes_in = 4 * (3 * e + hp + 2 * p + 2 * v) + 4 * 4 * w + w * v
    bytes_out = w * v + 4 * w * words + 4 * 4 * w
    ops = sum(its) * (e + p + hp + v) + w * (e + v)
    return {"bytes": bytes_in + bytes_out, "ops": ops}


def _launcher():
    return bind("wave_peel_launch", _INT_ARGS, 25)


def wave_peel(tel: DeviceTEL, bands, alive: torch.Tensor, ts, te, k, h):
    """One launch over a CUDA TEL: peels ``alive`` [W, V] bool in place.

    ``bands`` is ``(ps, pe, vs, ve)`` from :func:`segment_bounds`;
    ts/te/k/h are [W] int32.  Returns (packed [W, ceil(V/32)] int32,
    lo, hi, n_edges, iters), each [W] int32 — iters per lane.
    """
    ps, pe, vs, ve = bands
    w, v = alive.shape
    dev = alive.device
    packed = torch.empty((w, -(-max(v, 1) // 32)), dtype=torch.int32,
                         device=dev)
    lo, hi, ne, iters = torch.empty((4, w), dtype=torch.int32, device=dev)
    pairact = torch.empty((w, ps.shape[0]), dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    check(_launcher()(
        ts.data_ptr(), te.data_ptr(), k.data_ptr(), h.data_ptr(),
        tel.t.data_ptr(), tel.src.data_ptr(), tel.dst.data_ptr(),
        tel.t.shape[0], tel.hp_pair.data_ptr(), ps.data_ptr(),
        pe.data_ptr(), ps.shape[0], vs.data_ptr(), ve.data_ptr(), v,
        alive.data_ptr(), pairact.data_ptr(), packed.data_ptr(),
        packed.shape[1], lo.data_ptr(), hi.data_ptr(), ne.data_ptr(),
        iters.data_ptr(), w, stream), "wave_peel")
    wave_peel.launches += 1
    return packed, lo, hi, ne, iters


wave_peel.launches = 0


def _check_tel(tel: DeviceTEL, num_vertices: int) -> None:
    """Reject a TEL the kernel would read out of bounds or peel wrongly:
    unsorted segment ids, endpoints >= V or pair references >= P."""
    for name in DeviceTEL._fields:
        a = getattr(tel, name)
        if a.dtype != torch.int32 or a.dim() != 1 or not a.is_contiguous() \
                or a.device != tel.t.device:
            raise ValueError(f"wave_peel: TEL field {name} must be a "
                             "contiguous 1-D int32 tensor on one device")
    p = tel.num_pairs
    bad = torch.stack([
        (tel.pair_id[1:] < tel.pair_id[:-1]).any(),
        (tel.hp_src[1:] < tel.hp_src[:-1]).any(),
        (tel.src >= num_vertices).any() | (tel.dst >= num_vertices).any(),
        (tel.hp_pair >= p).any(),
    ]).tolist()
    if any(bad):
        raise ValueError("wave_peel: TEL is not in canonical layout "
                         f"(unsorted pair_id/hp_src, endpoint >= V or "
                         f"hp_pair >= P: {bad})")


def make_fused_wave_step(tel: DeviceTEL, num_vertices: int, *,
                         donate: bool = False):
    """Build the fused step for one (capacity-shaped) DeviceTEL.

    Returns ``step(alive [W, V] bool, ts, te, k, h) -> StepResult``.
    ``donate=True`` peels ``alive`` in place and returns it as
    ``StepResult.alive``; otherwise the kernel peels a copy.
    """
    dev = tel.t.device
    if dev.type == "cpu":
        return make_composite_step(tel, num_vertices, donate=donate)
    if dev.type != "cuda":
        raise ValueError(f"wave_peel: unsupported device {dev}")
    v = int(num_vertices)
    _check_tel(tel, v)
    bands = (*segment_bounds(tel.pair_id, tel.num_pairs),
             *segment_bounds(tel.hp_src, v))

    def step(alive, ts, te, k, h):
        if alive.device != dev or alive.dtype != torch.bool or \
                alive.dim() != 2 or alive.shape[1] != v or \
                alive.shape[0] == 0 or (donate and not alive.is_contiguous()):
            raise ValueError(
                f"wave_peel: alive must be a [W>0, {v}] bool tensor on "
                f"{dev} (contiguous when donated), got "
                f"{tuple(alive.shape)} {alive.dtype} on {alive.device}")
        w = alive.shape[0]
        out = alive if donate else \
            alive.clone(memory_format=torch.contiguous_format)
        packed, lo, hi, ne, iters = wave_peel(
            tel, bands, out, lanes(ts, w, dev), lanes(te, w, dev),
            lanes(k, w, dev), lanes(h, w, dev))
        return StepResult(out, packed, lo, hi, ne, iters.max())

    step.backend = "cuda"
    step.bands = bands
    return step
