"""Fused wave step: the CUDA kernel's wrapper, its band tables and its cost.

``make_fused_wave_step`` checks one TEL, builds its band tables once (on
the TEL's device, from the canonical sort) and returns ``step(alive, ts,
te, k, h) -> StepResult``, bit-identical to the composite lowering.  On a
CUDA TEL every call is one launch of ``csrc/wave_peel.cu``; on a CPU TEL
the step is the plain version, ``core.wave.make_composite_step`` over the
plain segment sum.  Any other device, or a TEL the kernel cannot take,
raises: unlike the JAX package, nothing falls back.  The kernel's one size
limit is shared memory: V <= 370,688 vertices on an H100
(:func:`max_vertices`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.graph import DeviceTEL
from repro_torch.core.wave import StepResult, lanes, make_composite_step
from repro_torch.kernels._build import bind, check
from repro_torch.kernels.segdeg.ops import segment_offsets

_INT_ARGS = frozenset({7, 11, 15, 16, 17, 20, 22, 27})
_I32_MIN = int(np.iinfo(np.int32).min)
_I32_MAX = int(np.iinfo(np.int32).max)


class Bands(NamedTuple):
    """What the kernel reads of a TEL beside its arrays, built once."""
    poff: torch.Tensor   # [P + 1] int32: first edge of each pair band
    hoff: torch.Tensor   # [V + 1] int32: first half-pair of each vertex
    orphan_lo: int       # min / max t of the edges outside every band
    orphan_hi: int       # (INT_MAX / INT_MIN when there are none)


def fused_step_cost(num_edges: int, num_pairs: int, num_halfpairs: int,
                    num_vertices: int, lane_iters) -> dict:
    """Least work of one fused step as the TPU kernel's dense formulation
    does it, the roofline's numerator (kept as in the first port, so times
    stay comparable; the cluster kernel reads less than this counts).

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


def canonical_step_cost(tel: DeviceTEL, bands: Bands, ts: torch.Tensor,
                        te: torch.Tensor, h: torch.Tensor, lane_iters,
                        num_vertices: int) -> dict:
    """Least work of one step of this kernel's pair-level formulation on
    this run's data, the roofline's numerator (``fused_step_cost`` is the
    dense one, kept beside it so rows compare with earlier designs).

    ``bytes``, each read or write once: the entries of hp_src, hp_pair,
    pair_u and pair_v that the real half-pairs name, poff and the last
    entry of hoff (the tables phase A walks); when some lane's window is
    not empty, t at both ends of every non-empty pair band, and for each
    lane ceil(log2(band length)) more t values in every band that
    straddles one of its window ends (the binary-search probes); t, src
    and dst of the edges outside every pair band when some lane's window
    meets their time range; the lanes' alive bytes and four scalars in;
    alive bytes, packed words and four scalars out.  The kernel's
    half-pair scratch is its own choice, not counted.
    ``ops``: per lane, one compare per half-pair (phase A), then per
    iteration one per kept half-pair and one per vertex, then one per
    kept half-pair for the outputs.
    """
    p, v, w = tel.num_pairs, int(num_vertices), int(ts.shape[0])
    its = [int(i) for i in lane_iters]
    poff = bands.poff.long()
    nreal = int(poff[-1])
    nh = int(bands.hoff[-1])
    words = -(-max(v, 1) // 32)
    bytes_ = 4 * (3 * nh + p + 1 + 1)
    bytes_ += 2 * w * v + 4 * w * words + 2 * 4 * 4 * w
    kept = [nh if int(x) <= 0 else 0 for x in h.tolist()]
    if p and nreal:
        a0, b0 = poff[:-1], poff[1:]
        length = b0 - a0
        some = length > 0
        tt = tel.t.long()
        ta = tt[a0.clamp(max=max(nreal - 1, 0))]
        tb = tt[(b0 - 1).clamp(min=0)]
        if bool((ts <= te).any()):
            bytes_ += 4 * int((some.long() + (length > 1).long()).sum())
        lo, hi = ts.long()[:, None], te.long()[:, None]
        meets = some & (ta <= hi) & (tb >= lo) & (lo <= hi)      # [W, P]
        probes = torch.ceil(torch.log2(length.clamp(min=1).double())).long()
        bytes_ += 4 * int((((meets & (ta < lo)).long()
                            + (meets & (tb > hi)).long()) * probes).sum())
        # each lane's window count of every pair, by search on (pair, t)
        key = tel.pair_id[:nreal].long() * 2 ** 33 + tt[:nreal] + 2 ** 31
        base = torch.arange(p, device=key.device)[None, :] * 2 ** 33
        wincnt = (torch.searchsorted(key, base + hi + 2 ** 31, right=True)
                  - torch.searchsorted(key, base + lo + 2 ** 31)).clamp(min=0)
        kept = torch.where(h.long() <= 0, nh,
                           2 * (wincnt > 0).sum(dim=1)).tolist()
    ops = sum(nh + i * (kh + v) + kh for i, kh in zip(its, kept))
    if bands.orphan_lo <= bands.orphan_hi and bool(
            ((ts <= te) & (ts <= bands.orphan_hi)
             & (te >= bands.orphan_lo)).any()):
        bytes_ += 12 * (tel.t.shape[0] - nreal)
    return {"bytes": bytes_, "ops": ops}


def max_vertices() -> int:
    """Largest V the kernel takes on this card (its shared memory); -1 if
    the card cannot be queried."""
    return bind("wave_peel_max_vertices", frozenset(), 0)()


def wave_peel(tel: DeviceTEL, bands: Bands, alive: torch.Tensor, ts, te, k,
              h):
    """One launch over a CUDA TEL: peels ``alive`` [W, V] bool in place.

    ``bands`` comes from :func:`make_fused_wave_step` (``step.bands``);
    ts/te/k/h are [W] int32.  Returns (packed [W, ceil(V/32)] int32, lo,
    hi, n_edges, iters), each [W] int32 — iters per lane.
    """
    w, v = alive.shape
    dev = alive.device
    packed = torch.empty((w, -(-max(v, 1) // 32)), dtype=torch.int32,
                         device=dev)
    lo, hi, ne, iters = torch.empty((4, w), dtype=torch.int32, device=dev)
    nhp = tel.hp_src.shape[0]
    halves = torch.empty((w, nhp, 4), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    check(bind("wave_peel_launch", _INT_ARGS, 29)(
        ts.data_ptr(), te.data_ptr(), k.data_ptr(), h.data_ptr(),
        tel.t.data_ptr(), tel.src.data_ptr(), tel.dst.data_ptr(),
        tel.t.shape[0], tel.pair_u.data_ptr(), tel.pair_v.data_ptr(),
        bands.poff.data_ptr(), tel.num_pairs, tel.hp_src.data_ptr(),
        tel.hp_pair.data_ptr(), bands.hoff.data_ptr(), v, bands.orphan_lo,
        bands.orphan_hi, alive.data_ptr(), halves.data_ptr(), nhp,
        packed.data_ptr(), packed.shape[1], lo.data_ptr(), hi.data_ptr(),
        ne.data_ptr(), iters.data_ptr(), w, stream), "wave_peel")
    wave_peel.launches += 1
    return packed, lo, hi, ne, iters


wave_peel.launches = 0


def _check_tel(tel: DeviceTEL, num_vertices: int) -> None:
    """Reject a TEL the kernel would read out of bounds or peel wrongly.

    The kernel counts a pair's in-window edges by binary search in its
    band and takes their endpoints from the pair table, so it needs the
    canonical layout: edges sorted by (pair_id, t); every edge of pair p
    joining pair_u[p] < pair_v[p]; half-pairs sorted by vertex, each real
    pair with exactly its two half-pairs (u, p) and (v, p) and every other
    pair (capacity padding) with none; every id in range.
    """
    for name in DeviceTEL._fields:
        a = getattr(tel, name)
        if a.dtype != torch.int32 or a.dim() != 1 or not a.is_contiguous() \
                or a.device != tel.t.device:
            raise ValueError(f"wave_peel: TEL field {name} must be a "
                             "contiguous 1-D int32 tensor on one device")
    p, v = tel.num_pairs, int(num_vertices)
    pid, t, pu, pv = tel.pair_id, tel.t, tel.pair_u, tel.pair_v
    real = pid < p                       # edges inside some pair band
    hreal = tel.hp_src < v               # half-pairs of some vertex
    if p:
        ep, hp = pid.clamp(0, p - 1).long(), tel.hp_pair.clamp(0, p - 1)
        lo_e = torch.minimum(tel.src, tel.dst)
        hi_e = torch.maximum(tel.src, tel.dst)
        edge_ok = (~real | ((lo_e == pu[ep]) & (hi_e == pv[ep]) &
                            (pu[ep] < pv[ep]))).all()
        hsrc, hp = tel.hp_src[hreal].long(), hp[hreal].long()
        is_pair = (pu < pv).long()
        count = torch.zeros(p, dtype=torch.long, device=t.device)
        total = torch.zeros(p, dtype=torch.long, device=t.device)
        count.index_add_(0, hp, torch.ones_like(hsrc))
        total.index_add_(0, hp, hsrc)
        hp_ok = (((hsrc == pu[hp]) | (hsrc == pv[hp])).all()
                 & (count == 2 * is_pair).all()
                 & (total == (pu.long() + pv.long()) * is_pair).all())
    else:
        edge_ok, hp_ok = (~real).all(), (~hreal).all()
    checks = {
        "edges sorted by (pair_id, t)": (
            (pid[1:] > pid[:-1]) | ((pid[1:] == pid[:-1]) & (t[1:] >= t[:-1]))
        ).all(),
        "pair_id >= 0": (pid >= 0).all(),
        "hp_src sorted": (tel.hp_src[1:] >= tel.hp_src[:-1]).all(),
        "src/dst in [0, V)": ((tel.src >= 0) & (tel.src < v) &
                              (tel.dst >= 0) & (tel.dst < v)).all(),
        "pair_u/pair_v in [0, V)": ((pu >= 0) & (pu < v) &
                                    (pv >= 0) & (pv < v)).all(),
        "hp_pair in [0, P)": ((tel.hp_pair >= 0) & (tel.hp_pair < p)).all(),
        "edges join pair_u < pair_v of their pair": edge_ok,
        "half-pairs are the pairs' endpoints": hp_ok,
    }
    ok = torch.stack(list(checks.values())).tolist()
    bad = [name for name, good in zip(checks, ok) if not good]
    if bad:
        raise ValueError("wave_peel: TEL is not in canonical layout: "
                         + "; ".join(bad))


def tel_bands(tel: DeviceTEL, num_vertices: int) -> Bands:
    """The kernel's band tables of a TEL (one host read for the orphan
    edges' time range)."""
    poff = segment_offsets(tel.pair_id, tel.num_pairs)
    hoff = segment_offsets(tel.hp_src, num_vertices)
    orphan = tel.t[int(poff[-1]):]
    lo, hi = (torch.stack([orphan.min(), orphan.max()]).tolist()
              if orphan.numel() else (_I32_MAX, _I32_MIN))
    return Bands(poff, hoff, int(lo), int(hi))


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
    if v > max_vertices():
        raise ValueError(
            f"wave_peel: V = {v} vertices do not fit one block's shared "
            f"memory on this card (the kernel takes V <= {max_vertices()})")
    _check_tel(tel, v)
    bands = tel_bands(tel, v)

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
