"""Fused wave steps: the CUDA kernels' wrappers, their band tables and cost.

Two kernel tiers compute the same step, bit-identical to the composite
lowering.  ``make_fused_wave_step`` (``csrc/wave_peel.cu``) holds each
lane's state in a thread-block cluster's shared memory;
``make_global_wave_step`` (``csrc/wave_peel_global.cu``) holds it in
global memory, for TELs whose V does not fit there.  Each checks one TEL,
builds its band tables once (on the TEL's device, from the canonical sort)
and returns ``step(alive, ts, te, k, h) -> StepResult``.  On a CUDA TEL
every call is one launch; on a CPU TEL the step is the plain version,
``core.wave.make_composite_step`` over the plain segment sum.  On a
``meta`` TEL (a dry run) a call computes nothing and returns the outputs'
shapes, charging the dry run's cost counter the dense count's bytes
(``fused_step_cost``).  Any other device, or a TEL the kernels cannot
take, raises.

The shared-memory kernel's one size limit: V <= 370,688 vertices on an
H100 (:func:`max_vertices` from the built library,
:func:`mirror_max_vertices` where none is loaded).  The capacity rule is
applied once per window TEL, when its step is built, and depends only on
V and the device.  :func:`kernel_tier` is the single-device dispatchers'
(``core.wave.make_wave_step_fn``, its ladder): a step asked for with
``use_kernel=None`` on CUDA or ``meta`` is the shared-memory kernel where
the TEL's V :func:`fits`, else the global-memory tier; ``use_kernel=True``
takes whichever tier fits V; ``use_kernel=False``, and ``None`` on the
CPU, the composite.  The mesh's dispatchers
(``core.distributed.make_sharded_kernel_step`` and its ladder) have no
global tier: :func:`wants_kernel` and :func:`declined` give them the
shared-memory kernel where V fits and the composite over segdeg above it,
as the JAX package leaves its Pallas step for the composite above its
VMEM budget; there ``use_kernel=True`` raises above the limit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.graph import DeviceTEL
from repro_torch.core.wave import StepResult, lanes, make_composite_step
from repro_torch.kernels._build import bind, check
from repro_torch.kernels.segdeg.ops import segment_offsets
from repro_torch.launch.op_cost import charge_kernel

_INT_ARGS = frozenset({7, 11, 15, 16, 17, 20, 22, 27})
_I32_MIN = int(np.iinfo(np.int32).min)
_I32_MAX = int(np.iinfo(np.int32).max)


class Bands(NamedTuple):
    """What the kernel reads of a TEL beside its arrays, built once."""
    poff: torch.Tensor   # [P + 1] int32: first edge of each pair band
    hoff: torch.Tensor   # [V + 1] int32: first half-pair of each vertex
    orphan_lo: int       # min / max t of the edges outside every band
    orphan_hi: int       # (INT_MAX / INT_MIN when there are none)
    halfpairs: int = 0   # hoff[V]: the half-pairs of real vertices


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


# ``wave_peel_max_vertices``' arithmetic, for where no library is loaded (a
# ``meta`` TEL models an H100): each of a lane's 8 cluster blocks holds the
# lane's mask and its slice's degree counters, 5 bytes a vertex slot, in
# the shared memory a block may opt in to less the kernel's static shared
# memory (``ptxas -v``), whole 32-vertex mask words a block.
CLUSTER_BLOCKS = 8
H100_SMEM_OPTIN = 232_448       # cudaDevAttrMaxSharedMemoryPerBlockOptin
KERNEL_STATIC_SMEM = 656        # wave_peel_kernel's static shared bytes


def mirror_max_vertices() -> int:
    """:func:`max_vertices` on an H100, computed without the library."""
    room = H100_SMEM_OPTIN - KERNEL_STATIC_SMEM
    return room // 5 // 32 * 32 * CLUSTER_BLOCKS


def vertex_limit(device) -> Optional[int]:
    """Largest V the fused step takes on ``device``: the built library's on
    CUDA, the mirror on ``meta``; None (no limit) elsewhere, where the
    step is the plain version."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return max_vertices()
    if dev.type == "meta":
        return mirror_max_vertices()
    return None


def fits(num_vertices: int, device) -> bool:
    """The capacity rule: whether the fused step takes a TEL of
    ``num_vertices`` vertices on ``device``."""
    limit = vertex_limit(device)
    return limit is None or int(num_vertices) <= limit


def kernel_tier(use_kernel: Optional[bool], num_vertices: int,
                device) -> Optional[str]:
    """The single-device step asked for with ``use_kernel``: ``"fused"``
    (the shared-memory kernel) where the TEL :func:`fits`, else
    ``"fused_global"`` (the global-memory tier), for True and for None on
    CUDA and ``meta``; None (the composite) for False and for None on any
    other device."""
    dev = torch.device(device)
    if use_kernel is not None and not use_kernel:
        return None
    if use_kernel is None and dev.type not in ("cuda", "meta"):
        return None
    return "fused" if fits(num_vertices, dev) else "fused_global"


def wants_kernel(use_kernel: Optional[bool], num_vertices: int,
                 device) -> bool:
    """Whether a mesh's step asked for with ``use_kernel`` is the
    shared-memory kernel: True and False as given, None the kernel on CUDA
    and ``meta`` where the TEL :func:`fits`, else the composite."""
    if use_kernel is not None:
        return bool(use_kernel)
    dev = torch.device(device)
    return dev.type in ("cuda", "meta") and fits(num_vertices, dev)


def declined(use_kernel: Optional[bool], num_vertices: int,
             device) -> Optional[str]:
    """Why the mesh's capacity rule turned an automatic request
    (``use_kernel=None``) on CUDA or ``meta`` away from the shared-memory
    kernel, as a mesh ladder's ``smem_limit`` event says it; None when it
    did not."""
    dev = torch.device(device)
    if use_kernel is not None or dev.type not in ("cuda", "meta") or \
            fits(num_vertices, dev):
        return None
    return (f"V={int(num_vertices)} > {vertex_limit(dev)}: the fused "
            "kernel's shared memory; the composite over segdeg peels it")


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
    if dev.type == "meta":
        # the windows and the band tables cannot be read here: the dense
        # count's bytes, which depend on the shapes alone
        charge_kernel("wave_peel", fused_step_cost(
            tel.t.shape[0], tel.num_pairs, tel.hp_src.shape[0], v,
            [0] * w)["bytes"])
        return packed, lo, hi, ne, iters
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

_GLOBAL_INT_ARGS = frozenset({7, 11, 15, 16, 17, 20, 25, 31})


def wave_peel_global(tel: DeviceTEL, bands: Bands, alive: torch.Tensor, ts,
                     te, k, h):
    """One cooperative launch over a CUDA TEL of any V (the global-memory
    tier): peels ``alive`` [W, V] bool in place.

    Takes what :func:`wave_peel` does and returns its outputs and one
    more, kept [W] int32: the half-pairs phase A kept for each lane of the
    ``bands.halfpairs`` it walked; every lane's iters is the lanes' shared
    count.  Its scratch (kept half-pairs, touched words, two degree
    buffers) is allocated here for each call, so the caching allocator
    reuses it.
    """
    w, v = alive.shape
    dev = alive.device
    words = -(-max(v, 1) // 32)
    packed = torch.empty((w, words), dtype=torch.int32, device=dev)
    lo, hi, ne, iters, kept = torch.empty((5, w), dtype=torch.int32,
                                          device=dev)
    if dev.type == "meta":
        charge_kernel("wave_peel_global", fused_step_cost(
            tel.t.shape[0], tel.num_pairs, tel.hp_src.shape[0], v,
            [0] * w)["bytes"])
        return packed, lo, hi, ne, iters, kept
    nhp = tel.hp_src.shape[0]
    halves = torch.empty((w, nhp, 4), dtype=torch.int32, device=dev)
    touched = torch.empty((w, words), dtype=torch.int32, device=dev)
    deg = torch.empty((2, w, v), dtype=torch.int32, device=dev)
    flags = torch.empty(2, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    check(bind("wave_peel_global_launch", _GLOBAL_INT_ARGS, 33)(
        ts.data_ptr(), te.data_ptr(), k.data_ptr(), h.data_ptr(),
        tel.t.data_ptr(), tel.src.data_ptr(), tel.dst.data_ptr(),
        tel.t.shape[0], tel.pair_u.data_ptr(), tel.pair_v.data_ptr(),
        bands.poff.data_ptr(), tel.num_pairs, tel.hp_src.data_ptr(),
        tel.hp_pair.data_ptr(), bands.hoff.data_ptr(), v, bands.orphan_lo,
        bands.orphan_hi, alive.data_ptr(), halves.data_ptr(), nhp,
        packed.data_ptr(), touched.data_ptr(), deg.data_ptr(),
        flags.data_ptr(), words, lo.data_ptr(), hi.data_ptr(), ne.data_ptr(),
        iters.data_ptr(), kept.data_ptr(), w, stream), "wave_peel_global")
    wave_peel_global.launches += 1
    return packed, lo, hi, ne, iters, kept


wave_peel_global.launches = 0


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
    """The kernel's band tables of a TEL (a host read of the tables' ends,
    one more for the orphan edges' time range)."""
    poff = segment_offsets(tel.pair_id, tel.num_pairs)
    hoff = segment_offsets(tel.hp_src, num_vertices)
    nreal, nh = torch.stack([poff[-1], hoff[-1]]).tolist()
    orphan = tel.t[nreal:]
    lo, hi = (torch.stack([orphan.min(), orphan.max()]).tolist()
              if orphan.numel() else (_I32_MAX, _I32_MIN))
    return Bands(poff, hoff, int(lo), int(hi), int(nh))


def _kernel_step(tel: DeviceTEL, num_vertices: int, launch, backend: str,
                 *, donate: bool):
    """A kernel tier's ``step(alive, ts, te, k, h) -> StepResult`` over a
    CUDA or ``meta`` TEL (checked and its bands built here), one
    ``launch`` (:func:`wave_peel` or :func:`wave_peel_global`) a call."""
    dev = tel.t.device
    v = int(num_vertices)
    bands = None                    # a meta TEL has no data to check
    if dev.type == "cuda":
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
        packed, lo, hi, ne, iters, *kept = launch(
            tel, bands, out, lanes(ts, w, dev), lanes(te, w, dev),
            lanes(k, w, dev), lanes(h, w, dev))
        if not kept:
            return StepResult(out, packed, lo, hi, ne, iters.max())
        return StepResult(out, packed, lo, hi, ne, iters.max(), kept[0],
                          bands.halfpairs if bands is not None else 0)

    step.backend = backend
    step.bands = bands
    return step


def _plain_or_device(tel: DeviceTEL, num_vertices: int, donate: bool):
    """The plain version's step on a CPU TEL, None on CUDA and ``meta``;
    raises on any other device."""
    dev = tel.t.device
    if dev.type == "cpu":
        return make_composite_step(tel, num_vertices, donate=donate)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"wave_peel: unsupported device {dev}")
    return None


def make_fused_wave_step(tel: DeviceTEL, num_vertices: int, *,
                         donate: bool = False):
    """Build the shared-memory kernel's step for one (capacity-shaped)
    DeviceTEL.

    Returns ``step(alive [W, V] bool, ts, te, k, h) -> StepResult``.
    ``donate=True`` peels ``alive`` in place and returns it as
    ``StepResult.alive``; otherwise the kernel peels a copy.  Raises for a
    V above the kernel's shared memory.
    """
    plain = _plain_or_device(tel, num_vertices, donate)
    if plain is not None:
        return plain
    dev, v = tel.t.device, int(num_vertices)
    if not fits(v, dev):
        raise ValueError(
            f"wave_peel: V = {v} vertices do not fit one block's shared "
            f"memory on this card (the kernel takes V <= "
            f"{vertex_limit(dev)})")
    return _kernel_step(tel, v, wave_peel, "fused", donate=donate)


def make_global_wave_step(tel: DeviceTEL, num_vertices: int, *,
                          donate: bool = False):
    """Build the global-memory tier's step for one DeviceTEL of any V, as
    :func:`make_fused_wave_step` builds the shared-memory kernel's."""
    plain = _plain_or_device(tel, num_vertices, donate)
    if plain is not None:
        return plain
    return _kernel_step(tel, int(num_vertices), wave_peel_global,
                        "fused_global", donate=donate)


# what :func:`kernel_tier` names -> the function that builds its step
TIERS = {"fused": make_fused_wave_step,
         "fused_global": make_global_wave_step}
