"""Wave-native batched TCD: Q query cells peeled in lockstep (PyTorch port).

The data layout follows ``repro.core.wave``: segment-sum values are
[E, Q] / [2P, Q], so the two degree reductions are sorted-segment sums over
the canonical TEL order, and the whole wave shares one fixpoint loop.

The device step — :class:`StepResult` (peel + TTI + stats + 32-bit mask
pack for W lanes) — has two lowerings behind one dispatcher,
:func:`make_wave_step_fn`:

  * **fused** (``kernels/wave_peel``): one CUDA kernel launch runs the
    whole fixpoint loop of every lane;
  * **composite** (this module's ``peel_to_fixpoint`` chain): torch
    gathers plus the two segment sums, which launch the ``kernels/segdeg``
    CUDA kernel on the card and run its plain version on the CPU.

On CPU tensors both lowerings run plain PyTorch; on CUDA tensors each runs
its kernel or raises, with or without a :class:`ResilienceConfig`, which
on the card only logs the failure (:class:`DegradationLadder`).  All of
them are bit-identical to the JAX package's lowerings on every
``StepResult`` field (tests/test_torch_wave.py).

Packed mask words are int32 tensors holding the uint32 bit patterns
(torch has little uint32 arithmetic); they are viewed as ``<u4`` at the
host boundary.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.graph import DeviceTEL, TemporalGraph
from repro_torch.kernels.segdeg.ops import (banded_segsum_ref,
                                            make_banded_segsum)

_I32_MAX = int(np.iinfo(np.int32).max)
_I32_MIN = int(np.iinfo(np.int32).min)


class WaveResult(NamedTuple):
    alive: torch.Tensor    # [Q, V] bool
    tti_lo: torch.Tensor   # [Q] int32
    tti_hi: torch.Tensor   # [Q] int32
    n_edges: torch.Tensor  # [Q] int32
    n_verts: torch.Tensor  # [Q] int32
    iters: torch.Tensor    # 0-d int32: fixpoint iterations of the wave


def lanes(x, w: int, device) -> torch.Tensor:
    """A scalar or per-lane value as a contiguous [w] int32 tensor on
    ``device``."""
    x = torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x),
                        dtype=torch.int32, device=device)
    if x.dim() == 0:
        return x.expand(w).contiguous()
    if tuple(x.shape) != (w,):
        raise ValueError(f"expected a scalar or [{w}] lane vector, got "
                         f"{tuple(x.shape)}")
    return x.contiguous()


# ------------------------------------------------------- segsum closures
def make_segsum_fns(graph: TemporalGraph):
    """(edges->pairs, halfpairs->vertices) segment-sum closures for a graph:
    the segdeg kernel on CUDA values, its plain version on CPU values."""
    return (make_banded_segsum(graph.num_pairs),
            make_banded_segsum(graph.num_vertices))


def wave_edge_activity(tel: DeviceTEL, alive: torch.Tensor, ts, te
                       ) -> torch.Tensor:
    """alive: [Q, V]; ts/te: [Q].  Returns [Q, E] bool edge activity."""
    win = (tel.t[None, :] >= ts[:, None]) & (tel.t[None, :] <= te[:, None])
    return win & alive[:, tel.src] & alive[:, tel.dst]


def wave_degrees_from_ea(tel: DeviceTEL, ea: torch.Tensor, h,
                         *, num_vertices: int, seg_pair: Callable,
                         seg_vert: Callable) -> torch.Tensor:
    """ea: [Q, E] edge activity; h: scalar or per-lane [Q].
    Returns [Q, V] int32 degrees."""
    paircnt = seg_pair(ea.T.to(torch.float32), tel.pair_id)   # [P, Q]
    pairact = (paircnt >= h).to(torch.float32)   # h broadcasts over lanes
    contrib = pairact[tel.hp_pair, :]                          # [2P, Q]
    deg = seg_vert(contrib, tel.hp_src)                        # [V, Q]
    return deg.T.to(torch.int32)


def peel_to_fixpoint(tel: DeviceTEL, alive: torch.Tensor, ts, te, k, h,
                     *, num_vertices: int, seg_pair, seg_vert,
                     max_iters: int = 0):
    """Shared batched peel loop -> (alive, ea, iters).

    k and h may be scalars or per-lane [Q] vectors.  The loop mirrors the
    JAX package's ``lax.while_loop``: the body runs while any lane changed
    (one host read per iteration), and the final iteration observed
    new == cur, so its ea is exactly the fixpoint's edge activity.
    """
    q = alive.shape[0]
    dev = alive.device
    k_lane, h_lane = lanes(k, q, dev), lanes(h, q, dev)
    ts, te = lanes(ts, q, dev), lanes(te, q, dev)
    # the [Q, E] window mask depends only on (ts, te): built once
    win = (tel.t[None, :] >= ts[:, None]) & (tel.t[None, :] <= te[:, None])

    def edge_activity(cur):
        return win & cur[:, tel.src] & cur[:, tel.dst]

    cur = alive
    iters = 0
    while not max_iters or iters < max_iters:   # the body runs at least once
        ea = edge_activity(cur)
        deg = wave_degrees_from_ea(tel, ea, h_lane,
                                   num_vertices=num_vertices,
                                   seg_pair=seg_pair, seg_vert=seg_vert)
        new = cur & (deg >= k_lane[:, None])
        iters += 1
        changed = bool((new != cur).any())
        cur = new
        if not changed:
            break
    if max_iters:  # truncated peel may exit pre-fixpoint: ea would be stale
        ea = edge_activity(cur)
    return cur, ea, iters


def tti_and_count(ea: torch.Tensor, t: torch.Tensor):
    """(tti_lo, tti_hi, n_edges) over the last axis of an edge-activity
    mask: min/max t of active edges (I32_MAX/I32_MIN when none) and their
    count, all int32."""
    n_edges = ea.sum(dim=-1, dtype=torch.int32)
    if ea.shape[-1] == 0:
        shape = ea.shape[:-1]
        return (torch.full(shape, _I32_MAX, dtype=torch.int32,
                           device=ea.device),
                torch.full(shape, _I32_MIN, dtype=torch.int32,
                           device=ea.device), n_edges)
    lo = torch.where(ea, t, _I32_MAX).amin(dim=-1).to(torch.int32)
    hi = torch.where(ea, t, _I32_MIN).amax(dim=-1).to(torch.int32)
    return lo, hi, n_edges


# ------------------------------------------------------------ bitmask pack
def packed_width(num_vertices: int) -> int:
    """32-bit words per packed [V] vertex mask."""
    return max(1, -(-num_vertices // 32))


def pack_alive_u32(alive: torch.Tensor, *, num_vertices: int
                   ) -> torch.Tensor:
    """[..., V] bool -> [..., ceil(V/32)] int32 holding the uint32 words;
    vertex v = bit v%32 of word v//32 (LSB-first, matching
    np.unpackbits(bitorder="little")).  Sums of distinct powers of two
    are exact in int32 (bit 31 is int32 min)."""
    w = packed_width(num_vertices)
    bits = torch.zeros(alive.shape[:-1] + (w * 32,), dtype=torch.int32,
                       device=alive.device)
    bits[..., :num_vertices] = alive
    shift = torch.arange(32, dtype=torch.int32, device=alive.device)
    return torch.sum(bits.reshape(alive.shape[:-1] + (w, 32)) << shift,
                     dim=-1, dtype=torch.int32)


def unpack_alive_u32(packed, num_vertices: int) -> np.ndarray:
    """Host-side inverse of :func:`pack_alive_u32` — one bulk unpackbits.
    Takes int32 or uint32 words (int32 wraps to the same bit pattern)."""
    if torch.is_tensor(packed):
        packed = packed.cpu().numpy()
    packed = np.ascontiguousarray(np.asarray(packed).astype("<u4",
                                                            copy=False))
    bits = np.unpackbits(packed.view(np.uint8), axis=-1, bitorder="little")
    return bits[..., :num_vertices].astype(bool)


# ------------------------------------------------------------- the step
class StepResult(NamedTuple):
    alive: torch.Tensor    # [W, V] bool — the lane buffer, peeled in place
    packed: torch.Tensor   # [W, ceil(V/32)] int32 (uint32 bit patterns)
    tti_lo: torch.Tensor   # [W] int32 (I32_MAX when lane core is empty)
    tti_hi: torch.Tensor   # [W] int32 (I32_MIN when lane core is empty)
    n_edges: torch.Tensor  # [W] int32
    iters: torch.Tensor    # 0-d int32 — shared fixpoint iterations


def make_composite_step(tel: DeviceTEL, num_vertices: int, *,
                        seg_pair=None, seg_vert=None, donate: bool = False):
    """The composite lowering as a ``step(alive, ts, te, k, h) ->
    StepResult`` closure.  Without closures it takes the plain segment
    sum, so with none given it is the plain version of the whole step on
    any device.  ``donate=True`` peels ``alive`` in place and returns it
    as ``StepResult.alive``; otherwise ``alive`` is left untouched."""
    if seg_pair is None:
        seg_pair = functools.partial(banded_segsum_ref,
                                     num_segments=tel.num_pairs)
    if seg_vert is None:
        seg_vert = functools.partial(banded_segsum_ref,
                                     num_segments=num_vertices)

    def step(alive, ts, te, k, h):
        w, dev = alive.shape[0], alive.device
        new, ea, iters = peel_to_fixpoint(
            tel, alive, lanes(ts, w, dev), lanes(te, w, dev),
            lanes(k, w, dev), lanes(h, w, dev), num_vertices=num_vertices,
            seg_pair=seg_pair, seg_vert=seg_vert)
        tti_lo, tti_hi, n_edges = tti_and_count(ea, tel.t[None, :])
        if donate:
            new = alive.copy_(new)
        packed = pack_alive_u32(new, num_vertices=num_vertices)
        return StepResult(new, packed, tti_lo, tti_hi, n_edges,
                          torch.tensor(iters, dtype=torch.int32, device=dev))

    step.backend = "composite"
    return step


def make_oracle_step_fn(tel: DeviceTEL, num_vertices: int):
    """Serial numpy reference step over host copies of the (possibly
    capacity- or bucket-padded) TEL: no torch op touches the peel.

    The returned step counts its own calls in ``step.calls``.

    Bit-identical to the composite on every ``StepResult`` field including
    the shared iteration count: the loop runs while any lane changed, the
    segment reductions drop ``pair_id == P`` and ``hp_src == V`` like the
    device paths, and the pack is the same LSB-first layout.  Results come
    back as tensors on the TEL's device.
    """
    t = tel.t.cpu().numpy()
    src = tel.src.cpu().numpy()
    dst = tel.dst.cpu().numpy()
    pair_id = tel.pair_id.cpu().numpy().astype(np.int64)
    hp_src = tel.hp_src.cpu().numpy().astype(np.int64)
    hp_pair = tel.hp_pair.cpu().numpy().astype(np.int64)
    p_cap = int(tel.pair_u.shape[0])
    v = int(num_vertices)
    pw = packed_width(v)
    dev = tel.t.device

    def _lanes(x, w):
        if torch.is_tensor(x):
            x = x.cpu().numpy()
        return np.broadcast_to(np.asarray(x), (w,)).astype(np.int64)

    def step(alive, ts, te, k, h):
        step.calls += 1
        cur = np.array(alive.cpu().numpy() if torch.is_tensor(alive)
                       else alive, dtype=bool)
        w = cur.shape[0]
        ts_l, te_l = _lanes(ts, w), _lanes(te, w)
        k_l, h_l = _lanes(k, w), _lanes(h, w)
        win = (t[None, :] >= ts_l[:, None]) & (t[None, :] <= te_l[:, None])
        it = 0
        while True:
            ea = win & cur[:, src] & cur[:, dst]
            it += 1
            new = np.empty_like(cur)
            for li in range(w):
                paircnt = np.bincount(pair_id[ea[li]],
                                      minlength=p_cap + 1)[:p_cap]
                contrib = (paircnt >= h_l[li])[hp_pair]
                deg = np.bincount(hp_src[contrib], minlength=v + 1)[:v]
                new[li] = cur[li] & (deg >= k_l[li])
            if np.array_equal(new, cur):
                break
            cur = new
        n_edges = ea.sum(axis=1).astype(np.int32)
        tti_lo = np.full(w, _I32_MAX, np.int32)
        tti_hi = np.full(w, _I32_MIN, np.int32)
        for li in range(w):
            if n_edges[li]:
                t_act = t[ea[li]]
                tti_lo[li] = t_act.min()
                tti_hi[li] = t_act.max()
        bits = np.pad(cur, [(0, 0), (0, pw * 32 - v)])
        packed = np.packbits(bits, axis=-1, bitorder="little").view("<i4")
        out = (cur, packed, tti_lo, tti_hi, n_edges, np.int32(it))
        return StepResult(*(torch.as_tensor(np.asarray(a)).to(dev)
                            for a in out))

    step.backend = "oracle"
    step.calls = 0
    return step


# --------------------------------------------------- degradation ladder
class StepDivergence(RuntimeError):
    """The tripwire's oracle disagreed with a step on the card."""


def _demotes(tel: DeviceTEL) -> bool:
    """Whether a ladder over ``tel`` may replay a failed call on another
    rung: on CPU tensors only (on the card every failure raises)."""
    return not tel.t.is_cuda


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Knobs for the graceful-degradation ladder (pass as
    ``make_wave_step_fn(resilience=...)`` / ``TCQEngine(resilience=...)``).

    tripwire_every:
        Sample every Nth step call: recompute one random lane on the
        numpy oracle and compare bit-for-bit; a divergence quarantines
        the current rung and replays the call one rung down (on the card:
        raises :class:`StepDivergence`).  0 disables the tripwire.
    seed:
        Seeds the tripwire's lane sampling (determinism for the chaos
        harness).
    rung_wrapper:
        ``wrapper(name, step_fn) -> step_fn`` applied to each rung at
        build time — the fault-injection seam (``core/faultinject.py``).

    The JAX package's ``interpret`` and ``vmem_budget_bytes`` have no
    counterpart: the kernel has no interpret mode, and a V above its
    shared-memory limit (``wave_peel.ops.max_vertices()``) raises.
    """

    tripwire_every: int = 64
    seed: int = 0
    rung_wrapper: Optional[Callable] = None


class DegradationLadder:
    """Graceful degradation across the step lowerings: ``"fused"`` ->
    ``"composite"`` -> ``"oracle"``.

    The rungs are the JAX package's ``"pallas"`` -> ``"xla"`` ->
    ``"oracle"`` on this port's lowerings: ``"fused"`` is the wave_peel
    kernel's plain version, ``"composite"`` plain torch gathers and
    segment sums, ``"oracle"`` the serial numpy step
    (:func:`make_oracle_step_fn`).

    Built like a step_fn, called like a step_fn.  Every rung is
    *non-donating*, so when a rung fails — a raised fault or a tripwire
    divergence — the same inputs replay on the next rung bit-identically:
    demotion is invisible in the results, it only shows up in ``events``
    and latency.  A demoted rung is quarantined for this ladder's
    lifetime (ladders are pinned per ``(epoch, Ts, Te)`` window entry, so
    a quarantine lasts the epoch).

    Demotion is for CPU tensors only.  On the card the ladder holds one
    rung, the step :func:`make_wave_step_fn` would build without it (the
    wave_peel kernel, or the composite over the segdeg kernel): a build
    failure raises, and a failed call or a tripwire divergence is logged
    in ``events`` and raised, never replayed elsewhere.
    """

    def __init__(self, tel: DeviceTEL, num_vertices: int, *,
                 seg_pair=None, seg_vert=None, use_kernel: bool = False,
                 config: Optional[ResilienceConfig] = None):
        self.config = config or ResilienceConfig()
        self.events = []            # [{rung, reason, detail, call}]
        self.calls = 0
        self.rung = 0
        self.demotes = _demotes(tel)
        self._rng = np.random.default_rng(self.config.seed)
        if seg_pair is None:
            seg_pair = make_banded_segsum(tel.num_pairs, tel.pair_id)
        if seg_vert is None:
            seg_vert = make_banded_segsum(num_vertices, tel.hp_src)
        rungs = []
        if use_kernel:
            from repro_torch.kernels.wave_peel.ops import \
                make_fused_wave_step

            rungs.append(("fused", make_fused_wave_step(
                tel, num_vertices, donate=False)))
        if self.demotes or not use_kernel:
            rungs.append(("composite", make_composite_step(
                tel, num_vertices, seg_pair=seg_pair, seg_vert=seg_vert,
                donate=False)))
        self._truth = make_oracle_step_fn(tel, num_vertices)  # unwrapped
        if self.demotes:
            rungs.append(("oracle", self._truth))
        wrap = self.config.rung_wrapper
        if wrap is not None:
            rungs = [(name, wrap(name, fn) or fn) for name, fn in rungs]
        self.rungs = rungs

    def _log(self, rung: str, reason: str, detail: str = "") -> None:
        self.events.append({"rung": rung, "reason": reason,
                            "detail": detail, "call": self.calls})

    @property
    def backend(self) -> str:
        return self.rungs[self.rung][0]

    @property
    def oracle_calls(self) -> int:
        """Oracle steps run, as a rung or for the tripwire."""
        return self._truth.calls

    @staticmethod
    def _lane_slice(x, lane: int, w: int) -> np.ndarray:
        if torch.is_tensor(x):
            x = x.cpu().numpy()
        return np.broadcast_to(np.asarray(x), (w,))[lane:lane + 1]

    def _lane_check(self, res: StepResult, alive, ts, te, k, h) -> bool:
        """Sampled cross-check: one random lane recomputed on the oracle
        and compared exactly on alive, packed, tti_lo/tti_hi and n_edges
        (lanes are independent, so a single-lane oracle run must match
        that lane of the wave — except the shared iteration count, a max
        over lanes)."""
        w = int(res.alive.shape[0])
        lane = int(self._rng.integers(w))
        truth = self._truth(
            alive[lane:lane + 1],
            self._lane_slice(ts, lane, w), self._lane_slice(te, lane, w),
            self._lane_slice(k, lane, w), self._lane_slice(h, lane, w))
        got = (res.alive[lane], res.packed[lane], res.tti_lo[lane],
               res.tti_hi[lane], res.n_edges[lane])
        want = (truth.alive[0], truth.packed[0], truth.tti_lo[0],
                truth.tti_hi[0], truth.n_edges[0])
        return all(np.array_equal(g.cpu().numpy(), x.cpu().numpy())
                   for g, x in zip(got, want))

    def __call__(self, alive, ts, te, k, h) -> StepResult:
        self.calls += 1
        every = self.config.tripwire_every
        check = bool(every) and self.calls % every == 0
        while True:
            name, fn = self.rungs[self.rung]
            last = self.rung == len(self.rungs) - 1
            try:
                res = fn(alive, ts, te, k, h)
            except Exception as e:
                if not self.demotes:            # the card: log and raise
                    self._log(name, "error", repr(e))
                    raise
                if last:
                    raise
                self._log(name, "error", repr(e))
                self.rung += 1
                continue            # replay the same cells one rung down
            if check and name != "oracle" and not self._lane_check(
                    res, alive, ts, te, k, h):
                self._log(name, "divergence", f"call {self.calls}")
                if not self.demotes:
                    raise StepDivergence(
                        f"{name} step diverged from the oracle at call "
                        f"{self.calls}")
                self.rung += 1
                continue            # quarantine + bit-identical replay
            return res


def make_wave_step_fn(tel: DeviceTEL, num_vertices: int, *,
                      seg_pair=None, seg_vert=None,
                      use_kernel=None, donate: bool = False,
                      resilience: Optional[ResilienceConfig] = None):
    """Build the device step for one TEL: ``step(alive, ts, te, k, h) ->
    StepResult`` with a ``.backend`` attribute.

    use_kernel=True takes the fused wave-peel kernel, False the composite
    lowering over ``seg_pair``/``seg_vert`` (by default the segdeg
    closures: the kernel on CUDA, never the plain segment sum there);
    None picks the fused kernel for a TEL on CUDA and the composite on the
    CPU.  On CPU tensors either choice runs plain PyTorch.  There is no
    shape fallback: a shape the kernel cannot take raises.
    ``donate=True`` peels the caller's ``alive`` buffer in place (the
    pipeline's persistent lane slab); leave it False when the caller
    reuses its buffer.

    With ``resilience`` set, the returned step is a
    :class:`DegradationLadder`: on CPU tensors it demotes across the
    lowerings (fused -> composite -> numpy oracle) on raised errors or a
    sampled divergence tripwire, logs each demotion, and replays the
    failed call on the next rung bit-identically; on the card it runs the
    same single step as without it, adds the tripwire, and logs then
    raises every failure.  Ladder rungs never donate (``donate`` is
    ignored): a replay and the tripwire need their inputs intact.
    """
    if use_kernel is None:
        use_kernel = tel.t.is_cuda
    if resilience is not None:
        return DegradationLadder(tel, num_vertices, seg_pair=seg_pair,
                                 seg_vert=seg_vert,
                                 use_kernel=bool(use_kernel),
                                 config=resilience)
    if use_kernel:
        from repro_torch.kernels.wave_peel.ops import make_fused_wave_step

        return make_fused_wave_step(tel, num_vertices, donate=donate)
    if seg_pair is None:
        seg_pair = make_banded_segsum(tel.num_pairs, tel.pair_id)
    if seg_vert is None:
        seg_vert = make_banded_segsum(num_vertices, tel.hp_src)
    return make_composite_step(tel, num_vertices, seg_pair=seg_pair,
                               seg_vert=seg_vert, donate=donate)


def tcd_wave(tel: DeviceTEL, alive: torch.Tensor, ts, te, k, h,
             *, num_vertices: int, seg_pair=None, seg_vert=None,
             max_iters: int = 0, step_fn=None) -> WaveResult:
    """Batched TCD to the fixpoint.  alive: [Q, V] warm-start supersets;
    k/h: scalars or per-lane [Q] vectors (mixed-threshold waves).

    Pass ``step_fn`` (from :func:`make_wave_step_fn`) to route through a
    prebuilt device step; otherwise the composite runs against
    ``seg_pair``/``seg_vert`` (by default the segdeg closures).
    """
    if step_fn is not None:
        if max_iters:
            raise ValueError(
                "step_fn peels to the fixpoint; max_iters is only "
                "supported on the composite path")
        r = step_fn(alive, ts, te, k, h)
        n_verts = r.alive.sum(dim=1, dtype=torch.int32)
        return WaveResult(r.alive, r.tti_lo, r.tti_hi, r.n_edges,
                          n_verts, r.iters)
    if seg_pair is None:
        seg_pair = make_banded_segsum(tel.num_pairs, tel.pair_id)
    if seg_vert is None:
        seg_vert = make_banded_segsum(num_vertices, tel.hp_src)
    q, dev = alive.shape[0], alive.device
    alive, ea, iters = peel_to_fixpoint(
        tel, alive, lanes(ts, q, dev), lanes(te, q, dev), k, h,
        num_vertices=num_vertices, seg_pair=seg_pair, seg_vert=seg_vert,
        max_iters=max_iters)
    tti_lo, tti_hi, n_edges = tti_and_count(ea, tel.t[None, :])
    n_verts = alive.sum(dim=1, dtype=torch.int32)
    return WaveResult(alive, tti_lo, tti_hi, n_edges, n_verts,
                      torch.tensor(iters, dtype=torch.int32, device=dev))
