"""Seeded fault injection for the TCQ serving stack (chaos harness;
PyTorch port of ``repro.core.faultinject``).

Faults are injected at the *wave-step seam*: every rung of the
degradation ladder (:class:`repro_torch.core.wave.DegradationLadder`) —
``"fused"`` (the wave_peel kernel), ``"composite"`` (torch gathers plus
the segdeg kernel), ``"oracle"`` (the numpy step) — is a step closure
with the same signature, and the ladder wraps each one via
``ResilienceConfig.rung_wrapper``.  :func:`rung_faults` builds such a
wrapper from per-rung :class:`FaultPlan`\\ s, so a chaos scenario is just
an engine constructed with ``resilience=ResilienceConfig(rung_wrapper=
rung_faults({"fused": FaultPlan(fail_at=(0,))}))`` — no test-only hooks
inside the engine itself.  (The JAX package names its rungs ``"pallas"``,
``"xla"`` and ``"oracle"``.)

Everything is keyed by a deterministic per-rung *call counter* (never
wall clock or RNG state shared with the engine), so a scenario replays
bit-identically: the same calls fail, stall, or corrupt on every run.

Fault classes:

* ``fail_at`` — the step raises :class:`KernelFault` (models a CUDA
  launch or runtime error, a kernel build failure, a device OOM).  On
  CPU tensors the ladder demotes to the next rung and replays the same
  inputs; on the card it logs the fault and raises it.
* ``slow_at`` — the step sleeps ``delay_s`` before running (models a
  straggler lane / a throttled device).  Results are unaffected; only
  latency moves.
* ``corrupt_at`` — the step's result comes back with the alive-mask of
  every lane flipped at ``corrupt_vertex`` (models silent data
  corruption).  The ladder's sampled oracle tripwire is the only thing
  standing between this and a wrong answer (on the card it raises
  :class:`~repro_torch.core.wave.StepDivergence`).

:func:`malformed_batches` supplies ingest batches that must be rejected
by ``TemporalGraph``'s validation (:class:`~repro_torch.core.graph.
GraphIngestError`) without perturbing the graph.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, List, Mapping, Optional, Tuple

import numpy as np


class KernelFault(RuntimeError):
    """Injected kernel failure (stands in for a CUDA launch or runtime
    error, a kernel build failure or a device OOM — what the kernel
    wrappers raise as ``RuntimeError``)."""


# ---------------------------------------------------------------- fault plan
@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Deterministic fault schedule for one ladder rung, keyed by the
    rung's 0-based call counter."""

    fail_at: Tuple[int, ...] = ()       # calls that raise KernelFault
    slow_at: Tuple[int, ...] = ()       # calls delayed by ``delay_s``
    corrupt_at: Tuple[int, ...] = ()    # calls whose alive-mask is flipped
    delay_s: float = 0.05
    corrupt_vertex: int = 0


class FaultyStep:
    """Wrap a wave step closure with a :class:`FaultPlan`.

    Transparent otherwise: attribute reads (``backend``, ``interpret``,
    ``events``) fall through to the wrapped step, so the ladder — and the
    engine's logging — see the rung they expect.
    """

    def __init__(self, fn: Callable, plan: FaultPlan):
        self._fn = fn
        self._plan = plan
        self.calls = 0

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def __call__(self, *args, **kwargs):
        i = self.calls
        self.calls += 1
        plan = self._plan
        if i in plan.fail_at:
            raise KernelFault(f"injected kernel failure (call {i})")
        if i in plan.slow_at:
            time.sleep(plan.delay_s)
        res = self._fn(*args, **kwargs)
        if i in plan.corrupt_at:
            vtx = plan.corrupt_vertex
            # flip every lane's alive bit at one vertex: guaranteed to
            # differ from truth whichever lane the tripwire samples
            alive = res.alive.clone()
            alive[:, vtx] = ~alive[:, vtx]
            res = res._replace(alive=alive)
        return res


def rung_faults(plans: Mapping[str, FaultPlan]
                ) -> Callable[[str, Callable], Callable]:
    """``ResilienceConfig.rung_wrapper`` injecting per-rung fault plans.

    ``plans`` maps rung names (``"fused"``, ``"composite"``, ``"oracle"``) to
    their schedules; unplanned rungs pass through unwrapped.  Injecting
    into ``"oracle"`` is allowed but note the ladder re-raises once its
    last rung fails.
    """
    def wrapper(name: str, fn: Callable) -> Callable:
        plan = plans.get(name)
        return fn if plan is None else FaultyStep(fn, plan)
    return wrapper


# ------------------------------------------------------- durability injectors
class InjectedCrash(BaseException):
    """A simulated process death at an exact journal point.

    Deliberately a ``BaseException``: service code that caught
    ``Exception`` to degrade gracefully would otherwise swallow the
    "kill" and keep running past the point the drill meant to stop at —
    a real ``kill -9`` is not catchable either.
    """


class CrashingWAL:
    """Wrap a :class:`~repro_torch.core.wal.WriteAheadLog` so the process
    "dies" at a chosen journal point (the kill-anywhere drill's knife).

    ``crash_after_records=n`` raises :class:`InjectedCrash` *after* the
    n-th successful append (0-based: ``0`` dies right after the first
    record lands) — the record is on disk, its acknowledgement never
    happened, exactly the torn-world a mid-operation kill leaves.
    ``crash_on_rotate=True`` dies after the rotation seals the old
    segment but *before* the caller writes its snapshot — the
    checkpoint's worst-case ordering.  ``mutilate`` (called with the
    journal directory) runs post-mortem damage — truncation, bit flips —
    before the drill hands the directory to ``recover``.

    Everything else proxies to the wrapped log, so the service under
    test is byte-for-byte the production code path.
    """

    def __init__(self, inner, *, crash_after_records: Optional[int] = None,
                 crash_on_rotate: bool = False,
                 mutilate: Optional[Callable[[str], None]] = None):
        self._inner = inner
        self._crash_after = crash_after_records
        self._crash_on_rotate = crash_on_rotate
        self._mutilate = mutilate

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def _die(self, where: str):
        if self._mutilate is not None:
            self._inner.close()
            self._mutilate(self._inner.dir)
        raise InjectedCrash(f"injected crash {where}")

    def append(self, kind, meta=None, arrays=None) -> int:
        idx = self._inner.append(kind, meta, arrays)
        if self._crash_after is not None and idx >= self._crash_after:
            self._die(f"after journal record {idx}")
        return idx

    def rotate(self) -> int:
        seq = self._inner.rotate()
        if self._crash_on_rotate:
            self._die(f"after segment rotation to {seq} (pre-snapshot)")
        return seq


def torn_tail(wal_dir: str, nbytes: int = 5) -> str:
    """Post-mortem torn write: chop ``nbytes`` off the newest journal
    segment's tail (models a partial page flush at power loss).  Returns
    the mutilated path."""
    from repro_torch.core.wal import list_segments

    seq, path = list_segments(wal_dir)[-1]
    size = max(0, os.path.getsize(path) - int(nbytes))
    with open(path, "r+b") as f:
        f.truncate(size)
    return path


def flip_tail_byte(wal_dir: str, offset_from_end: int = 3) -> str:
    """Post-mortem bit rot: XOR one byte near the newest segment's tail
    (CRC must catch it — a flipped record is corrupt, not just short)."""
    from repro_torch.core.wal import list_segments

    seq, path = list_segments(wal_dir)[-1]
    size = os.path.getsize(path)
    pos = max(0, size - int(offset_from_end))
    with open(path, "r+b") as f:
        f.seek(pos)
        b = f.read(1) or b"\0"
        f.seek(pos)
        f.write(bytes([b[0] ^ 0xFF]))
    return path


def corrupt_snapshot(wal_dir: str, offset: int = 256) -> str:
    """Post-mortem snapshot damage: XOR one byte of the *newest*
    snapshot file, so its embedded checksum fails and recovery must fall
    back to the previous retained snapshot."""
    from repro_torch.core.wal import list_snapshots

    seq, path = list_snapshots(wal_dir)[-1]
    pos = min(int(offset), os.path.getsize(path) - 1)
    with open(path, "r+b") as f:
        f.seek(pos)
        b = f.read(1)
        f.seek(pos)
        f.write(bytes([b[0] ^ 0xFF]))
    return path


# ---------------------------------------------------------- malformed ingest
def malformed_batches(seed: int = 0
                      ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Ingest batches that ``TemporalGraph.add_edges`` must reject with
    :class:`~repro_torch.core.graph.GraphIngestError` — one per validation
    class, seeded order."""
    i32 = np.iinfo(np.int32)
    batches = [
        # negative vertex id
        (np.array([-1, 2]), np.array([3, 4]), np.array([5, 6])),
        # fractional float id
        (np.array([1.5, 2.0]), np.array([3.0, 4.0]), np.array([5.0, 6.0])),
        # NaN timestamp
        (np.array([1, 2]), np.array([3, 4]), np.array([np.nan, 6.0])),
        # shape mismatch
        (np.array([1, 2, 3]), np.array([3, 4]), np.array([5, 6])),
        # id overflows the int32 pair-key packing
        (np.array([1 << 40, 2]), np.array([3, 4]), np.array([5, 6])),
        # timestamp collides with the int32-min padding sentinel
        (np.array([1, 2]), np.array([3, 4]), np.array([i32.min, 6])),
        # non-numeric dtype
        (np.array(["a", "b"]), np.array([3, 4]), np.array([5, 6])),
    ]
    rng = np.random.default_rng(seed)
    rng.shuffle(batches)
    return batches
