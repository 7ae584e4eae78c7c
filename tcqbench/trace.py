"""The benchmark's own spans and its reading of the device trace.

``Spans`` records, on the host clock, each call the benchmark makes into
the program (``query_batch``).  ``capture`` runs the
measured window under ``torch.profiler`` with CUDA activity only, and
``reduce`` turns the device activity into the busy time (the union of
the intervals of every kernel, copy and set), the operations that took
the most time and the longest idle gaps, each labelled by the span the
host was in.  A trace that saw no kernel raises ``TraceError``: the
device's share is then not measured, never 100% idle.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

SOURCE = "torch.profiler (CUPTI), CUDA activity of the measured window"


class TraceError(RuntimeError):
    """The profiler saw no kernel in the window."""


class Spans:
    def __init__(self):
        self.items: List[Tuple[str, float, float]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.items.append((name, t0, time.perf_counter()))

    def total(self, name: str) -> Tuple[int, float]:
        """(count, seconds) of the spans named ``name``."""
        d = [b - a for n, a, b in self.items if n == name]
        return len(d), sum(d)


def capture(window_fn):
    """Run ``window_fn()`` under the profiler.  Returns ``(result,
    events, t0, t1)``: its result, the device events as ``(name, start,
    end)`` in host-clock seconds, and the window's bounds.  The host and
    trace clocks are tied by a marker kernel launched after a
    synchronize at the window's start: the first device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        mark = time.perf_counter()
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = window_fn()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    evs = sorted(((e.name, e.time_range.start, e.time_range.end)
                  for e in prof.events()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: e[1])
    events = []
    if evs:
        base = evs[0][1]
        events = [(n, mark + (a - base) * 1e-6, mark + (b - base) * 1e-6)
                  for n, a, b in evs[1:]]       # the marker itself left out
    return out, events, t0, t1


def _label(spans: Sequence[Tuple[str, float, float]], t: float) -> str:
    """The innermost span holding time ``t``, or ``host``."""
    best: Optional[Tuple[str, float, float]] = None
    for s in spans:
        if s[1] <= t <= s[2] and (best is None or s[1] >= best[1]):
            best = s
    return "host" if best is None else best[0]


def reduce(events: Sequence[Tuple[str, float, float]], t0: float,
           t1: float, spans: Sequence[Tuple[str, float, float]],
           top: int = 10) -> Dict:
    """Busy and window seconds, the top device operations by time and the
    longest idle gaps, from device events on the host clock."""
    evs = [(n, max(a, t0), min(b, t1)) for n, a, b in events
           if b > t0 and a < t1]
    if not evs:
        raise TraceError("the profiler saw no kernel in the window: the "
                         "device figures are not measured")
    by_op: Dict[str, float] = {}
    for n, a, b in evs:
        by_op[n] = by_op.get(n, 0.0) + (b - a)
    busy, gaps = 0.0, []
    cur_a, cur_b = t0, t0
    for _, a, b in sorted(evs, key=lambda e: e[1]):
        if a > cur_b:
            busy += cur_b - cur_a
            gaps.append((cur_b, a))
            cur_a = a
        cur_b = max(cur_b, b)
    busy += cur_b - cur_a
    if t1 > cur_b:
        gaps.append((cur_b, t1))
    gaps.sort(key=lambda g: g[0] - g[1])
    by_label: Dict[str, float] = {}
    for a, b in gaps:
        lab = _label(spans, 0.5 * (a + b))
        by_label[lab] = by_label.get(lab, 0.0) + (b - a)
    return {
        "busy_s": busy,
        "window_s": t1 - t0,
        "events": len(evs),
        "device_ops": [[n[:160], s] for n, s in sorted(
            by_op.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[_label(spans, 0.5 * (a + b)), b - a]
                      for a, b in gaps[:top]],
        "idle_by_span": by_label,
    }
