"""Microseconds of the scheduler's per-lane feedback a device step: the
program's ``scheduler.retire`` spans (one a retired step: pruning, dedup,
warm starts) summed, over the device steps of the window's batches
(``QueryStats.device_steps``).  None without the program's recorder,
without such a span, or when the recorder dropped spans past its cap."""


def read(rec):
    try:
        from repro_torch.core import trace
    except ImportError:
        return None
    steps = sum(b["device_steps"] for b in rec.get("batches", ()))
    d = [s.end - s.start for s in trace.spans()
         if s.name == "scheduler.retire" and s.end is not None]
    if trace.dropped() or not d or not steps:
        return None
    return 1e6 * sum(d) / steps
