"""Microseconds of the lane pool's own host work a device step: the
self time of the program's ``pool.run`` spans (each one's duration less
its children's: ``pool.wait`` and ``scheduler.retire``), summed, over the
device steps of the window's batches (``QueryStats.device_steps``).  What
is left is lane assembly, parameter staging, launch, the host read of
the pinned buffers and the ring.  None without the program's recorder,
without such a span, or when the recorder dropped spans past its cap."""


def read(rec):
    try:
        from repro_torch.core import trace
    except ImportError:
        return None
    steps = sum(b["device_steps"] for b in rec.get("batches", ()))
    sp = trace.spans()
    own = {}
    for i, s in enumerate(sp):
        if s.name == "pool.run" and s.end is not None:
            own[i] = s.end - s.start
    for s in sp:
        if s.parent in own and s.end is not None:
            own[s.parent] -= s.end - s.start
    if trace.dropped() or not own or not steps:
        return None
    return 1e6 * sum(own.values()) / steps
