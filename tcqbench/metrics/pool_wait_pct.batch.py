"""Share of the window in which the host waited on the card: the
program's ``pool.wait`` spans (the lane pool blocked on a step's copies,
where the device set the ring's pace), summed over the trace's window.
None without the program's recorder, without such a span, or when the
recorder dropped spans past its cap."""


def read(rec):
    try:
        from repro_torch.core import trace
    except ImportError:
        return None
    tr = rec.get("trace")
    d = [s.end - s.start for s in trace.spans()
         if s.name == "pool.wait" and s.end is not None]
    if trace.dropped() or not d or not tr:
        return None
    return 100.0 * sum(d) / tr["window_s"]
