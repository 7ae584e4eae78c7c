"""Share of the window in which the service formed pools: the program's
``service.form`` spans (a pump's expiry, admission-time cache probe,
clustering and member selection), summed over the trace's window.  None
without the program's recorder, without such a span, or when the
recorder dropped spans past its cap."""


def read(rec):
    try:
        from repro_torch.core import trace
    except ImportError:
        return None
    tr = rec.get("trace")
    d = [s.end - s.start for s in trace.spans()
         if s.name == "service.form" and s.end is not None]
    if trace.dropped() or not d or not tr:
        return None
    return 100.0 * sum(d) / tr["window_s"]
