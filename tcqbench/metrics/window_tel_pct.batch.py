"""Share of the window in which the engine built union-window TELs: the
program's ``engine.window_tel`` spans (``TCQEngine._window_tel`` on an LRU
miss: the slice, the upload, the segment sums, the step build), summed
over the trace's window.  None without the program's recorder, without
such a span, or when the recorder dropped spans past its cap."""


def read(rec):
    try:
        from repro_torch.core import trace
    except ImportError:
        return None
    tr = rec.get("trace")
    d = [s.end - s.start for s in trace.spans()
         if s.name == "engine.window_tel" and s.end is not None]
    if trace.dropped() or not d or not tr:
        return None
    return 100.0 * sum(d) / tr["window_s"]
