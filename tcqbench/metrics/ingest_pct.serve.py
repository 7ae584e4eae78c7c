"""Share of the window in which the service ingested edges: the program's
``service.ingest`` spans (``TCQService.push_edges``: the host
merge-append, the engine's new epoch and the core cache's advance),
summed over the trace's window.  None without the program's recorder,
without such a span, or when the recorder dropped spans past its cap."""


def read(rec):
    try:
        from repro_torch.core import trace
    except ImportError:
        return None
    tr = rec.get("trace")
    d = [s.end - s.start for s in trace.spans()
         if s.name == "service.ingest" and s.end is not None]
    if trace.dropped() or not d or not tr:
        return None
    return 100.0 * sum(d) / tr["window_s"]
