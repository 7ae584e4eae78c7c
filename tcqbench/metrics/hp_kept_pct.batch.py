"""Share of the half-pair table walked by the global-memory tier's phase A
that some lane kept: the program's counters ``wave.hp_kept`` over
``wave.hp_scanned`` (each retired step: its lanes times the TEL's
half-pairs), summed over the trace's window, in %.  It is the share of
that pass that does work.  None without the program's counters (a program
that has none), or where nothing was scanned (no step of the window took
the global tier)."""


def read(rec):
    try:
        from repro_torch.core import trace
    except ImportError:
        return None
    counters = getattr(trace, "counters", None)
    if counters is None or not rec.get("trace"):
        return None
    c = counters()
    scanned = c.get("wave.hp_scanned", 0)
    if not scanned:
        return None
    return 100.0 * c.get("wave.hp_kept", 0) / scanned
