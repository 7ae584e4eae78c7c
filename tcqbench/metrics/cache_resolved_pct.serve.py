"""Share of the schedule cells the window's finished tickets needed that
the core cache answered: the service's ``cells_cached`` over its
``cells_needed`` (``TCQService.stats``, counted over the window).  None
where the service has no such counters."""


def read(rec):
    c = rec.get("serve") or {}
    if "cells_cached" not in c or not c.get("cells_needed"):
        return None
    return 100.0 * c["cells_cached"] / c["cells_needed"]
