"""Tickets that held lanes in a pool, per pool run in the window: the
service's ``pool_members`` over its ``pools`` (``TCQService.stats``,
counted over the window).  None where the service has no such
counters."""


def read(rec):
    c = rec.get("serve") or {}
    if "pools" not in c or "pool_members" not in c or not c["pools"]:
        return None
    return c["pool_members"] / c["pools"]
