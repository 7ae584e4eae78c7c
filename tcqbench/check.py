"""The comparison that decides ``correct``: the program's distinct cores of
a query against the reference's, core by core (TTI, vertex set, edge
count).  Every limit is 0: the answers are exact."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

Cores = Dict[Tuple[int, int], Tuple[np.ndarray, int]]


def program_cores(result) -> Cores:
    """{TTI: (vertices, edges)} of a program ``TCQResult``."""
    return {tuple(int(x) for x in c.tti):
            (np.asarray(c.vertices, np.int64), int(c.n_edges))
            for c in result.cores}


def differing(got: Cores, want: Cores) -> int:
    """Cores missing from ``got``, extra in it, or at a TTI of ``want``
    with another vertex set or edge count."""
    bad = len(got.keys() ^ want.keys())
    for key in got.keys() & want.keys():
        gv, ge = got[key]
        wv, we = want[key]
        if ge != we or not np.array_equal(gv, wv):
            bad += 1
    return bad


def verdict(checks: Dict[str, dict]) -> bool:
    """True iff every number is within its limit: at most ``limit``, or
    at least ``at_least``."""
    ok = True
    for c in checks.values():
        if "limit" in c:
            ok &= c["value"] <= c["limit"]
        if "at_least" in c:
            ok &= c["value"] >= c["at_least"]
    return bool(ok)


def lines(checks: Dict[str, dict]) -> List[str]:
    out = []
    for name, c in checks.items():
        if "limit" in c:
            out.append(f"check {name} {c['value']} limit {c['limit']}")
        else:
            out.append(f"check {name} {c['value']} at_least {c['at_least']}")
    return out
