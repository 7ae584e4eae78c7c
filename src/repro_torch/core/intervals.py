"""Tiny interval-set utility for the OTCD pruning schedule.

The OTCD schedule over a window with n distinct timestamps has n(n+1)/2
cells; materializing it is quadratic.  Instead each row keeps a merged list
of pruned column-index intervals — O(#prune triggers) memory, exactly the
cells the paper's Figure 4b shades.
"""

from __future__ import annotations

import bisect
from typing import Iterable, List, Tuple


class IntervalSet:
    """Disjoint, sorted, inclusive integer intervals with point queries."""

    def __init__(self, intervals: Iterable[Tuple[int, int]] = ()):  # noqa: D107
        ivs = sorted((int(a), int(b)) for a, b in intervals if a <= b)
        merged: List[Tuple[int, int]] = []
        for a, b in ivs:
            if merged and a <= merged[-1][1] + 1:
                pa, pb = merged[-1]
                merged[-1] = (pa, max(pb, b))
            else:
                merged.append((a, b))
        self._ivs = merged
        self._los = [a for a, _ in merged]

    def add(self, lo: int, hi: int) -> int:
        """Insert [lo, hi]; returns the number of NEWLY covered integers
        (exact per-rule pruning accounting, paper Table 4)."""
        if lo > hi:
            return 0
        ivs = self._ivs
        los = self._los
        # merge with neighbours; count already-covered integers in the
        # same bounded sweep (intervals are disjoint with gaps >= 2, so a
        # fully covered [lo, hi] lies inside one existing interval)
        start = bisect.bisect_left(los, lo)
        if start > 0 and ivs[start - 1][1] >= lo - 1:
            start -= 1
        end = start
        a, b = lo, hi
        covered = 0
        while end < len(ivs) and ivs[end][0] <= hi + 1:
            ia, ib = ivs[end]
            a2, b2 = max(ia, lo), min(ib, hi)
            if a2 <= b2:
                covered += b2 - a2 + 1
            if ia < a:
                a = ia
            if ib > b:
                b = ib
            end += 1
        new = (hi - lo + 1) - covered
        if new == 0:
            return 0
        ivs[start:end] = [(a, b)]
        los[start:end] = [a]
        return new

    def covers(self, x: int) -> bool:
        i = bisect.bisect_right(self._los, x) - 1
        return i >= 0 and self._ivs[i][0] <= x <= self._ivs[i][1]

    def highest_uncovered_leq(self, x: int):
        """Largest y <= x not covered by any interval, or None."""
        while True:
            i = bisect.bisect_right(self._los, x) - 1
            if i < 0 or x > self._ivs[i][1]:
                return x
            x = self._ivs[i][0] - 1
            if x < 0:
                return None

    def total_covered(self, lo: int, hi: int) -> int:
        """Number of covered integers within [lo, hi]."""
        if lo > hi:
            return 0
        i = bisect.bisect_left(self._los, lo)
        if i > 0 and self._ivs[i - 1][1] >= lo:
            i -= 1
        n = 0
        while i < len(self._ivs) and self._ivs[i][0] <= hi:
            a, b = self._ivs[i]
            n += min(b, hi) - max(a, lo) + 1
            i += 1
        return n

    def __repr__(self) -> str:
        return f"IntervalSet({self._ivs})"
