"""In-memory spans of the TCQ path, recorded while a ``torch.profiler``
session records.

A span is a named interval of host time with the index of its parent
span and a root id: every span opened under one root shares that root's
id, which ties the spans of one request together.  Start and end are
``time.perf_counter()`` readings, the clock the benchmark lays the
device trace on.  The parent stack is kept per thread, so a span opened
on another thread (the journal's writer) never nests into a query's.

The recorder is armed exactly while a profiler session records
(``torch.autograd.profiler._is_profiler_enabled``): profile a run and
read :func:`spans` afterwards.  There is no exporter, environment
variable or flag.  Spans stay in one list of at most :data:`CAP`; those
past it are counted by :func:`dropped` and not kept.

The spans of the port (parent in brackets):

* ``engine.query_batch`` — ``TCQEngine.query_batch``, the whole call
  (a root).
* ``engine.window_tel`` — ``TCQEngine._window_tel`` on an LRU miss: the
  slice, the upload, the segment sums and the step build (the caller's).
* ``pool.run`` — ``WavePipeline.run_pool``, the whole call (the
  caller's).
* ``pool.wait`` — the host blocked on a step's copies, on the card only
  (``pool.run``).
* ``scheduler.retire`` — the per-lane feedback of one retired step
  (``pool.run``).
* ``scheduler.decode`` — ``QueryState.decode_results`` (the caller's).
* ``service.pump`` — ``TCQService.pump``, the whole call (a root): the
  caller's poll, formation, the pool's ``engine.window_tel`` and
  ``pool.run``, and the finished tickets' ``scheduler.decode``.
* ``service.form`` — a pump's expiry, journal sync, admission-time cache
  probe, clustering and member selection, up to ``make_pool``
  (``service.pump``).
* ``service.ingest`` — ``TCQService.push_edges`` or ``ingest_graph``:
  the host merge-append, the journal record, the engine's new epoch and
  the core cache's advance (the caller's: ``service.pump`` when a poll
  pushes, else a root).

Sites on a per-step path read :func:`armed` once per pool into a local
and call :func:`begin` / :func:`end` behind it; other sites use
:func:`span`.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import List, Optional

import torch.autograd.profiler as _profiler

CAP = 2_000_000

_spans: List["Span"] = []
_dropped = 0
_lock = threading.Lock()
_roots = itertools.count()
_local = threading.local()


class Span:
    """One span: ``parent`` is the index of its parent in :func:`spans`
    (-1 for a root), ``root`` the id its root started, ``end`` None while
    it is open."""

    __slots__ = ("name", "start", "end", "parent", "root", "index")

    def __init__(self, name: str, start: float, parent: int, root: int):
        self.name = name
        self.start = start
        self.end: Optional[float] = None
        self.parent = parent
        self.root = root
        self.index = -1             # -1: past the cap, not kept


def armed() -> bool:
    """True while a ``torch.profiler`` session records."""
    return getattr(_profiler, "_is_profiler_enabled", False)


def _stack() -> List[Span]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def begin(name: str) -> Span:
    """Open a span under this thread's innermost open one; close it with
    :func:`end`.  Records whether or not the recorder is armed: the
    caller tests :func:`armed`."""
    global _dropped
    stack = _stack()
    top = stack[-1] if stack else None
    with _lock:
        sp = Span(name, 0.0, -1 if top is None else top.index,
                  next(_roots) if top is None else top.root)
        if len(_spans) < CAP:
            sp.index = len(_spans)
            _spans.append(sp)
        else:
            _dropped += 1
    stack.append(sp)
    sp.start = time.perf_counter()
    return sp


def end(sp: Span) -> None:
    """Close ``sp``, and any span still open inside it (left open by an
    exception), at the same time."""
    t = time.perf_counter()
    stack = _stack()
    while stack:
        top = stack.pop()
        top.end = t
        if top is sp:
            return


class span:
    """``with span(name):`` records ``name`` around the block while the
    recorder is armed, and costs one test of :func:`armed` when not."""

    __slots__ = ("name", "sp")

    def __init__(self, name: str):
        self.name = name
        self.sp: Optional[Span] = None

    def __enter__(self) -> None:
        if armed():
            self.sp = begin(self.name)

    def __exit__(self, *exc) -> None:
        if self.sp is not None:
            end(self.sp)


def spans() -> List[Span]:
    """Every span kept since the last :func:`clear`, in the order opened
    (a span's ``parent`` indexes this list)."""
    return _spans


def dropped() -> int:
    """Spans not kept since the last :func:`clear`: opened past
    :data:`CAP`."""
    return _dropped


def clear() -> None:
    """Forget every span and the dropped count; call with no span open."""
    global _dropped
    with _lock:
        _spans.clear()
        _dropped = 0
