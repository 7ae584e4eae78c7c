"""The trace guard and the breakdown on stub traces."""

import pytest

from tcqbench.trace import Spans, TraceError, reduce


def test_a_trace_without_kernels_fails():
    with pytest.raises(TraceError):
        reduce([], 0.0, 10.0, [])
    # events outside the window are no kernel of it either
    with pytest.raises(TraceError):
        reduce([("k", 11.0, 12.0)], 0.0, 10.0, [])


def test_busy_is_the_union_and_gaps_are_labelled():
    events = [("wave_peel", 1.0, 2.0), ("segdeg", 1.5, 3.0),
              ("memcpy", 6.0, 6.5), ("wave_peel", 9.0, 11.0)]
    spans = [("query_batch", 0.0, 5.0), ("inner", 3.2, 5.9),
             ("query_batch", 7.0, 8.9)]
    out = reduce(events, 0.0, 10.0, spans)
    assert out["busy_s"] == pytest.approx(2.0 + 0.5 + 1.0)
    assert out["window_s"] == 10.0
    assert out["events"] == 4
    assert out["device_ops"][0] == ["wave_peel", pytest.approx(2.0)]
    gaps = dict((round(s, 6), lab) for lab, s in out["idle_gaps"])
    assert gaps[3.0] == "inner"           # 3.0-6.0, midpoint 4.5: innermost
    assert gaps[2.5] == "query_batch"     # 6.5-9.0, midpoint 7.75
    assert gaps[1.0] == "query_batch"     # 0.0-1.0
    assert sum(out["idle_by_span"].values()) == pytest.approx(6.5)


def test_spans_total():
    s = Spans()
    with s("query_batch"):
        pass
    with s("query_batch"):
        pass
    n, secs = s.total("query_batch")
    assert n == 2 and secs >= 0
    assert s.total("other") == (0, 0)
