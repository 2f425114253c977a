"""tools/trace_summary.py: the trace reduction behind the kernel tables."""

import pytest

from tools import trace_summary as ts


@pytest.mark.parametrize("intervals, busy", [
    ([], 0),
    ([(0, 10), (20, 25)], 15),                 # disjoint
    ([(0, 10), (5, 12), (11, 13)], 13),        # chained overlaps
    ([(30, 40), (0, 100), (50, 60)], 100),     # nested, unsorted
])
def test_busy_is_union_of_intervals(intervals, busy):
    assert ts._busy_ns(intervals) == busy


def test_summarize_needs_a_trace(tmp_path):
    with pytest.raises(FileNotFoundError):
        ts.summarize(str(tmp_path))


def test_format_summary():
    text = ts.format_summary([{
        "plane": "/device:GPU:0", "lines": ["XLA Ops"], "busy_ms": 2.0,
        "span_ms": 2.5, "n_ops": 3,
        "top": [("dot.1", 1.5, 0.75), ("fusion.2", 0.5, 0.25)]}])
    lines = text.splitlines()
    assert lines[0].startswith("/device:GPU:0: busy 2.000 ms of a 2.500 ms")
    assert "75.0%" in lines[1] and lines[1].endswith("dot.1")
    assert len(lines) == 3
