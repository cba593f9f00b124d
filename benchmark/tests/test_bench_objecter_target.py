"""``objecter_target_ms``, the client's CRUSH target per client op: its
reader over made-up spans, and the cluster cell's traced CPU rehearsal
reading it."""
import pytest

from benchmark import trace
from benchmark.metrics import objecter_target_ms
from benchmark.tests.test_bench_cluster import rehearse


class _Run:
    def __init__(self, trace_summary):
        self.trace = trace_summary


def _span(name, ts, dur):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "pid": 1,
            "tid": 2}


def test_objecter_target_is_its_spans_over_the_windows_client_ops(
        monkeypatch):
    mark = {"ph": "i", "name": trace.WINDOW_SPAN, "ts": 1000.0, "pid": 1,
            "tid": 2}
    ops = [_span("osd.op", 1100.0 + 1000.0 * i, 100.0) for i in range(4)]
    targets = [_span("objecter.calc_target", 500.0, 10.0),    # before
               _span("objecter.calc_target", 1050.0, 20.0),
               _span("objecter.calc_target", 2050.0, 4.0),
               _span("objecter.calc_target", 3050.0, 6.0)]
    run = _Run({"window_s": 0.01})
    monkeypatch.setattr("benchmark.program_spans._events",
                        lambda: [mark] + ops)
    assert objecter_target_ms.read(run) is None
    monkeypatch.setattr("benchmark.program_spans._events",
                        lambda: [mark] + ops + targets)
    assert objecter_target_ms.read(run) == pytest.approx(30.0 / 4 / 1e3)
    assert objecter_target_ms.read(_Run(None)) is None


def test_the_traced_cluster_cell_reads_its_objecter_target():
    result = rehearse(trace_=True, seed=2**31 + 67, seconds=5.0)
    assert result["correct"], result["checks"]
    assert result["metrics"]["objecter_target_ms"]["value"] > 0
