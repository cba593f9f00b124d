"""The cluster cell, ``cluster84_write_c16``: a CPU rehearsal at a tiny
size (12 hosts of one OSD, ``pg_num`` 4, 256 KiB objects), the per-layer
metrics its trace reads, each fault failing its check (the control on
the card at the cell's own size too), and its new readers over made-up
windows."""
import time

import pytest

from benchmark import faults, harness, op_spans, roofline, trace
from benchmark.metrics import crc32c_roofline_pct

CELL = "cluster84_write_c16"
#: the cell's traffic at a size the CPU runs in a few seconds
TINY = {"op_bytes": 1 << 18, "distinct_payloads": 4, "objects": 32,
        "warmup_seconds": 0.2,
        "cluster": {"hosts": 12, "osds_per_host": 1, "pg_num": 4}}
SPEC = harness.load_spec()


def rehearse(seed: int = 2**31 + 61, trace_: bool = False,
             fault: str | None = None, seconds: float = 1.0) -> dict:
    return harness.run(CELL, seed, seconds, trace_, time.monotonic(),
                       device="cpu", fault=fault, overrides=TINY)


def _metrics(kind: str) -> set:
    return {m["name"] for m in SPEC[kind]
            if CELL in m.get("workloads", [CELL])}


def test_the_cell_writes_and_reads_every_object_back():
    result = rehearse(seconds=5.0)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == _metrics("end_to_end") == \
        {"serve_mib_s", "setup_s"}
    assert result["metrics"]["serve_mib_s"]["value"] > 0
    assert set(result["checks"]) == {
        "read_bad_bytes", "chunk_bad_bytes", "hinfo_crc_mismatches",
        "acting_sets_sharing_a_host", "writes_failed",
        "objects_never_acked"}
    assert list(result)[-1] == "checks"


def test_the_traced_cell_reads_each_of_its_per_layer_metrics():
    result = rehearse(trace_=True, seed=2**31 + 63, seconds=5.0)
    assert result["correct"], result["checks"]
    # the CPU has no kernels for a share of a roofline or an idle share
    # with device work to read
    got = set(result["metrics"])
    assert got == {m for m in _metrics("per_layer")
                   if "roofline" not in m}
    # one burst of 16 writes is one batch on the unthreaded engine
    assert result["metrics"]["engine_ops_per_batch"]["value"] > 1
    for name in ("osd_queue_ms", "ec_encode_wait_ms", "ec_sub_write_ms"):
        assert result["metrics"][name]["value"] > 0


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_fault_is_not_correct(fault):
    result = rehearse(fault=fault, seed=2**31 + 65, seconds=0.3)
    assert not result["correct"], (fault, result["checks"])
    assert result["checks"]["chunk_bad_bytes"]["value"] > 0


class _Run:
    def __init__(self, trace_summary):
        self.trace = trace_summary


def _x(name, ts, dur):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "pid": 1,
            "tid": 2}


def test_per_op_spans_divide_by_the_windows_client_ops(monkeypatch):
    mark = {"ph": "i", "name": trace.WINDOW_SPAN, "ts": 1000.0, "pid": 1,
            "tid": 2}
    events = [mark,
              _x("osd.op", 500.0, 100.0),                 # before
              _x("osd.op", 1100.0, 100.0), _x("osd.op", 2100.0, 100.0),
              _x("osd.queue_wait", 1050.0, 40.0),
              _x("osd.queue_wait", 2050.0, 60.0),
              _x("ec.encode_wait", 1200.0, 3000.0)]
    monkeypatch.setattr("benchmark.program_spans._events", lambda: events)
    run = _Run({"window_s": 0.01})
    assert op_spans.per_op_ms(run, "osd.queue_wait") == pytest.approx(0.05)
    assert op_spans.per_op_ms(run, "ec.encode_wait") == pytest.approx(1.5)
    assert op_spans.per_op_ms(run, "ec.sub_write") is None
    assert op_spans.per_op_ms(_Run(None), "osd.queue_wait") is None


def test_crc32c_roofline_is_the_ledgers_bytes_over_the_kernels_time():
    kernel = "crc32c_rows_kernel(unsigned char const*, long long, ...)"
    key = ("crc32c_rows", (), 12, 1 << 19)
    run = _Run({"kernels": {kernel: 2e-3, "gf_apply_kernel<...>": 1.0},
                "launches": {key: 10,
                             ("gf_apply", (4, 8), 8, 1 << 20): 3}})
    want = 100.0 * 10 * (12 * (1 << 19) + 48) / roofline.HBM_BYTES_S / 2e-3
    assert crc32c_roofline_pct.read(run) == pytest.approx(want)
    assert crc32c_roofline_pct.read(_Run({"kernels": {}, "launches": {
        key: 1}})) is None


@pytest.mark.card
@pytest.mark.parametrize("seed", [2**31 + 131, 2**31 + 132, 2**31 + 133])
def test_control_on_the_card_at_the_cells_size(card, seed):
    result = harness.run(CELL, seed, 5.0, False, time.monotonic(),
                         device=card, fault="control")
    assert not result["correct"], result["checks"]
