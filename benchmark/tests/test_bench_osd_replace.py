"""The recovery cell, ``osd3_repair``: a CPU rehearsal at a tiny size
(12 hosts of one OSD, ``pg_num`` 4, 16 objects of one stripe), the
per-layer metrics its trace reads, each fault failing its check (the
control on the card at the cell's own size too), and its new readers
over made-up windows."""
import time

import pytest

from benchmark import faults, harness, object_spans, trace
from benchmark.metrics import (recovery_push_ms, recovery_rebuild_ms,
                               recovery_reserve_wait_ms)

CELL = "osd3_repair"
#: the cell's traffic at a size the CPU runs in about a second
TINY = {"warmup_cycles": 1,
        "cluster": {"hosts": 12, "osds_per_host": 1, "pg_num": 4,
                    "objects": 16, "object_bytes": 32768}}
SPEC = harness.load_spec()


def rehearse(seed: int = 2**31 + 71, trace_: bool = False,
             fault: str | None = None, seconds: float = 1.0) -> dict:
    return harness.run(CELL, seed, seconds, trace_, time.monotonic(),
                       device="cpu", fault=fault, overrides=TINY)


def _metrics(kind: str) -> set:
    return {m["name"] for m in SPEC[kind]
            if CELL in m.get("workloads", [CELL])}


def test_the_cell_rebuilds_the_replaced_osd():
    result = rehearse()
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == _metrics("end_to_end") == \
        {"serve_mib_s", "setup_s"}
    assert result["metrics"]["serve_mib_s"]["value"] > 0
    assert set(result["checks"]) == {
        "read_bad_bytes", "chunk_bad_bytes", "hinfo_crc_mismatches",
        "acting_sets_moved", "acting_sets_sharing_a_host",
        "cycles_not_recovering_the_held_objects", "recovery_failures",
        "pgs_left_unclean"}
    assert list(result)[-1] == "checks"


def test_the_traced_cell_reads_each_of_its_per_layer_metrics():
    result = rehearse(trace_=True, seed=2**31 + 73)
    assert result["correct"], result["checks"]
    # the CPU has no kernels for a share of a roofline to read
    assert set(result["metrics"]) == {m for m in _metrics("per_layer")
                                      if "roofline" not in m}
    for name in ("recovery_reserve_wait_ms", "recovery_rebuild_ms",
                 "recovery_push_ms"):
        assert result["metrics"][name]["value"] > 0


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_fault_is_not_correct(fault):
    result = rehearse(fault=fault, seed=2**31 + 75)
    assert not result["correct"], (fault, result["checks"])
    assert result["checks"]["chunk_bad_bytes"]["value"] > 0


class _Run:
    def __init__(self, trace_summary):
        self.trace = trace_summary


def _x(name, ts, dur):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "pid": 1,
            "tid": 2}


def test_per_object_readers_divide_by_the_windows_recovered_objects(
        monkeypatch):
    mark = {"ph": "i", "name": trace.WINDOW_SPAN, "ts": 1000.0, "pid": 1,
            "tid": 2}
    stages = [_x("recovery.reserve_wait", 500.0, 1500.0),   # clipped
              _x("recovery.chain_hop", 1100.0, 40.0),
              _x("ec.decode_wave", 1200.0, 20.0),
              _x("recovery.push", 1300.0, 6.0),
              _x("recovery.push", 2300.0, 10.0)]
    objects = [_x("recovery.object", 400.0, 100.0),          # before
               _x("recovery.object", 1050.0, 300.0),
               _x("recovery.object", 2050.0, 300.0)]
    run = _Run({"window_s": 0.01})
    monkeypatch.setattr("benchmark.program_spans._events",
                        lambda: [mark] + stages)
    for reader in (recovery_reserve_wait_ms, recovery_rebuild_ms,
                   recovery_push_ms):
        assert reader.read(run) is None
    monkeypatch.setattr("benchmark.program_spans._events",
                        lambda: [mark] + stages + objects)
    assert recovery_reserve_wait_ms.read(run) == \
        pytest.approx(1000.0 / 2 / 1e3)
    assert recovery_rebuild_ms.read(run) == pytest.approx(60.0 / 2 / 1e3)
    assert recovery_push_ms.read(run) == pytest.approx(16.0 / 2 / 1e3)
    assert object_spans.per_object_ms(run, "no.such_span") is None
    assert recovery_push_ms.read(_Run(None)) is None


@pytest.mark.card
def test_control_on_the_card_at_the_cells_size(card):
    result = harness.run(CELL, 2**31 + 137, 5.0, False, time.monotonic(),
                         device=card, fault="control")
    assert not result["correct"], result["checks"]
