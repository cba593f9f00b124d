"""Each cell end to end on the CPU at a tiny size (a rehearsal only: no
number from here is a device number), the modules a run loads, and the
refusal to run without a card."""
import json
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests.common import TINY, rehearse

SPEC = harness.load_spec()


def _metrics_of(cell: str, kind: str) -> set:
    return {m["name"] for m in SPEC[kind]
            if cell in m.get("workloads", [cell])}


@pytest.mark.parametrize("cell", sorted(TINY))
def test_cell_runs_and_is_correct(cell):
    result = rehearse(cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == _metrics_of(cell, "end_to_end")
    assert list(result)[-1] == "checks"
    assert all(v["value"] <= v["limit"] for v in result["checks"].values())


@pytest.mark.parametrize("cell", sorted(TINY))
def test_traced_cell_reports_its_counter_metrics(cell):
    result = rehearse(cell, trace=True, seed=11)
    assert result["correct"]
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    # the CPU has no device events: only the counters' metrics read
    # anything, and no share of a roofline reads 0
    got = set(result["metrics"])
    assert got <= _metrics_of(cell, "per_layer")
    assert not any("roofline" in m for m in got)


def test_a_run_loads_no_jax_module():
    code = ("import sys, time; from benchmark import harness, faults, "
            "trace; from benchmark.tests.common import rehearse; "
            "[rehearse(c) for c in ('ec84_1m_resident', 'rbd84_write_c16')]; "
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole():
    sys.modules.setdefault("ceph_tpu_torch_probe_", sys)
    assert "ceph_tpu_torch_probe_" not in harness.forbidden_modules()
    del sys.modules["ceph_tpu_torch_probe_"]


def test_without_a_card_the_run_fails_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "rbd84_write_c16", "--seed", str(2**31 + 9), "--seconds", "1",
         "--trace", "0"], cwd=harness.ROOT, capture_output=True, text=True,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"},
        timeout=300)
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
