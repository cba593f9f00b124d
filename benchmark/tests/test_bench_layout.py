"""BENCHMARK.json against its files: every cell, configuration, traffic
and metric found by name, and a new one added as files alone."""
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [c["name"] for c in SPEC["workloads"]])
def test_every_cell_resolves_to_its_files(cell):
    found = harness.resolve(SPEC, cell)
    assert found["generator"].is_file() and found["reference"].is_file()
    names = {m["name"] for m, _p in found["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert found["per_layer"]
    for _m, path in found["end_to_end"] + found["per_layer"]:
        assert path.is_file()


def test_names_units_and_moves():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    cells = {c["name"] for c in SPEC["workloads"]}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[group]:
            assert NAME.match(entry["name"]), entry["name"]
    for metric in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(metric["unit"]) and metric["better"] in (
            "lower", "higher")
        assert set(metric.get("workloads", cells)) <= cells
    for metric in SPEC["per_layer"]:
        assert metric["moves"] in e2e
        moved = next(m for m in SPEC["end_to_end"]
                     if m["name"] == metric["moves"])
        assert set(metric["workloads"]) <= set(moved.get("workloads", cells))
    for metric in SPEC["end_to_end"]:
        assert 0.01 <= metric["bound"] <= 0.25


def _digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_cell_and_a_metric_are_added_as_files_alone(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp_path / "benchmark"
    before = _digests(bench)
    config = json.loads((bench / "configs" / "ec_rs84_1m.json").read_text())
    config.update(name="ec_rs42_64k", stripe_bytes=65536,
                  profile=dict(config["profile"], k=4, m=2))
    (bench / "configs" / "ec_rs42_64k.json").write_text(json.dumps(config))
    (bench / "traffic" / "resident_enc_lost2.json").write_text(json.dumps(
        {"generator": "resident_codec", "stripes": 2, "erasures": [2],
         "input_sets": 2, "warmup_calls": 1}))
    (bench / "metrics" / "calls_per_s.py").write_text(
        "def read(run):\n"
        "    return run.window['attempted'] / run.window['seconds']\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "ec_rs42_64k", "source": "test",
                            "file": "benchmark/configs/ec_rs42_64k.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "ec42_tiny", "config": "ec_rs42_64k",
                              "traffic": "resident_enc_lost2", "chips": 1,
                              "why": "test"})
    spec["end_to_end"].append({"name": "calls_per_s", "unit": "calls/s",
                               "better": "higher", "bound": 0.05,
                               "source": "host_clock",
                               "workloads": ["ec42_tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("import json, time; from benchmark import harness; "
            "print(json.dumps(harness.run('ec42_tiny', 3, 0.2, False, "
            "time.monotonic(), device='cpu')))")
    env_path = f"{tmp_path}:{harness.ROOT}"
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=dict(os.environ, PYTHONPATH=env_path),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"]
    assert set(result["metrics"]) == {"calls_per_s", "setup_s"}
    after = _digests(bench)
    assert all(after[p] == d for p, d in before.items())
