"""The port's perf gate (``ceph_tpu_torch/tools/perf_gate.py``) against the
JAX package's (``tools/perf_gate.py``).

Every case of ``tests/test_perf_gate.py`` that reaches ``evaluate`` runs
again with the root tool's ``evaluate`` wrapped: each call also runs the
port's ``evaluate`` on the same inputs with every ``"tpu"`` device marker
(and expected platform) relabelled ``"gpu"``, the port's platform of
record, and the two results must agree exactly once the root's are
relabelled the same way: verdict, failures and compared.  The case's
own assertions then run on the root's result as before.  A legacy line
(no device marker, no error) stays ``"tpu"`` in the port, so it is
never diffed against a card artifact.  On the repo's ``BENCH_r*.json``
history both tools pick the same reference, and the port expects no
platform where the root tool expects ``"tpu"``.
"""
import importlib.util
import inspect
import json
from pathlib import Path

import pytest

from ceph_tpu_torch.tools import perf_gate as port

ROOT = Path(__file__).resolve().parents[1]


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def cases():
    """tests/test_perf_gate.py, loaded with its own copy of the root tool
    (its module attribute ``perf_gate``)."""
    return _load("torch_perf_gate_cases", ROOT / "tests" / "test_perf_gate.py")


def relabel(obj):
    """Every value equal to "tpu" becomes "gpu" (strings inside a failure
    or verdict line: the word, wherever it stands)."""
    if isinstance(obj, dict):
        return {k: relabel(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [relabel(v) for v in obj]
    if obj == "tpu":
        return "gpu"
    return obj


def relabel_result(res: dict) -> dict:
    return {"ok": res["ok"],
            "verdict": res["verdict"].replace("tpu", "gpu"),
            "failures": [f.replace("tpu", "gpu") for f in res["failures"]],
            "compared": relabel(res["compared"])}


EVALUATE_CASES = [
    ("TestEvaluate", name) for name in (
        "test_pass_within_thresholds",
        "test_twenty_percent_regression_fails",
        "test_block_regression_fails_independently",
        "test_resilience_block_gated",
        "test_slo_block_gated",
        "test_wire_efficiency_regression_direction_is_up",
        "test_pct_of_peak_regression_fails_loose_threshold",
        "test_efficiency_platform_fallback_not_compared",
        "test_latency_regression_direction_is_up",
        "test_platform_fallback_hard_fails",
        "test_tpu_reference_cpu_new_fails_per_block",
        "test_cpu_vs_cpu_compares_normally",
        "test_custom_threshold",
        "test_no_reference_checks_platform_only",
        "test_bench_wrapper_normalizes")] + [
    ("TestMainAndHistory", name) for name in (
        "test_cli_exit_codes",
        "test_gate_for_bench_attaches_verdict",
        "test_repo_history_gates_the_r05_artifact")]


@pytest.mark.parametrize("cls,name", EVALUATE_CASES,
                         ids=[n for _c, n in EVALUATE_CASES])
def test_case_runs_against_the_port(cases, monkeypatch, tmp_path, capsys,
                                    cls, name):
    root_evaluate = cases.perf_gate.evaluate
    calls = []

    def both(new, reference, thresholds=None, expect_platform=None):
        res = root_evaluate(new, reference, thresholds, expect_platform)
        got = port.evaluate(relabel(new), relabel(reference), thresholds,
                            relabel(expect_platform))
        assert {k: got[k] for k in ("ok", "verdict", "failures",
                                    "compared")} == relabel_result(res)
        calls.append(res["ok"])
        return res
    monkeypatch.setattr(cases.perf_gate, "evaluate", both)
    method = getattr(getattr(cases, cls)(), name)
    fixtures = {"tmp_path": tmp_path, "capsys": capsys}
    method(**{p: fixtures[p] for p in inspect.signature(method).parameters})
    assert calls, f"{name} never reached evaluate"


def test_every_evaluate_case_is_listed(cases):
    """A case of tests/test_perf_gate.py that calls evaluate, main or
    gate_for_bench is in EVALUATE_CASES, or is one of the two legacy
    cases held below."""
    listed = {n for _c, n in EVALUATE_CASES}
    legacy = {"test_legacy_tpu_line_infers_platform",
              "test_legacy_reference_still_gates_tpu_regressions"}
    for cls in (cases.TestEvaluate, cases.TestMainAndHistory):
        for name, fn in inspect.getmembers(cls, inspect.isfunction):
            src = inspect.getsource(fn)
            if any(f"perf_gate.{f}(" in src for f in
                   ("evaluate", "main", "gate_for_bench")):
                assert name in listed | legacy, name


def test_legacy_lines_stay_tpu(cases):
    """A legacy line is still inferred as a TPU line, so a card artifact
    is never diffed against it: no comparison, and no fallback."""
    legacy = {"metric": "m", "value": 32000.0, "unit": "MiB/s",
              "vs_baseline": 4.0}
    assert port.artifact_platform(legacy) == "tpu"
    assert port.artifact_platform(dict(legacy, error="x", device="cpu")) \
        == "cpu"
    card = {"metric": "m", "value": 16000.0, "device": "gpu"}
    res = port.evaluate(card, legacy, expect_platform="gpu")
    assert res["ok"] and res["compared"] == []
    assert res["verdict"] == ("PERF GATE: PASS (no comparable reference "
                              "metrics; platform=gpu)")
    # the root tool diffs the same regression on its own platform
    assert not cases.perf_gate.evaluate(
        dict(card, device="tpu"), legacy, expect_platform="tpu")["ok"]


def test_gpu_reference_cpu_artifact_is_a_fallback():
    line = {"value": 100.0, "device": "cpu",
            "efficiency": {"device": "cpu", "pct_of_peak": 40.0}}
    ref = {"value": 100.0, "device": "gpu",
           "efficiency": {"device": "gpu", "pct_of_peak": 40.0}}
    res = port.evaluate(line, ref)
    assert not res["ok"] and res["compared"] == []
    assert res["failures"] == [
        "core.mib_s: platform fallback (reference on gpu, new on cpu)",
        "efficiency.pct_of_peak: platform fallback (reference on gpu, "
        "new on cpu)"]


def test_history_expects_gpu_once_a_round_measured_on_the_card(tmp_path):
    def write(name, doc):
        (tmp_path / name).write_text(json.dumps({"parsed": doc}))
    write("BENCH_r01.json", {"value": 5.0, "device": "cpu"})
    assert port.expected_platform(str(tmp_path)) is None
    write("BENCH_r02.json", {"value": 9.0, "device": "tpu"})
    assert port.expected_platform(str(tmp_path)) is None
    write("BENCH_r03.json", {"value": 7.0, "device": "gpu"})
    assert port.expected_platform(str(tmp_path)) == "gpu"
    res = port.gate_for_bench({"value": 7.0, "device": "cpu"},
                              str(tmp_path))
    assert not res["ok"] and res["reference"] == "BENCH_r03.json"


def test_repo_history(cases):
    """The repo's BENCH_r*.json: the same reference, no expected
    platform where the root tool expects tpu."""
    r_doc, r_path, r_expect = cases.perf_gate.scan_history(str(ROOT))
    p_doc, p_path, p_expect = port.scan_history(str(ROOT))
    assert r_path is not None and p_path == r_path and p_doc == r_doc
    assert r_expect == "tpu" and p_expect is None


def _card_line(tmp_path) -> Path:
    line = {"metric": "m", "value": 5000.0, "unit": "MiB/s",
            "device": "gpu",
            "serving": {"device": "gpu",
                        "batched": {"ops_s": 9000.0, "p99_ms": 3.0}},
            "efficiency": {"device": "gpu", "pct_of_peak": 12.0}}
    path = tmp_path / "line.json"
    path.write_text(json.dumps(line))
    return path


def test_card_artifact_against_itself_and_the_history(tmp_path, capsys):
    path = str(_card_line(tmp_path))
    assert port.main([path, "--baseline", path, "--json"]) == 0
    res = json.loads(capsys.readouterr().out)
    assert res["ok"] and len(res["compared"]) == 4
    assert port.main([path, "--repo-dir", str(ROOT), "--json"]) == 0
    res = json.loads(capsys.readouterr().out)
    assert res["ok"] and res["compared"] == []
    assert res["expected_platform"] is None
    assert "no comparable reference metrics" in res["verdict"]
    assert port.main([path, "--repo-dir", str(ROOT), "--expect-platform",
                      "tpu", "--check"]) == 1
    assert capsys.readouterr().out.strip() == (
        "PERF GATE: FAIL (platform fallback: expected tpu, measured gpu)")


def test_tables_are_the_root_tools(cases):
    assert port.METRIC_PATHS == cases.perf_gate.METRIC_PATHS
    assert port.METRIC_LIMITS == cases.perf_gate.METRIC_LIMITS
    assert port.METRIC_THRESHOLDS == cases.perf_gate.METRIC_THRESHOLDS
    assert port.DEFAULT_THRESHOLD == cases.perf_gate.DEFAULT_THRESHOLD
    assert port._BLOCK_DEVICE == cases.perf_gate._BLOCK_DEVICE
