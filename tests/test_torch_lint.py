"""ceph-lint over the port: ``ceph_tpu_torch.analysis`` and its CLI.

Four layers:

- differential: every deep rule on the reference fixtures
  (``tests/lint_fixtures/``), indexed under the port's prefixes, gives
  exactly the JAX package's findings;
- the registry: the JAX package's rules, less the four ``jit-*`` rules,
  plus ``launch-host-sync``;
- fixtures for the rules whose targets changed with the runtime
  (``no-host-sync``, ``launch-host-sync``, ``profiler-confinement``,
  ``bare-clock``), bad and clean twins held here as strings;
- the gate and the CLI over the port's tree, and the import isolation.
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

import ceph_tpu.analysis as J
import ceph_tpu_torch.analysis as A
from ceph_tpu_torch.analysis import rules_guards
from ceph_tpu_torch.tools import ceph_lint

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = Path(__file__).resolve().parent / "lint_fixtures"
BASELINE = ROOT / "ceph_tpu_torch" / "analysis" / "baseline.json"

DEEP_RULES = ("lock-order-cycle", "callback-under-lock",
              "cross-thread-unlocked", "instrument-under-lock",
              "hot-path-copy")
# (fixture, the rule it was written for)
FIXTURE_FILES = [("lock_cycle_bad.py", "lock-order-cycle"),
                 ("lock_cycle_clean.py", "lock-order-cycle"),
                 ("cross_thread_bad.py", "cross-thread-unlocked"),
                 ("cross_thread_clean.py", "cross-thread-unlocked"),
                 ("hot_copy_bad.py", "hot-path-copy"),
                 ("hot_copy_clean.py", "hot-path-copy")]
JIT_RULES = {"jit-host-sync", "jit-nonstatic-shape",
             "jit-traced-control-flow", "jit-donated-reuse"}


def _as_reference(findings):
    return sorted((f.rule, f.path.replace("ceph_tpu_torch/", "ceph_tpu/"),
                   f.line, f.severity,
                   f.message.replace("ceph_tpu_torch/", "ceph_tpu/"))
                  for f in findings)


# -- differential: the reference fixtures ------------------------------------

@pytest.mark.parametrize("rule_id", DEEP_RULES)
@pytest.mark.parametrize("fixture,target", FIXTURE_FILES)
def test_reference_fixtures_give_the_reference_findings(fixture, target,
                                                        rule_id):
    text = (FIXTURES / fixture).read_text()
    # msg/ lies in every deep rule's scope, in both packages
    port = A.run_rule_on_sources(rule_id,
                                 {f"ceph_tpu_torch/msg/{fixture}": text})
    ref = J.run_rule_on_sources(rule_id, {f"ceph_tpu/msg/{fixture}": text})
    assert all(f.path == f"ceph_tpu_torch/msg/{fixture}" for f in port)
    assert _as_reference(port) == _as_reference(ref)
    if rule_id == target:
        assert bool(port) == fixture.endswith("_bad.py")


# -- the registry ------------------------------------------------------------

def test_registry_is_the_reference_less_jit_plus_launch_host_sync():
    port, ref = A.all_rules(), J.all_rules()
    assert JIT_RULES <= set(ref)
    assert set(port) == (set(ref) - JIT_RULES) | {"launch-host-sync"}
    for rid in set(port) & set(ref):
        assert port[rid].severity == ref[rid].severity, rid
        assert port[rid].description
    assert port["launch-host-sync"].severity == \
        ref["jit-host-sync"].severity == "error"
    assert all(s.startswith("ceph_tpu_torch")
               for r in port.values() for s in r.scope)


# -- fixtures of the torch rules ---------------------------------------------

NO_HOST_SYNC_BAD = """\
import jax
from ceph_tpu.ops import codec
import torch


def serve(t, ev, stream):
    n = t.sum().item()
    h = t.cpu()
    a = h.numpy()
    rows = t.tolist()
    torch.cuda.synchronize()
    ev.synchronize()
    stream.synchronize()
    return n, a, rows
"""

NO_HOST_SYNC_CLEAN = """\
import numpy as np
import torch

from ceph_tpu_torch.ops.pipeline import settle
from . import engine


def serve(t, host, dev):
    card = t.to(dev, non_blocking=True)
    out = torch.from_numpy(np.asarray(host))
    return settle(card), out.view(-1), engine
"""


def test_no_host_sync_flags_imports_and_syncs():
    found = A.run_rule_on_sources("no-host-sync",
                                  {"serve.py": NO_HOST_SYNC_BAD})
    assert {(f.line, f.message) for f in found} == {
        (1, "import jax"), (2, "from ceph_tpu.ops import ..."),
        (7, ".item(...)"), (8, ".cpu(...)"), (9, ".numpy(...)"),
        (10, ".tolist(...)"), (11, "torch.cuda.synchronize(...)"),
        (12, ".synchronize(...)"), (13, ".synchronize(...)")}
    assert all(f.path == "ceph_tpu_torch/exec/serve.py" for f in found)


def test_no_host_sync_passes_clean_twin():
    assert A.run_rule_on_sources(
        "no-host-sync", {"serve.py": NO_HOST_SYNC_CLEAN}) == []


LAUNCH_BAD = """\
from . import cuda_build


def _helper(t):
    return t.cpu()


def launch(t):
    lib = cuda_build.load("gf_apply")
    lib.run(t.data_ptr())
    _helper(t)
    return t.item()


def plain(t):
    return t.numpy()
"""

LAUNCH_CLEAN = """\
from . import cuda_build, launch_ledger


def gf_apply(t):
    if t.device.type == "cpu":
        return plain(t)
    return _launch(t)


def plain(t):
    return t.cpu()


def _launch(t):
    lib = cuda_build.load("gf_apply")
    with launch_ledger.launch("gf_apply", (), 0, t.device):
        lib.run(t.data_ptr())
    return t
"""

LEDGER = """\
def launch(label, key, nbytes, device):
    end = device.event()
    end.synchronize()
    return end
"""


def test_launch_host_sync_flags_direct_and_transitive():
    found = A.run_rule_on_sources("launch-host-sync", {"k.py": LAUNCH_BAD})
    assert sorted((f.line, f.message) for f in found) == [
        (8, "host sync .cpu() reachable from kernel launcher launch "
            "via _helper"),
        (12, "host sync .item() reachable from kernel launcher launch")]
    assert all(f.path == "ceph_tpu_torch/ops/k.py" for f in found)


def test_launch_host_sync_stops_at_the_boundary():
    assert A.run_rule_on_sources("launch-host-sync", {
        "k.py": LAUNCH_CLEAN,
        "ceph_tpu_torch/ops/launch_ledger.py": LEDGER}) == []


def test_launch_host_sync_roots_are_the_ports_launchers():
    from ceph_tpu_torch.analysis.rules_torch import launching_functions
    roots = {(f.rel.rsplit("/", 1)[-1], f.qualname)
             for f in launching_functions(A.default_index())}
    assert {("rs_kernels.py", "_apply_launch"),
            ("rs_kernels.py", "_xor_launch"),
            ("rs_kernels.py", "crc32c_rows_into"),
            ("crush_kernels.py", "straw2_map")} <= roots
    assert all(r[0] != "launch_ledger.py" for r in roots)


PROFILER_BAD = """\
import torch.profiler
from torch.profiler import profile
from torch import profiler
import torch


def capture():
    with torch.profiler.profile():
        pass
    torch.autograd.profiler.record_function("x")
"""

PROFILER_CLEAN = """\
import torch


def capture():
    start = torch.cuda.Event(enable_timing=True)
    profiler = None
    return start, profiler
"""


def test_profiler_confinement_flags_torch_profiler():
    found = A.run_rule_on_sources("profiler-confinement",
                                  {"cap.py": PROFILER_BAD})
    assert sorted((f.line, f.message) for f in found) == [
        (1, "import torch.profiler"),
        (2, "from torch.profiler import ..."),
        (3, "from torch import profiler"),
        (8, "torch.profiler"),
        (10, "torch.autograd.profiler")]


def test_profiler_confinement_passes_clean_twin_and_allowlist():
    assert A.run_rule_on_sources("profiler-confinement",
                                 {"cap.py": PROFILER_CLEAN}) == []
    assert A.run_rule_on_sources("profiler-confinement", {
        "ceph_tpu_torch/common/profiler_capture.py": PROFILER_BAD}) == []
    assert all(len(why) > 20 for why in
               rules_guards.PROFILER_ALLOWLIST.values())


CLOCK_BAD = """\
import time


def encode(t):
    t0 = time.perf_counter()
    wall = time.time()
    return t, t0, wall
"""

CLOCK_CLEAN = """\
from ..common.tracer import trace_span


def encode(t):
    with trace_span("encode", owner="client"):
        return t
"""


def test_bare_clock_flags_bare_timing():
    found = A.run_rule_on_sources("bare-clock", {"enc.py": CLOCK_BAD})
    assert sorted((f.path, f.line) for f in found) == [
        ("ceph_tpu_torch/ops/enc.py", 5), ("ceph_tpu_torch/ops/enc.py", 6)]


@pytest.mark.parametrize("allowed", sorted(rules_guards.CLOCK_ALLOWLIST))
def test_bare_clock_allowlist_is_live_and_justified(allowed):
    """Each allowlisted file still times with a bare clock (else the entry
    is stale), is passed by the rule, and states its reason."""
    assert A.run_rule_on_sources("bare-clock", {allowed: CLOCK_BAD}) == []
    assert rules_guards._BARE_TIME.search((ROOT / allowed).read_text())
    assert len(rules_guards.CLOCK_ALLOWLIST[allowed]) > 20


def test_bare_clock_passes_clean_twin():
    assert A.run_rule_on_sources("bare-clock", {"enc.py": CLOCK_CLEAN}) == []


# -- the gate and the CLI ----------------------------------------------------

def test_gate_runs_clean_with_the_baseline():
    assert ceph_lint.main(["--baseline", str(BASELINE)]) == 0


def test_no_error_is_baselined_and_every_entry_is_justified():
    findings = A.run_rules(A.default_index())
    assert not [f.render() for f in findings if f.severity == "error"]
    base = A.load_baseline(BASELINE)
    assert base
    assert all(j and len(j) > 20 for j in base.values())
    severity = {f.key: f.severity for f in findings}
    assert all(severity.get(k) == "warning" for k in base)


def test_lint_summary_is_clean():
    s = ceph_lint.lint_summary()
    assert s["new"] == 0 and s["stale_baseline"] == 0
    assert s["total"] == s["baselined"] > 0
    assert s["rules_run"] == len(A.all_rules())
    assert sum(s["by_rule"].values()) == s["total"]


def test_cli_list_rules_unknown_rule_and_json(capsys):
    assert ceph_lint.main(["--list-rules"]) == 0
    assert "launch-host-sync" in capsys.readouterr().out
    assert ceph_lint.main(["--rules", "no-such-rule"]) == 2
    assert ceph_lint.main(["--rules", "jit-host-sync"]) == 2
    assert ceph_lint.main([]) == 1            # the baselined warnings
    capsys.readouterr()
    assert ceph_lint.main(["--json", "--baseline", str(BASELINE)]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["summary"]["new"] == 0
    assert all(f["baselined"] for f in doc["findings"])


def test_cli_runs_as_a_module():
    proc = subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.tools.ceph_lint",
         "--baseline", str(BASELINE), "--rules", "bare-clock,no-host-sync"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 new (0 errors, 0 warnings)" in proc.stdout


def test_analysis_import_loads_no_torch_jax_or_reference():
    code = ("import sys; import ceph_tpu_torch.analysis; "
            "bad = [m for m in ('jax', 'ceph_tpu', 'torch') "
            "if m in sys.modules]; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_phase_lint_is_clean():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    out = chip_smoke.phase_lint()
    assert (out["new"], out["stale"]) == (0, 0)
    assert out["baselined"] == out["total"] == sum(out["by_rule"].values())
