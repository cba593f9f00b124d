"""The port's profiler capture windows against the JAX package's, on the CPU.

``ProfilerCapture`` with an injected backend behaves as the JAX
package's does in ``tests/test_roofline.py`` (bounded windows, refusal
of a second window, the cooldown, the timed auto window, the stale-timer
guard, admin commands, the cluster's one capture per WARN/ERR
transition): each scenario runs on both classes and their outcomes are
compared.  The real backend (``torch.profiler``, CPU activity here)
exports a Chrome trace; it loads only where CUDA is initialised; and a
guard admits ``torch.profiler`` only in ``common/profiler_capture.py``
and ``tools/path_shapes.py``.
"""
from __future__ import annotations

import ast
import importlib
import importlib.util
import json
import os
import sys
import time
import warnings
from pathlib import Path

import pytest

from ceph_tpu.common import Context as JContext
from ceph_tpu.common.profiler_capture import ProfilerCapture as JCapture
from ceph_tpu_torch.common import Context
from ceph_tpu_torch.common import device_telemetry
from ceph_tpu_torch.common import profiler_capture as pcm
from ceph_tpu_torch.common.profiler_capture import ProfilerCapture

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "ceph_tpu_torch")
ALLOWED = {"common/profiler_capture.py", "tools/path_shapes.py"}


class FakeProfiler:
    def __init__(self, fail_start=False):
        self.calls: list[tuple] = []
        self.fail_start = fail_start

    def start_trace(self, path):
        if self.fail_start:
            raise RuntimeError("profiler backend down")
        self.calls.append(("start", Path(path).name.split("-", 3)[-1]))

    def stop_trace(self):
        self.calls.append(("stop",))


def _bounded_windows(cls, ctx, d):
    fp = FakeProfiler()
    pc = cls(cct=ctx(), out_dir=d, max_captures=2, profiler=fp)
    out = []
    for i in range(3):
        out.append("error" in pc.start(f"w{i}"))
        res = pc.stop()
        meta = json.loads((Path(res["path"]) / "capture.json").read_text())
        out.append(meta["reason"])
        time.sleep(1.05)                # capture dirs are named by second
    return out + [len(pc.captures()), fp.calls]


def _refusals(cls, ctx, d):
    pc = cls(cct=ctx(), out_dir=d, profiler=FakeProfiler())
    out = ["error" in pc.stop(), "error" in pc.start("a"),
           "error" in pc.start("b")]
    pc.stop()
    off = cls(cct=ctx(), out_dir=None, profiler=FakeProfiler())
    return out + ["error" in off.start("x"), off.auto_capture("WARN")]


def _cooldown(cls, ctx, d):
    pc = cls(cct=ctx(), out_dir=d, cooldown_s=300.0, auto_window_s=0.0,
             profiler=FakeProfiler())
    first = pc.auto_capture("SLOW_OPS")
    return ["stopped" in first, pc.auto_capture("SLOW_OPS"),
            len(pc.captures()), pc.auto_captures, pc.auto_skipped]


def _timed_window(cls, ctx, d):
    fp = FakeProfiler()
    pc = cls(cct=ctx(), out_dir=d, auto_window_s=0.05, profiler=fp)
    info = pc.auto_capture("SLOW_OPS")
    out = ["stopped" in info]
    deadline = time.time() + 2.0
    while pc.status()["active"] is not None and time.time() < deadline:
        time.sleep(0.01)
    return out + [pc.status()["active"], fp.calls.count(("stop",)),
                  len(pc.captures())]


def _stale_timer(cls, ctx, d):
    pc = cls(cct=ctx(), out_dir=d, auto_window_s=0.05, cooldown_s=0.0,
             profiler=FakeProfiler())
    out = [pc.auto_capture("X") is not None]
    pc.stop()
    out.append("error" in pc.start("operator"))
    time.sleep(0.15)
    out.append(pc.status()["active"] is not None)
    pc.stop()
    return out


def _failure(cls, ctx, d):
    pc = cls(cct=ctx(), out_dir=d, profiler=FakeProfiler(fail_start=True))
    out = [pc.auto_capture("X"), pc.captures()]
    pc2 = cls(cct=ctx(), out_dir=d, profiler=FakeProfiler())
    out.append("error" in pc2.start("ok"))
    pc2.stop()
    return out


def _admin(cls, ctx, d):
    cct = ctx()
    pc = cls(cct=cct, out_dir=d, profiler=FakeProfiler())
    pc.register_admin()
    try:
        out = ["error" in cct.admin_socket.call("device profile start"),
               cct.admin_socket.call("device profile status")["active"]
               is not None,
               "path" in cct.admin_socket.call("device profile stop"),
               sorted(cct.admin_socket.call("device profile status"))]
    finally:
        pc.close()
    return out + [cct.admin_socket.get("device profile start")]


SCENARIOS = {"bounded_windows": _bounded_windows, "refusals": _refusals,
             "cooldown": _cooldown, "timed_window": _timed_window,
             "stale_timer": _stale_timer, "failure": _failure,
             "admin": _admin}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_capture_behaves_as_the_jax_package(name, tmp_path):
    want = SCENARIOS[name](JCapture, JContext, tmp_path / "jax")
    got = SCENARIOS[name](ProfilerCapture, Context, tmp_path / "port")
    assert got == want


def _one_capture_per_transition(pkg, tmp_path):
    cluster = importlib.import_module(f"{pkg}.cluster")
    health = importlib.import_module(f"{pkg}.mgr.health")
    common = importlib.import_module(f"{pkg}.common")
    c = cluster.MiniCluster(n_osds=4, osds_per_host=2, chunk_size=1024,
                            cct=common.Context(), data_dir=tmp_path)
    try:
        c.profiler._profiler = FakeProfiler()
        c.health_engine.register("TEST_WARN",
                                 lambda: health.CheckResult("injected"))
        c.health()
        first = len(c.profiler.captures())
        c.health_engine.register("TEST_WARN2",
                                 lambda: health.CheckResult("injected2"))
        c.health()
        return [first, len(c.profiler.captures()),
                (tmp_path / "profiles").is_dir(),
                sorted(c.flight.dump(reason="t", force=True))]
    finally:
        c.shutdown()


def test_cluster_captures_once_per_warn_transition(tmp_path):
    want = _one_capture_per_transition("ceph_tpu", tmp_path / "jax")
    got = _one_capture_per_transition("ceph_tpu_torch", tmp_path / "port")
    assert got == want
    assert got[:3] == [1, 1, True]
    assert {"jit", "efficiency"} <= set(got[3])


def test_real_backend_needs_cuda_initialised(tmp_path, monkeypatch):
    monkeypatch.setattr(device_telemetry, "backend_ready", lambda: False)
    pc = ProfilerCapture(cct=Context(), out_dir=tmp_path)
    res = pc.start("x")
    assert "ProfilerUnavailable" in res["error"]
    assert pc.captures() == [] and pc.status()["active"] is None


def test_real_backend_exports_a_chrome_trace(tmp_path, monkeypatch):
    import torch
    monkeypatch.setattr(device_telemetry, "backend_ready", lambda: True)
    pc = ProfilerCapture(cct=Context(), out_dir=tmp_path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert "error" not in pc.start("cpu")
        torch.ones(4096).mul_(3).sum()
        res = pc.stop()
    assert "error" not in res
    trace = json.loads((Path(res["path"]) / pcm.TRACE_FILE).read_text())
    assert any(e.get("cat") == "cpu_op" for e in trace["traceEvents"])
    assert isinstance(pc._profiler, pcm.TorchProfiler)


def test_the_primer_runs_inside_its_span(tmp_path):
    """TorchProfiler.prime's fills and copies lie inside PRIMER_SPAN,
    where trace_device_stats finds them."""
    from torch.profiler import ProfilerActivity, profile
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            pcm.TorchProfiler().prime(device="cpu")
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    span = [e for e in events if e.get("name") == pcm.PRIMER_SPAN
            and e.get("ph") == "X"]
    assert len(span) == 1
    t0, t1 = span[0]["ts"], span[0]["ts"] + span[0]["dur"]
    inside = [e["name"] for e in events if e.get("cat") == "cpu_op"
              and t0 <= e["ts"] <= t1]
    # and one fill of the host tensor that is copied up
    assert inside.count("aten::fill_") == \
        pcm.TorchProfiler.PRIMER_LAUNCHES + 1
    assert inside.count("aten::copy_") == pcm.TorchProfiler.PRIMER_COPIES


def test_trace_device_stats_counts_kernels_and_busy_union(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_p", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    sys.path.insert(0, ROOT)
    spec.loader.exec_module(cs)
    events = [
        {"ph": "X", "cat": "kernel", "ts": 0, "dur": 10,
         "name": "void gf_apply_kernel<4>(unsigned char const*)"},
        {"ph": "X", "cat": "gpu_memcpy", "ts": 5, "dur": 10,
         "name": "Memcpy HtoD"},
        {"ph": "X", "cat": "kernel", "ts": 30, "dur": 5,
         "name": "crc32c_rows_kernel(unsigned char const*)"},
        {"ph": "X", "cat": "cpu_op", "ts": 0, "dur": 100, "name": "aten::mul"},
        {"ph": "X", "cat": "kernel", "ts": 31, "dur": 2, "name": "other"}]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    st = cs.trace_device_stats(str(path))
    assert st["kernels"] == {"gf_apply": 1, "crc32c_rows": 1}
    assert st["kernel_ms"] == {"gf_apply": 0.010, "crc32c_rows": 0.005}
    assert st["device_events"] == 4
    assert st["busy_s"] == pytest.approx(20e-6)
    assert st["runtime_launches"] == 0 and st["kernel_lag_us"] is None


def test_trace_device_stats_reads_each_kernels_lag(tmp_path):
    """A kernel's start less its launch's, matched by correlation id; a
    runtime call's less its operator's, by External id; the first launch
    and device event after the window opens."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_p", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    sys.path.insert(0, ROOT)
    spec.loader.exec_module(cs)
    events = [
        {"ph": "X", "cat": "cuda_runtime", "ts": 100, "dur": 4,
         "name": "cudaLaunchKernel", "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "ts": 200, "dur": 4,
         "name": "cudaLaunchKernelExC", "args": {"correlation": 8}},
        {"ph": "X", "cat": "cuda_runtime", "ts": 300, "dur": 4,
         "name": "cudaLaunchKernel", "args": {"correlation": 9}},
        {"ph": "X", "cat": "kernel", "ts": 90, "dur": 3,
         "name": "gf_apply_kernel", "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "ts": 230, "dur": 3,
         "name": "crc32c_rows_kernel", "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "ts": 400, "dur": 3,
         "name": "gf_apply_kernel", "args": {"correlation": 5}},
        {"ph": "X", "cat": "Trace", "ts": 50, "dur": 1000,
         "name": "PyTorch Profiler (0)"},
        {"ph": "X", "cat": "cpu_op", "ts": 500, "dur": 40,
         "name": "aten::copy_", "args": {"External id": 3}},
        {"ph": "X", "cat": "cuda_runtime", "ts": 510, "dur": 4,
         "name": "cudaMemcpyAsync", "args": {"External id": 3}},
        {"ph": "X", "cat": "cpu_op", "ts": 600, "dur": 40,
         "name": "aten::copy_", "args": {"External id": 4}},
        {"ph": "X", "cat": "cuda_runtime", "ts": 580, "dur": 4,
         "name": "cudaMemcpyAsync", "args": {"External id": 4}},
        # the window's primer: two fills, one of them on the card
        {"ph": "X", "cat": "user_annotation", "ts": 60, "dur": 20, "tid": 1,
         "name": pcm.PRIMER_SPAN},
        {"ph": "X", "cat": "cuda_runtime", "ts": 62, "dur": 2, "tid": 1,
         "name": "cudaLaunchKernel", "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "ts": 66, "dur": 2, "tid": 1,
         "name": "cudaLaunchKernel", "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "ts": 70, "dur": 2, "tid": 1,
         "name": "cudaDeviceSynchronize", "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "ts": 64, "dur": 1,
         "name": "fill", "args": {"correlation": 2}}]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    st = cs.trace_device_stats(str(path))
    assert st["runtime_launches"] == 3 and st["primer"] == [1, 2]
    assert st["device_events"] == 3
    assert st["kernel_lag_us"] == [-10.0, 30.0, 30.0]
    assert st["unmatched_launches"] == [[2, pytest.approx(250e-6)]]
    assert st["clock_offset_us"] == [-20.0, 10.0, 10.0]
    assert st["first_launch_s"] == pytest.approx(50e-6)
    assert st["first_device_s"] == pytest.approx(40e-6)


# -- the guard ------------------------------------------------------------------

def _profiler_uses(source: str) -> list[str]:
    tree = ast.parse(source)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names
                      if a.name.startswith("torch.profiler")
                      or a.name.startswith("torch.autograd.profiler")]
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.module.startswith(("torch.profiler",
                                       "torch.autograd.profiler")):
                found.append(f"from {node.module}")
            elif node.module in ("torch", "torch.autograd") and any(
                    a.name == "profiler" for a in node.names):
                found.append(f"from {node.module} import profiler")
        elif isinstance(node, ast.Attribute) and node.attr == "profiler" \
                and ast.unparse(node.value) in ("torch", "torch.autograd"):
            found.append(f"{ast.unparse(node.value)}.profiler")
    return found


def test_torch_profiler_is_confined():
    offenders, seen = [], set()
    for dirpath, _dirs, files in os.walk(PORT):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            rel = os.path.relpath(path, PORT)
            with open(path) as fh:
                uses = _profiler_uses(fh.read())
            if uses:
                seen.add(rel)
                if rel not in ALLOWED:
                    offenders.append((rel, uses))
    assert offenders == []
    assert seen == ALLOWED


def test_guard_catches_a_violation():
    bad = ("import torch.profiler\n"
           "from torch.profiler import profile\n"
           "from torch import profiler\n"
           "def f():\n"
           "    torch.profiler.profile()\n")
    uses = _profiler_uses(bad)
    assert "torch.profiler" in uses and "from torch.profiler" in uses
    assert "from torch import profiler" in uses
    assert uses.count("torch.profiler") == 2   # the import and the call
    assert _profiler_uses("self.profiler.start()\n") == []
