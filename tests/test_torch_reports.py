"""The port's four post-hoc reports (``ceph_tpu_torch/tools/
trace_report.py``, ``ts_report.py``, ``slo_report.py``,
``roofline_report.py``) against the JAX package's root tools, on the
CPU, and ``roofline.bench_block`` against the JAX package's.

Each package makes its own artifacts from a small cluster (12 OSDs, an
EC pool k=2 m=2 with a client p99 objective: JAX ``jax_rs`` on numpy,
the port ``torch_rs`` on the plain versions): a ``trace dump``, a
``flight dump`` bundle and a bench-shaped line (``efficiency`` from
``roofline.bench_block``, ``slo`` from the cluster's SLO block).  On
every artifact the root tool and the port's (both loaded by path) must
print the same text and the same ``--json``.  chip_smoke's phases
soak, corpus and reports run here too, with ``device="cpu"``.
"""
import contextlib
import importlib.util
import io
import json
from pathlib import Path

import numpy as np
import pytest

from ceph_tpu.common import roofline as jax_roofline
from ceph_tpu_torch.common import roofline

ROOT = Path(__file__).resolve().parents[1]
TOOLS = ("trace_report", "ts_report", "slo_report", "roofline_report")


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tools():
    return {t: (_load(f"root_{t}", ROOT / "tools" / f"{t}.py"),
                _load(f"port_{t}", ROOT / "ceph_tpu_torch" / "tools" /
                      f"{t}.py"))
            for t in TOOLS}


def _record_rows(mod) -> None:
    """Three ledger rows, the same in both packages' roofline modules."""
    mod.reset()
    for i, (label, nbytes, calls) in enumerate((
            ("gf_apply", 6 << 20, 5), ("crc32c_rows", 4 << 20, 3),
            ("xor_apply", 1 << 20, 1))):
        key = (((8, 4096), "uint8"), i)
        mod.record_compile(label, key, 0.0, float(nbytes))
        for j in range(calls):
            mod.record_call(label, key, 1e-3 * (i + 1), synced=j == 0)


def _cluster_artifacts(pkg: str, out: Path) -> dict:
    """The trace dump, a flight bundle and a bench line of one package."""
    if pkg == "jax":
        from ceph_tpu.cluster import MiniCluster
        from ceph_tpu.common import Context, default_context
        rl, device, platform = jax_roofline, "numpy", None
    else:
        from ceph_tpu_torch.cluster import MiniCluster
        from ceph_tpu_torch.common import Context, default_context
        rl, device, platform = roofline, "cpu", "cpu"
    _record_rows(rl)
    c = MiniCluster(n_osds=12, osds_per_host=3, chunk_size=512,
                    cct=Context(overrides={"slo_client_p99_ms": 50.0}))
    try:
        pid = c.create_ec_pool("p", {"k": "2", "m": "2", "device": device},
                               pg_num=4)
        rng = np.random.default_rng(5)
        data = {f"o{i}": rng.integers(0, 256, 1500 + 300 * i,
                                      dtype=np.uint8).tobytes()
                for i in range(12)}
        for oid, d in data.items():
            c.put(pid, oid, d)
        for oid, d in data.items():
            assert c.get(pid, oid, len(d)) == d
        c.status()
        c.critpath.refresh()
        c.ts.record(force=True)
        bundle = c.flight.dump("report-test", force=True)
        line = {"metric": "m", "value": 100.0, "unit": "MiB/s",
                "device": "cpu", "efficiency": rl.bench_block(platform),
                "slo": c.slo.bench_block("cpu")}
    finally:
        c.shutdown()
    paths = {}
    for name, doc in (("trace", json.loads(default_context().admin_socket
                                           .call_json("trace dump"))),
                      ("flight", bundle), ("line", line),
                      ("snapshot", rl.snapshot())):
        paths[name] = out / f"{name}.json"
        paths[name].write_text(json.dumps(doc, default=str))
    (out / "flight").mkdir()
    (out / "flight" / "flight-1-1-0001-x.json").write_text(
        paths["flight"].read_text())
    paths["flight_dir"] = out / "flight"
    return paths


@pytest.fixture(scope="module", params=["jax", "port"])
def artifacts(request, tmp_path_factory):
    return _cluster_artifacts(request.param,
                              tmp_path_factory.mktemp(request.param))


def _run(mod, argv) -> tuple:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main([str(a) for a in argv])
    return rc, buf.getvalue()


CASES = [
    ("trace_report", "trace", []),
    ("trace_report", "trace", ["--json"]),
    ("trace_report", "trace", ["--limit", "5"]),
    ("trace_report", "trace", ["--traces"]),
    ("trace_report", "trace", ["--trace-id", "FIRST"]),
    ("ts_report", "flight", []),
    ("ts_report", "flight", ["--json"]),
    ("ts_report", "flight", ["--log"]),
    ("ts_report", "flight_dir", ["--coarse", "--series", "client"]),
    ("slo_report", "line", []),
    ("slo_report", "line", ["--json"]),
    ("slo_report", "flight", []),
    ("slo_report", "flight", ["--json"]),
    ("slo_report", "trace", []),
    ("slo_report", "trace", ["--json"]),
    ("roofline_report", "line", []),
    ("roofline_report", "line", ["--json"]),
    ("roofline_report", "flight", ["--limit", "2"]),
    ("roofline_report", "snapshot", ["--json"]),
]


@pytest.mark.parametrize("tool,artifact,argv", CASES,
                         ids=[f"{t}-{a}-{'_'.join(v) or 'text'}"
                              for t, a, v in CASES])
def test_root_and_port_tool_print_the_same(tools, artifacts, tool,
                                           artifact, argv):
    root_mod, port_mod = tools[tool]
    path = artifacts[artifact]
    if "FIRST" in argv:
        _rc, listed = _run(port_mod, [path, "--traces"])
        argv = [a if a != "FIRST" else listed.splitlines()[1].split()[0]
                for a in argv]
    root = _run(root_mod, [path, *argv])
    got = _run(port_mod, [path, *argv])
    assert root[0] == 0 and root[1].strip()
    assert got == root


def test_reports_see_the_artifacts(tools, artifacts):
    """The artifacts carry what the reports read: spans, a trace tree,
    time series, the client class, the objective and three rows."""
    port = {t: m[1] for t, m in tools.items()}
    spans = json.loads(_run(port["trace_report"],
                            [artifacts["trace"], "--json"])[1])["spans"]
    assert spans and all(s["p99_ms"] >= s["p50_ms"] for s in spans)
    ts = json.loads(_run(port["ts_report"],
                         [artifacts["flight"], "--json"])[1])
    assert ts["series"] and ts["points"] >= 1
    for artifact in ("line", "flight"):
        slo = json.loads(_run(port["slo_report"],
                              [artifacts[artifact], "--json"])[1])
        assert slo["classes"]["client"]["ops"] >= 12
        assert slo["burn"]["client"]["objective_p99_ms"] == 50.0
    eff = json.loads(_run(port["roofline_report"],
                          [artifacts["line"], "--json"])[1])
    assert {r["function"] for r in eff["executables"]} >= {
        "gf_apply", "crc32c_rows", "xor_apply"}


@pytest.mark.parametrize("tool", ["trace_report", "roofline_report",
                                  "slo_report"])
def test_error_exits_match(tools, tmp_path, tool):
    """An artifact with nothing to report exits as the root tool does."""
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"traceEvents": []}))
    root_mod, port_mod = tools[tool]
    with contextlib.redirect_stderr(io.StringIO()):
        assert _run(port_mod, [empty]) == _run(root_mod, [empty])


def test_reports_load_the_ports_percentile_and_critpath(tools):
    """The port's tools load the port's own stdlib modules by path."""
    pkg = ROOT / "ceph_tpu_torch" / "common"
    for tool in ("trace_report", "ts_report"):
        assert Path(tools[tool][1]._PCTL_PATH).resolve() == \
            pkg / "percentile.py"
    assert Path(tools["slo_report"][1]._critpath.__file__).resolve() == \
        pkg / "critpath.py"


@pytest.mark.parametrize("filled", [False, True])
def test_bench_block_keys_match_the_jax_one(filled):
    if filled:
        _record_rows(jax_roofline)
        _record_rows(roofline)
    else:
        jax_roofline.reset()
        roofline.reset()
    try:
        want = jax_roofline.bench_block(None)
        got = roofline.bench_block(None)
        assert sorted(got) == sorted(want)
        if filled:
            assert got["device"] == want["device"] == "cpu"
            assert [sorted(r) for r in got["executables"]] == \
                [sorted(r) for r in want["executables"]]
            assert [r["executable"] for r in got["executables"]] == \
                [r["executable"] for r in want["executables"]]
            assert roofline.bench_block("gpu", limit=2)["device"] == "cpu"
            assert len(roofline.bench_block(None, limit=2)
                       ["executables"]) == 2
        else:
            assert got == want == {"device": "none",
                                   "error": "no executables recorded"}
    finally:
        jax_roofline.reset()
        roofline.reset()


def test_bench_block_marks_a_card_ledger_gpu():
    roofline.reset()
    try:
        key = (((4, 8), "uint8"), 0)
        roofline.record_compile("gf_apply", key, 0.0, 1e6,
                                meta={"route": "cuda"})
        roofline.record_call("gf_apply", key, 1e-3, synced=True,
                             clock="cuda_event")
        assert roofline.bench_block("gpu")["device"] == "gpu"
        assert roofline.bench_block(None)["device"] == "cpu"
    finally:
        roofline.reset()


# -- chip_smoke's phases soak, corpus and reports, on the CPU ----------------

def test_chip_smoke_phases_on_the_cpu():
    chip_smoke = _load("chip_smoke", ROOT / "chip_smoke.py")
    from ceph_tpu_torch.ops import launch_ledger as LL
    from ceph_tpu_torch.ops import rs_kernels as K
    LL.reset()          # a fresh process: every booked key has its row
    roofline.reset()
    soak, art, n_soak = chip_smoke.phase_soak(K, LL, device="cpu")
    assert soak["ec"]["model_held"] and soak["ec"]["final_scrub_clean"]
    assert soak["ec"]["ledger_launches"]["gf_apply"] > 0
    assert soak["ec"]["ledger_launches"]["crc32c_rows"] > 0
    assert sum(soak["ec"]["actions"].values()) == 300
    assert n_soak == dict.fromkeys(n_soak, 0)    # plain calls: uncounted
    corpus, n_corpus = chip_smoke.phase_corpus(K, LL, device="cpu")
    assert corpus["entries"] == 19 and corpus["digests_equal"]
    assert corpus["ledger_launches"]["xor_apply"] > 0
    serving = {"small_ops": {"runs": [
        {"batched": {"ops_s": v, "p99_ms": 1.0 + v / 1e4}}
        for v in (900.0, 1100.0, 1000.0)]}}
    clus = {"repair_wave": {"repair": {
        "rebuilt_MiBps": 500.0, "wire_bytes_per_repaired_byte": 8.5}}}
    blocks = chip_smoke.bench_blocks(serving, clus, "cpu")
    assert blocks[0]["batched"] == {"ops_s": 1000.0, "p99_ms": 1.1}
    out = chip_smoke.phase_reports(LL, art, 1234.5, *blocks,
                                   platform="cpu")
    assert out["roofline"]["rows"] >= out["roofline"]["ledger_keys"] > 0
    assert out["trace"]["rows"] > 0 and out["trace"]["tree_lines"] > 1
    assert "client" in out["flight"]["slo_classes"]
    assert out["gate"]["metrics"] == [
        "core.mib_s", "efficiency.pct_of_peak", "recovery.mib_s",
        "recovery.wire_per_byte", "serving.ops_s", "serving.p99_ms",
        "slo.client_p99_ms"]
    assert out["gate"]["self"].startswith("PERF GATE: PASS (7 metrics")
    assert "platform fallback" in out["gate"]["expect_tpu"]
