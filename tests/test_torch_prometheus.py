"""The port's prometheus exporter against the JAX package's, on the CPU.

One fresh interpreter (the exporters read process-wide registries, which
other tests in a worker would have filled) feeds the same counters,
spans, device batches, roofline rows and launch telemetry to both
packages and renders each with ``mgr.prometheus.render``; the two
texts must be equal line for line but for these, each named:

- values derived from a clock: the device-attribution seconds
  (``ceph_tpu_device_time_seconds``, ``ceph_tpu_*_device_time_sum``,
  ``ceph_tpu_busy_time_sum``), each the interval from a dispatch mark
  to its completion;
- the ``device`` collection, which describes each package's own
  backend (JAX's devices and compile cache, ``torch.cuda`` and the hand
  kernels built): its values and HELP text;
- the HELP text of the trace and compile stage times (a hand kernel has
  no trace step; its "compile" is the library's build or load).

Beside it: a scrape of a live port cluster parses (HELP and TYPE once a
family, every sample under a declared family) and carries the families
an operator's dashboards read, and a scrape never initialises CUDA.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CLOCK_VALUES = ("ceph_tpu_device_time_seconds{",
                "ceph_tpu_busy_time_sum{")
BACKEND_VALUES = '{collection="device"}'
CLOCK_SUFFIX = re.compile(r"^ceph_tpu_\w+_device_time_sum\{")
OWN_HELP = ("num_devices", "live_buffer_bytes", "mem_bytes_in_use",
            "mem_peak_bytes_in_use", "mem_bytes_limit",
            "hbm_high_water_bytes", "compile_cache_keys", "trace_time",
            "compile_time")

_FEED = r"""
import json, sys
import numpy as np

def feed(pkg):
    import importlib
    common = importlib.import_module(pkg + ".common")
    tracer = importlib.import_module(pkg + ".common.tracer")
    roofline = importlib.import_module(pkg + ".common.roofline")
    attr = importlib.import_module(pkg + ".common.device_attribution")
    prom = importlib.import_module(pkg + ".mgr.prometheus")
    pc_mod = importlib.import_module(pkg + ".common.perf_counters")
    cct = common.Context()
    pc = (pc_mod.PerfCountersBuilder("probe")
          .add_u64_counter("ops", "probe ops")
          .add_u64("depth", "probe depth")
          .add_time_avg("op_lat", "probe latency")
          .add_histogram("op_size", [64.0, 4096.0], "probe sizes")
          .create_perf_counters())
    cct.perf.add(pc)
    for i in range(5):
        pc.inc("ops")
        pc.tinc("op_lat", 0.25 * (i + 1))
        pc.hinc("op_size", 10.0 ** i)
    pc.set("depth", 7)
    tr = tracer.default_tracer()
    for i, dur in enumerate((0.0025, 0.04, 3e-5, 0.7)):
        tr.observe("probe.span" if i % 2 else "probe.other", 100.0,
                   100.0 + dur)
    for owner in ("client", "recovery", "client"):
        attr.record_batch(owner, attr.dispatch_mark(), 4096)
    key = (((4, 8), "uint8"), ((8, 524288), "uint8"))
    roofline.record_compile("gf_apply", key, 0.0, 6291456.0)
    for s in (0.004, 0.00002, 0.00003):
        roofline.record_call("gf_apply", key, s, synced=s > 0.001)
    jkey = ("gf_apply", (4, 8), 8, 524288)
    tracer.record_compilation("gf_apply", jkey, 0.0, 0.125, 0.0625)
    for _ in range(3):
        tracer.record_cache_hit("gf_apply", jkey)
    return prom.render(cct)

print(json.dumps({"jax": feed("ceph_tpu"), "port": feed("ceph_tpu_torch")}))
"""


@pytest.fixture(scope="module")
def renders():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _FEED], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _masked(text: str) -> list[str]:
    out = []
    for line in text.splitlines():
        if line.startswith(CLOCK_VALUES) or CLOCK_SUFFIX.match(line):
            line = line.rsplit(" ", 1)[0] + " <clock>"
        elif BACKEND_VALUES in line:
            line = line.rsplit(" ", 1)[0] + " <backend>"
        elif line.startswith("# HELP ") and \
                line.split()[2].removeprefix("ceph_tpu_") in OWN_HELP:
            line = " ".join(line.split()[:3]) + " <backend>"
        out.append(line)
    return out


def test_render_equals_the_jax_package_line_for_line(renders):
    want, got = _masked(renders["jax"]), _masked(renders["port"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w
    text = renders["port"]
    for family in ("ceph_tpu_ops", "ceph_tpu_op_lat", "ceph_tpu_op_size",
                   "ceph_tpu_span_latency_seconds",
                   "ceph_tpu_device_time_seconds",
                   "ceph_tpu_device_efficiency", "ceph_tpu_compilations",
                   "ceph_tpu_cache_hits", "ceph_tpu_pct_of_peak_x100"):
        assert f"# TYPE {family} " in text, family
    assert 'ceph_tpu_compilations{collection="jit"} 1' in text
    assert 'ceph_tpu_cache_hits{collection="jit"} 3' in text
    assert 'ceph_tpu_compile_time_sum{collection="jit"} 0.125' in text


def test_the_backend_masks_are_needed(renders):
    """The backend masks hide lines that do differ (the clock masks hide
    intervals, which differ or not by chance)."""
    jl, pl = renders["jax"].splitlines(), renders["port"].splitlines()
    differing = {j.split()[2] if j.startswith("#") else
                 j.split("{")[0] for j, p in zip(jl, pl) if j != p}
    assert {"ceph_tpu_num_devices", "ceph_tpu_trace_time",
            "ceph_tpu_compile_time", "ceph_tpu_live_buffer_bytes"} <= \
        differing


def _parse(text: str) -> tuple[dict, list]:
    helps, types, samples = {}, {}, []
    for line in text.splitlines():
        if line.startswith("# HELP "):
            name = line.split()[2]
            helps[name] = helps.get(name, 0) + 1
        elif line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            assert name not in types, name
            types[name] = kind
        elif line:
            samples.append(re.match(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)",
                                    line)[1])
    return {"helps": helps, "types": types}, samples


def test_live_cluster_scrape_parses(tmp_path):
    import numpy as np
    from ceph_tpu_torch.cluster import MiniCluster
    from ceph_tpu_torch.common import Context
    from ceph_tpu_torch.mgr import prometheus
    c = MiniCluster(n_osds=6, osds_per_host=2, chunk_size=256,
                    cct=Context(), data_dir=tmp_path,
                    store_backend="bluestore")
    try:
        pid = c.create_ec_pool("p", {"k": "2", "m": "1", "device": "cpu"},
                               pg_num=4)
        for i in range(4):
            c.put(pid, f"o{i}", np.full(3000, i, np.uint8).tobytes())
        c.health()
        text = prometheus.render(c.cct)
    finally:
        c.shutdown()
    fams, samples = _parse(text)
    assert set(fams["helps"]) == set(fams["types"])
    assert all(n == 1 for n in fams["helps"].values())
    types = fams["types"]
    for m in samples:
        assert m in types or any(
            m == f + sfx and types[f] in ("histogram", "summary")
            for f in types for sfx in ("_bucket", "_sum", "_count")), m
    for family in ("ceph_tpu_health_status", "ceph_tpu_stats_rate",
                   "ceph_tpu_device_efficiency", "ceph_tpu_wire_bytes",
                   "ceph_tpu_copy_state", "ceph_tpu_pg_heat"):
        assert family in types, family
    assert 'ceph_tpu_device_efficiency{executable="gf_apply_' in text


_NO_INIT = r"""
import json, torch
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 1
calls = []
def init(*a, **k):
    calls.append("init")
    raise RuntimeError("a scrape initialised CUDA")
torch.cuda.init = init
torch.cuda._lazy_init = init
torch.cuda.get_device_name = init
from ceph_tpu_torch.common import Context, device_telemetry
from ceph_tpu_torch.mgr import prometheus
text = prometheus.render(Context())
print(json.dumps({"calls": calls, "inv": device_telemetry.device_inventory(),
                  "ok": "ceph_tpu_num_devices" in text}))
"""


def test_scrape_never_initialises_cuda():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", _NO_INIT], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["calls"] == [] and out["ok"]
    assert out["inv"]["platform"] == "gpu"
    assert out["inv"]["device_kind"] == "unknown"
