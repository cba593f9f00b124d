"""The port stands alone: no JAX and nothing of ``ceph_tpu``.

tests/conftest.py imports JAX into every test process, so the runtime
check runs a fresh interpreter.  The static check walks every import of
the port's sources and of chip_smoke.py.
"""
import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ceph_tpu_torch.backend import ecutil
from ceph_tpu_torch.ops import rs_kernels
from ceph_tpu_torch.ops.codec import RSCodec
from ceph_tpu_torch.plugins.registry import ErasureCodePluginRegistry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "ceph_tpu_torch")

_PROBE = """
import json, sys
import numpy as np
from ceph_tpu_torch.backend import ecutil
from ceph_tpu_torch.bench import ec_bench
from ceph_tpu_torch import convert
from ceph_tpu_torch.plugins.registry import ErasureCodePluginRegistry
ec = ErasureCodePluginRegistry.instance().factory(
    "torch_rs", "", {"k": "4", "m": "2", "device": "cpu"})
sinfo = ecutil.StripeInfo(4, ec.get_chunk_size(4 * 128))
buf = np.random.default_rng(0).integers(0, 256, sinfo.stripe_width * 3,
                                        dtype=np.uint8)
shards = ecutil.encode_many(sinfo, ec, [buf])[0]
h = ecutil.HashInfo(6)
ecutil.hinfo_append(h, 0, shards, ec)
out = ecutil.decode_many(sinfo, ec, [{c: v for c, v in shards.items()
                                      if c not in (0, 5)}])
assert out[0] == buf.tobytes()
reg = ErasureCodePluginRegistry.instance()
for name, profile in (
        ("jerasure", {"technique": "liber8tion", "k": "4",
                      "packetsize": "16"}),
        ("jerasure", {"technique": "reed_sol_van", "k": "4", "m": "2",
                      "w": "16", "packetsize": "8"}),
        ("isa", {"k": "4", "m": "2"}),
        ("shec", {"k": "4", "m": "3", "c": "2"})):
    ec = reg.factory(name, "", profile | {"device": "cpu"})
    n = ec.get_chunk_count()
    sinfo = ecutil.StripeInfo(4, ec.get_chunk_size(4 * 128))
    buf = np.random.default_rng(1).integers(0, 256, sinfo.stripe_width * 2,
                                            dtype=np.uint8)
    shards = ecutil.encode_many(sinfo, ec, [buf])[0]
    ecutil.hinfo_append(ecutil.HashInfo(n), 0, shards, ec)
    out = ecutil.decode_many(sinfo, ec, [{c: v for c, v in shards.items()
                                          if c not in (0, n - 1)}])
    assert out[0] == buf.tobytes(), (name, profile)
from ceph_tpu_torch import common, failure, osd
from ceph_tpu_torch.exec import ServingEngine, workload
from ceph_tpu_torch.ops import pipeline
ec = ErasureCodePluginRegistry.instance().factory(
    "torch_rs", "", {"k": "4", "m": "2", "device": "cpu"})
sinfo = ecutil.StripeInfo(4, 1024)
eng = ServingEngine(ec_impl=ec, sinfo=sinfo, name="probe").start()
pays = workload.make_payloads(sinfo.stripe_width, 4)
res = workload.closed_loop(eng, 16, 4, payloads=pays)
assert res["ops"] == 16 and eng.pipeline.perf.get("completed") >= 1
assert eng.pipeline.perf.get("errors") == 0
eng.stop()
from ceph_tpu_torch.backend.ecutil import (
    decode_shards, decode_shards_many, partial_sum_accumulate,
    regen_combine, regen_project)
from ceph_tpu_torch.plugins import (plugin_clay, plugin_lrc,
                                    plugin_pm_regen, plugin_xor)
pl = pipeline.CodecPipeline(depth=2, name="probe.repair")
ec = reg.factory("torch_rs", "", {"k": "4", "m": "2", "device": "cpu"})
sinfo = ecutil.StripeInfo(4, 512)
buf = np.random.default_rng(2).integers(0, 256, sinfo.stripe_width * 2,
                                        dtype=np.uint8)
obj = ecutil.encode_many(sinfo, ec, [buf])[0]
coeffs, rows = ec.partial_sum_coefficients({0}, [1, 2, 3, 4])
acc = None
for src in (1, 2, 3, 4):
    acc = partial_sum_accumulate(coeffs[src], obj[src], acc, pipeline=pl,
                                 device="cpu")
assert rows == [0] and acc[0] == obj[0].tobytes()
got = decode_shards_many(sinfo, ec, [({c: obj[c] for c in (0, 2, 3, 5)},
                                      {1})], pipeline=pl)
assert got[0][1].tobytes() == obj[1].tobytes()
assert decode_shards(sinfo, ec, {c: obj[c] for c in range(1, 5)},
                     {0})[0].tobytes() == obj[0].tobytes()
pm = reg.factory("pm_regen", "", {"k": "3", "m": "2", "d": "4",
                                  "mode": "mbr", "device": "cpu"})
enc = pm.encode(set(range(5)), bytes(range(256)) * 12)
helpers = pm.minimum_to_repair(2, 4, {c: 1 for c in (0, 1, 3, 4)})
alpha = pm.get_sub_chunk_count()
betas = [regen_project(pm.repair_projection(2).tobytes(), enc[h], alpha,
                       pipeline=pl, device="cpu")
         for h in helpers]
assert regen_combine(pm.repair_combine(2, helpers).tobytes(), betas, alpha,
                     pipeline=pl, device="cpu") == enc[2].tobytes()
for name, profile in (("xor", {"k": "3"}),
                      ("clay", {"k": "4", "m": "2", "device": "cpu"}),
                      ("lrc", {"k": "4", "m": "2", "l": "3",
                               "device": "cpu"})):
    ec = reg.factory(name, "", profile)
    n = ec.get_chunk_count()
    enc = ec.encode(set(range(n)), bytes(range(256)) * 8)
    assert ec.decode({1}, {c: v for c, v in enc.items() if c != 1})[1] \
        .tobytes() == enc[1].tobytes(), name
assert pl.perf.get("errors") == 0 and pl.perf.get("completed") == 10
pl.close()
import io
from ceph_tpu_torch.crush import CRUSH_BUCKET_STRAW2, CrushMap
from ceph_tpu_torch.mgr import calc_pg_upmaps
from ceph_tpu_torch.osdmap import OSDMap, Pool
from ceph_tpu_torch.tools import crushtool, osdmaptool
cm = CrushMap()
cm.set_type_name(1, "host")
cm.set_type_name(2, "root")
hosts = [cm.add_bucket(CRUSH_BUCKET_STRAW2, 1, list(range(3 * h, 3 * h + 3)),
                       [0x10000] * 3) for h in range(4)]
root = cm.add_bucket(CRUSH_BUCKET_STRAW2, 2, hosts, [0x30000] * 4)
cm.set_item_name(root, "default")
cm.finalize()
om = OSDMap(crush=cm)
for o in range(12):
    om.create_osd(o)
om.add_pool(Pool(pool_id=1, size=3, pg_num=64, name="rbd",
                 crush_rule=cm.add_simple_rule("replicated_rule", "default",
                                               "host")))
report = io.StringIO()
st = osdmaptool.test_map_pgs(om, out=report, device="cpu")
assert st["total"] == 3 * 64 and "pool 1 pg_num 64" in report.getvalue()
crushtool.test_rule(cm, 0, 3, 0, 63, device="cpu")
calc_pg_upmaps(om, max_iterations=2, device="cpu")
print(json.dumps(sorted(m for m in sys.modules
                        if m == "jax" or m.startswith("jax.")
                        or m == "jaxlib" or m.startswith("jaxlib.")
                        or m == "ceph_tpu" or m.startswith("ceph_tpu."))))
"""


def _port_env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    return env


def test_port_never_loads_jax_or_the_jax_package():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                          env=_port_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def _port_sources():
    for dirpath, _dirs, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_imports_jax_or_ceph_tpu():
    sources = list(_port_sources())
    assert len(sources) > 15 and all(os.path.exists(p) for p in sources)
    bad = []
    for path in sources:
        for name in _imports(path):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "ceph_tpu"):
                bad.append((os.path.relpath(path, ROOT), name))
    assert bad == []


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rs_kernels.reset_launches()


def test_cuda_codec_without_a_card_raises(no_card):
    data = np.zeros((4, 256), np.uint8)
    codec = RSCodec(4, 2, device="cuda")
    for call in (lambda: codec.encode(data),
                 lambda: codec.decode({i: data[0] for i in range(1, 5)}, [0]),
                 lambda: codec.to_device(data)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    assert codec.parity_uploads == 0
    assert rs_kernels.launches == {"gf_apply": 0, "gf_apply_stripes": 0,
                                   "xor_apply": 0, "crc32c_rows": 0}


def test_plugin_on_cuda_without_a_card_raises(no_card):
    reg = ErasureCodePluginRegistry()
    ec = reg.factory("torch_rs", "", {"k": "4", "m": "2", "device": "cuda"})
    with pytest.raises(RuntimeError, match="cuda"):
        ec.encode(set(range(6)), b"\x01" * 4096)
    # auto: under the threshold the host codec answers, at it the card
    # is required and its absence raises
    auto = reg.factory("torch_rs", "", {"k": "4", "m": "2", "device": "auto",
                                        "device-threshold": "65536"})
    assert len(auto.encode(set(range(6)), b"\x01" * 4096)) == 6
    with pytest.raises(RuntimeError, match="cuda"):
        auto.encode(set(range(6)), b"\x01" * 65536)
    sinfo = ecutil.StripeInfo(4, 128)
    shards = {c: np.zeros(128, np.uint8) for c in range(6)}
    with pytest.raises(RuntimeError, match="cuda"):
        ecutil.hinfo_append(ecutil.HashInfo(6), 0, shards, ec)
    with pytest.raises(RuntimeError, match="cuda"):
        ecutil.encode_many(sinfo, ec, [np.zeros(512, np.uint8)])
    assert rs_kernels.launches == {"gf_apply": 0, "gf_apply_stripes": 0,
                                   "xor_apply": 0, "crc32c_rows": 0}


def test_plugin_without_a_device_key_runs_on_cuda(no_card):
    """No ``device`` in the profile means cuda: a call far under the auto
    threshold still goes to the card, and without one it raises."""
    reg = ErasureCodePluginRegistry()
    ec = reg.factory("torch_rs", "", {"k": "4", "m": "2"})
    assert ec.get_profile()["device"] == "cuda"
    assert ec.device_codec(4096) is ec.codec
    with pytest.raises(RuntimeError, match="cuda"):
        ec.encode(set(range(6)), b"\x01" * 4096)
    enc = reg.factory("torch_rs", "", {"k": "4", "m": "2", "device": "numpy"}
                      ).encode(set(range(6)), b"\x01" * 4096)
    with pytest.raises(RuntimeError, match="cuda"):
        ec.decode(set(range(6)), {i: enc[i] for i in range(2, 6)})
    sinfo = ecutil.StripeInfo(4, 128)
    with pytest.raises(RuntimeError, match="cuda"):
        ecutil.encode_many(sinfo, ec, [np.zeros(512, np.uint8)])
    assert rs_kernels.launches == {"gf_apply": 0, "gf_apply_stripes": 0,
                                   "xor_apply": 0, "crc32c_rows": 0}


@pytest.mark.parametrize("depth", [0, 4])
def test_serving_engine_without_a_card_raises(no_card, depth):
    """A ServingEngine over a torch_rs plugin with no ``device`` key
    serves on the card: without one every submit fails with the card's
    error, nothing answers on the host, and no kernel launch counts."""
    from ceph_tpu_torch.exec import ServingEngine
    reg = ErasureCodePluginRegistry()
    ec = reg.factory("torch_rs", "", {"k": "4", "m": "2"})
    sinfo = ecutil.StripeInfo(4, 1024)
    eng = ServingEngine(ec_impl=ec, sinfo=sinfo, name=f"nocard{depth}",
                        pipeline_depth=depth)
    try:
        with pytest.raises(RuntimeError, match="cuda"):
            eng.encode(np.zeros(sinfo.stripe_width, np.uint8))
        enc = ecutil.encode_many(
            sinfo, reg.factory("torch_rs", "", {"k": "4", "m": "2",
                                                "device": "numpy"}),
            [np.ones(sinfo.stripe_width, np.uint8)])[0]
        fut = eng.submit_decode({c: enc[c] for c in range(1, 5)})
        eng.flush()
        with pytest.raises(RuntimeError, match="cuda"):
            fut.result(5)
        assert eng.perf.get("ops_failed") == 2
        assert eng.pipeline.perf.get("completed") == 0
    finally:
        eng.stop()
    assert rs_kernels.launches == {"gf_apply": 0, "gf_apply_stripes": 0,
                                   "xor_apply": 0, "crc32c_rows": 0}


@pytest.mark.parametrize("name,profile", [
    ("jerasure", {"technique": "liber8tion", "k": "4", "packetsize": "16"}),
    ("jerasure", {"technique": "reed_sol_van", "k": "4", "m": "2",
                  "w": "16", "packetsize": "8"}),
    ("jerasure", {"technique": "cauchy_good", "k": "4", "m": "2"}),
    ("isa", {"k": "4", "m": "2"}),
    ("shec", {"k": "4", "m": "3", "c": "2"}),
])
def test_new_plugins_without_a_device_key_need_the_card(no_card, name,
                                                        profile):
    """jerasure, isa and shec with no ``device`` key run on cuda: without
    a card encode and decode raise, nothing falls back, no launch counts."""
    reg = ErasureCodePluginRegistry()
    ec = reg.factory(name, "", profile)
    assert ec.get_profile()["device"] == "cuda"
    n = ec.get_chunk_count()
    data = b"\x05" * 3000
    with pytest.raises(RuntimeError, match="cuda"):
        ec.encode(set(range(n)), data)
    enc = reg.factory(name, "", profile | {"device": "numpy"}
                      ).encode(set(range(n)), data)
    with pytest.raises(RuntimeError, match="cuda"):
        ec.decode(set(range(n)), {i: enc[i] for i in range(1, n)})
    sinfo = ecutil.StripeInfo(4, ec.get_chunk_size(4 * 128))
    with pytest.raises(RuntimeError, match="cuda"):
        ecutil.encode_many(sinfo, ec,
                           [np.zeros(sinfo.stripe_width, np.uint8)])
    assert rs_kernels.launches == {"gf_apply": 0, "gf_apply_stripes": 0,
                                   "xor_apply": 0, "crc32c_rows": 0}


@pytest.mark.parametrize("name,profile", [
    ("pm_regen", {"k": "3", "m": "2", "d": "4", "mode": "mbr"}),
    ("pm_regen", {"k": "3", "m": "2", "d": "4", "mode": "msr"}),
    ("clay", {"k": "4", "m": "2"}),
    ("clay", {"k": "4", "m": "2", "scalar_mds": "torch_rs"}),
    ("lrc", {"k": "4", "m": "2", "l": "3"}),
])
def test_repair_plugins_without_a_device_key_need_the_card(no_card, name,
                                                           profile):
    """pm_regen, clay and lrc with no ``device`` key run their products on
    the card: without one encode raises, nothing answers on the host, no
    launch counts."""
    reg = ErasureCodePluginRegistry()
    ec = reg.factory(name, "", profile)
    n = ec.get_chunk_count()
    data = bytes(range(256)) * 40
    with pytest.raises(RuntimeError, match="cuda"):
        ec.encode(set(range(n)), data)
    enc = reg.factory(name, "", profile | {"device": "numpy"}).encode(
        set(range(n)), data)
    with pytest.raises(RuntimeError, match="cuda"):
        ec.decode({0}, {c: v for c, v in enc.items() if c != 0})
    assert rs_kernels.launches == {"gf_apply": 0, "gf_apply_stripes": 0,
                                   "xor_apply": 0, "crc32c_rows": 0}


def _repair_leg(leg: str, data: np.ndarray, **kw):
    if leg == "partial_sum":
        return ecutil.partial_sum_accumulate([3], data, [data], **kw)
    if leg == "regen_project":
        return ecutil.regen_project(b"\x01\x02", data, 2, **kw)
    return ecutil.regen_combine(b"\x01\x02\x03\x04", [data, data], 2, **kw)


@pytest.mark.parametrize("leg", ["partial_sum", "regen_project",
                                 "regen_combine"])
def test_repair_legs_default_to_the_card(no_card, leg):
    """Called with their defaults (no device, no pipeline), the repair
    legs run on the card: without one they raise, and the host GF math
    answers only when the caller names ``device="numpy"``."""
    data = np.arange(512, dtype=np.uint8)
    with pytest.raises(RuntimeError, match="cuda"):
        _repair_leg(leg, data)
    assert _repair_leg(leg, data, device="numpy") == \
        _repair_leg(leg, data, device="cpu")
    assert rs_kernels.launches["gf_apply"] == 0


def test_repair_legs_on_cuda_without_a_card_raise(no_card):
    """The repair legs name their device; cuda without a card raises
    before anything is packed, and nothing runs on the host."""
    from ceph_tpu_torch.ops.pipeline import CodecPipeline
    pl = CodecPipeline(depth=2, name="nocard.repair")
    data = np.ones(512, np.uint8)
    try:
        for leg in ("partial_sum", "regen_project", "regen_combine"):
            with pytest.raises(RuntimeError, match="cuda"):
                _repair_leg(leg, data, pipeline=pl)
            with pytest.raises(RuntimeError, match="cuda"):
                _repair_leg(leg, data, pipeline=pl, device="cuda")
        assert pl.perf.get("submitted") == 0
    finally:
        pl.close()
    codec = RSCodec(4, 2, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        codec.encode_with_crc(np.zeros((4, 256), np.uint8))
    assert rs_kernels.launches == {"gf_apply": 0, "gf_apply_stripes": 0,
                                   "xor_apply": 0, "crc32c_rows": 0}


_SWEEP_PROBE = """
import json, sys
from ceph_tpu_torch.tools import kernel_sweep
rc = kernel_sweep.main(["--quick"])
print(json.dumps({"rc": rc, "loaded": sorted(
    m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib",
                                                  "ceph_tpu"))}))
"""


def test_kernel_sweep_imports_without_jax_and_needs_a_card():
    """The sweep tool loads nothing of JAX; without a card main exits 2
    and sweeps nothing (the CLI too, with nothing on stdout)."""
    proc = subprocess.run([sys.executable, "-c", _SWEEP_PROBE], cwd=ROOT,
                          env=_port_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {
        "rc": 2, "loaded": []}
    assert "cuda" in proc.stderr
    cli = subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.tools.kernel_sweep",
         "--quick"], cwd=ROOT, env=_port_env(), capture_output=True,
        text=True, timeout=300)
    assert cli.returncode == 2 and cli.stdout == ""


def test_ec_bench_default_plugin_runs():
    """With no --plugin, ec_bench takes jerasure (the reference CLI's
    default), which the port now has."""
    proc = subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.bench.ec_bench", "-P",
         "device=cpu", "--size", "65536", "--iterations", "1"],
        cwd=ROOT, env=_port_env(), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    seconds, kib = lines[0].split("\t")
    assert float(seconds) > 0 and kib == "64"
