"""The port's serving load generator (``ceph_tpu_torch/tools/rados_bench.py``)
against the root ``tools/rados_bench.py`` of the JAX package, on the CPU.

Each arm runs at a few dozen ops in both tools with the same arguments:
the port with ``--device cpu`` (the kernels' plain PyTorch versions), the
root tool with ``--device numpy``.  Timings differ; the JSON keys, the op
and byte counts and the error counts must not.  The port's closed loop
adds one key, ``kind`` (``exec/workload.py`` drives encodes and degraded
reads alike).  The open loop's count of arrivals follows the clock, so
only its keys, op size and rejections are compared.  The key streams are
compared draw by draw; one subprocess shows a run loads no JAX.
"""
import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

from ceph_tpu_torch.exec.workload import WorkloadKeys
from ceph_tpu_torch.tools import rados_bench as port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def root():
    spec = importlib.util.spec_from_file_location(
        "root_rados_bench", os.path.join(ROOT, "tools", "rados_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(mod, argv, device, capsys) -> dict:
    capsys.readouterr()
    assert mod.main([*argv, "--device", device, "--json"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _keys(d, prefix="") -> set:
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, f"{prefix}{k}.")
    return out


SMALL = ["--ops", "32", "--concurrency", "8", "--warmup", "8"]


def _assert_closed_equal(got: dict, want: dict):
    assert _keys(got) == _keys(want) | {"kind"}
    assert got["kind"] == "encode"
    for key in ("mode", "ops", "concurrency", "op_bytes", "ops_coalesced",
                "ops_rejected"):
        assert got[key] == want[key], key
    assert got["ops_rejected"] == 0 and got["ops_coalesced"] == got["ops"]


def test_closed_loop_matches_root_tool(root, capsys):
    _assert_closed_equal(_run(port, SMALL, "cpu", capsys),
                         _run(root, SMALL, "numpy", capsys))


def test_unbatched_matches_root_tool(root, capsys):
    got = _run(port, [*SMALL, "--unbatched"], "cpu", capsys)
    want = _run(root, [*SMALL, "--unbatched"], "numpy", capsys)
    _assert_closed_equal(got, want)
    assert got["batches"] == want["batches"] == 32


def test_compare_matches_root_tool(root, capsys):
    got = _run(port, [*SMALL, "--compare"], "cpu", capsys)
    want = _run(root, [*SMALL, "--compare"], "numpy", capsys)
    assert set(got) == set(want)
    for arm in ("batched", "unbatched"):
        _assert_closed_equal(got[arm], want[arm])
    assert got["unbatched"]["batches"] == 32 and got["speedup"] > 0


def test_open_loop_matches_root_tool(root, capsys):
    argv = ["--mode", "open", "--rate", "200", "--seconds", "0.25",
            "--warmup", "4"]
    got = _run(port, argv, "cpu", capsys)
    want = _run(root, argv, "numpy", capsys)
    assert _keys(got) == _keys(want)
    assert got["op_bytes"] == want["op_bytes"] == 4096
    assert got["rejected"] == 0 and got["ops"] > 0


@pytest.mark.parametrize("extra", [[], ["--key-dist", "zipf:1.2",
                                        "--flash-crowd", "0.9:0.25:0.5"]])
def test_mux_matches_root_tool(root, capsys, extra):
    argv = ["--mode", "mux", "--clients", "64", "--ops-per-client", "2",
            "--conns", "4", *extra]
    got = _run(port, argv, "cpu", capsys)
    want = _run(root, argv, "numpy", capsys)
    assert _keys(got) == _keys(want)
    for arm in (got["capacity"], got["overload"]):
        assert arm["completed"] == 128
    assert got["capacity"]["failed"] == 0
    assert got["capacity"]["finished_in_time"]
    if extra:
        wl, wl_root = got["workload"], want["workload"]
        for key in ("dist", "zipf_s", "n_keys", "hot_set", "flash",
                    "keys_drawn"):
            assert wl[key] == wl_root[key], key


def test_flash_crowd_key_sequence_matches_root(root):
    """The same seed and the same arrival progress give the same keys."""
    progress = [i / 500 for i in range(500)]
    for kw in ({"dist": "zipf", "zipf_s": 1.2, "flash": (0.9, 0.25, 0.5)},
               {"dist": "uniform", "flash": (0.5, 0.0, 1.0)}):
        a = WorkloadKeys(n_keys=1000, seed=17, **kw)
        b = root.WorkloadKeys(n_keys=1000, seed=17, **kw)
        assert [a.key(p) for p in progress] == [b.key(p) for p in progress]
        assert a.describe() == b.describe()
        assert a.describe()["flash_draws"] > 0


def test_tier_mux_matches_root_tool(root):
    kw = dict(n_clients=24, ops_per_client=2, n_conns=2, n_objects=48,
              object_bytes=1024, timeout_s=60.0)
    got = port.run_tier_mux_bench(device="cpu", **kw)
    want = root.run_tier_mux_bench(device="numpy", **kw)
    assert _keys(got) == _keys(want)
    for seg in ("cold", "warm"):
        assert got[seg]["completed"] == want[seg]["completed"] == 48
        assert got[seg]["failed"] == want[seg]["failed"] == 0
    assert got["hot_objects"] == want["hot_objects"]
    assert got["workload"] == want["workload"]


def test_overhead_and_zero_copy_arms_match_root_tool(root):
    kw = dict(n_clients=8, ops_per_client=8, n_conns=2, rounds=1)
    got, want = (m.run_mux_overhead_bench(**kw) for m in (port, root))
    assert _keys(got) == _keys(want) and got["rounds"] == 1
    kw = dict(n_clients=8, ops_per_client=2, n_conns=2, payload_bytes=4096)
    got, want = (m.run_zero_copy_pair(**kw) for m in (port, root))
    assert _keys(got) == _keys(want)
    for arm in ("fused", "legacy"):
        assert got[arm]["completed"] == want[arm]["completed"] == 16
    assert (got["copies_per_byte"], got["legacy_copies_per_byte"]) == \
        (want["copies_per_byte"], want["legacy_copies_per_byte"])


def test_cuda_without_a_card_fails_rather_than_run_on_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        port.main(["--ops", "4", "--json"])
    with pytest.raises(RuntimeError, match="is_available"):
        port.main(["--ops", "4", "--device", "auto", "--json"])


def test_a_run_loads_no_jax():
    code = ("import sys\n"
            "from ceph_tpu_torch.tools import rados_bench\n"
            "rados_bench.main(['--device', 'cpu', '--ops', '8', "
            "'--concurrency', '4', '--warmup', '0', '--json'])\n"
            "rados_bench.main(['--mode', 'mux', '--clients', '16', "
            "'--conns', '2', '--json'])\n"
            "assert 'jax' not in sys.modules, 'jax loaded'\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [json.loads(ln) for ln in r.stdout.splitlines()]
    assert lines[0]["ops"] == 8 and lines[1]["capacity"]["completed"] == 32
