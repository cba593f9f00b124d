"""``chip_smoke.py``'s phase ``net`` on the CPU, at a small size.

The phase (a BlueStore MiniCluster of 12 OSDs on 4 hosts, pg_num 32,
torch_rs k=8 m=4 at a 4 KiB stripe unit, served over TCP with cephx and
HMAC frames: TcpRados puts, gets and degraded gets, the zero-copy arms,
the mux client's closed loop and overload arm, the transport fault plan,
the wire-mode bus, the sharded front end with a tier, and the CLIs as
processes) runs here with ``device=cpu`` at 64 KiB objects and cut
counts; every ``gf_apply`` and ``crc32c_rows`` call it makes, less the
front end's engine batches, must equal ``path_shapes.net_shapes`` at
the same sizes, shape by shape.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

from ceph_tpu_torch.backend import ecutil
from ceph_tpu_torch.ops import rs_kernels
from ceph_tpu_torch.plugins.registry import ErasureCodePluginRegistry
from ceph_tpu_torch.tools import path_shapes as PS

SIZES = {"objects": 8, "obj_bytes": 64 << 10, "zero_copy": 4,
         "mux_sessions": 48, "mux_bytes": 16 << 10,
         "overload_sessions": 300, "fault_puts": 8, "bus_writes": 2,
         "frontend_objects": 2, "bench_seconds": 0.25, "bench_size": "64K"}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_phase_net_launches_match_net_shapes():
    CS = _chip_smoke()
    with PS.recorded_launches(rs_kernels) as seen:
        lines, _n_apply, _n_crc = CS.phase_net(
            rs_kernels, ecutil, ErasureCodePluginRegistry, sizes=SIZES,
            device="cpu", seen=seen)
    shapes = CS.net_launch_shapes(PS, ErasureCodePluginRegistry, seen,
                                  SIZES)
    assert shapes["checked"]
    serve = lines["serve"]
    assert serve["put"]["ops"] == SIZES["objects"]
    assert serve["put"]["tcp"]["rx_bytes"] > \
        SIZES["objects"] * SIZES["obj_bytes"]
    zc = lines["zero_copy"]
    assert zc["on"]["copies_per_byte"] < zc["off"]["copies_per_byte"]
    mux = lines["mux"]
    assert mux["sessions"] == SIZES["mux_sessions"]
    assert mux["client"]["completed"] == 2 * SIZES["mux_sessions"]
    assert lines["overload"]["sheds"] > 0
    faults = lines["faults"]
    assert faults["lost_acked_writes"] == 0 and faults["redials"] > 0
    assert set(faults["injected"]["planes"]["transport"]) >= {
        "delay", "truncate", "reset", "blackhole", "recv_reset"}
    bus = lines["wire_bus"]
    assert bus["crc"]["host_breakdown"]["frame_crc"]["calls"] > 0
    assert "crc mismatch" in bus["corrupted_frame"]["error"]
    fe = lines["frontend"]
    assert fe["encode"]["pieces"] >= SIZES["frontend_objects"]
    assert fe["shed"]["errno"] == 16
    assert fe["tier_read"]["admitted"] == SIZES["frontend_objects"]
    clis = lines["clis"]
    assert clis["client_process"] == {"ok": True, "cuda_initialized": False,
                                      "loaded": []}
    assert int(clis["rados_bench_write"]["block"]["Total writes made"]) > 0
