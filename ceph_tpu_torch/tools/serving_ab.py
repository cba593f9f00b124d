"""One phase of one tree, for comparing two commits on one card.

    python3 ceph_tpu_torch/tools/serving_ab.py [--root DIR] [--after-repair]
    python3 ceph_tpu_torch/tools/serving_ab.py --phase durable [--root DIR]
    python3 ceph_tpu_torch/tools/serving_ab.py --phase instruments \
        [--repeat N]

Runs a phase of the ``chip_smoke.py`` found in DIR (default: the
checkout holding this file) with DIR's own ``ceph_tpu_torch`` and prints
one JSON line.

``--phase serving`` (the default): the RBD-on-EC closed loop (torch_rs
k=8 m=4, 4 MiB ops, concurrency 16, 256 encodes and 256 degraded reads,
every op checked) at depth 4, then depth 0, 4, 0, and the small-op
batched-vs-unbatched comparison.  ``--after-repair`` runs DIR's phase
``repair`` first, in the same process, as ``chip_smoke.py`` does.  The
line holds the depth-4 arm's encode and decode MiB/s, all four arms, the
seconds the depth-4 encode arm spent in each pipeline stage, the
small-op speedups and the seconds taken.

``--phase durable``: a BlueStore MiniCluster (12 OSDs, torch_rs k=8 m=4,
pg_num 32), 64 IoCtx puts and gets of 4 MiB, osd.3's down/overwrite/
repair cycle, reload, FileStore, the tier and the store-fault gets, every
byte checked.  The line holds the ms per put and get, the stores' host
crc32c ms in each (every blob a put writes, every blob a get reads), the
phase's seconds and the card's name and power limit.

``--phase instruments``: the phase ``N`` times in one process, which
ages as ``chip_smoke.py`` does.  A line a run: the process's age, and
for the put and the degraded-get profiler window the trace's kernels
against the ledger's, its runtime launches, the launches whose kernel is
missing, the kernels' lag behind their launches and the runtime calls'
behind their operators (min, median, max), and the window primer's
device records against its calls; or the check's error.

The host's clock moves between machines, so compare trees only within
one call, each in its own process, in turns: parent, change, change,
parent (unpack the parent with ``git archive`` into a gitignored
directory and pass it as ``--root``).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

import torch


def load_smoke(root: str):
    """``chip_smoke.py`` of ``root`` as a module, with ``root`` first on
    the path so that its ``ceph_tpu_torch`` is the one imported."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def main(argv=None) -> int:
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap = argparse.ArgumentParser(prog="serving_ab")
    ap.add_argument("--root", default=here,
                    help="directory holding chip_smoke.py and the "
                         "ceph_tpu_torch package to run (default: this "
                         "checkout)")
    ap.add_argument("--after-repair", action="store_true",
                    help="run the tree's phase repair first (serving)")
    ap.add_argument("--phase", choices=("serving", "durable",
                                        "instruments"),
                    default="serving", help="the phase to run")
    ap.add_argument("--repeat", type=int, default=8,
                    help="runs of phase instruments")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print(f"serving_ab: torch.cuda.is_available() is False; phase "
              f"{args.phase} runs on a CUDA card", file=sys.stderr)
        return 2
    smoke = load_smoke(args.root)
    from ceph_tpu_torch.backend import ecutil
    from ceph_tpu_torch.ops import rs_kernels as K
    from ceph_tpu_torch.plugins.registry import ErasureCodePluginRegistry
    root = os.path.relpath(os.path.abspath(args.root), here)
    t0 = time.perf_counter()
    if args.phase == "durable":
        from ceph_tpu_torch.ops import cuda_build
        from ceph_tpu_torch.tools.kernel_sweep import nvidia_smi_line
        cuda_build.build_all()
        t0 = time.perf_counter()
        lines, _, _ = smoke.phase_durable(K, ecutil,
                                          ErasureCodePluginRegistry)
        put, get = lines["bluestore"]["write"], lines["bluestore"]["read"]

        def crc_ms(line: dict) -> float:
            crc = line["host_breakdown"]["store_crc32c_bluestore"]["s"]
            return crc / line["objects"] * 1e3
        print(json.dumps({
            "root": root, "phase": "durable",
            "put_ms": put["ms_per_op"], "get_ms": get["ms_per_op"],
            "put_crc_ms": crc_ms(put), "get_crc_ms": crc_ms(get),
            "seconds": time.perf_counter() - t0,
            "gpu": nvidia_smi_line()}), flush=True)
        return 0
    if args.phase == "instruments":
        from ceph_tpu_torch.ops import cuda_build
        cuda_build.build_all()
        keys = ("kernels", "ledger_launches", "by_cat", "primer",
                "runtime_launches", "unmatched_launches", "first_launch_s",
                "first_device_s", "kernel_lag_us", "clock_offset_us",
                "lead_s", "wall_s")
        for i in range(args.repeat):
            age = time.time() - smoke.T_START
            try:
                lines = smoke.phase_instruments(
                    K, ecutil, ErasureCodePluginRegistry)
                windows = {w: {key: lines["cluster"][f"{w}_profiled"][key]
                               for key in keys}
                           for w in ("put", "degraded_get")}
                error = None
            except AssertionError as e:
                windows, error = None, str(e)
            print(json.dumps({"root": root, "phase": "instruments",
                              "run": i, "age_s": age,
                              "windows": windows, "error": error}),
                  flush=True)
        return 0
    if args.after_repair:
        from ceph_tpu_torch.ops.pipeline import CodecPipeline
        smoke.phase_repair(K, ecutil, ErasureCodePluginRegistry,
                           CodecPipeline)
    report, _ = smoke.phase_serving(K, ecutil, ErasureCodePluginRegistry)
    arms = report["depth_0_vs_4"]["MiBps"]
    enc = report["rbd"]["encode"]["pipeline"]
    print(json.dumps({
        "root": root, "phase": "serving", "after_repair": args.after_repair,
        "encode_MiBps": arms["encode"][0], "decode_MiBps": arms["decode"][0],
        "arms": {"order": report["depth_0_vs_4"]["order"], **arms},
        "enc_pipe_s": {key: enc[key]["sum_s"] for key in
                       ("pack_time", "dispatch_time", "complete_time")},
        "small_ops_speedup": report["small_ops"]["speedup"],
        "seconds": time.perf_counter() - t0}), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
