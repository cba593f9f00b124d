"""Serving throughput of one tree, for comparing two commits on one card.

    python3 ceph_tpu_torch/tools/serving_ab.py [--root DIR] [--after-repair]

Runs phase ``serving`` of the ``chip_smoke.py`` found in DIR (default:
the checkout holding this file) with DIR's own ``ceph_tpu_torch``: the
RBD-on-EC closed loop (torch_rs k=8 m=4, 4 MiB ops, concurrency 16, 256
encodes and 256 degraded reads, every op checked) at depth 4, then depth
0, 4, 0, and the small-op batched-vs-unbatched comparison.
``--after-repair`` runs DIR's phase ``repair`` first, in the same
process, as ``chip_smoke.py`` does.  Prints one JSON line: the depth-4
arm's encode and decode MiB/s, all four arms, the seconds the depth-4
encode arm spent in each pipeline stage, the small-op speedups and the
seconds taken.

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
                    help="run the tree's phase repair first")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("serving_ab: torch.cuda.is_available() is False; the serving "
              "path runs on a CUDA card", file=sys.stderr)
        return 2
    smoke = load_smoke(args.root)
    from ceph_tpu_torch.backend import ecutil
    from ceph_tpu_torch.ops import rs_kernels as K
    from ceph_tpu_torch.plugins.registry import ErasureCodePluginRegistry
    t0 = time.perf_counter()
    if args.after_repair:
        from ceph_tpu_torch.ops.pipeline import CodecPipeline
        smoke.phase_repair(K, ecutil, ErasureCodePluginRegistry,
                           CodecPipeline)
    report, _ = smoke.phase_serving(K, ecutil, ErasureCodePluginRegistry)
    arms = report["depth_0_vs_4"]["MiBps"]
    enc = report["rbd"]["encode"]["pipeline"]
    print(json.dumps({
        "root": os.path.relpath(os.path.abspath(args.root), here),
        "after_repair": args.after_repair,
        "encode_MiBps": arms["encode"][0], "decode_MiBps": arms["decode"][0],
        "arms": {"order": report["depth_0_vs_4"]["order"], **arms},
        "enc_pipe_s": {key: enc[key]["sum_s"] for key in
                       ("pack_time", "dispatch_time", "complete_time")},
        "small_ops_speedup": report["small_ops"]["speedup"],
        "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
