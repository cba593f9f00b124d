"""rados bench equivalent: cluster-level EC pool write/read benchmark.

Mirror of the reference's ObjBencher workloads (reference:
src/common/obj_bencher.h:64 — ``write_bench``/``seq_read_bench`` driven by
``rados bench <seconds> write|seq``; output block with total time, ops,
bandwidth MB/sec, IOPS and latency) over :class:`ceph_tpu_torch.cluster
.MiniCluster` — a vstart EC pool + rados bench without external daemons.

CLI:  python -m ceph_tpu_torch.bench.rados_bench --seconds 10 write
      [--osds 12] [--k 4] [--m 2] [--pg-num 8] [--object-size 4M]
      [--plugin torch_rs] [--device cuda|cpu] [--concurrency 16]

The port's copy of ``ceph_tpu.bench.rados_bench``.  The pool runs on the
card (``torch_rs``, no ``device`` key) unless ``--device cpu`` asks for
the plain PyTorch versions on the host; without a card and without
``--device cpu`` the bench raises.  After the reference's output block it
prints the run's kernel launches as one JSON line.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from ..common import parse_size
from ..cluster import MiniCluster

BENCH_PREFIX = "benchmark_data"


def write_bench(cluster, pool_id: int, seconds: float, object_size: int,
                concurrency: int = 16, out=None) -> dict:
    """obj_bencher.cc write_bench shape: submit `concurrency` writes, drain,
    repeat until the clock runs out."""
    w = out.write if out is not None else (lambda s: None)
    rng = np.random.default_rng(0)
    payload = rng.integers(0, 256, size=object_size, dtype=np.uint8).tobytes()
    t0 = time.perf_counter()
    done = 0
    latencies = []
    while time.perf_counter() - t0 < seconds:
        batch_start = time.perf_counter()
        for i in range(concurrency):
            cluster.put(pool_id, f"{BENCH_PREFIX}_{done + i}", payload,
                        deliver=False)
        cluster.deliver_all()
        dt = time.perf_counter() - batch_start
        # each op's submit-to-commit latency spans the whole batch drain
        # (rados bench with N in flight reports the same shape)
        latencies.extend([dt] * concurrency)
        done += concurrency
    elapsed = time.perf_counter() - t0
    stats = _report("write", elapsed, done, object_size, latencies, w)
    return stats


def seq_read_bench(cluster, pool_id: int, max_objects: int,
                   object_size: int, out=None) -> dict:
    w = out.write if out is not None else (lambda s: None)
    t0 = time.perf_counter()
    latencies = []
    done = 0
    for i in range(max_objects):
        s0 = time.perf_counter()
        data = cluster.get(pool_id, f"{BENCH_PREFIX}_{i}", object_size)
        if len(data) != object_size:
            raise IOError(f"{BENCH_PREFIX}_{i}: read {len(data)} bytes, "
                          f"wrote {object_size}")
        latencies.append(time.perf_counter() - s0)
        done += 1
    elapsed = time.perf_counter() - t0
    return _report("seq", elapsed, done, object_size, latencies, w)


def _report(kind, elapsed, ops, object_size, latencies, w) -> dict:
    bw = ops * object_size / elapsed / 1e6 if elapsed else 0.0
    iops = ops / elapsed if elapsed else 0.0
    avg_lat = sum(latencies) / len(latencies) if latencies else 0.0
    max_lat = max(latencies) if latencies else 0.0
    w(f"Total time run:         {elapsed:.6f}\n")
    w(f"Total {'writes made' if kind == 'write' else 'reads made'}:     "
      f"{ops}\n")
    w(f"{'Write' if kind == 'write' else 'Read'} size:             "
      f"{object_size}\n")
    w(f"Object size:            {object_size}\n")
    w(f"Bandwidth (MB/sec):     {bw:.4g}\n")
    w(f"Average IOPS:           {iops:.0f}\n")
    w(f"Average Latency(s):     {avg_lat:.6g}\n")
    w(f"Max latency(s):         {max_lat:.6g}\n")
    return {"elapsed": elapsed, "ops": ops, "bandwidth_mb_s": bw,
            "iops": iops, "avg_latency_s": avg_lat}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="rados_bench",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=["write", "seq"])
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--osds", type=int, default=12)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--m", type=int, default=2)
    ap.add_argument("--pg-num", type=int, default=8)
    ap.add_argument("--object-size", default="4M")
    ap.add_argument("--chunk-size", default="64K")
    ap.add_argument("--plugin", default="torch_rs")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (the card, the default) or cpu (the plain "
                         "PyTorch versions on the host)")
    ap.add_argument("--technique", default="reed_sol_van")
    ap.add_argument("--concurrency", type=int, default=16)
    args = ap.parse_args(argv)

    import torch
    from ..ops import rs_kernels
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("rados_bench runs the pool on the card and "
                           "torch.cuda.is_available() is False; pass "
                           "--device cpu for the host")
    object_size = parse_size(args.object_size)
    cluster = MiniCluster(n_osds=args.osds,
                          chunk_size=parse_size(args.chunk_size))
    profile = {"plugin": args.plugin, "k": str(args.k), "m": str(args.m),
               "technique": args.technique}
    if args.device == "cpu":
        profile["device"] = "cpu"
    pool = cluster.create_ec_pool("bench", profile, pg_num=args.pg_num)
    print(f"# {args.osds} osds, pool 'bench' k={args.k} m={args.m} "
          f"pg_num={args.pg_num} plugin={args.plugin} "
          f"device={args.device}", file=sys.stderr)

    rs_kernels.reset_launches()
    if args.mode == "write":
        write_bench(cluster, pool, args.seconds, object_size,
                    args.concurrency, out=sys.stdout)
    else:
        # write the dataset first, then time sequential reads
        n = max(1, int(args.seconds * 4))
        for i in range(n):
            cluster.put(pool, f"{BENCH_PREFIX}_{i}",
                        b"\xab" * object_size)
        seq_read_bench(cluster, pool, n, object_size, out=sys.stdout)
    print(json.dumps({"launches": dict(rs_kernels.launches)}), flush=True)
    cluster.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
