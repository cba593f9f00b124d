"""The five configs of BASELINE.md's run matrix, over the port.

The counterpart of the root ``tools/baseline_matrix.py`` (which drives the
JAX package), with the same configs and the same JSON keys; every number
is measured on the host and card this runs on:

  1. CPU baseline          ceph_erasure_code_benchmark --plugin isa analog
                           (src/test/erasure-code/ceph_erasure_code_benchmark.cc:151-181):
                           the native cpp_rs plugin (GFNI/AVX-512 or AVX2
                           pshufb), RS(4,2) and RS(8,4), 1 MiB.
  2. single-stripe torch_rs  one 1 MiB stripe per call INCLUDING the
                           host<->device copies, the plugin's auto route
                           (sub-threshold calls on the SIMD host codec)
                           and the host codec forced.
  3. batched device path   the C++ BatchQueue coalescing stripes into one
                           gf_apply_stripes launch a batch (the sidecar
                           boundary): throughput against max_batch; every
                           stripe's parity is checked against the host
                           codec.  No padding to max_batch: a launch of
                           any stripe count runs the same kernel.
  4. cluster-level         rados bench on a port MiniCluster EC pool,
                           torch_rs k=4 m=2
                           (qa/standalone/erasure-code/test-erasure-code.sh:21-66).
  5. bulk placement        osdmaptool --test-map-pgs analog: every PG of
                           a pool through BulkPGMapper (the crush_straw2
                           kernel) against the host interpreter, with
                           bit-equality.

Writes its JSON to ``--out`` (merging with what is there) and prints one
JSON line a config.

Usage: python -m ceph_tpu_torch.tools.baseline_matrix --out PATH [--quick]
           [--only N[,N...]] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

MIB = 2**20


def timeit(fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


def config1_cpu_baseline(quick: bool, device: str) -> dict:
    """Native SIMD host codec through the plugin path, 1 MiB buffers."""
    from ..native import SIMD_NAMES, NativeRegistry, registry_lib
    reg = NativeRegistry.instance()
    level = registry_lib().ec_simd_level()
    out = {"simd_level": level, "simd_name": SIMD_NAMES[level]}
    iters = 10 if quick else 50
    for k, m in ((4, 2), (8, 4)):
        ec = reg.factory("cpp_rs", {"k": str(k), "m": str(m),
                                    "technique": "reed_sol_van"})
        chunk = MIB // k
        rng = np.random.default_rng(0)
        data = np.ascontiguousarray(
            rng.integers(0, 256, size=(k, chunk), dtype=np.uint8))
        t_enc = timeit(lambda: ec.encode(data), iters)
        parity = ec.encode(data)
        erased = [0, k]                      # 1 data + 1 parity
        avail = {i: data[i] for i in range(1, k)}
        avail |= {k + j: parity[j] for j in range(1, m)}
        t_dec = timeit(lambda: ec.decode(avail, erased, chunk), iters)
        out[f"rs_k{k}m{m}"] = {
            "encode_mibs": round(1.0 / t_enc, 1),
            "decode_mibs": round(1.0 / t_dec, 1),
        }
    return out


def config2_single_stripe(quick: bool, device: str) -> dict:
    """One 1 MiB stripe per call: the device path with its copies, the
    plugin's auto route and the host codec forced."""
    from ..ops.codec import RSCodec, torch_device
    from ..plugins.registry import ErasureCodePluginRegistry
    k, m = 8, 4
    chunk = MIB // k
    rng = np.random.default_rng(1)
    data = np.ascontiguousarray(
        rng.integers(0, 256, size=(k, chunk), dtype=np.uint8))
    iters = 3 if quick else 10

    dev = RSCodec(k, m, technique="reed_sol_van", device=device)
    t_dev = timeit(lambda: dev.encode(data), iters, warmup=1)

    auto = ErasureCodePluginRegistry.instance().factory(
        "torch_rs", "", {"k": str(k), "m": str(m), "device": "auto"})
    bufs = {i: (data[i].copy() if i < k else np.zeros(chunk, np.uint8))
            for i in range(k + m)}
    t_auto = timeit(
        lambda: auto.encode_chunks(set(range(k + m)), bufs), iters)

    cpu = RSCodec(k, m, technique="reed_sol_van", device="numpy")
    t_cpu = timeit(lambda: cpu.encode(data), iters)
    return {
        "platform": torch_device(device).type,
        "device_incl_transfer_mibs": round(1.0 / t_dev, 1),
        "auto_routed_mibs": round(1.0 / t_auto, 1),
        "cpu_forced_mibs": round(1.0 / t_cpu, 1),
        "note": "the device path copies k chunks up and m down per call; "
                "the auto route compares against ec_device_threshold_bytes; "
                "cpu_forced is the SIMD host codec on the same call shape",
    }


def config3_batch_queue(quick: bool, device: str,
                        stripes_total: int | None = None) -> dict:
    """C++ batch queue -> gf_apply_stripes: throughput against the batch
    cap.  Each queue's first stripe runs alone (the warm-up) and counts in
    its dispatches."""
    from ..gf import ref as gfref
    from ..native import BatchQueue, StripesOnDevice
    from ..ops.codec import RSCodec
    k, m, chunk = 8, 4, 4096
    pmat = RSCodec(k, m, technique="reed_sol_van", device="numpy").parity_mat
    fn = StripesOnDevice(pmat, device)
    rng = np.random.default_rng(2)
    if stripes_total is None:
        stripes_total = 256 if quick else 1024
    curve = []
    for max_batch in (1, 4, 16, 64, 256):
        q = BatchQueue(k, m, chunk, fn, max_batch=max_batch)
        data = rng.integers(0, 256, size=(stripes_total, k, chunk),
                            dtype=np.uint8)
        q.submit(data[0])
        q.flush()                            # warm: first launch of a key
        t0 = time.perf_counter()
        parities = [q.submit(d) for d in data]
        q.flush()
        dt = time.perf_counter() - t0
        batches = q.batches
        q.close()
        want = gfref.apply_matrix_fast(
            pmat, data.transpose(1, 0, 2).reshape(k, -1))
        got = np.stack(parities).transpose(1, 0, 2).reshape(m, -1)
        if not np.array_equal(got, want):
            bad = int((got != want).reshape(m, stripes_total, chunk)
                      .any(axis=(0, 2)).sum())
            raise AssertionError(f"max_batch {max_batch}: {bad} stripes' "
                                 f"parity differs from the host codec")
        curve.append({
            "max_batch": max_batch,
            "stripes_per_s": round(stripes_total / dt, 1),
            "mibs": round(stripes_total * k * chunk / MIB / dt, 1),
            "dispatches": batches,
        })
    return {"k": k, "m": m, "chunk": chunk, "curve": curve}


def config4_rados_bench(quick: bool, device: str) -> dict:
    """Cluster-level write/read bench on a MiniCluster EC pool."""
    import io

    from ..bench.rados_bench import seq_read_bench, write_bench
    from ..cluster import MiniCluster
    secs = 3 if quick else 10
    mc = MiniCluster(n_osds=12, osds_per_host=3)
    pid = mc.create_ec_pool("bench", {"plugin": "torch_rs", "k": "4",
                                      "m": "2", "device": device}, pg_num=8)
    sink = io.StringIO()
    w = write_bench(mc, pid, secs, 4 * MIB, concurrency=16, out=sink)
    r = seq_read_bench(mc, pid, w["ops"], 4 * MIB, out=sink)
    mc.shutdown()
    return {
        "write_mb_s": round(w["bandwidth_mb_s"], 1),
        "write_iops": round(w["iops"], 1),
        "read_mb_s": round(r["bandwidth_mb_s"], 1),
        "read_iops": round(r["iops"], 1),
        "seconds": secs,
    }


def config5_bulk_placement(quick: bool, device: str) -> dict:
    """Every PG of a pool: BulkPGMapper against the host interpreter."""
    from ..crush.map import (CRUSH_BUCKET_STRAW2,
                             CRUSH_RULE_CHOOSELEAF_INDEP, CRUSH_RULE_EMIT,
                             CRUSH_RULE_TAKE, CrushMap)
    from ..osdmap.bulk import BulkPGMapper
    from ..osdmap.osdmap import OSDMap
    from ..osdmap.types import PG, POOL_TYPE_ERASURE, Pool

    n_osds = 256
    pg_num = 4096 if quick else 32768
    cmap = CrushMap()
    cmap.set_type_name(1, "host")
    cmap.set_type_name(2, "root")
    hosts = []
    for h0 in range(0, n_osds, 8):
        items = list(range(h0, h0 + 8))
        hosts.append(cmap.add_bucket(
            CRUSH_BUCKET_STRAW2, 1, items, [0x10000] * len(items)))
    root = cmap.add_bucket(CRUSH_BUCKET_STRAW2, 2, hosts,
                           [sum(cmap.buckets[h].item_weights)
                            for h in hosts])
    cmap.finalize()
    ruleno = cmap.add_rule([(CRUSH_RULE_TAKE, root, 0),
                            (CRUSH_RULE_CHOOSELEAF_INDEP, 6, 1),
                            (CRUSH_RULE_EMIT, 0, 0)])
    m = OSDMap(crush=cmap)
    for o in range(n_osds):
        m.create_osd(o)
    pool = Pool(pool_id=1, type=POOL_TYPE_ERASURE, size=6, min_size=5,
                pg_num=pg_num, crush_rule=ruleno, name="bulk")
    m.add_pool(pool)

    t0 = time.perf_counter()
    host = [m.pg_to_up_acting_osds(PG(1, ps))[2] for ps in range(pg_num)]
    t_host = time.perf_counter() - t0

    mapper = BulkPGMapper(m, device=device)
    mapping = mapper.map_pool(1)             # includes the kernel's load
    t0 = time.perf_counter()
    mapping = mapper.map_pool(1)
    t_dev = time.perf_counter() - t0

    mismatch = sum(
        1 for ps in range(pg_num)
        if list(mapping.acting[ps][:len(host[ps])]) != list(host[ps]))
    return {
        "pg_num": pg_num, "n_osds": n_osds,
        "host_pgs_per_s": round(pg_num / t_host, 1),
        "jax_pgs_per_s": round(pg_num / t_dev, 1),   # the JAX tool's key
        "speedup": round(t_host / t_dev, 1),
        "mismatches": mismatch,
    }


CONFIGS = {
    1: ("cpu_baseline_simd", config1_cpu_baseline),
    2: ("single_stripe_incl_transfer", config2_single_stripe),
    3: ("batch_queue_curve", config3_batch_queue),
    4: ("rados_bench_minicluster", config4_rados_bench),
    5: ("bulk_placement", config5_bulk_placement),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="baseline_matrix")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--only", default="")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--out", required=True,
                    help="the JSON file to write (merged with what is "
                         "there)")
    args = ap.parse_args(argv)
    only = {int(x) for x in args.only.split(",") if x} or set(CONFIGS)

    results = {}
    try:
        with open(args.out) as f:
            results = json.load(f)
    except (OSError, ValueError):
        pass
    for n, (name, fn) in sorted(CONFIGS.items()):
        if n not in only:
            continue
        print(f"# config {n}: {name} ...", file=sys.stderr, flush=True)
        try:
            results[name] = fn(args.quick, args.device)
        except Exception as e:               # recorded, as the JAX tool does
            results[name] = {"error": f"{type(e).__name__}: {e}"}
        print(json.dumps({name: results[name]}), flush=True)
    results["_meta"] = {"ts": time.time(), "quick": args.quick}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1, sort_keys=True)
    print(f"# wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
