"""rados_bench: open/closed-loop workload generator for the serving engine.

The port of the root ``tools/rados_bench.py``.  The serving-side sibling
of ``rados bench`` (the cluster-level write/seq bench is
``python -m ceph_tpu_torch.bench.rados_bench``): this tool drives
CONCURRENT encode ops through ``ceph_tpu_torch.exec.ServingEngine`` and
reports throughput plus p50/p95/p99 latency -- the numbers that decide
whether the op coalescer is earning its deadline.

    # closed loop, 64 clients, compare coalesced vs op-at-a-time:
    python -m ceph_tpu_torch.tools.rados_bench --compare --concurrency 64 \
        --ops 512

    # closed loop against one engine configuration:
    python -m ceph_tpu_torch.tools.rados_bench --concurrency 64 \
        --ops 1024 --batch-max-ops 64 --op-size 16K --device cuda

    # open loop at a fixed arrival rate (tail latency without
    # coordinated omission):
    python -m ceph_tpu_torch.tools.rados_bench --mode open --rate 2000 \
        --seconds 5

    # 10,000 logical sessions over 8 TCP connections, capacity and
    # overload arms, with a zipf + flash-crowd key stream:
    python -m ceph_tpu_torch.tools.rados_bench --mode mux \
        --key-dist zipf:1.2 --flash-crowd 0.9:0.25:0.5

    # machine-readable:
    python -m ceph_tpu_torch.tools.rados_bench --compare --json

``--unbatched`` pins ``batch_max_ops=1`` (every op is its own device
dispatch) -- the baseline the coalesced number is judged against, on the
same device.  The codec is ``torch_rs`` on the card (``--device cuda``)
unless the caller asks for ``cpu`` (the plain PyTorch versions),
``numpy`` (the host codec) or ``auto`` (the size split); cuda and auto on
a machine with no card fail at once rather than run on the CPU.

The loops, ``compare_batched_unbatched`` and the key streams
(:class:`~ceph_tpu_torch.exec.workload.WorkloadKeys`) are
``exec/workload.py``'s; the mux arms drive ``net.ClusterServer`` over
``msg.MuxClient``, the tier arm a ``tier/`` writeback tier.  Latency
percentiles are the shared nearest rank of ``common/percentile.py``
(the root tool's own rank sits one sample higher at most).
"""
from __future__ import annotations

import argparse
import errno
import gc
import json
import os
import random
import sys
import tempfile
import threading
import time

import torch

from ..backend import StripeInfo
from ..cluster import MiniCluster
from ..common import Context, copy_ledger, instruments, parse_size
from ..common.percentile import nearest_rank
from ..common.tracer import default_tracer
from ..exec import ServingEngine
from ..exec.workload import (WorkloadKeys, closed_loop,
                             compare_batched_unbatched, make_payloads,
                             open_loop)
from ..msg import MuxClient
from ..net import KEYRING, ClusterServer
from ..ops.codec import torch_device
from ..osd.osd_ops import ObjectOperation
from ..plugins.registry import ErasureCodePluginRegistry

DEVICES = ("cuda", "cpu", "numpy", "auto")


def build_codec(args):
    """The plugin and stripe geometry the arguments name.  A ``torch_rs``
    profile on cuda or auto needs a card: none raises here."""
    profile = {"plugin": args.plugin, "k": str(args.k), "m": str(args.m),
               "technique": args.technique}
    if args.plugin == "torch_rs":
        profile["device"] = args.device
        if args.device in ("cuda", "auto"):
            torch_device("cuda")
    ec = ErasureCodePluginRegistry.instance().factory(
        args.plugin, "", profile)
    return ec, StripeInfo(args.k, parse_size(args.chunk_size))


def human(result: dict, out) -> None:
    w = out.write
    if "batched" in result:
        for label in ("unbatched", "batched"):
            r = result[label]
            w(f"{label:>10}: {r['ops_s']:>9.1f} ops/s  "
              f"{r['mb_s']:>8.2f} MB/s  p50 {r['p50_ms']:.3f} ms  "
              f"p95 {r['p95_ms']:.3f} ms  p99 {r['p99_ms']:.3f} ms  "
              f"(mean batch {r['mean_batch_size']})\n")
        w(f"{'speedup':>10}: {result['speedup']}x coalesced vs "
          f"op-at-a-time\n")
        return
    w(f"Mode:               {result['mode']}\n")
    w(f"Ops completed:      {result['ops']}\n")
    if "rejected" in result:
        w(f"Ops rejected:       {result['rejected']}\n")
    w(f"Op size:            {result['op_bytes']}\n")
    w(f"Total time (s):     {result['elapsed_s']}\n")
    w(f"Throughput (ops/s): {result['ops_s']}\n")
    w(f"Bandwidth (MB/s):   {result['mb_s']}\n")
    w(f"Latency p50 (ms):   {result['p50_ms']}\n")
    w(f"Latency p95 (ms):   {result['p95_ms']}\n")
    w(f"Latency p99 (ms):   {result['p99_ms']}\n")
    w(f"Mean batch size:    {result['mean_batch_size']}\n")


def _ms(sorted_lats: list[float], q: float) -> float:
    return round(nearest_rank(sorted_lats, q) * 1e3, 3)


def parse_key_dist(spec: str) -> tuple[str, float]:
    """``uniform`` or ``zipf:<s>`` -> (dist, s)."""
    if spec == "uniform":
        return "uniform", 0.0
    if spec.startswith("zipf:"):
        return "zipf", float(spec.split(":", 1)[1])
    if spec == "zipf":
        return "zipf", 1.1
    raise ValueError(f"--key-dist {spec!r}: expected uniform or zipf:<s>")


def parse_flash_crowd(spec: str) -> tuple[float, float, float]:
    """``frac:start:dur`` (all 0..1, progress coordinates) -> tuple."""
    parts = spec.split(":")
    if len(parts) != 3:
        raise ValueError(
            f"--flash-crowd {spec!r}: expected frac:start:dur")
    return float(parts[0]), float(parts[1]), float(parts[2])


def _closed_loop_segment(mux, n_clients: int, ops_per_client: int,
                         payload: bytes, timeout_s: float,
                         keys: WorkloadKeys | None = None,
                         method: str = "ping",
                         extra: dict | None = None) -> dict:
    """One closed-loop burst over an ALREADY-CONNECTED mux: every logical
    session runs ``ops_per_client`` RPCs (next op submits when the
    previous completes; EBUSY sheds retry the same op).  ``method``
    picks the op — ``ping`` (transport echo), ``tier_read`` (served
    through the cluster, ``extra`` carrying the pool), or a CALLABLE
    ``progress -> (method, args)`` for mixed streams (the tiering
    bench's read/write flash crowd).  Shared by
    :func:`run_mux_bench` (one segment per process),
    :func:`run_mux_overhead_bench` (many segments against one warmed
    server, so segment-to-segment deltas isolate instrument cost from
    setup noise) and :func:`run_tier_mux_bench` (cold/warm tier arms
    against one preloaded cluster)."""
    total = n_clients * ops_per_client
    lock = threading.Lock()
    state = {"done": 0, "failed": 0, "shed_retries": 0}
    lats: list[float] = []
    finished = threading.Event()

    def _op():
        # a fresh arrival draws its method + key at the CURRENT
        # progress of the run, so the flash-crowd window covers a
        # contiguous slice of the op sequence at any client count
        with lock:
            progress = state["done"] / total
        if callable(method):
            m, a = method(progress)
        else:
            m = method
            a = {"payload": payload} if m == "ping" else dict(extra or {})
        if keys is not None:
            a["key"] = keys.key(progress)
        return m, a

    def mk_cb(sess, left, m, args):
        def cb(call):
            r = call.result
            shed = (not isinstance(r, BaseException)
                    and not r.ok and r.errno == errno.EBUSY)
            with lock:
                if shed:
                    state["shed_retries"] += 1
                elif isinstance(r, BaseException) or not r.ok:
                    state["failed"] += 1
                    state["done"] += 1
                else:
                    lats.append(time.monotonic() - call.t_submit)
                    state["done"] += 1
                fin = state["done"] >= total
            if fin:
                finished.set()
                return
            if shed:        # refused: retry the SAME op (same key)
                sess.call_async(m, args, cb=mk_cb(sess, left, m, args))
            elif left > 1:  # completed: next op in the loop
                nm, na = _op()
                sess.call_async(nm, na, cb=mk_cb(sess, left - 1, nm, na))
        return cb

    t0 = time.perf_counter()
    for _ in range(n_clients):
        s = mux.session()
        m0, first = _op()
        s.call_async(m0, first, cb=mk_cb(s, ops_per_client, m0, first))
    ok = finished.wait(timeout_s)
    elapsed = time.perf_counter() - t0
    lats.sort()
    return {"finished_in_time": bool(ok), "elapsed_s": elapsed,
            "state": state, "lats": lats}


def run_mux_bench(n_clients: int = 10000, ops_per_client: int = 2,
                  n_conns: int = 8, payload_bytes: int = 64,
                  queue_max: int | None = None,
                  op_threads: int | None = None,
                  timeout_s: float = 120.0,
                  keys: WorkloadKeys | None = None,
                  conf_overrides: dict | None = None,
                  distinct_payloads: bool = False) -> dict:
    """Closed-loop mux bench: ``n_clients`` logical sessions multiplexed
    over ``n_conns`` TCP connections to an async ClusterServer, each
    running ``ops_per_client`` ping RPCs closed-loop (next op submits
    when the previous completes).  A shed (EBUSY) refusal RETRIES the op
    — goodput counts only completed work — so with ``queue_max`` set low
    this measures goodput + shed-rate UNDER OVERLOAD, and with it high
    it measures clean concurrency capacity.  Returns goodput (ops/s),
    latency percentiles, shed-rate, and transport stats.
    """
    with tempfile.TemporaryDirectory() as td:
        cluster = MiniCluster(n_osds=3, osds_per_host=3, chunk_size=512,
                              data_dir=td)
        conf = cluster.cct.conf
        saved = {}
        overrides = {}
        if queue_max is not None:
            overrides["ms_async_dispatch_queue_max"] = queue_max
        if op_threads is not None:
            overrides["ms_async_op_threads"] = op_threads
        # extra conf keys (e.g. ms_zero_copy arms) ride the same
        # save/restore cycle; the cluster cct IS the process default
        # context, so the mux client's config observers see them too
        overrides.update(conf_overrides or {})
        for k, v in overrides.items():
            saved[k] = conf.get(k)
            conf.set(k, v)
        server = ClusterServer(cluster)
        mux = None
        try:
            server.start()
            mux = MuxClient("127.0.0.1", server.port,
                            os.path.join(td, KEYRING), n_conns=n_conns)
            mux.connect()
            payload = b"\xab" * payload_bytes
            # distinct_payloads: a FRESH bytes object per op.  The
            # default shares ONE payload object across every call in a
            # batch, which pickle memoizes — the legacy frame then
            # carries the payload once however many calls ride it, a
            # wire-volume fiction no real workload gets.  Copy-path
            # arms (run_zero_copy_pair) need each op to weigh its own
            # bytes on both serialize paths.
            # bytes(payload) would return the SAME object — go through
            # bytearray to force a genuinely fresh one
            meth = (lambda _p: ("ping",
                                {"payload": bytes(bytearray(payload))})) \
                if distinct_payloads else "ping"
            seg = _closed_loop_segment(mux, n_clients, ops_per_client,
                                       payload, timeout_s, keys=keys,
                                       method=meth)
            ok = seg["finished_in_time"]
            elapsed = seg["elapsed_s"]
            state = seg["state"]
            lats = seg["lats"]
            st = mux.stats()
            shed_snap = (server._transport.shed.snapshot()
                         if server._transport is not None else {})
            completed = state["done"] - state["failed"]
            arrivals = completed + state["shed_retries"]
            return {
                "mode": "mux",
                "clients": n_clients,
                "connections": st["connections"],
                "ops_per_client": ops_per_client,
                "completed": completed,
                "failed": state["failed"],
                "finished_in_time": bool(ok),
                "elapsed_s": round(elapsed, 4),
                "ops_s": round(completed / elapsed, 1) if elapsed else 0.0,
                "p50_ms": _ms(lats, 50),
                "p95_ms": _ms(lats, 95),
                "p99_ms": _ms(lats, 99),
                "shed_retries": state["shed_retries"],
                "shed_rate": round(
                    state["shed_retries"] / arrivals, 4) if arrivals
                else 0.0,
                "server_shed": shed_snap,
                "mux_stats": st,
                "threads": threading.active_count(),
                "workload": keys.describe() if keys is not None else None,
            }
        finally:
            if mux is not None:
                mux.close()
            server.stop()
            cluster.shutdown()
            for k, v in saved.items():
                conf.set(k, v)


def run_tier_mux_bench(n_clients: int = 10000, ops_per_client: int = 2,
                       n_conns: int = 8, n_objects: int = 1000,
                       object_bytes: int = 2048, zipf_s: float = 1.1,
                       flash: tuple = (0.9, 0.0, 1.0),
                       hot_frac: float = 0.001, write_frac: float = 0.2,
                       seed: int = 17, device: str = "cuda",
                       timeout_s: float = 300.0) -> dict:
    """Flash-crowd tiering bench at mux scale: ``n_clients`` logical
    sessions run a zipf + flash-crowd key stream (``hot_frac`` of the
    keyspace — 0.1% by default — absorbing ``flash[0]`` of arrivals)
    of closed-loop mixed tier_read/tier_write RPCs (``write_frac``
    writes) against one preloaded cluster, three segments with
    IDENTICAL streams (same seed):

    - **cold**: no tier bound — reads are full EC base-pool reads over
      the wire (the path a miss proxies to) and writes are EC
      full-stripe writes, encode and all;
    - **warmup**: a writeback tier bound over the base — misses
      promote (min_recency 1), writes absorb, populating the hot set;
    - **warm**: the same stream against the warmed tier — the number
      the cache exists for.

    Device seconds per segment come from the critical-path ledger
    (DEVICE-phase attribution: codec dispatches and host-SIMD fallback
    both land there).  A healthy EC READ never touches the codec, so
    the cold arm's device time is its write encodes — exactly the work
    writeback absorption elides — and warm-vs-cold compares
    device-time-per-op as well as p99.  Returns cold/warm p99 + device
    time, the warm pass's hit rate and promotion churn, and the
    workload description.
    """
    def _mk_keys():
        # one stream per segment, SAME seed: the zipf ranks and flash
        # decisions replay draw-for-draw, so cold and warm arms serve
        # the same key sequence
        return WorkloadKeys(n_keys=n_objects, dist="zipf", zipf_s=zipf_s,
                            flash=flash, hot_frac=hot_frac, seed=seed)

    def _device_seconds(cluster) -> float:
        cluster.critpath.refresh()
        return sum(acc.get("device", 0.0)
                   for acc in cluster.critpath.phase_seconds().values())

    with tempfile.TemporaryDirectory() as td:
        cct = Context(overrides={
            # promote on the first recorded hit-set appearance: a flash
            # crowd earns residency immediately, like the reference's
            # min_read_recency_for_promote=1 deployments
            "tier_promote_min_recency": 1,
            "tier_target_max_objects": max(256, n_objects),
        })
        cluster = MiniCluster(n_osds=6, osds_per_host=2, chunk_size=512,
                              cct=cct, data_dir=td)
        server = None
        mux = None
        try:
            base = cluster.create_ec_pool(
                "tierbase", {"k": "2", "m": "1", "device": device},
                pg_num=4)
            cache = cluster.create_replicated_pool(
                "tiercache", size=3, pg_num=4,
                params={"hit_set_count": "4", "hit_set_period": "3600"})
            for i in range(n_objects):
                data = bytes([(i + j) % 251
                              for j in range(64)]) * (object_bytes // 64)
                cluster.operate(base, f"obj{i:08d}",
                                ObjectOperation().write_full(data))
            server = ClusterServer(cluster)
            server.start()
            mux = MuxClient("127.0.0.1", server.port,
                            os.path.join(td, KEYRING), n_conns=n_conns)
            mux.connect()

            wdata = bytes(range(64)) * (object_bytes // 64)

            def _mix(pool: str):
                # the read/write choice replays draw-for-draw across
                # segments (own seeded rng, consumed once per arrival)
                wrng = random.Random(seed ^ 0x5BD1)

                def draw(progress):
                    if wrng.random() < write_frac:
                        return "tier_write", {"pool": pool,
                                              "payload": wdata}
                    return "tier_read", {"pool": pool}
                return draw

            def _segment(pool: str, keys: WorkloadKeys) -> dict:
                d0 = _device_seconds(cluster)
                seg = _closed_loop_segment(
                    mux, n_clients, ops_per_client, b"", timeout_s,
                    keys=keys, method=_mix(pool))
                dd = _device_seconds(cluster) - d0
                st, lats = seg["state"], seg["lats"]
                done = st["done"] - st["failed"]
                return {"completed": done, "failed": st["failed"],
                        "finished_in_time": seg["finished_in_time"],
                        "elapsed_s": round(seg["elapsed_s"], 4),
                        "ops_s": round(done / seg["elapsed_s"], 1)
                        if seg["elapsed_s"] else 0.0,
                        "p50_ms": _ms(lats, 50),
                        "p99_ms": _ms(lats, 99),
                        "device_s": round(dd, 6),
                        "device_us_per_op": round(dd / done * 1e6, 3)
                        if done else 0.0}

            default_tracer().reset()
            cold = _segment("tierbase", _mk_keys())
            print(f"# tiering: cold p99 {cold['p99_ms']:.2f} ms, "
                  f"{cold['device_us_per_op']:.0f} us device/op",
                  file=sys.stderr)

            svc = cluster.create_tier(cache, base)
            c0 = dict(svc.stats()["counters"])
            warmup = _segment("tiercache", _mk_keys())
            c1 = dict(svc.stats()["counters"])
            warm = _segment("tiercache", _mk_keys())
            c2 = dict(svc.stats()["counters"])

            def _delta(a, b, k):
                return int(b.get(k, 0)) - int(a.get(k, 0))

            hits = _delta(c1, c2, "hit")
            misses = _delta(c1, c2, "miss")
            warm["hit_rate"] = round(hits / (hits + misses), 4) \
                if hits + misses else 0.0
            warm["promotions"] = _delta(c1, c2, "promote")
            warmup_block = {"elapsed_s": warmup["elapsed_s"],
                            "promotions": _delta(c0, c1, "promote"),
                            "hit_rate": round(
                                _delta(c0, c1, "hit")
                                / max(1, _delta(c0, c1, "hit")
                                      + _delta(c0, c1, "miss")), 4)}
            keys_desc = _mk_keys()
            out = {
                "mode": "tier-mux",
                "device": device,
                "clients": n_clients,
                "ops_per_client": ops_per_client,
                "objects": n_objects,
                "object_bytes": object_bytes,
                "hot_objects": keys_desc.hot,
                "resident": len(svc.resident()),
                "cold": cold,
                "warmup": warmup_block,
                "warm": warm,
                "workload": {"dist": "zipf", "zipf_s": zipf_s,
                             "hot_frac": hot_frac, "flash": list(flash),
                             "write_frac": write_frac, "seed": seed},
            }
            if cold["p99_ms"]:
                out["warm_over_cold_p99"] = round(
                    warm["p99_ms"] / cold["p99_ms"], 4)
            if cold["device_us_per_op"]:
                out["warm_over_cold_device_us"] = round(
                    warm["device_us_per_op"] / cold["device_us_per_op"],
                    4)
            print(f"# tiering: warm p99 {warm['p99_ms']:.2f} ms, "
                  f"{warm['device_us_per_op']:.0f} us device/op, "
                  f"hit rate {warm['hit_rate']:.3f}, "
                  f"{warm['promotions']} promotions", file=sys.stderr)
            return out
        finally:
            if mux is not None:
                mux.close()
            if server is not None:
                server.stop()
            cluster.shutdown()


def run_mux_overhead_bench(n_clients: int = 64, ops_per_client: int = 300,
                           n_conns: int = 2, payload_bytes: int = 64,
                           rounds: int = 7, timeout_s: float = 120.0) -> dict:
    """Instrument-overhead A/B on the serving.async mux workload.

    One server and one warmed mux; ``rounds`` PAIRED closed-loop
    segments (instruments on vs off via the kill-switch) alternate over
    the SAME connections, each measured in PROCESS CPU time per op.
    Wall-clock throughput on a small shared host swings 2x run-to-run
    from scheduler noise and per-process setup differences; CPU-per-op
    against one warmed server isolates the work the instruments actually
    add.  The published overhead is the MEDIAN of the per-round paired
    deltas, with the on/off order alternating each round so slow drift
    cancels instead of biasing one arm.
    """
    total = n_clients * ops_per_client
    with tempfile.TemporaryDirectory() as td:
        cluster = MiniCluster(n_osds=3, osds_per_host=3, chunk_size=512,
                              data_dir=td)
        server = ClusterServer(cluster)
        mux = None
        try:
            server.start()
            mux = MuxClient("127.0.0.1", server.port,
                            os.path.join(td, KEYRING), n_conns=n_conns)
            mux.connect()
            payload = b"\xab" * payload_bytes

            def segment(off: bool) -> dict:
                gc.collect()
                c0 = time.process_time()
                if off:
                    with instruments.disabled():
                        seg = _closed_loop_segment(
                            mux, n_clients, ops_per_client, payload,
                            timeout_s)
                else:
                    seg = _closed_loop_segment(
                        mux, n_clients, ops_per_client, payload, timeout_s)
                cpu = time.process_time() - c0
                state, lats = seg["state"], seg["lats"]
                completed = state["done"] - state["failed"]
                return {
                    "cpu_us_per_op": cpu / total * 1e6,
                    "ops_s": round(completed / seg["elapsed_s"], 1)
                    if seg["elapsed_s"] else 0.0,
                    "p99_ms": _ms(lats, 99),
                    "completed": completed,
                }

            def median(vals):
                s = sorted(vals)
                m = len(s) // 2
                return s[m] if len(s) % 2 else (s[m - 1] + s[m]) / 2

            segment(False)    # warmup: discarded (cold code paths, sockets)
            deltas = []
            on_segs, off_segs = [], []
            for i in range(rounds):
                first_off = bool(i % 2)        # alternate A/B, B/A order
                a = segment(first_off)
                b = segment(not first_off)
                on_seg, off_seg = (b, a) if first_off else (a, b)
                on_segs.append(on_seg)
                off_segs.append(off_seg)
                deltas.append(
                    (on_seg["cpu_us_per_op"] - off_seg["cpu_us_per_op"])
                    / off_seg["cpu_us_per_op"] * 100.0)

            def arm(segs):
                return {
                    "ops_s": median([s["ops_s"] for s in segs]),
                    "p99_ms": median([s["p99_ms"] for s in segs]),
                    "cpu_us_per_op": round(
                        median([s["cpu_us_per_op"] for s in segs]), 2),
                }

            return {
                "mode": "mux-overhead",
                "clients": n_clients,
                "ops_per_client": ops_per_client,
                "connections": n_conns,
                "rounds": rounds,
                "overhead_pct": round(max(0.0, median(deltas)), 2),
                "deltas_pct": [round(d, 2) for d in sorted(deltas)],
                "instruments_on": arm(on_segs),
                "instruments_off": arm(off_segs),
            }
        finally:
            if mux is not None:
                mux.close()
            server.stop()
            cluster.shutdown()


def run_mux_overload_pair(n_clients: int = 10000,
                          ops_per_client: int = 2,
                          n_conns: int = 8,
                          overload_queue_max: int = 64,
                          key_dist: str | None = None,
                          flash_crowd: str | None = None) -> dict:
    """The mux mode's two arms (the JAX package's ``bench.py``
    ``serving.async`` block): one clean-capacity run
    (queue limit ABOVE the client count: nothing sheds) and one
    overload run (tiny dispatch queue, one worker: the shed ladder must
    refuse work while goodput continues).  ``key_dist`` /
    ``flash_crowd`` overlay a key stream on the arrivals (fresh
    generator per arm: the streams stay independently reproducible)."""
    def mk_keys():
        if key_dist is None and flash_crowd is None:
            return None
        dist, s = parse_key_dist(key_dist or "uniform")
        return WorkloadKeys(
            n_keys=n_clients, dist=dist, zipf_s=s,
            flash=parse_flash_crowd(flash_crowd) if flash_crowd else None)
    capacity = run_mux_bench(n_clients, ops_per_client, n_conns,
                             queue_max=max(2 * n_clients, 2048),
                             keys=mk_keys())
    overload = run_mux_bench(min(n_clients, 2000), ops_per_client,
                             n_conns, queue_max=overload_queue_max,
                             op_threads=1, keys=mk_keys())
    return {
        "clients": capacity["clients"],
        "ops_s": capacity["ops_s"],
        "p99_ms": capacity["p99_ms"],
        "p50_ms": capacity["p50_ms"],
        "threads": capacity["threads"],
        "workload": capacity.get("workload"),
        "capacity": capacity,
        "overload": {
            "clients": overload["clients"],
            "ops_s": overload["ops_s"],
            "p99_ms": overload["p99_ms"],
            "shed_rate": overload["shed_rate"],
            "shed_retries": overload["shed_retries"],
            "server_shed": overload["server_shed"],
            "completed": overload["completed"],
        },
    }


def run_zero_copy_pair(n_clients: int = 256, ops_per_client: int = 4,
                       n_conns: int = 8,
                       payload_bytes: int = 65536) -> dict:
    """The zero-copy pair (the JAX package's ``bench.py``
    ``serving.zero_copy`` block): the same closed-loop
    mux ping workload twice — the FUSED arm serializing payloads through
    the raw sideband segment (``ms_zero_copy=true``: one staging copy
    server-side, one materialize client-side) and the LEGACY arm forced
    through pickled frames (pickle + segment join on send, unpickle on
    receive, both directions).  The copy ledger resets around each arm,
    so each arm's ``copies_per_byte`` is exactly its own bytes-copied /
    bytes-served ratio: about 1 on the fused arm and 3 on the legacy
    arm (a legacy ratio below ~3 would mean the ledger stopped seeing
    the copies, not that the legacy path got faster)."""
    def arm(on: bool) -> dict:
        led = copy_ledger.ledger()
        led.reset()
        r = run_mux_bench(n_clients, ops_per_client, n_conns,
                          payload_bytes=payload_bytes,
                          queue_max=max(2 * n_clients, 2048),
                          conf_overrides={"ms_zero_copy": on},
                          distinct_payloads=True)
        snap = led.snapshot()
        return {"ops_s": r["ops_s"], "p50_ms": r["p50_ms"],
                "p99_ms": r["p99_ms"], "completed": r["completed"],
                "finished_in_time": r["finished_in_time"],
                "copies_per_byte": snap["copies_per_byte"],
                "copied": snap["copied"],
                "copied_total": snap["copied_total"],
                "served": snap["served"]}

    fused = arm(True)
    legacy = arm(False)
    return {
        "payload_bytes": payload_bytes,
        "clients": n_clients,
        "ops_per_client": ops_per_client,
        "fused": fused,
        "legacy": legacy,
        "copies_per_byte": fused["copies_per_byte"],
        "legacy_copies_per_byte": legacy["copies_per_byte"],
        "goodput_ratio": round(fused["ops_s"] / legacy["ops_s"], 3)
        if legacy["ops_s"] else 0.0,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="rados_bench", description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=["closed", "open", "mux"],
                    default="closed")
    ap.add_argument("--ops", type=int, default=512,
                    help="closed loop: total ops to complete")
    ap.add_argument("--concurrency", type=int, default=64,
                    help="closed loop: logical clients in flight")
    ap.add_argument("--rate", type=float, default=1000.0,
                    help="open loop: offered arrival rate (ops/s)")
    ap.add_argument("--seconds", type=float, default=5.0,
                    help="open loop: arrival window")
    ap.add_argument("--op-size", default="4K")
    ap.add_argument("--chunk-size", default="1K")
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--m", type=int, default=2)
    ap.add_argument("--plugin", default="torch_rs")
    ap.add_argument("--device", default="cuda", choices=DEVICES,
                    help="torch_rs device: cuda|cpu|numpy|auto (cuda "
                         "measures the real dispatch path the coalescer "
                         "amortizes; cpu runs the kernels' plain "
                         "versions)")
    ap.add_argument("--technique", default="reed_sol_van")
    ap.add_argument("--batch-max-ops", type=int, default=None,
                    help="coalescer cap (default: osd_batch_max_ops)")
    ap.add_argument("--batch-max-delay-ms", type=float, default=None)
    ap.add_argument("--unbatched", action="store_true",
                    help="op-at-a-time baseline (batch_max_ops=1)")
    ap.add_argument("--compare", action="store_true",
                    help="run batched AND unbatched, report the speedup")
    ap.add_argument("--warmup", type=int, default=64,
                    help="warmup ops per engine (compiles size buckets)")
    ap.add_argument("--clients", type=int, default=10000,
                    help="mux mode: logical closed-loop sessions")
    ap.add_argument("--ops-per-client", type=int, default=2,
                    help="mux mode: RPCs each session completes")
    ap.add_argument("--conns", type=int, default=8,
                    help="mux mode: TCP connections carrying all sessions")
    ap.add_argument("--overload-queue-max", type=int, default=64,
                    help="mux mode: dispatch-queue limit for the overload "
                         "arm (tiny = heavy shedding)")
    ap.add_argument("--key-dist", default=None,
                    help="mux mode: key distribution over the keyspace — "
                         "uniform or zipf:<s> (e.g. zipf:1.2)")
    ap.add_argument("--flash-crowd", default=None,
                    help="mux mode: frac:start:dur — during the "
                         "[start, start+dur) slice of the run (progress "
                         "coordinates, 0..1), frac of arrivals hit the "
                         "0.1%% hot set (the cache-tier stress shape)")
    ap.add_argument("--json", action="store_true", dest="as_json")
    args = ap.parse_args(argv)

    if args.mode == "mux":
        result = run_mux_overload_pair(
            n_clients=args.clients, ops_per_client=args.ops_per_client,
            n_conns=args.conns,
            overload_queue_max=args.overload_queue_max,
            key_dist=args.key_dist, flash_crowd=args.flash_crowd)
        if args.as_json:
            print(json.dumps(result))
        else:
            w = sys.stdout.write
            w(f"mux capacity:  {result['clients']} clients over "
              f"{args.conns} conns  {result['ops_s']:.0f} ops/s  "
              f"p50 {result['p50_ms']:.3f} ms  "
              f"p99 {result['p99_ms']:.3f} ms  "
              f"threads {result['threads']}\n")
            ov = result["overload"]
            w(f"mux overload:  {ov['clients']} clients  "
              f"{ov['ops_s']:.0f} ops/s goodput  "
              f"p99 {ov['p99_ms']:.3f} ms  "
              f"shed-rate {ov['shed_rate']:.2%} "
              f"({ov['shed_retries']} refusals)\n")
            wl = result.get("workload")
            if wl:
                w(f"workload:      {wl['dist']}"
                  f"{':%g' % wl['zipf_s'] if wl['zipf_s'] else ''} over "
                  f"{wl['n_keys']} keys, {wl['distinct_keys']} touched"
                  + (f", flash {wl['flash']} hit {wl['flash_draws']}/"
                     f"{wl['keys_drawn']} draws onto {wl['hot_set']} "
                     f"hot keys" if wl["flash"] else "") + "\n")
        return 0

    ec, sinfo = build_codec(args)
    op_bytes = parse_size(args.op_size)
    print(f"# k={args.k} m={args.m} chunk={sinfo.chunk_size} "
          f"op={op_bytes} plugin={args.plugin} device={args.device}",
          file=sys.stderr)

    if args.compare:
        result = compare_batched_unbatched(
            ec, sinfo, n_ops=args.ops, concurrency=args.concurrency,
            op_bytes=op_bytes, warmup_ops=args.warmup,
            batch_max_ops=args.batch_max_ops)
    else:
        engine = ServingEngine(
            ec_impl=ec, sinfo=sinfo, name="rados_bench",
            max_ops=max(1024, args.concurrency * 2),
            max_bytes=max(64 << 20, args.concurrency * op_bytes * 4),
            batch_max_ops=1 if args.unbatched else args.batch_max_ops,
            batch_max_delay_ms=args.batch_max_delay_ms).start()
        try:
            payloads = make_payloads(op_bytes)
            if args.warmup:
                closed_loop(engine, args.warmup,
                            min(args.concurrency, args.warmup), payloads)
            if args.mode == "closed":
                result = closed_loop(engine, args.ops, args.concurrency,
                                     payloads)
            else:
                result = open_loop(engine, args.rate, args.seconds,
                                   payloads)
        finally:
            engine.stop()

    if args.as_json:
        print(json.dumps(result))
    else:
        human(result, sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
