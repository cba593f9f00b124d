"""Open/closed-loop workload generation over a ServingEngine.

The measurement half of the serving subsystem (the role ``rados bench``'s
ObjBencher plays for the reference, src/common/obj_bencher.cc — but aimed
at the SERVING question: what does coalescing buy at a given concurrency,
and what does the tail look like?):

- **closed loop**: a fixed number of logical clients, each submitting its
  next op the moment the previous completes (completion-callback driven,
  so it needs no thread per client).  Throughput is demand-limited; this
  is the mode the "coalesced >= 3x unbatched at concurrency 64"
  acceptance gate uses.
- **open loop**: ops arrive on a fixed schedule regardless of completions
  (the honest way to measure tail latency under load — closed loops
  self-throttle and hide queueing delay; see the coordinated-omission
  literature).  Requires a started (threaded) engine.

Both report throughput and p50/p95/p99 latency.  Works with a threaded
engine (deadline batching across arrivals) or the deterministic
single-thread engine (the caller pumps ``step()``).

A copy of ``ceph_tpu.exec.workload`` with one addition: ``closed_loop``
takes ``kind="decode"``, whose payloads are ``{chunk: bytes}`` dicts
submitted through ``submit_decode`` (degraded reads), so both directions
of the serving path are driven the same way.
"""
from __future__ import annotations

import threading
import time

import numpy as np

from ..common.percentile import nearest_rank as percentile  # noqa: F401
from ..osd.mclock import CLIENT_OP
from .engine import ServingEngine
from .throttle import ThrottleFull

# `percentile` is THE shared nearest-rank helper (common/percentile.py).


def _latency_stats(lat_s: list[float]) -> dict:
    s = sorted(lat_s)
    return {
        "p50_ms": round(percentile(s, 50) * 1e3, 3),
        "p95_ms": round(percentile(s, 95) * 1e3, 3),
        "p99_ms": round(percentile(s, 99) * 1e3, 3),
        "mean_ms": round(sum(s) / len(s) * 1e3, 3) if s else 0.0,
        "max_ms": round(s[-1] * 1e3, 3) if s else 0.0,
    }


def make_payloads(op_bytes: int, n_distinct: int = 8, seed: int = 0
                  ) -> list[np.ndarray]:
    """A small rotation of distinct payloads (identical buffers would let
    clever caches lie; distinct-per-op would spend the run on RNG)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=op_bytes, dtype=np.uint8)
            for _ in range(max(1, n_distinct))]


def _engine_deltas(engine: ServingEngine, before: dict) -> dict:
    after = {k: engine.perf.get(k)
             for k in ("batches", "ops_coalesced", "ops_rejected")}
    d = {k: int(after[k] - before[k]) for k in after}
    d["mean_batch_size"] = round(
        d["ops_coalesced"] / d["batches"], 2) if d["batches"] else 0.0
    return d


def _perf_snapshot(engine: ServingEngine) -> dict:
    return {k: engine.perf.get(k)
            for k in ("batches", "ops_coalesced", "ops_rejected")}


def _op_nbytes(payload) -> int:
    """Bytes one op submits: the buffer, or a decode's chunks together."""
    if isinstance(payload, dict):
        return sum(int(np.asarray(v).nbytes) for v in payload.values())
    return int(payload.nbytes)


def closed_loop(engine: ServingEngine, n_ops: int, concurrency: int,
                payloads: list | None = None,
                op_bytes: int = 4096, op_class: str = CLIENT_OP,
                timeout: float = 300.0, kind: str = "encode") -> dict:
    """``concurrency`` logical clients, each resubmitting on completion,
    until ``n_ops`` complete.  Returns throughput + latency percentiles.
    ``kind="decode"`` submits ``payloads`` (chunk dicts) as degraded
    reads.

    Throttle note: the engine's op throttle must admit ``concurrency``
    ops (a closed loop with demand above the admission bound would just
    deadlock its own completions)."""
    if kind not in ("encode", "decode"):
        raise ValueError(f"kind={kind!r} must be encode or decode")
    if payloads is None:
        if kind == "decode":
            raise ValueError("a decode loop needs its chunk dicts")
        payloads = make_payloads(op_bytes)
    submit = engine.submit_encode if kind == "encode" \
        else engine.submit_decode
    if engine.op_throttle.max < concurrency:
        raise ValueError(
            f"op throttle {engine.op_throttle.max} < concurrency "
            f"{concurrency}: the closed loop would block itself")
    width = engine.sinfo.stripe_width \
        if engine.sinfo is not None and kind == "encode" else 1
    padded = -(-_op_nbytes(payloads[0]) // width) * width
    if engine.byte_throttle.max < concurrency * padded:
        raise ValueError(
            f"byte throttle {engine.byte_throttle.max} < concurrency * "
            f"op bytes {concurrency * padded}: the closed loop would "
            f"block itself")
    lock = threading.Lock()
    all_done = threading.Event()
    lat: list[float] = []
    state = {"submitted": 0}
    before = _perf_snapshot(engine)

    def submit_next() -> None:
        with lock:
            i = state["submitted"]
            if i >= n_ops:
                return
            state["submitted"] = i + 1
        fut = submit(payloads[i % len(payloads)], op_class=op_class)
        fut.add_done_callback(on_done)

    def on_done(fut) -> None:
        with lock:
            lat.append(fut.t_done - fut.t_submit)
            finished = len(lat) >= n_ops
        if finished:
            all_done.set()
        else:
            submit_next()

    t0 = time.monotonic()
    for _ in range(min(concurrency, n_ops)):
        submit_next()
    if engine.running:
        if not all_done.wait(timeout):
            raise TimeoutError(f"closed loop incomplete after {timeout}s: "
                               f"{len(lat)}/{n_ops}")
    else:
        while not all_done.is_set():
            if time.monotonic() - t0 > timeout:
                raise TimeoutError(
                    f"closed loop incomplete after {timeout}s: "
                    f"{len(lat)}/{n_ops}")
            engine.step()
    elapsed = time.monotonic() - t0
    op_nbytes = _op_nbytes(payloads[0])
    out = {
        "mode": "closed", "kind": kind, "ops": n_ops,
        "concurrency": concurrency,
        "op_bytes": op_nbytes,
        "elapsed_s": round(elapsed, 4),
        "ops_s": round(n_ops / elapsed, 1) if elapsed else 0.0,
        "mb_s": round(n_ops * op_nbytes / elapsed / 1e6, 2)
        if elapsed else 0.0,
    }
    out.update(_latency_stats(lat))
    out.update(_engine_deltas(engine, before))
    return out


def open_loop(engine: ServingEngine, rate_ops_s: float, seconds: float,
              payloads: list[np.ndarray] | None = None,
              op_bytes: int = 4096, op_class: str = CLIENT_OP,
              timeout: float = 300.0) -> dict:
    """Fixed arrival rate for ``seconds``; latency includes queueing
    delay (no coordinated omission).  Fail-fast engines count rejected
    arrivals instead of blocking the arrival process."""
    if not engine.running:
        raise ValueError("open loop needs a started (threaded) engine")
    if payloads is None:
        payloads = make_payloads(op_bytes)
    lock = threading.Lock()
    lat: list[float] = []
    rejected = 0
    before = _perf_snapshot(engine)

    def on_done(fut) -> None:
        with lock:
            lat.append(fut.t_done - fut.t_submit)

    period = 1.0 / rate_ops_s
    t0 = time.monotonic()
    offered = 0
    next_t = t0
    while True:
        now = time.monotonic()
        if now >= t0 + seconds:
            break
        if now < next_t:
            time.sleep(min(next_t - now, 0.01))
            continue
        try:
            fut = engine.submit_encode(payloads[offered % len(payloads)],
                                       op_class=op_class)
            fut.add_done_callback(on_done)
        except ThrottleFull:
            rejected += 1
        offered += 1
        next_t += period
    engine.flush(timeout)
    elapsed = time.monotonic() - t0
    done = len(lat)
    op_nbytes = int(payloads[0].nbytes)
    out = {
        "mode": "open", "offered_ops_s": rate_ops_s, "ops": done,
        "rejected": rejected, "op_bytes": op_nbytes,
        "elapsed_s": round(elapsed, 4),
        "ops_s": round(done / elapsed, 1) if elapsed else 0.0,
        "mb_s": round(done * op_nbytes / elapsed / 1e6, 2)
        if elapsed else 0.0,
    }
    out.update(_latency_stats(lat))
    out.update(_engine_deltas(engine, before))
    return out


def compare_batched_unbatched(ec_impl, sinfo, n_ops: int = 512,
                              concurrency: int = 64, op_bytes: int = 4096,
                              cct=None, warmup_ops: int = 64,
                              batch_max_ops: int | None = None,
                              timeout: float = 300.0) -> dict:
    """The acceptance-gate measurement: the SAME closed-loop workload on
    the SAME device through (a) a coalescing engine and (b) an
    op-at-a-time engine (``batch_max_ops=1`` — every op is its own device
    dispatch).  A warmup pass per engine takes shape compilation out of
    the measured window (the size buckets exist so steady state has a
    bounded shape set)."""
    results: dict = {"concurrency": concurrency, "op_bytes": op_bytes,
                     "n_ops": n_ops}
    payloads = make_payloads(op_bytes)
    for label, max_ops in (("batched",
                            batch_max_ops or min(concurrency, 64)),
                           ("unbatched", 1)):
        eng = ServingEngine(cct=cct, ec_impl=ec_impl, sinfo=sinfo,
                            name=f"bench.{label}",
                            max_ops=max(1024, concurrency * 2),
                            max_bytes=max(64 << 20,
                                          concurrency * op_bytes * 4),
                            batch_max_ops=max_ops,
                            batch_max_delay_ms=2.0).start()
        try:
            closed_loop(eng, warmup_ops, concurrency, payloads,
                        timeout=timeout)                       # warm shapes
            results[label] = closed_loop(eng, n_ops, concurrency, payloads,
                                         timeout=timeout)
        finally:
            eng.stop()
    b, u = results["batched"]["ops_s"], results["unbatched"]["ops_s"]
    results["speedup"] = round(b / u, 2) if u else 0.0
    return results
