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

A copy of ``ceph_tpu.exec.workload`` with two additions: ``closed_loop``
takes ``kind="decode"``, whose payloads are ``{chunk: bytes}`` dicts
submitted through ``submit_decode`` (degraded reads), so both directions
of the serving path are driven the same way; and :class:`WorkloadKeys`,
the seeded key streams (uniform, zipf, flash crowd) of the JAX package's
``tools/rados_bench.py``, which the chaos campaign's tier phase draws
from (``tools/chaos_run.py``).
"""
from __future__ import annotations

import bisect
import random
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


class WorkloadKeys:
    """Deterministic key streams for production-shaped workloads: a
    uniform or zipfian draw over an ``n_keys`` keyspace, optionally
    overlaid with a FLASH CROWD — a window of the run during which a
    fraction of arrivals collapses onto a tiny hot set (the head of the
    zipf ranking), the "everyone opens the same object" shape a cache
    tier exists for.

    Coordinates are op-sequence PROGRESS (0..1), not wall-clock, so a
    stream is reproducible at any scale: generating 10k clients' keys
    is 10k * ops calls of :meth:`key`, seeded once.  Thread-safe (mux
    completion callbacks submit from reactor threads)."""

    def __init__(self, n_keys: int = 10000, dist: str = "uniform",
                 zipf_s: float = 1.1, flash: tuple | None = None,
                 hot_frac: float = 0.001, seed: int = 0,
                 prefix: str = "obj"):
        if dist not in ("uniform", "zipf"):
            raise ValueError(f"unknown key distribution {dist!r}")
        if flash is not None:
            frac, start, dur = flash
            if not (0.0 <= frac <= 1.0 and 0.0 <= start <= 1.0
                    and 0.0 <= dur <= 1.0):
                raise ValueError(f"flash-crowd out of [0,1]: {flash}")
        self.n = int(n_keys)
        self.dist = dist
        self.s = float(zipf_s)
        self.flash = flash
        self.hot = max(1, int(round(hot_frac * self.n)))
        self.prefix = prefix
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._seen: set[int] = set()
        self.counts = {"total": 0, "flash": 0}
        if dist == "zipf":
            # rank r (1-based) with P(r) proportional to 1/r^s: an
            # explicit CDF + bisect — exact, no rejection loop, and the
            # head of the ranking doubles as the flash-crowd hot set
            acc, cdf = 0.0, []
            for r in range(1, self.n + 1):
                acc += 1.0 / (r ** self.s)
                cdf.append(acc)
            self._cdf = [c / acc for c in cdf]

    def _rank(self) -> int:
        if self.dist == "zipf":
            return bisect.bisect_left(self._cdf, self._rng.random())
        return self._rng.randrange(self.n)

    def key(self, progress: float) -> str:
        """The next key for an arrival at ``progress`` (0..1) of the
        run: hot-set draw inside the flash-crowd window, the base
        distribution outside it."""
        with self._lock:
            self.counts["total"] += 1
            rank = None
            if self.flash is not None:
                frac, start, dur = self.flash
                if start <= progress < start + dur \
                        and self._rng.random() < frac:
                    self.counts["flash"] += 1
                    rank = self._rng.randrange(self.hot)
            if rank is None:
                rank = self._rank()
            self._seen.add(rank)
            return f"{self.prefix}{rank:08d}"

    def describe(self) -> dict:
        with self._lock:
            return {"dist": self.dist,
                    "zipf_s": self.s if self.dist == "zipf" else None,
                    "n_keys": self.n,
                    "hot_set": self.hot,
                    "flash": list(self.flash) if self.flash else None,
                    "keys_drawn": self.counts["total"],
                    "flash_draws": self.counts["flash"],
                    "distinct_keys": len(self._seen)}
