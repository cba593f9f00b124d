"""ServingEngine: admission throttles + mClock ordering + op coalescing.

The serving subsystem the north star needs between "fast codec" and "fast
service": the reference's ``Throttle`` / ``WorkQueue`` / ``Finisher`` trio
(src/common/Throttle.h, src/common/WorkQueue.h, src/common/Finisher.h)
fused with inference-style dynamic batching:

- **admission**: every submitted op takes from a byte throttle AND an op
  throttle first — backpressure blocks (FIFO) or fails fast
  (``osd_serving_fail_fast``) instead of growing queues unboundedly;
- **ordering**: admitted ops land in a dmClock queue keyed by op CLASS
  (client vs recovery vs scrub — :mod:`ceph_tpu_torch.osd.mclock`), so QoS
  decides WHO batches first when the queue is contended;
- **coalescing**: one coalescer thread drains the queue into device
  batches through the pipelined ``ecutil.encode_many`` /
  ``decode_many`` under a deadline — an op waits at most
  ``osd_batch_max_delay_ms`` for companions, and a batch never exceeds
  ``osd_batch_max_ops``.  64 concurrent 1 MiB writes become a handful of
  fused dispatches instead of 64;
- **completion**: results come back as :class:`BatchFuture`; callbacks
  run on a :class:`Finisher`, never on the coalescer thread.

The two threads time themselves: the coalescer's ``serving.gather`` span
(and ``gather_wait_time``) covers each call of :meth:`ServingEngine.
_gather`, blocked on ops or on the batching deadline; the finisher's
``finisher.run`` span (and ``finisher_busy_time``, in the finisher's
collection ``<name>.finisher``) each stretch of callbacks it runs after
a wait.

The port of ``ceph_tpu.exec.engine``: the device pipeline is the CUDA
one of ``ops/pipeline.py``, and the engine always has one — depth 0 is
a synchronous pipeline, not a second dispatch path — so every batch for
the card goes through the same stream, pinned buffers and event.  Batches
are not padded to size buckets (``exec/batcher.py``).

Deterministic single-thread mode for tests: leave ``start()`` uncalled
and drive with ``step()``/``flush()`` — same code path, no threads.

Every queue here is bounded: the throttles bound the mClock admission
queue (ops and bytes), the finisher bounds its callback queue.
"""
from __future__ import annotations

import threading
import time
import weakref

import numpy as np

from ..backend import ecutil
from ..common import default_context
from ..common.perf_counters import PerfCountersBuilder
from ..common.tracer import LATENCY_BUCKETS_S, default_tracer, trace_span
from ..ops.pipeline import CodecPipeline
from ..osd.mclock import CLIENT_OP, MClockOpClassQueue
from .batcher import BatchFuture, DECODE, ENCODE, dispatch_batch
from .finisher import Finisher
from .throttle import Throttle, ThrottleFull

# live engines, for the prometheus mclock-depth gauge export
_ENGINES: "weakref.WeakSet[ServingEngine]" = weakref.WeakSet()

BATCH_SIZE_BUCKETS = [1, 2, 4, 8, 16, 32, 64, 128, 256]


def live_engines() -> list["ServingEngine"]:
    return list(_ENGINES)


def _build_perf(name: str):
    return (PerfCountersBuilder(name)
            .add_u64("queue_depth", "ops waiting for a batch slot")
            .add_u64("queue_bytes", "bytes waiting for a batch slot")
            .add_u64_counter("ops_submitted", "ops admitted")
            .add_u64_counter("ops_rejected",
                             "fail-fast admissions refused (backpressure)")
            .add_u64_counter("ops_completed", "ops finished")
            .add_u64_counter("ops_failed", "ops finished with an error")
            .add_u64_counter("batches", "device batches dispatched")
            .add_u64_counter("ops_coalesced", "ops fused into batches")
            .add_u64_counter("bytes_in", "payload bytes through the engine")
            .add_histogram("batch_size", BATCH_SIZE_BUCKETS,
                           "ops per dispatched batch")
            .add_time_avg("queue_wait_time", "submit-to-dispatch wait")
            .add_time_avg("e2e_time", "submit-to-completion latency")
            .add_histogram("queue_wait_lat", list(LATENCY_BUCKETS_S),
                           "submit-to-dispatch wait histogram (s)")
            .add_histogram("op_e2e_lat", list(LATENCY_BUCKETS_S),
                           "submit-to-completion latency histogram (s)")
            .add_time_avg("gather_wait_time",
                          "coalescer thread inside a batch's gather: "
                          "blocked on ops or on the batching deadline")
            .create_perf_counters())


class ServingEngine:
    """One serving pipeline: throttles -> dmClock queue -> coalescer ->
    fused device dispatch -> finisher completions."""

    def __init__(self, cct=None, ec_impl=None, sinfo=None,
                 name: str = "serving",
                 max_bytes: int | None = None, max_ops: int | None = None,
                 fail_fast: bool | None = None,
                 batch_max_delay_ms: float | None = None,
                 batch_max_ops: int | None = None,
                 class_info: dict | None = None,
                 pipeline_depth: int | None = None,
                 flush_to_admit: bool = False):
        self.cct = cct if cct is not None else default_context()
        conf = self.cct.conf
        self.name = name
        self.ec_impl = ec_impl          # default codec (per-op override ok)
        self.sinfo = sinfo
        self.fail_fast = bool(conf.get("osd_serving_fail_fast")
                              if fail_fast is None else fail_fast)
        # an engine its submitters step (no threads, flushed by the same
        # loop that submits, as the cluster's delivery loop does): an
        # admission that would wait flushes what the engine holds first,
        # since no other thread would free the throttles
        self.flush_to_admit = bool(flush_to_admit)
        self.batch_max_delay_ms = float(
            conf.get("osd_batch_max_delay_ms")
            if batch_max_delay_ms is None else batch_max_delay_ms)
        self.batch_max_ops = int(conf.get("osd_batch_max_ops")
                                 if batch_max_ops is None else batch_max_ops)
        self.byte_throttle = Throttle(
            f"{name}.bytes",
            conf.get("osd_serving_throttle_bytes")
            if max_bytes is None else max_bytes, cct=self.cct)
        self.op_throttle = Throttle(
            f"{name}.ops",
            conf.get("osd_serving_throttle_ops")
            if max_ops is None else max_ops, cct=self.cct)
        self.queue = MClockOpClassQueue(class_info)
        self.finisher = Finisher(name)
        # the device pipeline: coalesced batches dispatch async through it
        # (device-routed codecs only), so the NEXT batch's host pack
        # overlaps the in-flight device compute.  depth 0 = synchronous.
        self.pipeline = CodecPipeline(
            depth=pipeline_depth, cct=self.cct, name=f"{name}.pipeline")
        self.perf = _build_perf(name)
        self.cct.perf.add(self.perf)
        self.cct.perf.add(self.finisher.perf)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._idle = threading.Condition(self._lock)
        self._depth = 0
        self._qbytes = 0
        self._in_flight = 0
        self._eager = 0                 # queued ops with a blocked waiter
        self._first_t = 0.0             # oldest queued op's submit time
        self._stopping = False
        self._thread: threading.Thread | None = None
        # live-tunable batching knobs (md_config observer pattern); the
        # explicit ctor args pin a test's engine against global pokes.
        # Observers hold the engine WEAKLY: the config store outlives
        # engines and a strong closure would pin every engine forever.
        ref = weakref.ref(self)

        def _update(attr, cast):
            def obs(_name, value, _ref=ref):
                eng = _ref()
                if eng is not None:
                    setattr(eng, attr, cast(value))
            return obs
        if batch_max_delay_ms is None:
            conf.add_observer("osd_batch_max_delay_ms",
                              _update("batch_max_delay_ms", float))
        if batch_max_ops is None:
            conf.add_observer("osd_batch_max_ops",
                              _update("batch_max_ops", int))
        _ENGINES.add(self)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ServingEngine":
        """Run threaded: coalescer + finisher threads."""
        if self._thread is None:
            self._stopping = False
            # re-register counters a previous stop() unhooked (restart),
            # and rejoin the live-engine registry stop() discarded from —
            # a restarted engine must keep exporting its queue gauges
            self.cct.perf.add(self.perf)
            self.cct.perf.add(self.finisher.perf)
            self.cct.perf.add(self.byte_throttle.perf)
            self.cct.perf.add(self.op_throttle.perf)
            self.pipeline.reopen()
            _ENGINES.add(self)
            self.finisher.start()
            self._thread = threading.Thread(
                target=self._loop, name=f"coalescer-{self.name}",
                daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        """Drain everything queued, stop the threads, and unhook the
        perf collections from the Context (the repo's discipline: a
        discarded component must not leave frozen gauges in perf dump /
        prometheus forever — PGBackend.shutdown does the same)."""
        with self._lock:
            self._stopping = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self.finisher.stop()
        while self.step():              # anything submitted after join
            pass
        self._stopping = False
        for pc in (self.perf, self.finisher.perf, self.byte_throttle.perf,
                   self.op_throttle.perf):
            self.cct.perf.remove(pc.name)
        self.pipeline.close()           # drains + unhooks its perf
        _ENGINES.discard(self)

    @property
    def running(self) -> bool:
        return self._thread is not None

    def depths(self) -> dict:
        """mClock queue depth by op class (+ total/bytes gauges + the
        device breaker's state when the breaker is on)."""
        with self._lock:
            d = self.queue.depths()
            d["_total"] = self._depth
            d["_bytes"] = self._qbytes
        if self.pipeline.breaker is not None:
            d["_breaker"] = self.pipeline.breaker.state
        return d

    def pressure(self) -> float:
        """Admission occupancy in [0, 1]: the larger of the byte and op
        throttle fill fractions — the overload signal the sharded front
        end (msg/frontend.py) sheds on before work ever queues here."""
        b, o = self.byte_throttle, self.op_throttle
        return max(b.count / b.max if b.max else 0.0,
                   o.count / o.max if o.max else 0.0)

    def inject_device_faults(self, injector) -> None:
        """Route the device-plane fault injection (failure/) through this
        engine's codec pipeline — the chaos harness hook."""
        self.pipeline.inject_faults(injector)

    # -- submission ----------------------------------------------------------

    # an admission wait shorter than this never emits a trace event: the
    # uncontended fast path would otherwise add one ring entry per op
    # for a phase whose whole point is "the throttle actually blocked"
    ADMISSION_TRACE_FLOOR_S = 5e-4

    def _admit_traced(self, cost_bytes: int):
        """Admit, and stamp a ``serving.admission`` event into the
        submitter's active trace when the throttles measurably blocked
        (the critical-path ledger's ``admission`` phase).  Returns the
        submitter's TraceContext so the op's BatchFuture rides the SAME
        context (one lookup; an ambient change between two lookups
        would split admission and batch_wait across traces)."""
        tr = default_tracer()
        ctx = tr.current_ctx()
        t0 = time.monotonic()
        self._admit(cost_bytes)
        wait = time.monotonic() - t0
        if ctx is not None and wait >= self.ADMISSION_TRACE_FLOOR_S:
            tr.complete("serving.admission", time.time() - wait, wait,
                        ctx=ctx, engine=self.name)
        return ctx

    def _admit(self, cost_bytes: int) -> None:
        if self.fail_fast:
            if not self.op_throttle.get_or_fail(1):
                self.perf.inc("ops_rejected")
                raise ThrottleFull(self.op_throttle.name, 1,
                                   self.op_throttle.count,
                                   self.op_throttle.max)
            if not self.byte_throttle.get_or_fail(cost_bytes):
                self.op_throttle.put(1)
                self.perf.inc("ops_rejected")
                raise ThrottleFull(self.byte_throttle.name, cost_bytes,
                                   self.byte_throttle.count,
                                   self.byte_throttle.max)
        elif self.flush_to_admit and self._thread is None:
            for thr, c in ((self.op_throttle, 1),
                           (self.byte_throttle, cost_bytes)):
                if not thr.get_or_fail(c):
                    self.flush()
                    thr.get(c)
        else:
            self.op_throttle.get(1)
            self.byte_throttle.get(cost_bytes)

    def _enqueue(self, op: BatchFuture) -> BatchFuture:
        with self._lock:
            if self._depth == 0:
                self._first_t = op.t_submit
            self.queue.enqueue(op.op_class, op, now=op.t_submit, cost=1.0)
            self._depth += 1
            self._qbytes += op.cost_bytes
            if op.eager:
                self._eager += 1
            self.perf.set("queue_depth", self._depth)
            self.perf.set("queue_bytes", self._qbytes)
            self.perf.inc("ops_submitted")
            self.perf.inc("bytes_in", op.cost_bytes)
            self._cond.notify()
        return op

    # one bytes->uint8 conversion for the whole codebase (ecutil's)
    _as_u8 = staticmethod(ecutil._as_u8)

    def submit_encode(self, buf, op_class: str = CLIENT_OP,
                      sinfo=None, ec_impl=None,
                      eager: bool = False) -> BatchFuture:
        """Admit one encode op; returns a :class:`BatchFuture` resolving
        to ``{chunk: np.uint8 chunk bytes}`` for the (zero-padded to
        stripe width) buffer.  ``eager`` marks a submission whose caller
        blocks on the result: the coalescer then dispatches what has
        accumulated instead of waiting out the batching deadline."""
        sinfo = sinfo if sinfo is not None else self.sinfo
        ec = ec_impl if ec_impl is not None else self.ec_impl
        if sinfo is None or ec is None:
            raise ValueError("engine has no default codec: pass "
                             "sinfo/ec_impl per op or at construction")
        arr = self._as_u8(buf)
        pad = (-len(arr)) % sinfo.stripe_width
        if pad:
            arr = np.concatenate(
                [arr, np.zeros(pad, dtype=np.uint8)])
        cost = int(arr.nbytes)
        ctx = self._admit_traced(cost)
        op = BatchFuture(ENCODE, arr, sinfo, ec, op_class, cost,
                         time.monotonic(), time.time(), eager=eager,
                         trace=ctx)
        return self._enqueue(op)

    def submit_decode(self, chunks: dict, op_class: str = CLIENT_OP,
                      sinfo=None, ec_impl=None,
                      eager: bool = False) -> BatchFuture:
        """Admit one decode op (``{chunk_id: chunk bytes}``, >= k
        present); resolves to the logical bytes."""
        sinfo = sinfo if sinfo is not None else self.sinfo
        ec = ec_impl if ec_impl is not None else self.ec_impl
        if sinfo is None or ec is None:
            raise ValueError("engine has no default codec: pass "
                             "sinfo/ec_impl per op or at construction")
        payload = {c: self._as_u8(v) for c, v in chunks.items()}
        cost = int(sum(v.nbytes for v in payload.values()))
        ctx = self._admit_traced(cost)
        op = BatchFuture(DECODE, payload, sinfo, ec, op_class, cost,
                         time.monotonic(), time.time(), eager=eager,
                         trace=ctx)
        return self._enqueue(op)

    # sync conveniences (the ECBackend hook uses these) --------------------
    # eager=True: the caller blocks right here, so making it sit out the
    # full batching deadline buys nothing when it is alone — concurrent
    # sync submitters still fuse (whatever queued by dispatch time rides
    # the same batch), but a serial caller pays ~dispatch, not ~deadline.

    def encode(self, buf, op_class: str = CLIENT_OP, timeout: float = 60.0,
               **kw) -> dict:
        fut = self.submit_encode(buf, op_class, eager=True, **kw)
        if self._thread is None:
            self.flush()
        return fut.result(timeout)

    def decode(self, chunks: dict, op_class: str = CLIENT_OP,
               timeout: float = 60.0, **kw) -> bytes:
        fut = self.submit_decode(chunks, op_class, eager=True, **kw)
        if self._thread is None:
            self.flush()
        return fut.result(timeout)

    # -- the coalescer -------------------------------------------------------

    def _drain_locked(self, limit: int,
                      force: bool = False) -> list[BatchFuture]:
        """Pop up to ``limit`` ops in dmClock order (lock held).
        ``force`` serves QoS-over-limit items immediately (stop/step)."""
        ops: list[BatchFuture] = []
        while len(ops) < limit and self._depth:
            now = time.monotonic()
            item = self.queue.dequeue(now)
            if item is None:
                # everything queued is over its QoS limit.  A formed
                # batch dispatches now; an empty round waits for
                # eligibility (drains immediately on stop/step — limits
                # are rates, not suicide pacts)
                nxt = self.queue.next_eligible_time(now)
                if ops or nxt is None:
                    break
                if force or self._stopping:
                    item = self.queue.dequeue(nxt)
                    if item is None:
                        break
                else:
                    self._cond.wait(min(nxt - now, 0.05))
                    continue
            ops.append(item)
            self._depth -= 1
            self._qbytes -= item.cost_bytes
            if item.eager:
                self._eager -= 1
        self.perf.set("queue_depth", self._depth)
        self.perf.set("queue_bytes", self._qbytes)
        if self._depth:
            # leftover ops KEEP their original wait budget: the next
            # deadline derives from the oldest remaining submit time,
            # not from now (resetting would double an op's max wait
            # every partial drain)
            self._first_t = min(
                (rec.queue[0].item.t_submit
                 for rec in self.queue.clients.values() if rec.queue),
                default=time.monotonic())
        self._in_flight += len(ops)
        return ops

    def _gather(self) -> list[BatchFuture] | None:
        """Form one batch under the deadline; None = stopped and empty.
        An EMPTY list means: nothing to pack but the device pipeline has
        batches in flight — the loop completes the oldest instead of
        sleeping (the completion boundary on the idle edge)."""
        with self._lock:
            while self._depth == 0:
                if self.pipeline.in_flight:
                    return []
                if self._stopping:
                    return None
                self._cond.wait()
            deadline = self._first_t + self.batch_max_delay_ms / 1e3
            while (self._depth < self.batch_max_ops
                   and not self._eager      # a blocked sync waiter cuts
                   and not self._stopping):  # through the deadline
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._cond.wait(left)
            return self._drain_locked(self.batch_max_ops)

    def _dispatch(self, ops: list[BatchFuture]) -> None:
        t = time.monotonic()
        tr = default_tracer()
        for op in ops:
            op.t_dispatch = t
            self.perf.tinc("queue_wait_time", t - op.t_submit)
            self.perf.hinc("queue_wait_lat", t - op.t_submit)
            if op.trace is not None:
                # the submit-to-dispatch wait IS the batch-formation
                # deadline the op paid: stamped into the op's trace so
                # the critical-path ledger attributes `batch_delay`
                tr.complete("serving.batch_wait", op.t_submit_wall,
                            t - op.t_submit, ctx=op.trace,
                            engine=self.name)
        self.perf.inc("batches")
        self.perf.inc("ops_coalesced", len(ops))
        self.perf.hinc("batch_size", len(ops))
        for group, fut in dispatch_batch(ops, pipeline=self.pipeline):
            if fut is None:             # synchronous: results are landed
                self._queue_completions(group)
            else:                       # in flight on the device pipeline:
                # complete at the completion boundary (the result-landing
                # callback registered by the batcher runs first)
                fut.add_done_callback(
                    lambda _f, _g=tuple(group): self._queue_completions(_g))

    def _queue_completions(self, ops) -> None:
        for op in ops:
            self.finisher.queue(self._complete_op, op)

    def _complete_op(self, op: BatchFuture) -> None:
        op.t_done = time.monotonic()
        # release BEFORE the callbacks run: a callback that resubmits
        # (closed-loop generators) must find this op's units free
        self.byte_throttle.put(op.cost_bytes)
        self.op_throttle.put(1)
        e2e = op.t_done - op.t_submit
        self.perf.inc("ops_completed")
        if op._error is not None:
            self.perf.inc("ops_failed")
        self.perf.tinc("e2e_time", e2e)
        self.perf.hinc("op_e2e_lat", e2e)
        default_tracer().complete("serving.op", op.t_submit_wall, e2e,
                                  kind=op.kind, op_class=op.op_class)
        # finisher completion boundary: fold this thread's pending span
        # batch into the tracer ring once per retired op
        default_tracer().flush()
        with self._lock:
            self._in_flight -= 1
            if not self._in_flight and not self._depth:
                self._idle.notify_all()
        op._finish(op._result, op._error)

    def _loop(self) -> None:
        while True:
            with trace_span("serving.gather", owner="serving"), \
                    self.perf.time("gather_wait_time"):
                ops = self._gather()
            if ops is None:
                return
            if ops:
                self._dispatch(ops)
            else:
                # idle edge: nothing to pack — retire the oldest in-flight
                # device batch (completions ride the finisher as usual)
                self.pipeline.complete_one()

    # -- deterministic driving (tests / inline mode) -----------------------

    def step(self) -> int:
        """One inline coalescer round: drain up to batch_max_ops NOW (no
        deadline wait), dispatch, run completions.  Single-thread mode
        only; returns ops dispatched."""
        assert self._thread is None, "step() is for the unstarted engine"
        with self._lock:
            ops = self._drain_locked(self.batch_max_ops, force=True)
        if ops:
            self._dispatch(ops)
        self.pipeline.flush()
        self.finisher.drain()
        return len(ops)

    def flush(self, timeout: float | None = 60.0) -> None:
        """Complete everything submitted so far."""
        if self._thread is None:
            while self.step():
                pass
            return
        with self._lock:
            ok = self._idle.wait_for(
                lambda: not self._depth and not self._in_flight, timeout)
        if not ok:
            raise TimeoutError(f"serving flush timed out after {timeout}s")
        self.finisher.wait_for_empty(timeout)
