"""CodecPipeline: depth-limited async dispatch of codec batches on a CUDA
stream.

The port of ``ceph_tpu.ops.pipeline``.  A synchronous ``RSCodec.encode``
copies from pageable memory, launches, and copies back with a blocking
``.cpu()``, so the host pack and unpack (the shard-major transposes of
``backend/ecutil.py``) and the card's work run one after the other.  The
pipeline keeps up to ``depth`` dispatched batches in flight and defers the
wait on the card to an explicit completion boundary:

    submit(pack, dispatch, unpack):
        pack()              host: build the packed uint8 block, straight
                            into pinned memory (:meth:`host_block`)
        dispatch(packed)    on the pipeline's CUDA stream: pinned -> card
                            (non_blocking), the gf_apply kernel, card ->
                            pinned output (non_blocking), an event
        -> PipelineFuture
    completion (oldest-first once depth is exceeded, or flush(), or an
    out-of-order ``result()``):
        event wait, numpy view of the pinned output   <- the ONLY wait
        unpack(packed, host) -> future's result

What JAX gave for free the port builds by hand:

- *Asynchrony.*  JAX dispatch is asynchronous by default; here one CUDA
  stream per pipeline (per card) carries every dispatch, the launches sit
  inside ``torch.cuda.stream(stream)`` (the kernel wrappers launch on the
  current stream), and both copies are ``non_blocking`` from and to
  pinned host memory.  A copy from pageable memory would block the host,
  so the pipeline never calls ``RSCodec.to_device`` on data.  The codec's
  one-time matrix uploads run before the stream context, on the default
  stream, so they never wait on in-flight pipeline work.
- *The completion boundary.*  ``jax.block_until_ready`` + ``device_get``
  become one wait on the event recorded after the output copy, then a
  numpy view of the pinned output.  Nothing else waits on the card: no
  ``.cpu()``, ``.numpy()`` or ``.item()`` on a CUDA tensor, no
  ``torch.cuda.synchronize()``.  The wait is ``Event.synchronize``, which
  releases the GIL, so the coalescer packs the next batch while a
  completer waits (``chip_smoke.py`` phase ``serving`` checks this).
- *Lifetimes.*  The pinned input and output, and the card's input and
  output tensors, belong to the future until its event completes
  (:class:`_Dispatched` holds them).  A matrix tensor made on another
  stream takes ``record_stream`` before the pipeline's stream reads it.
- *Buffer donation* (``ceph_tpu/ops/codec.py``'s donated apply) has no
  PyTorch counterpart and is dropped: a launch never aliases its input,
  and the input tensor is freed when the future drops it.

A ``device="cpu"`` codec dispatches the plain PyTorch version
synchronously and its completion waits on nothing (the CPU tests).

The repair legs have no ``RSCodec``: :meth:`CodecPipeline.dispatch_apply`
takes the matrix and a pinned block of rows ([data; running sums] for a
chain hop) with the device named by the caller, and returns the same
dispatched batch as the codec's directions.

A failure on the card (dispatch, event wait or kernel) fails the
future and so the op: the pipeline has no host fallback, so a kernel
fault is never served quietly by the CPU.  The circuit breaker of the
JAX package stays, failing fast: after ``pipeline_breaker_threshold``
consecutive device failures a submit fails at once with
:class:`~ceph_tpu_torch.failure.breaker.BreakerOpen`, without touching
the card, until a half-open probe after ``pipeline_breaker_cooldown``
succeeds.  Every stage lands on the tracer
(``pipeline.pack``/``dispatch``/``complete`` spans) and the in-flight
depth on a perf histogram.

Multi-card: ``jax_rs_mesh_devices`` >= 2 with that many cards present
raises ``NotImplementedError`` at construction (the mesh steps are not
ported yet); with fewer cards the option is ignored, as in the JAX
package.  ``mesh_dispatches`` stays, at 0.
"""
from __future__ import annotations

import collections
import threading
import weakref

import numpy as np
import torch

from ..common import default_context
from ..common import device_attribution
from ..common.perf_counters import PerfCountersBuilder
from ..common.tracer import (activate_trace, current_trace,
                             default_tracer, trace_span)
from ..failure.breaker import BreakerOpen, CircuitBreaker, state_rank
from ..failure.injector import InjectedFault, InjectedOOM
from .codec import scale_accumulate_device

DEPTH_BUCKETS = [0, 1, 2, 4, 8, 16, 32]

_MISSING = object()


class _Dispatched:
    """One dispatched batch on the card: the pinned host output its copy
    lands in, the event recorded after that copy, and the tensors that
    must stay alive until the event completes."""

    __slots__ = ("out", "event", "keep")

    def __init__(self, out: torch.Tensor, event, keep: tuple):
        self.out = out
        self.event = event
        self.keep = keep

    @property
    def nbytes(self) -> int:
        return int(self.out.nbytes)

    def wait(self) -> np.ndarray:
        """Wait for the batch's event; the pinned output as numpy."""
        self.event.synchronize()
        self.keep = None
        return self.out.numpy()


def settle(dev):
    """The completion boundary's wait: a dispatched batch's host array.
    A :class:`_Dispatched` (or anything with ``wait``) waits on its event;
    a CPU tensor (a cpu codec's dispatch) is already done."""
    if hasattr(dev, "wait"):
        return dev.wait()
    if isinstance(dev, torch.Tensor):
        return dev.numpy()
    return dev


def launch(dev: torch.device, host: np.ndarray, run, keep: tuple = (),
           stream=None) -> _Dispatched | torch.Tensor:
    """The dispatch body every batch shares: ``host`` [rows, N] uint8
    (pinned for a card, see :meth:`CodecPipeline.host_block`) to ``dev``
    on ``stream`` (None: the current stream), ``run(card_input)`` (the
    kernel), the result back into a pinned output, an event.  ``keep``:
    tensors the launch reads, held until the event (a card tensor made on
    another stream takes ``record_stream``).  On the CPU ``run`` takes
    the host tensor and its result returns as it is.  :func:`settle`
    waits for either."""
    src = torch.from_numpy(np.ascontiguousarray(host, dtype=np.uint8))
    if dev.type == "cpu":
        return run(src)
    with torch.cuda.device(dev), torch.cuda.stream(stream):
        stream = torch.cuda.current_stream(dev)
        for t in keep:
            if t.is_cuda:
                t.record_stream(stream)
        card_in = src.to(dev, non_blocking=True)
        card_out = run(card_in)
        out = torch.empty(tuple(card_out.shape), dtype=card_out.dtype,
                          pin_memory=True)
        out.copy_(card_out, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
    return _Dispatched(out, event, (src, card_in, card_out, *keep))


def apply_rows(mat: np.ndarray, block: np.ndarray, k: int,
               dev: torch.device, stream=None) -> _Dispatched | torch.Tensor:
    """A GF(2^8) apply with no ``RSCodec`` behind it: the chain-repair
    hop and the regenerating-repair legs.  ``block`` [k + a, N] host
    uint8 (from :meth:`CodecPipeline.host_block` for ``dev``) holds the
    data rows [0, k) and, for a hop, the running sums [k, k + a) the
    product XORs into (a = 0: none); ``mat`` [r, k] (a = 0 or r).  The
    block and the matrix go to the card in one copy each, from pinned
    memory, on ``stream`` -> ``[r, N]`` through :func:`launch`."""
    mat_t = torch.from_numpy(np.array(mat, dtype=np.uint8))
    if dev.type == "cuda":
        mat_t = mat_t.pin_memory()

    def run(card):
        acc = card[k:] if card.shape[0] > k else None
        return scale_accumulate_device(
            mat_t.to(card.device, non_blocking=True), card[:k], acc)
    return launch(dev, block, run, keep=(mat_t,), stream=stream)


class PipelineFuture:
    """Completion handle for one in-flight device batch.

    ``result()``/``exception()`` FORCE completion when the item is still
    in flight (out-of-order completion is legal: forcing item 3 before
    item 1 completes 3 alone; 1 stays dispatched).  Device-side failures
    (anything the event wait or the unpack stage raises) surface here,
    never on the dispatching thread.

    ``timeout`` bounds only the wait for ANOTHER thread to finish the
    item: the forcing path runs the completion itself and waits on the
    card unboundedly.
    """

    __slots__ = ("kind", "meta", "owner", "trace",
                 "_pipeline", "_packed", "_dev", "_unpack",
                 "_dispatched_at", "_event", "_result",
                 "_error", "_callbacks", "_cb_lock")

    def __init__(self, pipeline: "CodecPipeline", kind: str, meta: dict,
                 owner: str = "client", trace=None):
        self.kind = kind
        self.meta = meta
        # the owner class this batch's device occupancy is charged to
        # (common/device_attribution), resolved on the SUBMITTING thread
        # where the trace context is active
        self.owner = owner
        # the submitter's TraceContext: completion spans run on whatever
        # thread forces the boundary, and activating this keeps them in
        # the op's trace
        self.trace = trace
        self._pipeline = weakref.ref(pipeline)
        self._packed = None
        self._dev = None
        self._unpack = None
        self._dispatched_at = 0.0
        self._event = threading.Event()
        self._result = None
        self._error: BaseException | None = None
        self._callbacks: list = []
        self._cb_lock = threading.Lock()

    # -- consumer side -----------------------------------------------------

    def done(self) -> bool:
        return self._event.is_set()

    @property
    def value(self):
        """The result, valid once done (for done-callbacks)."""
        return self._result

    @property
    def error(self) -> BaseException | None:
        """The failure, valid once done (for done-callbacks)."""
        return self._error

    def _force(self) -> None:
        if not self._event.is_set():
            pl = self._pipeline()
            if pl is not None:
                pl.complete(self)

    def result(self, timeout: float | None = None):
        self._force()
        if not self._event.wait(timeout):
            raise TimeoutError(f"pipeline item not complete within {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result

    def exception(self, timeout: float | None = None):
        self._force()
        if not self._event.wait(timeout):
            raise TimeoutError(f"pipeline item not complete within {timeout}s")
        return self._error

    def add_done_callback(self, fn) -> None:
        """``fn(future)`` on completion; immediate when already done."""
        with self._cb_lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    # -- pipeline side -----------------------------------------------------

    def _finish(self, result, error: BaseException | None) -> None:
        with self._cb_lock:
            self._result = result
            self._error = error
            self._event.set()
            callbacks, self._callbacks = self._callbacks, []
        for fn in callbacks:
            fn(self)


def _build_perf(name: str):
    return (PerfCountersBuilder(name)
            .add_u64("in_flight", "dispatched device batches not yet "
                                  "completed (the pipeline's depth gauge)")
            .add_u64_counter("submitted", "batches submitted to the pipeline")
            .add_u64_counter("completed", "batches completed (event wait + "
                                          "unpack)")
            .add_u64_counter("errors", "batches that failed in pack, "
                                       "dispatch, device compute, or "
                                       "unpack, or were refused by the "
                                       "open breaker")
            .add_u64_counter("mesh_dispatches",
                             "batches split across a device mesh (not "
                             "ported: stays 0)")
            .add_u64("breaker_state",
                     "circuit breaker state (0 closed, 1 half-open "
                     "probe in flight, 2 open: submits fail fast)")
            .add_histogram("inflight_depth", DEPTH_BUCKETS,
                           "in-flight depth observed at each dispatch")
            .add_time_avg("pack_time", "host pack stage (overlaps in-flight "
                                       "device work)")
            .add_time_avg("dispatch_time", "async device dispatch stage")
            .add_time_avg("complete_time", "completion boundary: event "
                                           "wait + host unpack")
            .create_perf_counters())


class CodecPipeline:
    """Depth-limited async dispatch queue over the device codec.

    ``depth`` bounds in-flight device batches (0 = synchronous: every
    submit completes before returning — the comparison baseline).  When a
    submit exceeds the bound, the OLDEST item completes first: that is
    the pipeline's backpressure AND its completion boundary on the
    steady-state path.
    """

    def __init__(self, depth: int | None = None,
                 name: str = "codec_pipeline", cct=None,
                 mesh_devices: int | None = None):
        self.cct = cct if cct is not None else default_context()
        conf = self.cct.conf
        self.name = name
        self.depth = int(conf.get("jax_rs_pipeline_depth")
                         if depth is None else depth)
        self.mesh_devices = int(conf.get("jax_rs_mesh_devices")
                                if mesh_devices is None else mesh_devices)
        self._mesh_ctx()                # raises where a mesh would engage
        self.perf = _build_perf(name)
        self.cct.perf.add(self.perf)
        self._lock = threading.Lock()
        self._queue: collections.OrderedDict = collections.OrderedDict()
        # one CUDA stream per card this pipeline dispatches to
        self._streams: dict[int, torch.cuda.Stream] = {}
        # circuit breaker on the device path (failure/breaker.py):
        # pipeline_breaker_threshold consecutive device failures open it
        # and submits fail fast with BreakerOpen until a half-open probe
        # (after pipeline_breaker_cooldown) re-closes.  Threshold 0
        # disables.
        thresh = int(conf.get("pipeline_breaker_threshold"))
        self.breaker = CircuitBreaker(
            f"{name}.breaker", threshold=thresh,
            cooldown=float(conf.get("pipeline_breaker_cooldown"))) \
            if thresh > 0 else None
        # device-plane fault injection (failure/injector.py): when set,
        # dispatch/completion rolls may raise InjectedFault/InjectedOOM
        self.fault_injector = None

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        """Drain and unhook the perf collection (a discarded component
        must not leave frozen gauges behind); the breaker leaves the live
        registry."""
        self.flush()
        self.cct.perf.remove(self.perf.name)
        if self.breaker is not None:
            self.breaker.close()

    def reopen(self) -> None:
        """Re-register the perf collection AND the breaker after a close
        (engine restart)."""
        self.cct.perf.add(self.perf)
        if self.breaker is not None:
            self.breaker.reopen()

    # -- fault injection (device plane) ------------------------------------

    def inject_faults(self, injector) -> None:
        """Attach (or, with None, detach) a FaultInjector whose device
        plane rolls dispatch/completion failures and simulated OOM into
        this pipeline — the chaos harness hook."""
        self.fault_injector = injector

    def _roll_device_fault(self, stage: str) -> None:
        inj = self.fault_injector
        if inj is None:
            return
        f = inj.plan.device
        if stage == "dispatch":
            if inj.roll("device", "oom", f.oom_prob, target=self.name):
                raise InjectedOOM("RESOURCE_EXHAUSTED: injected device "
                                  "OOM at dispatch")
            if inj.roll("device", "dispatch_fail", f.dispatch_fail_prob,
                        target=self.name):
                raise InjectedFault("injected device dispatch failure")
        elif inj.roll("device", "completion_fail",
                      f.completion_fail_prob, target=self.name):
            raise InjectedFault("injected device completion failure")

    # -- breaker bookkeeping -----------------------------------------------

    def _device_failure(self) -> None:
        if self.breaker is not None:
            self.breaker.record_failure()
            self.perf.set("breaker_state", state_rank(self.breaker.state))

    def _device_success(self) -> None:
        if self.breaker is not None:
            self.breaker.record_success()
            self.perf.set("breaker_state", 0)

    @property
    def in_flight(self) -> int:
        with self._lock:
            return len(self._queue)

    # -- submission --------------------------------------------------------

    def submit(self, pack, dispatch, unpack, kind: str = "op",
               owner: str | None = None, **meta) -> PipelineFuture:
        """Run ``pack()`` (host) and ``dispatch(packed)`` (async device
        launch) NOW; defer ``unpack(packed, host_arrays)`` to the
        completion boundary.  Returns the future; errors in any stage
        land on it.  ``owner`` tags the batch's device occupancy
        (client/serving/recovery/scrub/rebalance); when omitted it
        resolves from the active TraceContext's op class.  While the
        breaker is open the future fails at once with
        :class:`BreakerOpen` and ``dispatch`` is not called."""
        fut = PipelineFuture(self, kind, meta,
                             owner=device_attribution.resolve_owner(owner),
                             trace=current_trace())
        self.perf.inc("submitted")
        # pack is host work: its failures are the caller's bug, never
        # breaker evidence — keep it outside the device try
        try:
            with trace_span("pipeline.pack", kind=kind, owner=fut.owner), \
                    self.perf.time("pack_time"):
                packed = pack() if pack is not None else None
            fut._packed = packed
        except BaseException as e:              # noqa: BLE001 — the future
            self.perf.inc("errors")             # carries the failure
            fut._finish(None, e)
            return fut
        if self.breaker is not None and not self.breaker.allow():
            self.perf.inc("errors")
            fut._packed = None
            fut._finish(None, BreakerOpen(
                f"{self.breaker.name}: {self.breaker.consecutive_failures} "
                f"consecutive device failures; failing fast"))
            return fut
        try:
            self._roll_device_fault("dispatch")
            with trace_span("pipeline.dispatch", kind=kind,
                            owner=fut.owner), \
                    self.perf.time("dispatch_time"):
                fut._dev = dispatch(packed)
            fut._dispatched_at = device_attribution.dispatch_mark()
            fut._unpack = unpack
        except BaseException as e:              # noqa: BLE001 — the future
            self._device_failure()              # carries the failure
            self.perf.inc("errors")
            fut._packed = None
            fut._finish(None, e)
            return fut
        with self._lock:
            self._queue[fut] = True
            depth = len(self._queue)
        self.perf.hinc("inflight_depth", depth)
        self.perf.set("in_flight", depth)
        if self.depth <= 0:
            self.complete(fut)                  # synchronous mode
        else:
            while True:
                with self._lock:
                    if len(self._queue) <= self.depth:
                        break
                    oldest = next(iter(self._queue))
                self.complete(oldest)
        return fut

    # -- completion boundary -----------------------------------------------

    def complete(self, fut: PipelineFuture) -> PipelineFuture:
        """Complete ONE item (possibly out of order): the only place the
        serving data path waits on the card."""
        with self._lock:
            present = self._queue.pop(fut, _MISSING) is not _MISSING
            self.perf.set("in_flight", len(self._queue))
        if not present:
            # already completed (or another thread is completing it now)
            fut._event.wait()
            return fut
        result, error = None, None
        recorded = device_ok = False
        try:
            with activate_trace(fut.trace), \
                    trace_span("pipeline.complete", kind=fut.kind,
                               owner=fut.owner), \
                    self.perf.time("complete_time"):
                self._roll_device_fault("completion")
                host = settle(fut._dev)
                device_ok = True
                self._device_success()
                # device occupancy ends at the event: the host unpack
                # below is HOST time
                device_attribution.record_batch(
                    fut.owner, fut._dispatched_at,
                    getattr(host, "nbytes", 0) or 0)
                recorded = True
                result = fut._unpack(fut._packed, host) \
                    if fut._unpack is not None else host
        except BaseException as e:              # noqa: BLE001 — device-side
            error = e                           # failures surface on the
            if not recorded:                    # future, not the completer
                # the card was busy up to the failure either way
                device_attribution.record_batch(fut.owner,
                                                fut._dispatched_at, 0)
            if not device_ok:
                self._device_failure()
            self.perf.inc("errors")
        self.perf.inc("completed")
        # free buffers promptly
        fut._packed = fut._dev = fut._unpack = None
        fut._finish(result, error)
        # pipeline completion boundary: fold this thread's pending span
        # batch into the tracer ring once per completed item
        default_tracer().flush()
        return fut

    def complete_one(self) -> bool:
        """Complete the oldest in-flight item; False when empty."""
        with self._lock:
            if not self._queue:
                return False
            oldest = next(iter(self._queue))
        self.complete(oldest)
        return True

    def flush(self) -> None:
        """Complete everything in flight (oldest first)."""
        while self.complete_one():
            pass

    # -- device dispatch helpers ---------------------------------------------

    def _mesh_ctx(self):
        """None: the single-card path.  ``jax_rs_mesh_devices`` >= 2 with
        that many cards present would engage a mesh, which the port does
        not have yet, so it raises rather than quietly run on one card."""
        if self.mesh_devices < 2 or \
                torch.cuda.device_count() < self.mesh_devices:
            return None
        raise NotImplementedError(
            f"jax_rs_mesh_devices={self.mesh_devices}: the multi-card "
            f"codec pipeline is not ported yet")

    def _stream(self, dev: torch.device) -> torch.cuda.Stream | None:
        """The pipeline's stream on card ``dev``; None for the CPU."""
        if dev.type != "cuda":
            return None
        index = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        stream = self._streams.get(index)
        if stream is None:
            stream = self._streams.setdefault(
                index, torch.cuda.Stream(device=index))
        return stream

    @staticmethod
    def host_block(dev: torch.device, shape) -> np.ndarray:
        """An uninitialised uint8 host array for a batch bound for ``dev``:
        a numpy view of pinned memory for a card (so the copy to it is
        asynchronous), plain numpy for the CPU."""
        if dev.type == "cuda":
            return torch.empty(tuple(shape), dtype=torch.uint8,
                               pin_memory=True).numpy()
        return np.empty(tuple(shape), dtype=np.uint8)

    def _launch(self, dev: torch.device, host: np.ndarray, run,
                keep: tuple = ()) -> _Dispatched | torch.Tensor:
        """:func:`launch` on the pipeline's stream for ``dev``."""
        return launch(dev, host, run, keep, self._stream(dev))

    def dispatch_encode(self, codec, data_shards, chunk_size: int):
        """``data_shards`` [k, S*chunk] host uint8 (logical row order) ->
        parity [m, S*chunk], dispatched async on the pipeline's stream;
        ``chunk_size`` is the JAX package's mesh split unit, unused on one
        card."""
        mat = codec.parity_matrix_device()
        return self._launch(codec.torch_device, data_shards,
                            codec.encode_device, keep=(mat,))

    def dispatch_decode(self, codec, stack, erasures, available):
        """``stack`` [k', S*chunk] host uint8 survivors in the sorted-src
        order ``codec.decode_matrix(erasures, available)`` returns ->
        recovered rows [len(erasures), S*chunk], async.  The decode matrix
        is the codec's card-resident LRU copy."""
        mat, _src = codec.decode_matrix_device(erasures, available)
        return self._launch(
            codec.torch_device, stack,
            lambda card: codec.decode_device(card, erasures, available),
            keep=(mat,))

    def dispatch_apply(self, mat: np.ndarray, block: np.ndarray, k: int,
                       dev: torch.device):
        """:func:`apply_rows` on the pipeline's stream for ``dev``, as a
        dispatched batch (a CPU tensor for ``dev`` cpu)."""
        return apply_rows(mat, block, k, dev, self._stream(dev))
