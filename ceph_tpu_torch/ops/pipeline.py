"""CodecPipeline: depth-limited async dispatch of codec batches on a CUDA
stream.

The port of ``ceph_tpu.ops.pipeline``.  A synchronous ``RSCodec.encode``
copies from pageable memory, launches, and copies back with a blocking
``.cpu()``, so the host pack and unpack (the shard-major transposes of
``backend/ecutil.py``) and the card's work run one after the other.  The
pipeline keeps up to ``depth`` dispatched batches in flight and defers the
wait on the card to an explicit completion boundary:

    submit(pack, dispatch, unpack):
        pack()              host: the batch's block of chunk rows, straight
                            into pinned memory (:meth:`host_block`)
        dispatch(block)     on the pipeline's CUDA stream: the block's
                            input rows -> card (non_blocking), the
                            gf_apply kernel, the result -> the block's
                            output rows (non_blocking), an event
        -> PipelineFuture
    completion (oldest-first once depth is exceeded, or flush(), or an
    out-of-order ``result()``):
        event wait: the batch settles to its block   <- the ONLY wait
        the batch's stream seconds from its timing events
        unpack(packed, block) -> future's result

*The batch layout.*  Every GF(2^8) apply the pipeline dispatches reads
and writes one block of chunk rows: rows [0, k) are the k data chunks in
logical order, then, in logical id order, only the parity rows the batch
reads or writes (a repair leg: its data rows, then its running-sum
rows).  An encode's block is [n, N], the parity landing in rows [k, n);
a decode's survivors are packed once into their rows and the erased rows
land in their own (:func:`launch`'s ``rows`` and ``land``).  The one
result that is not rows of a block, ``crc32c_rows``' checksums, lands in
a pinned output of its own.

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
  become one wait on the event recorded after the output copy; the
  block is then the batch's host result.  Nothing else waits on the card: no
  ``.cpu()``, ``.numpy()`` or ``.item()`` on a CUDA tensor, no
  ``torch.cuda.synchronize()``.  The wait is ``Event.synchronize``, which
  releases the GIL, so the coalescer packs the next batch while a
  completer waits (``chip_smoke.py`` phase ``serving`` checks this).
- *Lifetimes.*  The pinned block, and the card's input and output
  tensors, belong to the future until its event completes
  (:class:`_Dispatched` holds them).  A matrix tensor made on another
  stream takes ``record_stream`` before the pipeline's stream reads it.
- *Buffer donation* (``ceph_tpu/ops/codec.py``'s donated apply) has no
  PyTorch counterpart and is dropped: a launch never aliases its input,
  and the input tensor is freed when the future drops it.

A ``device="cpu"`` codec dispatches the plain PyTorch version
synchronously and its completion waits on nothing (the CPU tests).

*Device time.*  Every dispatch records a timing event on its stream
before the H2D copy, and the event that closes the batch is a timing
event too, so once the wait returns the batch's stream seconds (H2D
copy, kernel, D2H copy, in stream order) are the events' elapsed time;
a mesh batch takes the longest of its cards', a cpu codec the host
time of its synchronous run.  Completion books them in
``common/device_attribution`` (``device top``, prometheus), in the
``device_time`` counter and on the ``pipeline.wait`` span
(``device_s``).  The events are recorded with the instruments off too.

The repair legs have no ``RSCodec``: :meth:`CodecPipeline.dispatch_apply`
takes the matrix and a pinned block of rows ([data; running sums] for a
chain hop, [data; empty rows] for a leg with no sums) with the device
named by the caller, and returns the same dispatched batch as the
codec's directions.

A failure on the card (dispatch, event wait or kernel) fails the
future and so the op: the pipeline has no host fallback, so a kernel
fault is never served quietly by the CPU.  The circuit breaker of the
JAX package stays, failing fast: after ``pipeline_breaker_threshold``
consecutive device failures a submit fails at once with
:class:`~ceph_tpu_torch.failure.breaker.BreakerOpen`, without touching
the card, until a half-open probe after ``pipeline_breaker_cooldown``
succeeds.  Every stage lands on the tracer
(``pipeline.pack``/``dispatch``/``complete`` spans, the completion split
into ``pipeline.wait`` and ``pipeline.unpack``) and the in-flight depth
on a perf histogram.

Multi-card: with ``jax_rs_mesh_devices`` >= 2 and that many cards
present (or a :class:`~ceph_tpu_torch.parallel.mesh.Mesh` set as the
``mesh`` attribute), encode and decode batches go through the mesh steps
of ``parallel/mesh.py``, as the JAX package's do (``ceph_tpu/ops/
pipeline.py:466-565``): ``sharded_batch_encode_step`` on the batch's
stripes [S, k, chunk], zero stripes padding S to a multiple of dp, and
``sharded_decode_step`` on the survivors [k', S*chunk], the decode
matrix's column blocks the codec's copies on each shard's card.  With
fewer cards the option is ignored.  A mesh that fails to build raises:
the pipeline never serves from one card in its place.  The reference's
shape rules pick the path: an encode batch whose bytes are not whole
chunks, or whose chunk does not split over sp, and a decode whose
survivors are not the decode matrix's, take the single-card path.  A
mesh dispatch is asynchronous like a single one: the steps run with the
pipeline's stream current on every card, ``mesh.shard`` moves each
shard's block there (gathered into pinned memory first, so the move is
asynchronous), ``Sharded.host`` brings the result blocks back into one
pinned buffer, and an event on every card's stream closes the batch;
the batch waits on all of them (:class:`_Dispatched`), then puts the
blocks in place in its block's output rows and settles to that block
like any other.  ``mesh_dispatches`` counts the batches.
"""
from __future__ import annotations

import collections
import contextlib
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
    """One dispatched batch on the card (or the cards of a mesh): ``out``,
    the host array it settles to (the caller's block, whose rows the
    result lands in; the crc checksums' own pinned output), ``nbytes``,
    the bytes the result brings back, the timing events recorded after
    the copies (one a card) and ``starts``, those recorded before the
    batch's first copy (one a card), the tensors that must stay alive
    until the events complete, and, for a mesh batch, ``finish(out)``:
    puts the result's blocks, landed in a pinned buffer of their own, in
    ``out``'s rows (the padding dropped).  A cpu codec's batch ran at
    dispatch: no events, ``host_s`` its run's seconds."""

    __slots__ = ("out", "events", "keep", "finish", "starts", "host_s",
                 "nbytes")

    def __init__(self, out, events: tuple, keep: tuple, finish=None,
                 starts: tuple = (), host_s: float = 0.0, nbytes: int = 0):
        self.out = out
        self.events = events
        self.keep = keep
        self.finish = finish
        self.starts = starts
        self.host_s = host_s
        self.nbytes = nbytes

    def wait(self):
        """Wait for the batch's events; ``out`` with the result in it."""
        for event in self.events:
            event.synchronize()
        self.keep = None
        if self.finish is not None:
            self.finish(self.out)
        return self.out

    def seconds(self) -> float:
        """After :meth:`wait`: the batch's seconds on its stream, each
        card's start event to its closing event, the longest of the
        cards; a cpu run's ``host_s``."""
        if not self.starts:
            return self.host_s
        return max(s.elapsed_time(e)
                   for s, e in zip(self.starts, self.events)) / 1e3


def settle(dev):
    """The completion boundary's wait: a dispatched batch's host array.
    A :class:`_Dispatched` (or anything with ``wait``) waits on its event;
    a CPU tensor (a cpu codec's dispatch) is already done."""
    if hasattr(dev, "wait"):
        return dev.wait()
    if isinstance(dev, torch.Tensor):
        return dev.numpy()
    return dev


def stream_seconds(dev) -> float:
    """A settled batch's seconds on the device (:meth:`_Dispatched.
    seconds`); 0 for a dispatch that ran nothing (a decode whose data
    rows all survived)."""
    return dev.seconds() if isinstance(dev, _Dispatched) else 0.0


def _runs(rows) -> list[tuple[int, int, int]]:
    """``(position, row, count)`` of each run of consecutive ``rows``: the
    copies that move those rows between a block and a packed tensor."""
    runs: list[tuple[int, int, int]] = []
    for pos, row in enumerate(int(r) for r in rows):
        if runs and runs[-1][1] + runs[-1][2] == row:
            runs[-1] = (runs[-1][0], runs[-1][1], runs[-1][2] + 1)
        else:
            runs.append((pos, row, 1))
    return runs


def _timing_event(stream) -> torch.cuda.Event:
    event = torch.cuda.Event(enable_timing=True)
    event.record(stream)
    return event


def launch(dev: torch.device, block: np.ndarray, run, rows, land,
           keep: tuple = (), stream=None) -> _Dispatched:
    """The dispatch body every batch shares.  ``block`` [R, N] C-contiguous
    uint8 (pinned for a card, see :meth:`CodecPipeline.host_block`): its
    rows ``rows``, in order, go to ``dev`` on ``stream`` (None: the
    current stream), one copy a run of consecutive rows; ``run(card_input)``
    (the kernel); the result's rows land in the block's rows ``land``, one
    copy a run, between two timing events, and the batch settles to the
    block.  ``land`` None: a result that is not rows of the block (the crc
    checksums) lands in a pinned output of its own and the batch settles
    to that.  ``keep``: tensors the launch reads, held until the event (a
    card tensor made on another stream takes ``record_stream``).  On the
    CPU ``run`` takes the rows and runs now, timed on the host.
    :func:`settle` waits for either."""
    src = torch.from_numpy(block)
    runs = _runs(rows)
    if dev.type == "cpu":
        t0 = device_attribution.dispatch_mark()
        out = run(torch.cat([src[r:r + n] for _p, r, n in runs]))
        if land is None:
            block = out.numpy()
        else:
            for p, r, n in _runs(land):
                src[r:r + n].copy_(out[p:p + n])
        return _Dispatched(block, (), (), nbytes=int(out.nbytes),
                           host_s=device_attribution.seconds_since(t0))
    with torch.cuda.device(dev), torch.cuda.stream(stream):
        stream = torch.cuda.current_stream(dev)
        for t in keep:
            if t.is_cuda:
                t.record_stream(stream)
        # the card's input and the copies' views are made before the
        # start event, so the batch's stream time opens at its first
        # copy, not at host set-up
        card_in = torch.empty((len(rows), int(src.shape[1])),
                              dtype=src.dtype, device=dev)
        copies = [(card_in[p:p + n], src[r:r + n]) for p, r, n in runs]
        start = _timing_event(stream)
        for dst, part in copies:
            dst.copy_(part, non_blocking=True)
        card_out = run(card_in)
        if land is None:
            out = torch.empty(tuple(card_out.shape), dtype=card_out.dtype,
                              pin_memory=True)
            out.copy_(card_out, non_blocking=True)
            block = out.numpy()
        else:
            for p, r, n in _runs(land):
                src[r:r + n].copy_(card_out[p:p + n], non_blocking=True)
        event = _timing_event(stream)
    return _Dispatched(block, (event,), (src, card_in, card_out, *keep),
                       starts=(start,), nbytes=int(card_out.nbytes))


def apply_rows(mat: np.ndarray, block: np.ndarray, k: int, sums: bool,
               dev: torch.device, stream=None) -> _Dispatched:
    """A GF(2^8) apply with no ``RSCodec`` behind it: the chain-repair
    hop and the regenerating-repair legs.  ``block`` [k + r, N] host
    uint8 (from :meth:`CodecPipeline.host_block` for ``dev``) holds the
    data rows [0, k), then r rows: a hop's running sums the product XORs
    into (``sums``), else empty rows; ``mat`` [r, k].  The rows the
    apply reads and the matrix go to the card in one copy each, from
    pinned memory, on ``stream``, and the [r, N] result lands in the
    block's last r rows (:func:`launch`)."""
    r = int(mat.shape[0])
    mat_t = torch.from_numpy(np.array(mat, dtype=np.uint8))
    if dev.type == "cuda":
        mat_t = mat_t.pin_memory()

    def run(card):
        acc = card[k:] if card.shape[0] > k else None
        return scale_accumulate_device(
            mat_t.to(card.device, non_blocking=True), card[:k], acc)
    return launch(dev, block, run, range(k + r if sums else k),
                  range(k, k + r), keep=(mat_t,), stream=stream)


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
                 "_event", "_result",
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
                             "batches split across the device mesh's "
                             "shards (jax_rs_mesh_devices engaged, or a "
                             "mesh set on the pipeline)")
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
            .add_time_avg("wait_time", "completion boundary: the wait on "
                                       "the batch's events (the completer "
                                       "blocked on the card)")
            .add_time_avg("unpack_time", "completion boundary: the host "
                                         "unpack into per-op results")
            .add_time_avg("device_time", "each batch's seconds on its "
                                         "stream from its timing events "
                                         "(H2D copy, kernel, D2H copy); a "
                                         "cpu codec: its run on the host")
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
        # the device mesh, built from mesh_devices when that many cards
        # are present (a mesh that fails to build raises here); a caller
        # may set the attribute to a mesh of its own
        self.mesh = self._mesh_ctx()
        # the mesh steps: the encode's a codec (each holds the parity
        # matrix on every card of its mesh), the decode's one
        self._enc_steps: weakref.WeakKeyDictionary = \
            weakref.WeakKeyDictionary()
        self._dec_step = None
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
                with trace_span("pipeline.wait", kind=fut.kind,
                                owner=fut.owner) as wait, \
                        self.perf.time("wait_time"):
                    host = settle(fut._dev)
                    device_s = stream_seconds(fut._dev)
                    wait.set(device_s=device_s)
                device_ok = True
                self._device_success()
                self.perf.tinc("device_time", device_s)
                device_attribution.record_batch(
                    fut.owner, device_s, getattr(fut._dev, "nbytes", 0))
                recorded = True
                with trace_span("pipeline.unpack", kind=fut.kind,
                                owner=fut.owner), \
                        self.perf.time("unpack_time"):
                    result = fut._unpack(fut._packed, host) \
                        if fut._unpack is not None else host
        except BaseException as e:              # noqa: BLE001 — device-side
            error = e                           # failures surface on the
            if not recorded:                    # future, not the completer
                # a batch that failed has no stream time to read: it
                # counts as a batch with no seconds
                device_attribution.record_batch(fut.owner, 0.0, 0)
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
        """A device mesh over the first ``jax_rs_mesh_devices`` cards when
        >= 2 are asked for and present; None for the single-card path.
        ``make_mesh`` failing raises: no batch is served from one card in
        the mesh's place."""
        if self.mesh_devices < 2 or \
                torch.cuda.device_count() < self.mesh_devices:
            return None
        from ..parallel import mesh as meshmod
        return meshmod.make_mesh(self.mesh_devices)

    def _mesh_for(self, codec):
        """The mesh when it engages for ``codec``: its devices are of the
        codec's type (a cpu codec never runs on a card)."""
        mesh = self.mesh
        if mesh is None or mesh.device_type != codec.torch_device.type:
            return None
        return mesh

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

    def dispatch_encode(self, codec, block, chunk_size: int):
        """``block`` [n, S*chunk] host uint8 (:meth:`host_block`) whose
        rows [0, k) hold the data in logical order -> the parity lands in
        its rows [k, n), dispatched async on the pipeline's stream, or
        over the mesh's shards when it engages and the shapes divide
        (``chunk_size`` is the unit the stripes split by)."""
        k, n = codec.k, codec.k + codec.m
        mesh = self._mesh_for(codec)
        if mesh is not None:
            out = self._mesh_encode(codec, block, int(chunk_size), mesh)
            if out is not None:
                return out
        mat = codec.parity_matrix_device()
        dev = codec.torch_device
        return launch(dev, block, codec.encode_device, range(k),
                      range(k, n), (mat,), self._stream(dev))

    def _mesh_encode(self, codec, block, c: int, mesh):
        """The encode through ``sharded_batch_encode_step`` (None: the
        shapes take the single-card path).  [k, S*c] is the stripes'
        [S, k, c] with the axes swapped, zero stripes pad S to a multiple
        of dp (a zero stripe encodes to zero parity), and the parity comes
        back into the block's rows [k, n)."""
        k, m = codec.k, codec.m
        total = block.shape[1]
        dp, sp = mesh.shape["dp"], mesh.shape["sp"]
        if c <= 0 or total % c or c % sp:
            return None
        from ..parallel import mesh as meshmod
        stripes = total // c
        step = self._mesh_step(mesh, codec)
        data = torch.from_numpy(block[:k]).view(k, stripes, c)

        def finish(parity, out):
            parity.full(out=torch.from_numpy(out[k:]).view(
                m, stripes, c).transpose(0, 1))
        return self._mesh_run(
            mesh, block, m * total, lambda: step(meshmod.shard(
                mesh, data.transpose(0, 1), ("dp", None, "sp"),
                (stripes + (-stripes) % dp, k, c))), finish)

    def dispatch_decode(self, codec, block, rows, land, erasures,
                        available):
        """``block`` [R, S*chunk] host uint8 whose rows ``rows`` are the
        survivors, in the sorted-src order ``codec.decode_matrix(erasures,
        available)`` returns -> the recovered rows land in its rows
        ``land``, one per erasure in sorted order, async (one pass each
        way, :func:`launch`).  The decode matrix is the codec's
        card-resident LRU copy.  A mesh takes the survivors as one
        stack."""
        mesh = self._mesh_for(codec)
        if mesh is not None:
            out = self._mesh_decode(codec, block, rows, land, erasures,
                                    available, mesh)
            if out is not None:
                return out
        mat, _src = codec.decode_matrix_device(erasures, available)
        dev = codec.torch_device
        return launch(
            dev, block,
            lambda card: codec.decode_device(card, erasures, available),
            rows, land, (mat,), self._stream(dev))

    def _mesh_decode(self, codec, block, rows, land, erasures, available,
                     mesh):
        """The decode through ``sharded_decode_step`` (None: the survivors
        are not the decode matrix's).  Each shard's columns of the decode
        matrix are the codec's copy on its card; zero survivors pad the
        count to a multiple of dp and zero columns the bytes to one of
        sp."""
        from ..parallel import mesh as meshmod
        erasures = sorted(int(e) for e in erasures)
        stack = block[list(rows)]
        kk, total = stack.shape
        _D, src = codec.decode_matrix(erasures, available)
        if kk != len(src):
            return None
        dp, sp = mesh.shape["dp"], mesh.shape["sp"]
        per = -(-kk // dp)
        step = self._mesh_step(mesh)

        def run():
            D = meshmod.Sharded(mesh, (len(erasures), per * dp), (None, "dp"),
                                {(i, j): codec.decode_matrix_device(
                                    erasures, available, mesh.device(i, j),
                                    (i * per, (i + 1) * per))[0]
                                 for i, j in mesh.shards()})
            return step(D, meshmod.shard(mesh, stack, ("dp", "sp"),
                                         (per * dp, total + (-total) % sp)))

        def finish(rec, out):
            got = np.empty((len(erasures), total), dtype=np.uint8)
            rec.full(out=torch.from_numpy(got))
            out[list(land)] = got
        return self._mesh_run(mesh, block, len(erasures) * total, run,
                              finish)

    def _mesh_step(self, mesh, codec=None):
        """The mesh's encode step for ``codec`` (it holds the parity matrix
        on every card of the mesh) or, with None, its decode step: built
        once a mesh, under the lock."""
        from ..parallel import mesh as meshmod
        with self._lock:
            if codec is None:
                if self._dec_step is None or self._dec_step[0] is not mesh:
                    self._dec_step = (mesh, meshmod.sharded_decode_step(mesh))
                return self._dec_step[1]
            got = self._enc_steps.get(codec)
            if got is None or got[0] is not mesh:
                got = self._enc_steps[codec] = (
                    mesh, meshmod.sharded_batch_encode_step(
                        mesh, codec.parity_mat))
            return got[1]

    def _mesh_run(self, mesh, block, nbytes: int, run, finish
                  ) -> _Dispatched:
        """One mesh dispatch: ``run()`` -> the step's
        :class:`Sharded` result, made with the pipeline's stream current
        on every card of the mesh (the step's moves and launches, and the
        uploads of matrices it is the first to need, are ordered on it);
        its blocks move back into one pinned buffer, timing events a card
        open and close the batch, and once every event is done
        ``finish(landed, block)`` puts them in the block's output rows
        (``nbytes`` of them).  On CPU devices the steps run now, timed on
        the host."""
        cuda = mesh.device_type == "cuda"
        with contextlib.ExitStack() as current:
            if cuda:
                for dev in mesh.devices:
                    current.enter_context(
                        torch.cuda.stream(self._stream(dev)))
                starts = tuple(_timing_event(self._stream(dev))
                               for dev in mesh.devices)
            else:
                t0 = device_attribution.dispatch_mark()
            result = run()
            landed = result.host()
            self.perf.inc("mesh_dispatches")
            land = lambda out: finish(landed, out)      # noqa: E731
            if not cuda:
                return _Dispatched(block, (), (), land,
                                   host_s=device_attribution
                                   .seconds_since(t0), nbytes=nbytes)
            events = tuple(_timing_event(self._stream(dev))
                           for dev in mesh.devices)
        return _Dispatched(block, events, (result,), land,
                           starts=starts, nbytes=nbytes)

    def dispatch_apply(self, mat: np.ndarray, block: np.ndarray, k: int,
                       sums: bool, dev: torch.device):
        """:func:`apply_rows` on the pipeline's stream for ``dev``, as a
        dispatched batch (already run for ``dev`` cpu)."""
        return apply_rows(mat, block, k, sums, dev, self._stream(dev))
