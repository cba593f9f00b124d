"""Span tracer: the process-wide timing backbone.

A copy of ``ceph_tpu.common.tracer``: the port keeps its own copy, so it
needs nothing of the JAX package.

- :class:`Span` / :class:`Tracer`: nested spans with a thread-safe bounded
  ring buffer, exported as Chrome trace-event JSON (``chrome://tracing`` /
  Perfetto load ``Tracer.dump()`` output directly).
- per-span-name latency histograms (log-spaced bounds).
- :class:`TraceContext` (trace id, parent span id, owner op class): rides
  an op across threads so the pipeline's completion spans, which run on
  whichever thread forces the boundary, land in the op's trace.

- the launch telemetry registry behind ``ops/launch_ledger.py``: per
  (kernel, launch shape) key its first launch ("compilation": the
  kernel's build or cached-library load and the synchronised first
  launch) and its later launches ("cache hits"), plus the process-wide
  ``jit`` PerfCounters collection, under the JAX package's names so that
  ``jit dump``, the flight bundle and ``RECOMPILE_STORM`` read both alike.

Stdlib-only.
"""
from __future__ import annotations

import itertools
import os
import random
import threading
import time
from bisect import bisect_left
from collections import deque
from dataclasses import dataclass

from . import instruments

# log-spaced span-latency bounds (seconds); one overflow bucket follows
LATENCY_BUCKETS_S = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0)

TRACE_CAPACITY = int(os.environ.get("CEPH_TPU_TRACE_CAPACITY", 16384))

# finished events buffered per thread before the batch folds into the
# shared ring: the owning thread touches the ring lock once per batch
# (or at an explicit completion-boundary flush()) instead of per span —
# the reactor-thread contention class
FLUSH_BATCH = 64

# unsampled-trace micro-records kept for slow-op promotion (one small
# dict entry per in-flight unsampled op; FIFO eviction past the bound)
MICRO_CAPACITY = 4096

# process-wide id allocators: ids must stay unique across every Tracer
# instance (cross-daemon stitching joins on them).  The high word is a
# per-process random salt: in multi-process mode (rados serve +
# --connect) each client process allocates its own ids, and sequential
# small ints would collide in the server's stitched dump, silently
# merging unrelated ops into one tree.
_id_salt = random.getrandbits(31) << 32
_trace_ids = itertools.count(_id_salt + 1)
_span_ids = itertools.count(_id_salt + 1)


@dataclass
class TraceContext:
    """What rides the wire: enough to stitch a child daemon's spans
    under the caller's (trace id + parent span id) and to attribute the
    work to an owner class (client/serving/recovery/scrub/rebalance).
    Picklable on purpose — net.py RPC frames and wire-mode bus envelopes
    serialize it.

    ``sampled``/``weight`` are the head-based sampling decision, made
    ONCE at :meth:`Tracer.new_trace` and carried here so the whole
    distributed trace samples atomically across daemons: an unsampled
    context suppresses every span it touches (locally and remotely)
    except slow-op promotions, and a sampled one stamps its 1/rate
    weight on every event so downstream rate math stays unbiased."""
    trace_id: int
    span_id: int          # the span new children hang under (0 = root)
    op_class: str = "client"
    sampled: bool = True
    weight: float = 1.0   # 1/sample_rate, decided at the root

    def child_of(self, span_id: int) -> "TraceContext":
        return TraceContext(self.trace_id, span_id, self.op_class,
                            self.sampled, self.weight)


class _Activation:
    """Context manager pushing a TraceContext (and optional track) onto
    the calling thread's stacks.  ``ctx=None`` is a no-op so call sites
    need no branching for untraced messages."""

    __slots__ = ("tracer", "ctx", "track", "_pushed")

    def __init__(self, tracer: "Tracer", ctx: TraceContext | None,
                 track: str | None = None):
        self.tracer = tracer
        self.ctx = ctx
        self.track = track
        self._pushed = False

    def __enter__(self) -> TraceContext | None:
        if self.ctx is not None or self.track is not None:
            self.tracer._ctx_stack().append((self.ctx, self.track))
            self._pushed = True
        return self.ctx

    def __exit__(self, *exc) -> bool:
        if self._pushed:
            self.tracer._ctx_stack().pop()
        return False


class Span:
    """One timed region; use as a context manager.  ``dur`` (seconds) is
    valid after ``__exit__``; the Chrome event is emitted on exit so the
    ring buffer holds only finished spans."""

    __slots__ = ("tracer", "name", "cat", "args", "ts_us", "dur",
                 "_t0", "trace_id", "span_id", "parent_id", "track",
                 "op_class", "sampled", "weight")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: dict):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self.dur = 0.0
        # distributed-trace linkage (span_id/parent/class/weight) is
        # filled on __enter__ only when a TraceContext is active; a
        # nonzero trace_id is the "linked" flag (_trace_ids starts at 1)
        self.trace_id = 0
        self.track: str | None = None

    def set(self, **args) -> "Span":
        """Attach results discovered mid-span (e.g. bytes moved)."""
        self.args.update(args)
        return self

    def __enter__(self) -> "Span":
        tracer = self.tracer
        tracer._push(self)
        # one fused walk for the innermost ctx AND track (two separate
        # current_ctx()/current_track() sweeps cost real time per op)
        ctx = track = None
        for c, t in reversed(tracer._ctx_stack()):
            if ctx is None and c is not None:
                ctx = c
            if track is None and t is not None:
                track = t
            if ctx is not None and track is not None:
                break
        if ctx is not None:
            self.trace_id = ctx.trace_id
            self.span_id = next(_span_ids)
            self.parent_id = ctx.span_id
            self.op_class = ctx.op_class
            self.sampled = getattr(ctx, "sampled", True)
            self.weight = getattr(ctx, "weight", 1.0)
            # nested spans (this thread, while we are open) chain under
            # us — even when unsampled, so child daemons inherit the
            # head decision through child_of()
            tracer._ctx_stack().append((ctx.child_of(self.span_id),
                                        None))
        self.track = track
        self._t0 = time.perf_counter()
        self.ts_us = (self._t0 - tracer._t0) * 1e6
        return self

    def __exit__(self, *exc) -> bool:
        self.dur = time.perf_counter() - self._t0
        tracer = self.tracer
        if self.trace_id:
            tracer._ctx_stack().pop()
        tracer._pop(self)
        tracer._finish_span(self)
        return False


class _NullSpan:
    """The kill-switch span: context-manager compatible, records
    nothing.  One shared instance serves every call site — no per-op
    allocation when ``instruments_enabled=false``."""

    __slots__ = ()
    dur = 0.0
    ts_us = 0.0
    args: dict = {}

    def set(self, **args) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class Tracer:
    """Thread-safe span recorder with a bounded ring of Chrome events.

    Finished events buffer per thread and fold into the shared ring in
    batches (``FLUSH_BATCH``, or an explicit completion-boundary
    :meth:`flush`), so hot threads touch the ring lock ~1/64th as often
    as they emit.  Read surfaces (:meth:`dump`, :meth:`histograms`)
    drain every thread's pending batch first, so nothing observable
    changes except the lock traffic."""

    def __init__(self, capacity: int = TRACE_CAPACITY):
        # finished events: dicts, or lite tuples (name, cat, ts_us,
        # dur_us, tid) from the untraced fast path — materialized by
        # dump()
        self._events: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._local = threading.local()
        # per-thread pending-event buffers (thread ident -> list); the
        # owner appends without the lock (single writer + GIL), batches
        # fold under the ring lock
        self._pending: dict[int, list] = {}
        # paired clocks: spans stamp with perf_counter; wall-clock sources
        # (TrackedOp timelines) map through the epoch pair
        self._t0 = time.perf_counter()
        self._wall0 = time.time()
        self.pid = os.getpid()
        # span-name -> [bucket_counts..., overflow] plus (sum, count)
        self._hist: dict[str, list] = {}
        # head-based sampling: decided once per root context
        # in new_trace(); unsampled traces keep only a micro-record here
        # until they finish fast (dropped) or cross slow_threshold_s
        # (promoted into the ring)
        self.sample_rate = 1.0
        self.slow_threshold_s = 30.0
        self._micro: dict[int, dict] = {}
        self._micro_lock = threading.Lock()

    # -- span stack (per thread, for nesting introspection) ----------------

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _push(self, span: Span) -> None:
        self._stack().append(span)

    def _pop(self, span: Span) -> None:
        st = self._stack()
        if st and st[-1] is span:
            st.pop()

    def current(self) -> Span | None:
        st = self._stack()
        return st[-1] if st else None

    def depth(self) -> int:
        return len(self._stack())

    # -- distributed trace contexts (per thread) ----------------------------

    def _ctx_stack(self) -> list:
        st = getattr(self._local, "ctx_stack", None)
        if st is None:
            st = self._local.ctx_stack = []
        return st

    def new_trace(self, op_class: str = "client") -> TraceContext:
        """A fresh root context (span_id 0): the client edge of an op.

        The head-based sampling decision happens HERE, once per trace:
        the result rides the context (and every child_of() derived from
        it, across daemons), so a distributed trace is all-in or
        all-out.  Unsampled roots leave a micro-record (start, class,
        id) for retroactive slow-op promotion; sampled roots carry a
        1/rate weight so dump consumers can de-bias rate math."""
        tid = next(_trace_ids)
        if self._sample(tid):
            rate = self.sample_rate
            w = 1.0 / rate if 0.0 < rate < 1.0 else 1.0
            return TraceContext(tid, 0, op_class, True, w)
        self._note_micro(tid, op_class)
        return TraceContext(tid, 0, op_class, False, 1.0)

    def _sample(self, trace_id: int) -> bool:
        """Deterministic per-trace-id decision (Knuth multiplicative
        hash): equidistributed over sequential ids, reproducible for a
        given id, and free of shared RNG state on the hot path."""
        rate = self.sample_rate
        if rate >= 1.0:
            return True
        if rate <= 0.0:
            return False
        return ((trace_id * 2654435761) & 0xFFFFFFFF) < rate * 4294967296.0

    # -- unsampled-op micro-records (slow-op promotion) ---------------------

    def _note_micro(self, trace_id: int, op_class: str) -> None:
        with self._micro_lock:
            self._micro[trace_id] = {"trace_id": trace_id,
                                     "start_wall": time.time(),
                                     "op_class": op_class}
            while len(self._micro) > MICRO_CAPACITY:
                self._micro.pop(next(iter(self._micro)))

    def _drop_micro(self, trace_id: int) -> None:
        if trace_id in self._micro:          # cheap pre-check, racy is fine
            with self._micro_lock:
                self._micro.pop(trace_id, None)

    def micro_records(self) -> list[dict]:
        """The in-flight unsampled ops (start wall time, op class, trace
        id) — what SLOW_OPS triage sees for ops the sampler skipped that
        have not completed yet."""
        with self._micro_lock:
            return [dict(r) for r in self._micro.values()]

    def current_ctx(self) -> TraceContext | None:
        """The innermost active TraceContext on this thread (None when
        the current work is untraced)."""
        for ctx, _track in reversed(self._ctx_stack()):
            if ctx is not None:
                return ctx
        return None

    def current_track(self) -> str | None:
        """The innermost daemon track ('osd.3', 'client', ...) active on
        this thread; spans default their track from it."""
        for _ctx, track in reversed(self._ctx_stack()):
            if track is not None:
                return track
        return None

    def activate(self, ctx: TraceContext | None,
                 track: str | None = None) -> _Activation:
        """Adopt an inbound trace context (and optionally name the local
        daemon track) for the duration of a ``with`` block.  ``ctx=None``
        activates only the track; both None is a no-op."""
        return _Activation(self, ctx, track)

    def track_scope(self, track: str) -> _Activation:
        """Name the local daemon track without touching the context."""
        return _Activation(self, None, track)

    # -- recording ----------------------------------------------------------

    def span(self, name: str, cat: str = "", **args) -> Span:
        if not instruments.enabled():
            return _NULL_SPAN
        return Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "", **args) -> None:
        if not instruments.enabled():
            return
        ctx = self.current_ctx()
        if ctx is not None and not getattr(ctx, "sampled", True):
            return                   # unsampled trace: no per-event record
        ev = {"name": name, "cat": cat or "instant", "ph": "i", "s": "t",
              "ts": (time.perf_counter() - self._t0) * 1e6,
              "pid": self.pid, "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        self._emit(ev)

    def observe(self, name: str, t0: float, t1: float | None = None,
                cat: str = "") -> None:
        """Record a finished region measured with ``time.perf_counter()``
        — the allocation-light fast path for hot UNTRACED spans (the
        per-op rpc dispatch).  No Span object, no context-manager
        protocol, no event dict: a lite tuple rides the pending buffer
        and the ring, and :meth:`dump` materializes whatever survived
        eviction.  Use :meth:`span` whenever a TraceContext may be
        active — this path carries no trace linkage."""
        if not instruments.enabled():
            return
        if t1 is None:
            t1 = time.perf_counter()
        # inlined _emit_lite: this is the single hottest instrument call
        # (one per RPC dispatch), so it pays for zero extra frames
        buf = getattr(self._local, "pending", None)
        if buf is None:
            buf = self._pending_buf()
        buf.append((name, cat, (t0 - self._t0) * 1e6, (t1 - t0) * 1e6,
                    threading.get_ident()))
        if len(buf) >= FLUSH_BATCH:
            self._flush_buf(buf)

    def complete(self, name: str, start_wall: float, dur_s: float,
                 cat: str = "", ctx: TraceContext | None = None,
                 **args) -> None:
        """A span observed externally on the WALL clock (TrackedOp ops,
        queue/batch/backoff waits measured after the fact): mapped onto
        the tracer timeline via the paired epochs.  With ``ctx`` the
        event joins that distributed trace as a child span (trace/span/
        parent ids + op_class stamped like a live span) so the
        critical-path ledger can attribute it — linkage is EXPLICIT
        opt-in, never ambient, so TrackedOp timelines that happen to
        run under an active context don't double-count as tree nodes."""
        if not instruments.enabled():
            return
        promoted = False
        if ctx is not None and not getattr(ctx, "sampled", True):
            if dur_s < self.slow_threshold_s:
                if ctx.span_id == 0:         # the trace's root completed fast
                    self._drop_micro(ctx.trace_id)
                return
            promoted = True                  # slow op: into the ring anyway
            self._drop_micro(ctx.trace_id)
        ev = {"name": name, "cat": cat or "op", "ph": "X",
              "ts": (start_wall - self._wall0) * 1e6,
              "dur": dur_s * 1e6,
              "pid": self.pid, "tid": threading.get_ident()}
        if ctx is not None:
            args["trace_id"] = ctx.trace_id
            args["span_id"] = next(_span_ids)
            args["parent_span_id"] = ctx.span_id
            args.setdefault("op_class", ctx.op_class)
            if promoted:
                # promoted events represent only themselves: weight 1
                args["promoted"] = True
            elif getattr(ctx, "weight", 1.0) != 1.0:
                args["sample_weight"] = ctx.weight
        if args:
            ev["args"] = args
        self._emit(ev, name, dur_s)

    def _finish_span(self, span: Span) -> None:
        promoted = False
        if span.trace_id and not span.sampled:
            # unsampled trace: the span vanishes unless it crossed the
            # complaint time — then it is promoted into the ring so
            # SLOW_OPS / flight bundles / slo_report never go dark
            if span.dur < self.slow_threshold_s:
                if span.parent_id == 0:      # the root finished fast
                    self._drop_micro(span.trace_id)
                return
            promoted = True
            self._drop_micro(span.trace_id)
        if not span.trace_id and not span.args and span.track is None:
            # the hot shape (untraced, no args, no track): defer the
            # event-dict build to dump() — evicted events never pay it
            self._emit_lite((span.name, span.cat,
                             span.ts_us, span.dur * 1e6,
                             threading.get_ident()))
            return
        ev = {"name": span.name, "cat": span.cat or "span", "ph": "X",
              "ts": span.ts_us, "dur": span.dur * 1e6,
              "pid": self.pid, "tid": threading.get_ident()}
        args = dict(span.args) if span.args else {}
        if span.trace_id:
            args["trace_id"] = span.trace_id
            args["span_id"] = span.span_id
            args["parent_span_id"] = span.parent_id
            # the owner class rides every traced span so the critical-
            # path ledger (common/critpath.py) can classify a trace
            # without re-deriving it from span-name heuristics
            args.setdefault("op_class", span.op_class)
            if promoted:
                args["promoted"] = True
            elif span.weight != 1.0:
                args["sample_weight"] = span.weight
        if args:
            ev["args"] = args
        if span.track is not None:
            ev["track"] = span.track
        self._emit(ev, span.name, span.dur)

    # -- per-thread batching -------------------------------------------------

    def _pending_buf(self) -> list:
        buf = getattr(self._local, "pending", None)
        if buf is None:
            buf = self._local.pending = []
            with self._lock:
                old = self._pending.get(threading.get_ident())
                if old:
                    # a dead thread's ident was reused: fold its
                    # leftovers before the new owner takes the slot
                    self._fold_locked(old)
                self._pending[threading.get_ident()] = buf
        return buf

    def _emit(self, ev: dict, name: str | None = None,
              dur_s: float = 0.0) -> None:
        buf = self._pending_buf()
        buf.append((ev, name, dur_s))
        if len(buf) >= FLUSH_BATCH:
            self._flush_buf(buf)

    def _emit_lite(self, ev: tuple) -> None:
        # a lite event rides the buffer BARE (no wrapper triple): the
        # fold recognizes the 5-tuple shape and derives name/duration
        # from it, so the hot path allocates one tuple per op, not two
        buf = getattr(self._local, "pending", None)
        if buf is None:
            buf = self._pending_buf()
        buf.append(ev)
        if len(buf) >= FLUSH_BATCH:
            self._flush_buf(buf)

    def _flush_buf(self, buf: list) -> None:
        with self._lock:
            self._fold_locked(buf)

    def _fold_locked(self, buf: list) -> None:
        # under self._lock.  The owner may append concurrently (without
        # the lock): capture len first, drain exactly that prefix — the
        # append lands at the tail and survives for the next flush.
        n = len(buf)
        if not n:
            return
        items = buf[:n]
        del buf[:n]
        for item in items:
            if len(item) == 5:
                # bare lite event: (name, cat, ts_us, dur_us, tid)
                self._events.append(item)
                self._hist_add_locked(item[0], item[3] * 1e-6)
            else:
                ev, name, dur_s = item
                self._events.append(ev)
                if name is not None:
                    self._hist_add_locked(name, dur_s)

    def flush(self) -> None:
        """Fold the CALLING thread's pending batch into the ring — the
        completion-boundary hook (pipeline complete, dispatcher worker
        loop, serving finisher, mux sender loop)."""
        buf = getattr(self._local, "pending", None)
        if buf:
            self._flush_buf(buf)

    def _drain_all_locked(self) -> None:
        for buf in list(self._pending.values()):
            self._fold_locked(buf)

    def _hist_add_locked(self, name: str, dur_s: float) -> None:
        # cells are flat lists [counts, sum, count] and the bucket scan
        # is a C-level bisect: this runs once per event inside the fold
        # critical section, so it is the floor of the batched ring cost
        h = self._hist.get(name)
        if h is None:
            h = self._hist[name] = [[0] * (len(LATENCY_BUCKETS_S) + 1),
                                    0.0, 0]
        h[0][bisect_left(LATENCY_BUCKETS_S, dur_s)] += 1
        h[1] += dur_s
        h[2] += 1

    # -- export --------------------------------------------------------------

    def _materialize(self, ev) -> dict:
        """A ring entry as a Chrome event dict.  Lite tuples (the
        untraced span/observe fast path) build their dict HERE, once
        per surviving event, instead of once per op."""
        if type(ev) is tuple:
            name, cat, ts, dur, tid = ev
            return {"name": name, "cat": cat or "span", "ph": "X",
                    "ts": ts, "dur": dur, "pid": self.pid, "tid": tid}
        return dict(ev)

    def dump(self, stitched: bool = True) -> dict:
        """Chrome trace-event JSON (the ``trace dump`` admin command):
        load in chrome://tracing or ui.perfetto.dev as-is.

        ``stitched`` (default) renders the cross-daemon view: events
        whose span carried a daemon *track* ('osd.3', 'client') are
        re-homed onto a synthetic pid per track — one process row per
        daemon — with ``process_name`` metadata events naming the rows,
        so one client op's spans across N daemons line up on one shared
        timeline (all tracks stamp from this tracer's clock pair)."""
        with self._lock:
            self._drain_all_locked()
            events = [self._materialize(ev) for ev in self._events]
        if stitched:
            track_pids: dict[str, int] = {}
            meta: list[dict] = []
            for ev in events:
                track = ev.pop("track", None)
                if track is None:
                    continue
                pid = track_pids.get(track)
                if pid is None:
                    # deterministic synthetic pids, far from real ones
                    pid = track_pids[track] = 1_000_000 + len(track_pids)
                    meta.append({"name": "process_name", "ph": "M",
                                 "pid": pid, "tid": 0,
                                 "args": {"name": track}})
                ev["pid"] = pid
            events = meta + events
        else:
            for ev in events:
                ev.pop("track", None)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def reset(self) -> dict:
        with self._lock:
            self._drain_all_locked()
            n = len(self._events)
            self._events.clear()
            self._hist.clear()
        with self._micro_lock:
            self._micro.clear()
        return {"success": f"dropped {n} events"}

    def histograms(self) -> dict:
        """Per-span-name latency histograms: {name: {buckets (bounds, s),
        counts (len+1, last = overflow), sum, count}}."""
        with self._lock:
            self._drain_all_locked()
            return {name: {"buckets": list(LATENCY_BUCKETS_S),
                           "counts": list(h[0]),
                           "sum": h[1], "count": h[2]}
                    for name, h in self._hist.items()}


_default_tracer: Tracer | None = None
_default_lock = threading.Lock()


def default_tracer() -> Tracer:
    global _default_tracer
    if _default_tracer is None:
        with _default_lock:
            if _default_tracer is None:
                _default_tracer = Tracer()
    return _default_tracer



def wire_config(conf) -> None:
    """Adopt the default tracer's sampling knobs from a ConfigProxy and
    follow live updates: ``tracer_sample_rate`` sets the head-based
    sampling probability, ``osd_op_complaint_time`` doubles as the
    slow-op promotion threshold (the same bound SLOW_OPS health uses, so
    'promoted into the ring' and 'flagged slow' agree by construction)."""
    tr = default_tracer()
    if "tracer_sample_rate" in conf.schema:
        tr.sample_rate = float(conf.get("tracer_sample_rate"))

        def _on_rate(_name, v, _tr=tr):
            _tr.sample_rate = float(v)
        conf.add_observer("tracer_sample_rate", _on_rate)
    if "osd_op_complaint_time" in conf.schema:
        tr.slow_threshold_s = float(conf.get("osd_op_complaint_time"))

        def _on_complaint(_name, v, _tr=tr):
            _tr.slow_threshold_s = float(v)
        conf.add_observer("osd_op_complaint_time", _on_complaint)

def trace_span(name: str, cat: str = "", **args) -> Span:
    """Convenience: a span on the process-default tracer."""
    return default_tracer().span(name, cat, **args)


def trace_instant(name: str, cat: str = "", **args) -> None:
    default_tracer().instant(name, cat, **args)


def new_trace(op_class: str = "client") -> TraceContext:
    """A fresh root trace context on the process-default tracer."""
    return default_tracer().new_trace(op_class)


def current_trace() -> TraceContext | None:
    """The calling thread's active TraceContext, if any."""
    return default_tracer().current_ctx()


def activate_trace(ctx: TraceContext | None,
                   track: str | None = None) -> _Activation:
    """Adopt an inbound context / daemon track on the default tracer."""
    return default_tracer().activate(ctx, track)


def root_or_ambient(op_class: str) -> _Activation:
    """Activate the calling thread's ambient trace context — or root a
    fresh ``op_class`` trace when none is active — so the sub-ops a call
    fans out attribute their wire bytes and device time to the right
    owner class (an enclosing scrub-repair/scheduler-wave context wins
    over the default)."""
    tr = default_tracer()
    return tr.activate(tr.current_ctx() or tr.new_trace(op_class))


# -- launch telemetry registry (fed by ops.launch_ledger) ------------------
#
# Keyed by (kernel label, launch key).  Each entry exists because the
# key's first launch happened (the port's "compilation": PyTorch runs
# eagerly, so a key's first launch pays the kernel library's build or
# load instead of a trace and an XLA compile); later launches bump
# ``calls``.  The ``jit`` PerfCounters collection aggregates across keys
# and is registered into every Context's collection so `perf dump` /
# prometheus carry it.

_jit_lock = threading.Lock()
_jit_stats: dict[tuple, dict] = {}
_jit_perf = None


def jit_perf_counters():
    """The process-wide ``jit`` PerfCounters (built lazily: tracer must
    stay importable before perf_counters in partial environments)."""
    global _jit_perf
    with _jit_lock:
        if _jit_perf is None:
            from .perf_counters import PerfCountersBuilder
            _jit_perf = (
                PerfCountersBuilder("jit")
                .add_u64_counter("compilations",
                                 "distinct (function, shape) compiles")
                .add_u64_counter("cache_hits",
                                 "dispatches served by a compiled cache key")
                .add_time_avg("trace_time", "trace wall time (0: a hand "
                                            "kernel has no trace step)")
                .add_time_avg("compile_time",
                              "kernel build or cached-library load wall "
                              "time, on a kernel's first key")
                .add_time_avg("first_dispatch_time",
                              "first execution incl. completion wait")
                .create_perf_counters())
        return _jit_perf


def record_compilation(fn_label: str, key, trace_s: float, compile_s: float,
                       dispatch_s: float) -> None:
    pc = jit_perf_counters()
    pc.inc("compilations")
    pc.tinc("trace_time", trace_s)
    pc.tinc("compile_time", compile_s)
    pc.tinc("first_dispatch_time", dispatch_s)
    with _jit_lock:
        entry = _jit_stats.get((fn_label, key))
        if entry is None:
            _jit_stats[(fn_label, key)] = {
                "function": fn_label, "key": repr(key), "compiles": 1,
                "trace_s": trace_s, "compile_s": compile_s,
                "first_dispatch_s": dispatch_s, "calls": 1}
        else:
            # one label on two devices, or a key seen again after the
            # ledger's reset: accumulate, don't clobber
            entry["compiles"] += 1
            entry["calls"] += 1
            entry["trace_s"] += trace_s
            entry["compile_s"] += compile_s
            entry["first_dispatch_s"] += dispatch_s


def record_cache_hit(fn_label: str, key) -> None:
    jit_perf_counters().inc("cache_hits")
    with _jit_lock:
        entry = _jit_stats.get((fn_label, key))
        if entry is not None:
            entry["calls"] += 1


def jit_dump() -> dict:
    """The ``jit dump`` admin command: per-key stats + the aggregate
    counters, compile-cost-sorted so the expensive kernels lead."""
    with _jit_lock:
        entries = [dict(e) for e in _jit_stats.values()]
    entries.sort(key=lambda e: e["compile_s"], reverse=True)
    return {"functions": entries,
            "num_keys": len(entries),
            "counters": jit_perf_counters().dump()}


def jit_reset() -> dict:
    with _jit_lock:
        n = len(_jit_stats)
        _jit_stats.clear()
    return {"success": f"dropped {n} jit cache-key records"}
