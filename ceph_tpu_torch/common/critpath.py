"""Critical-path latency decomposition: where did this op's wall time go.

The stitched distributed traces carry every span of a completed
op — client dispatch, daemon queue, batch formation, device compute,
per-shard wire hops — but nothing folds them into the number an
operator (or the SLO engine, ``mgr/slo.py``) actually needs: *per-phase
attribution* — "client p99 = 41 ms: 62% batch_delay, 21% device, 9%
wire".  Online-EC tail-latency studies (PAPERS.md, arXiv:1709.05365)
show the phase MIX is what shifts under load; a single latency number
cannot distinguish "the device got slower" from "the batching deadline
got longer" from "retries are eating the budget".

This module provides:

- the **canonical phase taxonomy** (:data:`PHASES`): ``queue`` (op sat
  in a daemon/engine queue), ``admission`` (throttle wait),
  ``batch_delay`` (coalescer deadline wait for companions),
  ``dispatch`` (host-side prep of a device dispatch), ``device``
  (device compute + transfers), ``wire`` (cross-daemon hops: bus
  envelopes, RPC frames), ``retry`` (resends / backoff / host
  fallback), ``other`` (everything unattributed);
- the **span->phase registry** (:data:`SPAN_PHASES` + prefix rules):
  every span name the tracer emits maps to a declared phase, and
  ``tests/test_span_phase_guard.py`` enforces that new spans in the
  serving/recovery/pipeline layers DECLARE one (an explicit ``phase=``
  span arg overrides the registry);
- :func:`decompose`: derive one completed op's critical path from its
  stitched span tree — each span's SELF time (duration minus the union
  of its children, overlap-clamped so concurrent children never
  double-count, the ``device_attribution`` clamping convention) charges
  its phase; the per-phase seconds SUM to the trace's total wall time
  (the acceptance invariant);
- :class:`CritPathLedger`: a bounded per-op-class ledger folding
  completed traces from the tracer ring into per-class phase
  attribution + latency records — the source of ``slo status``'s
  attribution table, the ``ceph_tpu_latency_phase_seconds`` prometheus
  family, and the SLO engine's good/bad op stream.

Stdlib-only (the tracer's discipline): importable before any JAX
backend initializes, and usable by ``tools/slo_report.py`` on a trace
dump alone.

A copy of ``ceph_tpu.common.critpath``.
"""
from __future__ import annotations

import os
import re
import threading
import time
import weakref
from collections import defaultdict, deque

# the tracer ring's event capacity (mirrors tracer.TRACE_CAPACITY
# without importing it: this module must stay loadable by PATH for
# tools/slo_report.py).  Sizes the ledger's seen-trace bound: the ring
# holds at most this many events, hence at most this many distinct
# trace ids — a seen-set twice as large can never evict an id whose
# events are still foldable.
TRACE_CAPACITY_HINT = int(os.environ.get("CEPH_TPU_TRACE_CAPACITY",
                                         16384))

try:
    from .device_attribution import canonical_owner
    from .percentile import nearest_rank, weighted_nearest_rank
except ImportError:
    # loaded standalone by PATH (tools/slo_report.py on a raw trace
    # dump): pull the two stdlib-only siblings the same way
    import importlib.util as _ilu
    import os as _os
    _here = _os.path.dirname(_os.path.abspath(__file__))

    def _sibling(name):
        spec = _ilu.spec_from_file_location(
            f"_critpath_{name}", _os.path.join(_here, f"{name}.py"))
        mod = _ilu.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    canonical_owner = _sibling("device_attribution").canonical_owner
    _pct = _sibling("percentile")
    nearest_rank = _pct.nearest_rank
    weighted_nearest_rank = _pct.weighted_nearest_rank

# -- the canonical phase taxonomy -------------------------------------------

QUEUE = "queue"              # waiting in a daemon/engine queue
ADMISSION = "admission"      # blocked on an admission throttle
BATCH_DELAY = "batch_delay"  # coalescer deadline wait for companions
DISPATCH = "dispatch"        # host-side prep of a device dispatch
DEVICE = "device"            # device compute + host<->device transfer
WIRE = "wire"                # cross-daemon hops (bus envelopes, RPC)
RETRY = "retry"              # resends, backoff sleeps, host fallback
OTHER = "other"              # unattributed self time

PHASES = (QUEUE, ADMISSION, BATCH_DELAY, DISPATCH, DEVICE, WIRE, RETRY,
          OTHER)

# -- the span -> phase registry ---------------------------------------------
#
# Exact span names first; the two prefix rules below catch the open-ended
# families (per-message-type bus spans, per-method RPC spans).  A span
# may also carry an explicit ``phase=<name>`` arg, which wins — the API
# for call sites whose name cannot be enumerated here.

SPAN_PHASES: dict[str, str] = {
    # queue: emitted by the OSD daemon when a queued op finally runs
    "osd.queue_wait": QUEUE,
    # a PG recovery job waiting for its local and remote reservations
    # (RecoveryScheduler, from schedule_backend to the last grant)
    "recovery.reserve_wait": QUEUE,
    # admission: serving-engine throttle wait (emitted only when the
    # throttle actually blocked the submitter)
    "serving.admission": ADMISSION,
    # batch formation: submit-to-dispatch wait inside the op coalescer,
    # and the coalescer thread's own wait for ops or the deadline
    "serving.batch_wait": BATCH_DELAY,
    "serving.gather": BATCH_DELAY,
    # dispatch: host-side prep on the way to the device
    "pipeline.pack": DISPATCH,
    "pipeline.dispatch": DISPATCH,
    "pg.generate_transactions": DISPATCH,
    "crush.bulk_map": DISPATCH,
    "codec.decode_matrix_build": DISPATCH,
    "jit.trace": DISPATCH,
    "jit.compile": DISPATCH,
    "recovery.wave": DISPATCH,
    # chained streaming repair: plan building on the coordinator, then
    # one scale-accumulate per survivor hop (device or exact host GF)
    "recovery.chain": DISPATCH,
    "recovery.chain_hop": DISPATCH,
    # regenerating-code repair: plan assembly on the coordinator, then
    # one projection/combine inner product per helper/newcomer hop
    "recovery.regen": DISPATCH,
    "recovery.regen_hop": DISPATCH,
    # mux: per-riding-call stamps around batched RpcBatch /
    # RpcResultBatch frames (msg/client.py sender loop, msg/server.py
    # dispatcher) — cross-daemon frame time, hence wire
    "mux.batch_send": WIRE,
    "mux.batch_reply": WIRE,
    # device: compute + transfers (the codec spans wrap the actual
    # device/SIMD work; ec.* self-time is pack/scatter around it)
    "codec.encode": DEVICE,
    "codec.decode": DEVICE,
    "codec.decode_batch": DEVICE,
    "codec.encode_host": DEVICE,
    "codec.decode_host": DEVICE,
    "codec.table_upload": DEVICE,
    "jit.first_dispatch": DEVICE,
    "serving.batch_encode": DEVICE,
    "serving.batch_decode": DEVICE,
    "pipeline.complete": DEVICE,
    # the completion's two stages, so its phase totals stay the same
    "pipeline.wait": DEVICE,
    "pipeline.unpack": DEVICE,
    "ec.encode": DEVICE,
    "ec.decode": DEVICE,
    "ec.decode_wave": DEVICE,
    "codec.scale_accumulate": DEVICE,
    # retry: resends / backoff / circuit-broken host fallback
    "pipeline.host_fallback": RETRY,
    "net.resend": RETRY,
    "client.op_retry": RETRY,
    "client.backoff_resend": RETRY,
    # other: op-engine execution and client-side machinery (the residual
    # a dedicated phase does not yet name)
    "client.op": OTHER,
    # the client's CRUSH target for an op (Objecter._calc_target)
    "objecter.calc_target": OTHER,
    "client.rpc": OTHER,
    "osd.op": OTHER,
    "serving.op": OTHER,
    # one object brought back to full redundancy, from its dispatch in a
    # wave, chain or per-object op to the commit of its last push; and a
    # target shard applying one pushed or chained chunk to its store
    "recovery.object": OTHER,
    "recovery.push": OTHER,
    # the finisher thread running completion callbacks after a wake-up
    "finisher.run": OTHER,
    "backfill.pg": OTHER,
    # cache tier (tier/service.py): the proxy read forwards across the
    # tier boundary to the base pool (wire-shaped hop); promotion,
    # writeback flush, and eviction are data-movement orchestration
    # whose leaf work (codec, store) claims its own phases
    "tier.read": OTHER,
    "tier.write": OTHER,
    "tier.agent": OTHER,
    "tier.proxy_read": WIRE,
    "tier.proxy_write": WIRE,
    "tier.promote": DISPATCH,
    "tier.flush": DISPATCH,
    "tier.evict": DISPATCH,
    # the dmClock-class background roots (osd_daemon.queue_background)
    "osd.client": OTHER,
    "osd.serving": OTHER,
    "osd.recovery": OTHER,
    "osd.scrub": OTHER,
    "osd.rebalance": OTHER,
}

# per-message-type bus dispatch spans: ``osd.<MsgType>`` with a CamelCase
# type name (backend/messages.py) — distinguished from the lowercase
# ``osd.op``/``osd.recovery`` daemon spans by the capital letter
_BUS_SPAN = re.compile(r"^osd\.[A-Z]")

#: (prefix, phase) rules for the open-ended span families
PREFIX_PHASES: tuple[tuple[str, str], ...] = (
    ("rpc.", WIRE),          # net.py per-method server spans
)


def declare(name: str, phase: str) -> None:
    """Register a new span name's phase (the extension point the
    span-phase guard steers new code toward)."""
    if phase not in PHASES:
        raise ValueError(f"unknown phase {phase!r} (choose from {PHASES})")
    SPAN_PHASES[name] = phase


def is_declared(name: str) -> bool:
    """True when ``name`` maps to a phase WITHOUT falling through to
    ``other``-by-default (the guard's question)."""
    if name in SPAN_PHASES or _BUS_SPAN.match(name):
        return True
    return any(name.startswith(p) for p, _ph in PREFIX_PHASES)


def phase_for(name: str, args: dict | None = None) -> str:
    """The phase a span charges its self time to: an explicit
    ``phase=`` span arg wins, then the exact-name registry, then the
    prefix rules; unknown names land in ``other``."""
    if args:
        explicit = args.get("phase")
        if explicit in PHASES:
            return explicit
    ph = SPAN_PHASES.get(name)
    if ph is not None:
        return ph
    if _BUS_SPAN.match(name):
        return WIRE
    for prefix, ph in PREFIX_PHASES:
        if name.startswith(prefix):
            return ph
    return OTHER


# -- critical-path extraction -----------------------------------------------

def _interval(ev: dict) -> tuple[float, float]:
    ts = float(ev["ts"])
    return ts, ts + float(ev.get("dur", 0.0))


def decompose(spans: list[dict], unmapped: dict | None = None
              ) -> dict | None:
    """Fold ONE trace's complete ('ph': 'X') span events into per-phase
    seconds.  ``spans`` must all belong to one trace (each carries
    ``args.span_id``/``args.parent_span_id`` the tracer stamped).

    The invariant: ``sum(phases.values()) == total_s`` (±float noise).
    Each span's self time is its duration minus the union of its
    children's intervals, every interval clipped to its parent and
    clamped against the previous sibling's trailing edge — so children
    that overlap (concurrent device batches, parallel shard hops)
    charge their UNION, never their sum, the same convention
    ``common/device_attribution`` uses for overlapping dispatches.
    Multiple roots (resent ops, sibling queue-wait events) contribute
    the union of their intervals to the total.

    Returns ``{total_s, phases, n_spans, op_class, end_ts_us}`` or None
    for an empty trace.  ``unmapped`` (optional dict) accumulates
    occurrence counts of span names that fell through to ``other``."""
    spans = [e for e in spans if e.get("ph") == "X"
             and "span_id" in e.get("args", ())]
    if not spans:
        return None
    ids = {e["args"]["span_id"] for e in spans}
    children: dict[int, list[dict]] = defaultdict(list)
    roots: list[dict] = []
    for e in spans:
        parent = e["args"].get("parent_span_id", 0)
        if parent and parent in ids:
            children[parent].append(e)
        else:
            roots.append(e)
    phases = dict.fromkeys(PHASES, 0.0)

    def charge(ev: dict, self_us: float) -> None:
        args = ev.get("args") or {}
        ph = phase_for(ev["name"], args)
        if unmapped is not None and ph == OTHER and \
                not is_declared(ev["name"]) and args.get("phase") is None:
            unmapped[ev["name"]] = unmapped.get(ev["name"], 0) + 1
        phases[ph] += self_us / 1e6

    def walk(ev: dict, lo: float, hi: float) -> None:
        s, t = _interval(ev)
        s, t = max(s, lo), min(t, hi)
        if t <= s:
            return                       # fully clamped away by siblings
        kids = sorted(children.get(ev["args"]["span_id"], ()),
                      key=lambda k: float(k["ts"]))
        covered = 0.0
        edge = s
        for k in kids:
            ks, kt = _interval(k)
            ks2, kt2 = max(ks, edge), min(kt, t)
            if kt2 > ks2:
                covered += kt2 - ks2
                edge = kt2
                walk(k, ks2, kt2)
        charge(ev, max(0.0, (t - s) - covered))

    roots.sort(key=lambda e: float(e["ts"]))
    total_us = 0.0
    edge = float("-inf")
    for r in roots:
        rs, rt = _interval(r)
        rs2 = max(rs, edge)
        if rt > rs2:
            total_us += rt - rs2
            edge = rt
            walk(r, rs2, rt)
    # op class: the root's stamped class, else the first span carrying
    # one (every ctx-linked span stamps op_class)
    op_class = None
    for e in roots + spans:
        op_class = e.get("args", {}).get("op_class") \
            or e.get("args", {}).get("owner")
        if op_class:
            break
    # sample weight: head-sampled traces stamp 1/rate on their events
    # (the tracer's head sampling); the trace's weight de-biases downstream rate
    # math (SLO windows, class percentiles).  Promoted slow ops carry no
    # weight — they represent only themselves.
    w = 1.0
    for e in spans:
        sw = e.get("args", {}).get("sample_weight")
        if sw:
            w = max(w, float(sw))
    return {
        "total_s": total_us / 1e6,
        "phases": phases,
        "n_spans": len(spans),
        "op_class": canonical_owner(op_class),
        "w": w,
        "start_ts_us": min(float(e["ts"]) for e in spans),
        "end_ts_us": max(_interval(e)[1] for e in spans),
    }


def group_traces(events: list[dict]) -> dict[int, list[dict]]:
    """trace_id -> its complete span events (drops untraced spans)."""
    out: dict[int, list[dict]] = defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        tid = e.get("args", {}).get("trace_id")
        if tid:
            out[tid].append(e)
    return dict(out)


# -- the bounded per-class ledger -------------------------------------------

_LEDGERS: "weakref.WeakSet[CritPathLedger]" = weakref.WeakSet()


def live_ledgers() -> list["CritPathLedger"]:
    return list(_LEDGERS)


class CritPathLedger:
    """Bounded fold of completed traces into per-op-class phase
    attribution.  ``refresh()`` pulls the tracer ring (each trace folded
    exactly once, keyed by trace id); per-class records ride bounded
    deques so memory stays fixed however long the process lives."""

    def __init__(self, cct=None, name: str = "critpath",
                 capacity: int = 1024):
        self.cct = cct
        self.name = name
        self.capacity = max(8, int(capacity))
        self._lock = threading.Lock()
        # serializes whole refresh() passes: a prometheus scrape thread
        # racing a status() tick must not double-fold the same trace
        # (the per-trace check and the ingest are not one atom)
        self._refresh_lock = threading.Lock()
        # op_class -> deque of {"t", "total_s", "phases"}; t is on the
        # perf_counter clock (comparable to time.perf_counter()) so the
        # SLO engine can window-filter without a second clock
        self._records: dict[str, deque] = {}
        # cumulative per-(class, phase) seconds — the prometheus counter
        self._phase_seconds: dict[str, dict[str, float]] = {}
        self._totals: dict[str, dict] = {}   # class -> {ops, total_s}
        # tid -> {"n": spans folded, "cls": class, "rec": the record
        # dict (shared with the class deque, amended IN PLACE when a
        # trace grows — a refresh that raced an in-flight op folds the
        # partial tree, and the next refresh after the root closes
        # replaces the truncated numbers instead of dropping them)
        self._seen: dict[int, dict] = {}
        # bound: 2x the tracer ring's EVENT capacity — the ring can
        # hold at most TRACE_CAPACITY distinct trace ids, so an id
        # evicted from here is guaranteed gone from the ring too and
        # can never be re-folded as a duplicate
        self._seen_order: deque[int] = deque(
            maxlen=2 * max(TRACE_CAPACITY_HINT, capacity))
        self.unmapped: dict[str, int] = {}
        self.folded = 0
        _LEDGERS.add(self)

    # -- folding -----------------------------------------------------------

    def refresh(self, tracer=None) -> int:
        """Fold every completed trace currently in the tracer ring;
        returns how many folded or amended.  Refreshes SERIALIZE (a
        prometheus scrape racing a status() tick must not double-fold),
        and a trace that GROWS after its first fold — a refresh caught
        it mid-flight, or late async spans (pipeline completions,
        resends) landed after the root closed — is re-decomposed and
        its record amended IN PLACE, so the final numbers are the full
        op, never a truncated snapshot."""
        if tracer is None:
            from . import tracer as tracer_mod
            tracer = tracer_mod.default_tracer()
        with self._refresh_lock:
            events = tracer.dump(stitched=False)["traceEvents"]
            folded = 0
            for tid, spans in sorted(group_traces(events).items()):
                with self._lock:
                    seen = self._seen.get(tid)
                    if seen is not None and seen["n"] >= len(spans):
                        continue
                start_us = min(float(e["ts"]) for e in spans)
                if seen is not None and \
                        start_us > seen["start_us"] + 1e-6:
                    # the ring evicted the trace's FRONT (root included)
                    # since the first fold: re-decomposing the tail
                    # would corrupt a once-complete record with orphan
                    # math.  Keep the old numbers; bump n so the next
                    # refreshes stop re-trying.
                    with self._lock:
                        seen["n"] = len(spans)
                    continue
                rec = decompose(spans, unmapped=self.unmapped)
                if rec is None:
                    continue
                # map the trace-relative end timestamp onto the process
                # perf_counter clock via the tracer's epoch pair
                t = tracer._t0 + rec["end_ts_us"] / 1e6
                if seen is None:
                    record = self.ingest(rec["op_class"], rec["total_s"],
                                         rec["phases"], t=t, w=rec["w"])
                    with self._lock:
                        if len(self._seen_order) == \
                                self._seen_order.maxlen:
                            self._seen.pop(self._seen_order[0], None)
                        self._seen_order.append(tid)
                        self._seen[tid] = {"n": len(spans),
                                           "cls": rec["op_class"],
                                           "start_us": start_us,
                                           "rec": record}
                else:
                    self._amend(seen, rec, t, len(spans))
                folded += 1
            return folded

    def _amend(self, seen: dict, rec: dict, t: float, n: int) -> None:
        """Replace a previously-folded trace's numbers with the fuller
        decomposition (record dict mutated in place — the class deque
        holds the same object; cumulative sums adjusted by delta)."""
        with self._lock:
            old = seen["rec"]
            cls = seen["cls"]
            old_w = old.get("w", 1.0)
            new_w = float(rec.get("w", old_w))
            acc = self._phase_seconds[cls]
            for p in PHASES:
                acc[p] += float(rec["phases"].get(p, 0.0)) * new_w \
                    - old["phases"][p] * old_w
            self._totals[cls]["total_s"] += \
                float(rec["total_s"]) * new_w - old["total_s"] * old_w
            self._totals[cls]["ops"] += new_w - old_w
            old["t"] = t
            old["total_s"] = float(rec["total_s"])
            old["phases"] = {p: float(rec["phases"].get(p, 0.0))
                             for p in PHASES}
            old["w"] = new_w
            seen["n"] = n
            # a late-closing root can carry an EARLIER start than the
            # spans the first fold saw: track the true front so the
            # ring-eviction guard in refresh() compares against it
            seen["start_us"] = min(seen["start_us"], rec["start_ts_us"])

    def ingest(self, op_class: str, total_s: float, phases: dict,
               t: float | None = None, w: float = 1.0) -> dict:
        """Fold one op record directly (refresh()'s sink; also the
        synthetic-record entry tests and tools use).  ``w`` is the
        record's sample weight (1/rate for head-sampled traces): the
        cumulative accumulators scale by it so rates stay unbiased.
        Returns the record dict (refresh keeps it for in-place
        amendment)."""
        t = time.perf_counter() if t is None else t
        w = float(w) if w and w > 0 else 1.0
        record = {"t": t, "total_s": float(total_s),
                  "phases": {p: float(phases.get(p, 0.0))
                             for p in PHASES},
                  "w": w}
        with self._lock:
            dq = self._records.get(op_class)
            if dq is None:
                dq = self._records[op_class] = deque(maxlen=self.capacity)
                self._phase_seconds[op_class] = dict.fromkeys(PHASES, 0.0)
                self._totals[op_class] = {"ops": 0, "total_s": 0.0}
            dq.append(record)
            acc = self._phase_seconds[op_class]
            for p in PHASES:
                acc[p] += record["phases"][p] * w
            self._totals[op_class]["ops"] += w
            self._totals[op_class]["total_s"] += record["total_s"] * w
            self.folded += 1
        return record

    # -- read --------------------------------------------------------------

    def records(self, op_class: str) -> list[dict]:
        """The bounded window of per-op records for one class (newest
        last) — the SLO engine's good/bad stream."""
        with self._lock:
            dq = self._records.get(op_class)
            return [dict(r) for r in dq] if dq else []

    def classes(self) -> list[str]:
        with self._lock:
            return sorted(self._records)

    def phase_seconds(self) -> dict[str, dict[str, float]]:
        """Cumulative per-(class, phase) seconds — the
        ``ceph_tpu_latency_phase_seconds`` source."""
        with self._lock:
            return {cls: dict(acc)
                    for cls, acc in sorted(self._phase_seconds.items())}

    def class_summary(self, op_class: str) -> dict | None:
        """p50/p99 + phase fractions over the class's record window.
        Fractions are aggregate phase seconds over aggregate total
        seconds (they sum to 1.0 whenever any time was recorded)."""
        recs = self.records(op_class)
        if not recs:
            return None
        pairs = sorted((r["total_s"], r.get("w", 1.0)) for r in recs)
        wsum = sum(w for _v, w in pairs)
        agg = dict.fromkeys(PHASES, 0.0)
        for r in recs:
            rw = r.get("w", 1.0)
            for p in PHASES:
                agg[p] += r["phases"][p] * rw
        whole = sum(agg.values())
        return {
            "ops": len(recs),
            "weighted_ops": round(wsum, 1),
            "p50_ms": round(weighted_nearest_rank(pairs, 50) * 1e3, 3),
            "p99_ms": round(weighted_nearest_rank(pairs, 99) * 1e3, 3),
            "mean_ms": round(sum(v * w for v, w in pairs) / wsum * 1e3, 3)
            if wsum else 0.0,
            "phase_ms": {p: round(agg[p] * 1e3, 3) for p in PHASES},
            "phases": {p: round(agg[p] / whole, 4) if whole else 0.0
                       for p in PHASES},
        }

    def snapshot(self) -> dict:
        """The full ledger view (flight-recorder source / `slo dump`)."""
        return {
            "classes": {cls: self.class_summary(cls)
                        for cls in self.classes()},
            "phase_seconds": self.phase_seconds(),
            "folded": self.folded,
            "unmapped_spans": dict(self.unmapped),
            "capacity": self.capacity,
        }

    def close(self) -> None:
        _LEDGERS.discard(self)


def format_phase_mix(phases: dict) -> str:
    """'62% batch_delay, 21% device, 9% wire' — THE one rendering of a
    phase-fraction dict, shared by `ceph slo status` (via
    render_attribution) and tools/slo_report.py so the live table and
    the artifact table can never drift apart."""
    parts = sorted(((p, f) for p, f in phases.items() if f),
                   key=lambda kv: kv[1], reverse=True)
    return ", ".join(f"{round(100 * f)}% {p}" for p, f in parts) \
        or "no attributed time"


def render_attribution(snapshot: dict) -> list[str]:
    """The attribution table lines ('client p99 = 41.0 ms: 62%
    batch_delay, 21% device, 9% wire') from a ledger snapshot — shared
    by `ceph slo status` and tools/slo_report.py."""
    lines = []
    for cls, summary in sorted((snapshot.get("classes") or {}).items()):
        if not summary:
            continue
        lines.append(f"{cls} p99 = {summary['p99_ms']:.1f} ms "
                     f"({summary['ops']} ops): "
                     f"{format_phase_mix(summary['phases'])}")
    return lines or ["no completed traces folded yet"]
