"""Wire accounting: byte/op counters for every message on the wire.

The network plane was the last invisible subsystem: spans told us WHEN a
sub-op crossed a daemon boundary but never HOW MUCH moved, so
ROADMAP item 3's success metric (bytes-on-wire per byte repaired,
RapidRAID arXiv:1207.6744) and item 4's (wire bytes per served op) were
unmeasurable.  This module is the counting house both the in-process
cluster bus (backend/messages.py) and the TCP messenger (net.py) report
into — the role the reference's ``Messenger::dispatch_throttle`` /
``ms_crc``/perf counters play in src/msg.

One :class:`WireAccounting` owns ONE ``wire.<name>`` perf collection:

- ``tx_bytes``/``tx_msgs`` and ``rx_bytes``/``rx_msgs`` totals;
- per-op-class rollups ``class_bytes:<cls>`` / ``class_msgs:<cls>``
  attributed from the message's :class:`~ceph_tpu_torch.common.tracer.
  TraceContext` owner class (client/serving/recovery/scrub/rebalance;
  untraced control chatter lands on ``other``).  **Invariant: the class
  rollups partition the totals** — every accounted message charges
  exactly one class, so ``sum(class_bytes:*) == tx_bytes + rx_bytes``
  (pinned by tests/test_observability.py);
- an ``rpc_latency_ms`` histogram (the messenger-side op latency the
  reference's ``ms_dispatch`` perf counters carry);
- ``send_queue_depth``/``send_queue_peak`` gauges (undelivered messages
  parked at the destination — the AsyncMessenger out_q depth).

Per-message-TYPE byte/op counts live in a plain locked dict (the type
set is open-ended; perf collections want fixed keys) and export as the
labelled ``ceph_tpu_wire_bytes{owner,msg_type,dir}`` prometheus family
via :func:`live_wire_accountants`.

Message SIZES: transports that frame real bytes (wire-mode bus, net.py
sockets) account the frame length; the deterministic in-process bus
estimates via the per-type sizer registry (:func:`register_wire_sizes`).
Every message class sent through PGChannel/RPC must register a sizer —
tests/test_wire_guard.py enforces it by AST + registry, so no message
type ships unmetered.
"""
from __future__ import annotations

import threading
import weakref
from typing import Callable

from . import instruments
from .perf_counters import PerfCountersBuilder

# the owner classes wire bytes attribute to: device_attribution's
# canonical set plus "other" for untraced control-plane chatter
# (peering queries, activation fan-out, handshakes)
WIRE_CLASSES = ("client", "serving", "recovery", "scrub", "rebalance",
                "other")

# message overhead charged per estimated (non-framed) message: stands in
# for the v2 preamble + per-segment crc + type name segment
MSG_OVERHEAD = 32

_RPC_LAT_BUCKETS_MS = [0.1, 0.5, 1.0, 5.0, 10.0, 50.0, 100.0, 500.0,
                       1000.0]

# live accountants, for the prometheus wire families (the weakref
# pattern of osd_daemon.live_daemons / stats.live_aggregators)
_ACCOUNTANTS: "weakref.WeakSet[WireAccounting]" = weakref.WeakSet()

# message type name -> sizer(msg) -> payload bytes
_SIZERS: dict[str, Callable] = {}


def live_wire_accountants() -> list["WireAccounting"]:
    return list(_ACCOUNTANTS)


def register_wire_sizes(mapping: dict) -> None:
    """Register payload sizers: ``{MessageClass|name: sizer(msg)->int}``.
    Called at module import next to the message definitions
    (backend/messages.py, net.py) so the registry is complete the moment
    the types are sendable."""
    for key, fn in mapping.items():
        name = key if isinstance(key, str) else key.__name__
        _SIZERS[name] = fn


def registered_wire_types() -> set[str]:
    """The metered message-type names (the test_wire_guard surface)."""
    return set(_SIZERS)


def wire_class(ctx) -> str:
    """The op class a message's bytes charge to: the riding
    TraceContext's owner class, else ``other`` (untraced control
    chatter)."""
    cls = getattr(ctx, "op_class", None)
    return cls if cls in WIRE_CLASSES else ("other" if cls is None
                                            else "client")


def wire_size(msg) -> int:
    """Estimated on-wire size of ``msg`` (payload + MSG_OVERHEAD).
    Unregistered types fall back to a pickle measurement — the bytes are
    still counted (the completeness invariant holds), but the fallback
    bumps ``unsized_msgs`` and the AST guard fails the build, so the
    fallback never quietly becomes the norm."""
    sizer = _SIZERS.get(type(msg).__name__)
    if sizer is None:
        import pickle
        try:
            return MSG_OVERHEAD + len(pickle.dumps(msg))
        except Exception:
            return MSG_OVERHEAD
    return MSG_OVERHEAD + int(sizer(msg))


def _bytes_len(v) -> int:
    return len(v) if isinstance(v, (bytes, bytearray, memoryview)) else 0


def blob_size(obj, _depth: int = 0) -> int:
    """Sum of every bytes-like payload nested in ``obj`` (dicts/lists/
    tuples/sets walked; depth-bounded).  The shared sizer for messages
    whose weight is their buffers (RPC args, read replies, omap
    payloads)."""
    if isinstance(obj, (bytes, bytearray, memoryview)):
        return len(obj)
    if _depth >= 6:
        return 0
    if isinstance(obj, dict):
        return sum(blob_size(k, _depth + 1) + blob_size(v, _depth + 1)
                   for k, v in obj.items())
    if isinstance(obj, (list, tuple, set, frozenset)):
        return sum(blob_size(v, _depth + 1) for v in obj)
    if isinstance(obj, str):
        return len(obj)
    return 8 if isinstance(obj, (int, float)) else 0


class WireAccounting:
    """Per-transport wire counters: one ``wire.<name>`` perf collection
    plus the per-type table and RPC latency summaries."""

    def __init__(self, cct=None, name: str = "wire"):
        from .context import default_context
        self.cct = cct if cct is not None else default_context()
        self.name = name
        b = (
            PerfCountersBuilder(f"wire.{name}")
            .add_u64_counter("tx_msgs", "messages sent on the wire")
            .add_u64_counter("tx_bytes", "bytes sent on the wire")
            .add_u64_counter("rx_msgs", "messages received from the wire")
            .add_u64_counter("rx_bytes", "bytes received from the wire")
            .add_u64_counter("unsized_msgs",
                             "messages accounted via the pickle fallback "
                             "(a type missing its wire sizer)")
            .add_u64("send_queue_depth",
                     "undelivered messages parked at the busiest "
                     "destination at the last send")
            .add_u64("send_queue_peak",
                     "peak send-queue depth observed on any destination")
            .add_histogram("rpc_latency_ms", _RPC_LAT_BUCKETS_MS,
                           "RPC dispatch wall time (server side) in "
                           "milliseconds")
        )
        for cls in WIRE_CLASSES:
            b.add_u64_counter(f"class_bytes:{cls}",
                              f"wire bytes attributed to {cls} ops")
            b.add_u64_counter(f"class_msgs:{cls}",
                              f"wire messages attributed to {cls} ops")
        self.perf = b.create_perf_counters()
        self.cct.perf.add(self.perf)
        self._lock = threading.Lock()
        # type -> {"tx_msgs","tx_bytes","rx_msgs","rx_bytes"} — the
        # read-side base; live mutation happens in per-thread shards
        self._types: dict[str, dict] = {}
        # rpc method -> [count, seconds_sum] — same split
        self._rpc: dict[str, list] = {}
        # per-thread fast-path state: cached perf-counter
        # cells per (direction, class) plus this thread's type/rpc
        # shards, all mutated lock-free by their owner and folded under
        # self._lock at read boundaries
        self._tls = threading.local()
        self._type_shards: dict[int, dict] = {}
        self._rpc_shards: dict[int, dict] = {}
        self._queue_peak = 0
        _ACCOUNTANTS.add(self)

    def _fast(self) -> tuple[dict, dict, dict, dict]:
        """This thread's (cell cache, type shard, rpc shard, misc cache)
        tuple, registered for read-time folding on first use."""
        st = getattr(self._tls, "state", None)
        if st is None:
            ident = threading.get_ident()
            types: dict = {}
            rpc: dict = {}
            with self._lock:
                # a dead thread's ident was reused: bank its shards
                # into the base before the new owner takes the slot
                self._absorb_shards_locked(ident)
                self._type_shards[ident] = types
                self._rpc_shards[ident] = rpc
            st = self._tls.state = ({}, types, rpc, {})
        return st

    def _absorb_shards_locked(self, ident: int) -> None:
        old = self._type_shards.pop(ident, None)
        if old:
            for t, row in old.items():
                base = self._types.get(t)
                if base is None:
                    base = self._types[t] = {
                        "tx_msgs": 0, "tx_bytes": 0,
                        "rx_msgs": 0, "rx_bytes": 0}
                base["tx_msgs"] += row[0]
                base["tx_bytes"] += row[1]
                base["rx_msgs"] += row[2]
                base["rx_bytes"] += row[3]
        old = self._rpc_shards.pop(ident, None)
        if old:
            for m, (c, s) in old.items():
                rec = self._rpc.setdefault(m, [0, 0.0])
                rec[0] += c
                rec[1] += s

    # -- per-message -------------------------------------------------------

    def _account(self, direction: str, type_name: str, nbytes: int,
                 ctx) -> None:
        if not instruments.enabled():
            return
        n = int(nbytes)
        if n < 0:
            n = 0
        cls = wire_class(ctx)
        cells, types = self._fast()[:2]
        key = (direction, cls)
        row = cells.get(key)
        if row is None:
            # first op of this (direction, class) on this thread: bind
            # the four perf cells + the type-shard index ONCE — the
            # steady state is four list bumps and two dict lookups
            pc = self.perf
            row = cells[key] = (pc._cell(f"{direction}_msgs"),
                                pc._cell(f"{direction}_bytes"),
                                pc._cell(f"class_msgs:{cls}"),
                                pc._cell(f"class_bytes:{cls}"),
                                0 if direction == "tx" else 2)
        row[0][0] += 1
        row[1][0] += n
        row[2][0] += 1
        row[3][0] += n
        t = types.get(type_name)
        if t is None:
            t = types[type_name] = [0, 0, 0, 0]
        di = row[4]
        t[di] += 1
        t[di + 1] += n

    def account_tx(self, type_name: str, nbytes: int, ctx=None) -> None:
        self._account("tx", type_name, nbytes, ctx)

    def account_rx(self, type_name: str, nbytes: int, ctx=None) -> None:
        self._account("rx", type_name, nbytes, ctx)

    def account_msg(self, msg, nbytes: int | None = None,
                    ctx=None) -> None:
        """Account one outbound message object: real frame length when
        the transport has it, the sizer estimate otherwise."""
        if nbytes is None:
            if type(msg).__name__ not in _SIZERS:
                self.perf.inc("unsized_msgs")
            nbytes = wire_size(msg)
        self.account_tx(type(msg).__name__, nbytes,
                        ctx if ctx is not None
                        else getattr(msg, "trace", None))

    def note_queue_depth(self, depth: int) -> None:
        if not instruments.enabled():
            return
        d = int(depth)
        self.perf.set("send_queue_depth", d)
        # plain-attribute peak pre-check: the old get() folded every
        # thread's cells under the lock ON EVERY SEND; the gauge write
        # happens only on a new peak now
        if d > self._queue_peak:
            self._queue_peak = d
            self.perf.set("send_queue_peak", d)

    def observe_rpc(self, method: str, seconds: float) -> None:
        if not instruments.enabled():
            return
        st = self._fast()
        rpc, misc = st[2], st[3]
        hist = misc.get("rpc_hist")
        if hist is None:
            # bind the histogram cell + bucket bounds once per thread;
            # the steady state is one linear bucket scan + three bumps
            # (hinc() re-resolves the metric and cell on every call)
            m = self.perf._metrics["rpc_latency_ms"]
            c = self.perf._cell("rpc_latency_ms")
            if c[3] is None:
                c[3] = [0] * (len(m.buckets) + 1)
            hist = misc["rpc_hist"] = (c, tuple(m.buckets))
        c, bounds = hist
        ms = seconds * 1000.0
        i = 0
        n = len(bounds)
        while i < n and ms > bounds[i]:
            i += 1
        c[3][i] += 1
        c[1] += ms
        c[2] += 1
        rec = rpc.get(method)
        if rec is None:
            rec = rpc[method] = [0, 0.0]
        rec[0] += 1
        rec[1] += seconds

    # -- read surfaces -----------------------------------------------------

    def per_type(self) -> dict[str, dict]:
        """Per-message-type table (the prometheus ``ceph_tpu_wire_bytes``
        family + the `daemonperf` wire columns), live shards folded in
        non-destructively."""
        with self._lock:
            out = {t: dict(v) for t, v in self._types.items()}
            for shard in list(self._type_shards.values()):
                # list(dict.items()) is one GIL-atomic snapshot; the
                # owner may keep appending — later reads catch up
                for t, row in list(shard.items()):
                    e = out.get(t)
                    if e is None:
                        e = out[t] = {"tx_msgs": 0, "tx_bytes": 0,
                                      "rx_msgs": 0, "rx_bytes": 0}
                    e["tx_msgs"] += row[0]
                    e["tx_bytes"] += row[1]
                    e["rx_msgs"] += row[2]
                    e["rx_bytes"] += row[3]
        return dict(sorted(out.items()))

    def rpc_methods(self) -> dict[str, dict]:
        with self._lock:
            agg: dict[str, list] = {m: list(v)
                                    for m, v in self._rpc.items()}
            for shard in list(self._rpc_shards.values()):
                for m, row in list(shard.items()):
                    rec = agg.setdefault(m, [0, 0.0])
                    rec[0] += row[0]
                    rec[1] += row[1]
        return {m: {"count": c, "sum_s": round(s, 6),
                    "avg_ms": round(s / c * 1000.0, 3) if c else 0.0}
                for m, (c, s) in sorted(agg.items())}

    def class_bytes(self) -> dict[str, float]:
        return {cls: self.perf.get(f"class_bytes:{cls}")
                for cls in WIRE_CLASSES}

    def totals(self) -> dict[str, float]:
        return {k: self.perf.get(k)
                for k in ("tx_msgs", "tx_bytes", "rx_msgs", "rx_bytes")}

    def dump(self) -> dict:
        """The flight-recorder / admin snapshot."""
        return {"totals": self.totals(),
                "classes": self.class_bytes(),
                "types": self.per_type(),
                "rpc": self.rpc_methods(),
                "queue_peak": self.perf.get("send_queue_peak")}

    def close(self) -> None:
        self.cct.perf.remove(self.perf.name)
        _ACCOUNTANTS.discard(self)
