"""EC sub-op wire payloads and the in-process message bus.

Analog of the reference's ``ECSubWrite``/``ECSubRead``(+replies) payloads
(reference: src/osd/ECMsgTypes.h:23-129) carried by
``MOSDECSubOpWrite/Read`` messages, and of the messenger fan-out that moves
them between shards (reference: src/osd/ECBackend.cc:2036-2070).  The bus is
deterministic: sends enqueue, ``deliver_all`` drains — tests step it to
exercise pipeline orderings; a down shard silently drops its queue the way a
dead OSD would.

A copy of ``ceph_tpu.backend.messages``.  The chain and regenerating
repair legs carry the device their GF products run on as one ``device``
string (cuda | cpu | numpy) instead of a ``use_device`` flag.  In wire
mode (``MessageBus(wire=True)``) every message crosses the bus as a
v2-style frame of ``backend/wire.py`` that pickles the port's own message
classes.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

from .extent import ExtentSet
from .memstore import Transaction
from ..common import wire_accounting
from ..common.tracer import default_tracer
# the bus fault plane lives in the failure/ schema (one schema, one seed
# across planes); re-exported here beside the bus that applies it
from ..failure.config import FaultConfig  # noqa: F401  (re-export)


@dataclass
class ECSubWrite:
    """Primary -> shard: apply this shard-local transaction (ECMsgTypes.h:23-38).

    ``log_entries`` ride along exactly like the reference's (ECSubWrite
    carries the op's pg_log entries so every shard's log advances with the
    write); ``at_version``/``trim_to`` are the eversion bump and the
    piggybacked trim point."""
    from_shard: int
    tid: int
    t: Transaction
    at_version: int = 0
    trim_to: int = 0
    log_entries: list = field(default_factory=list)
    backfill_or_async_recovery: bool = False
    # two-phase commit: entries <= this are stable cluster-wide, the shard
    # may drop their rollback data (the reference piggybacks
    # roll_forward_to on every sub-write, ECMsgTypes.h:23-38)
    roll_forward_to: int = 0
    # dispatch generation: a rolled-back-and-reissued op bumps this so the
    # primary can tell fresh acks from stale ones (the role op reqids and
    # the osdmap epoch stamp play in the reference)
    gen: int = 0
    # distributed-trace context (stamped by PGChannel.send from the
    # sender's active trace): the receiving shard's spans stitch under
    # the originating client op
    trace: object = None


@dataclass
class ECSubWriteReply:
    """Shard -> primary: committed/applied acks (ECMsgTypes.h:91-102)."""
    from_shard: int
    tid: int
    committed: bool = True
    applied: bool = True
    gen: int = 0


@dataclass
class RollForward:
    """Primary -> shard: entries <= ``to`` are committed on min_size shards;
    drop their rollback data.  The standalone kick the reference sends as a
    dummy transaction when the pipeline drains (ECBackend.cc:2106-2120)."""
    from_shard: int
    to: int


@dataclass
class Rollback:
    """Primary -> shard: undo every logged entry with version > ``to`` using
    the rollback info captured at apply time, and rewind your log.  The
    divergent-entry rollback of the reference's peering
    (doc/dev/osd_internals/erasure_coding/ecbackend.rst:149-174)."""
    from_shard: int
    to: int


@dataclass
class ECSubRead:
    """Primary -> shard: read chunk extents, optionally sub-chunk runs
    (ECMsgTypes.h:105-116; sub-chunks serve clay, ECBackend.cc:985-1031)."""
    from_shard: int
    tid: int
    # oid -> list of (chunk-space offset, length, subchunk_runs|None)
    to_read: dict[str, list[tuple]] = field(default_factory=dict)
    attrs_to_read: set[str] = field(default_factory=set)
    include_omap: bool = False     # replicated recovery moves omap too
    # denominator for subchunk_runs (codec's get_sub_chunk_count(); the
    # reference ships it inside the run offsets, ECMsgTypes.h:105-116)
    sub_chunk_count: int = 1
    # distributed-trace context (see ECSubWrite.trace)
    trace: object = None


@dataclass
class ECSubReadReply:
    """Shard -> primary (ECMsgTypes.h:118-129)."""
    from_shard: int
    tid: int
    buffers_read: dict[str, list[tuple[int, bytes]]] = field(default_factory=dict)
    attrs_read: dict[str, dict] = field(default_factory=dict)
    # oid -> (omap kvs, omap header) when include_omap was set
    omap_read: dict[str, tuple] = field(default_factory=dict)
    errors: dict[str, int] = field(default_factory=dict)


@dataclass
class PushOp:
    """Recovery payload: reconstructed chunk data for a missing shard
    (reference: src/osd/ECBackend.cc:284-360 shape)."""
    from_shard: int
    oid: str
    data: bytes
    attrs: dict = field(default_factory=dict)
    version: int = 0
    # None = leave omap alone (EC chunks have none); dict = replace
    omap: dict | None = None
    omap_header: bytes = b""


@dataclass
class PushReply:
    from_shard: int
    oid: str


@dataclass
class PGLogQuery:
    """Primary -> shard: report your log state (the pg_query_t/pg_info_t
    exchange peering opens with, reference: src/osd/PeeringState.cc
    GetInfo; ``since`` bounds the entry payload of the reply)."""
    from_shard: int
    since: int = 0


@dataclass
class PGLogInfo:
    """Shard -> primary: last_update + entries after ``since`` (pg_info_t
    plus the log segment merge_log would examine)."""
    from_shard: int
    last_update: int
    tail: int
    entries: list = field(default_factory=list)


@dataclass
class PGScan:
    """Primary -> shard: list your objects (the backfill scan,
    reference: MOSDPGScan / PrimaryLogPG::do_scan)."""
    from_shard: int


@dataclass
class PGScanReply:
    from_shard: int
    oids: list = field(default_factory=list)


@dataclass
class PGLogUpdate:
    """Primary -> shard: adopt this authoritative log segment (the rewind/
    catch-up half of merge_log).  Entries replace everything the shard has
    past ``rewind_to``; last_update becomes ``last_update``."""
    from_shard: int
    entries: list = field(default_factory=list)
    last_update: int = 0
    rewind_to: int = 0
    trim_to: int = 0


@dataclass
class PGActivate:
    """Primary -> replica: peering is done, serve at this epoch (the
    MOSDPGLog-with-activation the Activating state fans out,
    reference: PeeringState::Active constructor / activate())."""
    from_shard: int
    epoch: int
    head: int = 0                 # authority log head at activation


@dataclass
class PGActivateAck:
    """Replica -> primary: activated (reference: the peer_activated set
    PeeringState::Active collects before pg goes clean)."""
    from_shard: int
    epoch: int


@dataclass
class ECPartialSum:
    """Hop -> next hop: chained streaming repair leg (RapidRAID-style
    pipelined partial sums, PAPERS.md arXiv:1207.6744).  Each survivor
    GF-scales its local chunk by its decode coefficients and XORs the
    result into ``acc`` before forwarding, so the newcomer receives ~1x
    the lost bytes instead of the primary pulling k full shards."""
    from_shard: int
    tid: int
    coordinator: int              # shard Applied/Abort replies go to
    oids: list = field(default_factory=list)       # plan order
    lengths: list = field(default_factory=list)    # per-oid chunk bytes
    versions: list = field(default_factory=list)   # per-oid pg_log version
    rows: list = field(default_factory=list)       # erased chunks, acc order
    targets: list = field(default_factory=list)    # target shard per row
    # remaining legs: [(shard, chunk, ((coeff per row)...)), ...]
    hops: list = field(default_factory=list)
    attrs: dict = field(default_factory=dict)      # oid -> replicated attrs
    # one running partial-sum buffer per erased row (concatenation over
    # plan oids; sliced apart by ``lengths`` at the final hop)
    acc: list | None = None
    # where the leg's GF products run: "cuda" (the card), "cpu" (the
    # plain PyTorch versions) or "numpy" (the host GF math)
    device: str = "numpy"
    trace: object = None


@dataclass
class ECPartialSumApply:
    """Final hop -> repair target: one reconstructed chunk, applied like
    a PushOp (stale-version guard included) but scoped to the chain tid."""
    from_shard: int
    tid: int
    coordinator: int
    oid: str
    data: bytes
    attrs: dict = field(default_factory=dict)
    trace: object = None


@dataclass
class ECPartialSumApplied:
    """Repair target -> coordinator: chunk for ``oid`` is durable."""
    from_shard: int
    tid: int
    oid: str


@dataclass
class ECPartialSumAbort:
    """Any hop -> coordinator: the chain cannot complete (missing or
    rotten local chunk, version skew, misroute); coordinator falls back
    to centralized verified repair for the unfinished objects."""
    from_shard: int
    tid: int
    reason: str = ""
    trace: object = None


@dataclass
class ECRegenRead:
    """Coordinator -> one leg of a regenerating repair (product-matrix
    MSR/MBR, arXiv:1412.3022).  The same message serves both legs:

    - **helper leg** (``proj`` set): project your stored chunk's
      ``sub_count`` symbol rows by the 1 x sub_count coefficient row and
      ship the beta-stream to ``target`` via :class:`ECRegenHelper`;
    - **newcomer leg** (``combine`` set): expect ``len(helpers)``
      beta-streams per oid, combine them by the sub_count x d matrix
      into the lost chunk, verify, apply, ack the coordinator.

    Validation mirrors the chain hops (the verification-first rule):
    any mismatch aborts to the coordinator, which falls back to
    centralized waves."""
    from_shard: int
    tid: int
    coordinator: int              # shard Applied/Abort replies go to
    target: int                   # newcomer shard the beta-streams converge on
    chunk: int                    # receiver's chunk id (helper: its own; newcomer: the lost one)
    sub_count: int = 1            # alpha symbol rows per stored chunk
    proj: bytes = b""             # helper leg: 1 x alpha projection row
    combine: bytes = b""          # newcomer leg: alpha x d combine matrix (row-major)
    helpers: list = field(default_factory=list)   # newcomer leg: helper chunks, stream order
    oids: list = field(default_factory=list)      # plan order
    lengths: list = field(default_factory=list)   # per-oid STORED chunk bytes
    versions: list = field(default_factory=list)  # per-oid pg_log version
    attrs: dict = field(default_factory=dict)     # oid -> replicated attrs
    # where the leg's GF products run: "cuda" (the card), "cpu" (the
    # plain PyTorch versions) or "numpy" (the host GF math)
    device: str = "numpy"
    trace: object = None


@dataclass
class ECRegenHelper:
    """Helper -> newcomer: the beta-byte inner-product streams — the d
    small shipments that replace k full-chunk reads (MBR: d*beta equals
    ONE chunk; MSR: d/alpha chunks)."""
    from_shard: int
    tid: int
    coordinator: int
    chunk: int                    # helper's chunk id (stream-order key)
    streams: dict = field(default_factory=dict)   # oid -> beta bytes
    trace: object = None


# -- wire accounting (common/wire_accounting.py) -----------------------------
#
# Every PG message type registers its payload sizer here, next to its
# definition, so the non-framed in-process bus can charge honest byte
# counts (the wire-mode bus and net.py use real frame lengths).  The
# sizers weigh the fields that dominate on a real wire — chunk buffers,
# transactions, log entries; fixed-size headers ride the shared
# MSG_OVERHEAD.  A type without one is still charged, through the
# pickle fallback, and counted on ``unsized_msgs``.

_blob = wire_accounting.blob_size

wire_accounting.register_wire_sizes({
    ECSubWrite: lambda m: _blob(m.t.ops) + _blob(m.log_entries),
    ECSubWriteReply: lambda m: 16,
    RollForward: lambda m: 8,
    Rollback: lambda m: 8,
    ECSubRead: lambda m: _blob(m.to_read) + _blob(m.attrs_to_read),
    ECSubReadReply: lambda m: (_blob(m.buffers_read) + _blob(m.attrs_read)
                               + _blob(m.omap_read)),
    PushOp: lambda m: (len(m.data) + _blob(m.attrs) + _blob(m.omap)
                       + len(m.omap_header)),
    PushReply: lambda m: len(m.oid),
    PGLogQuery: lambda m: 8,
    PGLogInfo: lambda m: 16 + _blob(m.entries),
    PGScan: lambda m: 8,
    PGScanReply: lambda m: _blob(m.oids),
    PGLogUpdate: lambda m: 24 + _blob(m.entries),
    PGActivate: lambda m: 16,
    PGActivateAck: lambda m: 16,
    ECPartialSum: lambda m: (_blob(m.acc) + _blob(m.hops) + _blob(m.attrs)
                             + _blob(m.oids) + _blob(m.rows)
                             + _blob(m.targets) + 8 * len(m.lengths)
                             + 8 * len(m.versions)),
    ECPartialSumApply: lambda m: (len(m.data) + _blob(m.attrs)
                                  + len(m.oid) + 16),
    ECPartialSumApplied: lambda m: 16 + len(m.oid),
    ECPartialSumAbort: lambda m: 16 + len(m.reason),
    ECRegenRead: lambda m: (len(m.proj) + len(m.combine) + _blob(m.helpers)
                            + _blob(m.oids) + _blob(m.attrs)
                            + 8 * len(m.lengths) + 8 * len(m.versions)
                            + 16),
    ECRegenHelper: lambda m: _blob(m.streams) + 24,
    # the cluster-bus wrapper: header + the routed payload
    "PGEnvelope": lambda m: 16 + wire_accounting.wire_size(m.msg),
})


@dataclass
class _WireEnvelope:
    """A framed message in flight (wire-mode bus): real bytes between
    send and delivery.  from_shard survives outside the frame so the
    reorder scheduler keeps per-sender FIFO without parsing."""
    from_shard: int | None
    frame: bytes


@dataclass
class PGEnvelope:
    """Cluster-bus wrapper routing a PG-scoped message to the right PG on
    the destination OSD — the analog of the spg_t every reference OSD
    message carries for dispatch (src/osd/OSD.cc ms_fast_dispatch).
    ``from_shard`` mirrors the inner message's so reorder fault injection
    keeps per-sender FIFO semantics."""
    pgid: object
    msg: object
    from_shard: int | None = None
    # the sender's active TraceContext: the destination OSD activates it
    # around dispatch so its spans join the originating op's trace
    trace: object = None


class OSDEndpoint:
    """ONE bus registration per OSD: demuxes PGEnvelopes to the per-PG
    channels hosted on this OSD (the reference OSD's single messenger
    endpoint feeding many PGs)."""

    def __init__(self, osd: int):
        self.osd = osd
        self.pg_channels: dict = {}       # pgid -> PGChannel

    def handle_message(self, msg) -> None:
        if not isinstance(msg, PGEnvelope):
            raise TypeError(
                f"OSD endpoint {self.osd} got non-enveloped {type(msg)}")
        ch = self.pg_channels.get(msg.pgid)
        if ch is None:
            return           # PG deleted/moved: drop, like an unknown spg_t
        handler = ch.handlers.get(self.osd)
        if handler is None:
            return
        # the payload's own trace field (ECSubRead/ECSubWrite) wins: it
        # is stamped once and stays stable across reissues, while the
        # envelope's is whatever context the (re)sender held
        ctx = getattr(msg.msg, "trace", None) or msg.trace
        if ctx is None:
            handler.handle_message(msg.msg)
            return
        # a traced message: this OSD's dispatch becomes a child span on
        # its own track, so the stitched Chrome trace shows the sub-op
        # crossing the daemon boundary (client -> primary -> this shard)
        tr = default_tracer()
        with tr.activate(ctx, track=f"osd.{self.osd}"), \
                tr.span(f"osd.{type(msg.msg).__name__}", cat="rpc",
                        owner=ctx.op_class):
            handler.handle_message(msg.msg)


class PGChannel:
    """A PG's view of the shared cluster bus.

    Exposes the MessageBus surface the PG backends use (send/register/
    handlers/down/mark_*/deliver_*/listeners/fault injection) while the
    actual queues, down-set, and delivery loop live on ONE cluster-wide
    MessageBus with one OSDEndpoint per OSD — the reference's topology
    (one messenger per OSD, many PGs behind it).  Down/up are OSD-wide:
    killing an OSD affects every PG it serves, exactly like a real death.
    """

    def __init__(self, bus: MessageBus, pgid):
        self.bus = bus
        self.pgid = pgid
        self.handlers: dict[int, object] = {}   # this PG's shard handlers

    def register(self, shard: int, handler) -> None:
        self.handlers[shard] = handler
        ep = self.bus.handlers.get(shard)
        if not isinstance(ep, OSDEndpoint):
            ep = OSDEndpoint(shard)
            self.bus.register(shard, ep)
        ep.pg_channels[self.pgid] = self

    def unregister_all(self) -> None:
        """Drop this PG from every OSD endpoint (PG teardown)."""
        for ep in self.bus.handlers.values():
            if isinstance(ep, OSDEndpoint):
                ep.pg_channels.pop(self.pgid, None)

    def send(self, to_shard: int, msg) -> None:
        # trace propagation across the daemon boundary: stamp the
        # sender's active context onto the envelope AND onto payloads
        # that declare a trace field (ECSubRead/ECSubWrite — the wire
        # shape the reference's blkin hooks annotate)
        ctx = default_tracer().current_ctx()
        if ctx is not None and getattr(msg, "trace", True) is None:
            msg.trace = ctx
        self.bus.send(to_shard, PGEnvelope(
            self.pgid, msg, getattr(msg, "from_shard", None), trace=ctx))

    # -- delegation to the shared bus ---------------------------------------

    @property
    def down(self) -> set[int]:
        return self.bus.down

    def mark_down(self, shard: int) -> None:
        self.bus.mark_down(shard)

    def mark_up(self, shard: int) -> None:
        self.bus.mark_up(shard)

    def deliver_one(self, shard: int) -> bool:
        return self.bus.deliver_one(shard)

    def deliver_all(self, max_rounds: int = 10000) -> int:
        return self.bus.deliver_all(max_rounds)

    def inject_faults(self, cfg) -> None:
        self.bus.inject_faults(cfg)

    @property
    def down_listeners(self) -> list:
        return self.bus.down_listeners

    @property
    def up_listeners(self) -> list:
        return self.bus.up_listeners

    @property
    def queues(self):
        return self.bus.queues

    @property
    def wire(self) -> bool:
        return self.bus.wire

    @property
    def wire_secret(self):
        return self.bus.wire_secret

    @property
    def delivered(self) -> int:
        return self.bus.delivered

    @property
    def dropped(self) -> int:
        return self.bus.dropped

    @property
    def duplicated(self) -> int:
        return self.bus.duplicated


class MessageBus:
    """Per-shard FIFO queues; handlers registered per shard id.

    ``wire=True`` runs every message through the v2-style frame codec
    (backend/wire.py): send serializes to integrity-protected bytes,
    delivery parses them back — so codec/registration bugs and corrupted
    payloads surface as frame errors instead of silent shared-object
    aliasing.  ``wire_secret`` switches the frames from crc to secure
    (HMAC) mode, e.g. with a cephx session key."""

    def __init__(self, wire: bool = False, wire_secret: bytes | None = None):
        self.queues: dict[int, deque] = {}
        self.handlers: dict[int, object] = {}
        self.down: set[int] = set()
        self.wire = wire
        self.wire_secret = wire_secret
        self.delivered = 0
        self.dropped = 0
        self.duplicated = 0
        # optional WireAccounting (common/wire_accounting.py): when set,
        # every send charges byte/op counters per message type and per
        # owner op class — the in-process half of wire observability
        self.wire_stats = None
        # failure/revival notification fan-out: the reference's analog is the
        # osdmap epoch bump reaching each OSD after heartbeats report it
        self.down_listeners: list = []
        self.up_listeners: list = []
        # called at the top of deliver_all: the cluster hooks its daemon
        # op-queue drains here so "deliver everything" includes client
        # ops parked on live daemons (e.g. queued while their OSD was
        # down), matching the pre-shared-bus progress guarantees
        self.pre_deliver_hooks: list = []
        self._faults: FaultConfig | None = None
        self._fault_rng = None
        # optional event sink: fn(plane, kind, target=..., **detail) —
        # a FaultInjector.record, so bus drops/dups/reorders land in the
        # same seeded campaign log as every other plane's events
        self.fault_log = None

    def inject_faults(self, cfg) -> None:
        """Enable (or, with None, disable) fault injection.  Accepts the
        legacy bus :class:`FaultConfig` or a whole
        :class:`~ceph_tpu_torch.failure.config.FaultPlan` (its bus plane, with
        the campaign seed, is what applies here)."""
        if cfg is not None and hasattr(cfg, "bus_config"):
            cfg = cfg.bus_config()
        self._faults = cfg
        if cfg is not None:
            import random
            self._fault_rng = random.Random(cfg.seed)

    def register(self, shard: int, handler) -> None:
        self.queues.setdefault(shard, deque())
        self.handlers[shard] = handler

    def mark_down(self, shard: int) -> None:
        """Drop the shard: pending + future messages to it vanish (a dead
        OSD's socket resets; the reference learns via heartbeats+osdmap).
        Edge-triggered: marking an already-down shard is a no-op, so the
        per-PG fan-out over a shared bus fires listeners exactly once."""
        if shard in self.down:
            return
        self.down.add(shard)
        if shard in self.queues:
            self.queues[shard].clear()
        for cb in self.down_listeners:
            cb(shard)

    def mark_up(self, shard: int) -> None:
        if shard not in self.down:
            return
        self.down.discard(shard)
        for cb in self.up_listeners:
            cb(shard)

    def send(self, to_shard: int, msg) -> None:
        if to_shard in self.down:
            return
        f = self._faults
        if f is not None and f.drop_prob and \
                self._fault_rng.random() < f.drop_prob:
            self.dropped += 1
            if self.fault_log is not None:
                self.fault_log("bus", "drop", target=to_shard)
            return
        acct = self.wire_stats
        # attribute to the PAYLOAD's type and trace — the envelope is
        # routing; the payload's own stamped ctx wins over the envelope's
        # (the precedence OSDEndpoint.handle_message applies) — but SIZE
        # the whole thing the wire carries, envelope included
        inner = msg.msg if isinstance(msg, PGEnvelope) else msg
        ctx = getattr(inner, "trace", None) or getattr(msg, "trace", None)
        # wire-mode buses charge the REAL frame length below: skip the
        # sizer walk entirely rather than estimate-then-discard
        nbytes = wire_accounting.wire_size(msg) \
            if acct is not None and not self.wire else None
        if self.wire:
            from .wire import message_encode
            sender = getattr(msg, "from_shard", None)
            frame = message_encode(msg, secret=self.wire_secret)
            if acct is not None:
                nbytes = len(frame)      # real framed bytes on this bus
            msg = _WireEnvelope(sender, frame)
        q = self.queues.setdefault(to_shard, deque())
        if acct is not None:
            acct.account_msg(inner, nbytes=nbytes, ctx=ctx)
            acct.note_queue_depth(len(q) + 1)
        q.append(msg)

    def _pick(self, q: deque):
        """Next message to deliver.  Under reorder injection: the earliest
        message of a uniformly random sender (per-sender FIFO preserved,
        cross-sender order randomized)."""
        f = self._faults
        if f is None or not f.reorder or len(q) < 2:
            return q.popleft()
        senders, seen = [], set()
        for m in q:
            s = getattr(m, "from_shard", None)
            if s not in seen:
                seen.add(s)
                senders.append(s)
        pick = self._fault_rng.choice(senders)
        for i, m in enumerate(q):
            if getattr(m, "from_shard", None) == pick:
                del q[i]
                return m
        return q.popleft()        # unreachable

    def deliver_one(self, shard: int) -> bool:
        q = self.queues.get(shard)
        if not q or shard in self.down:
            return False
        msg = self._pick(q)
        if isinstance(msg, _WireEnvelope):
            from .wire import FrameParser, message_decode
            parser = FrameParser(self.wire_secret)
            [(tag, segs)] = parser.feed(msg.frame)
            msg = message_decode(tag, segs)
        handler = self.handlers[shard]
        handler.handle_message(msg)
        self.delivered += 1
        f = self._faults
        if f is not None and f.dup_prob and \
                self._fault_rng.random() < f.dup_prob and \
                shard not in self.down:
            # immediate redelivery: the resend after a connection reset
            self.duplicated += 1
            if self.fault_log is not None:
                self.fault_log("bus", "dup", target=shard)
            handler.handle_message(msg)
        return True

    def deliver_all(self, max_rounds: int = 10000) -> int:
        """Drain every queue to quiescence; returns messages delivered."""
        n = 0
        for _ in range(max_rounds):
            for hook in self.pre_deliver_hooks:
                hook()
            progressed = False
            for shard in list(self.queues):
                while self.deliver_one(shard):
                    progressed = True
                    n += 1
            if not progressed:
                return n
        raise RuntimeError("message storm: bus did not quiesce")
