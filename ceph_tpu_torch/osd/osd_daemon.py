"""The OSD daemon shell: boot, sharded op queue, dispatch.

Analog of the reference's ``OSD`` daemon skeleton (reference:
src/osd/OSD.cc — ``init`` boot at :2719, ``ms_fast_dispatch`` at :6877,
sharded ``enqueue_op``/``dequeue_op`` at :9490,9543): the layer between
the messenger and the PGs.  What the reference spreads over a 10k-LoC
daemon collapses here to the load-bearing pieces:

- **superblock + boot**: the daemon persists ``{whoami, epoch, pgids}``
  in its meta store and on boot re-registers every PG it hosted
  (OSD::init reads the superblock then loads PGs;
  src/osd/OSD.cc:2719,3306).
- **epoch gate**: ops stamped with an older epoch than the PG's are
  bounced back to the client for a resend with a newer map
  (require_same_or_newer_map; the Objecter handles the resend).
- **sharded op queue with mClock QoS**: ops land in one of N shard
  queues picked by pgid hash — the reference's ShardedOpWQ — and each
  shard dequeues in dmClock order over op CLASSES (client ops vs
  recovery vs scrub), so background work cannot starve clients
  (src/osd/OSD.cc:9490-9600, src/osd/mClockOpClassQueue.h).
- **dispatch**: a dequeued client op runs through the PG's op engine
  (PrimaryLogPG.do_op); a dequeued background item is just a thunk.

The event loop is cooperative (``drain``), matching the framework's
deterministic single-thread design; shard count shapes ORDER (ops on one
PG stay FIFO within their class), not parallelism.

A copy of ``ceph_tpu.osd.osd_daemon``.
"""
from __future__ import annotations

import time
import weakref
from dataclasses import dataclass, field
from typing import Callable

from .mclock import (
    BG_RECOVERY, BG_SCRUB, CLIENT_OP, MClockOpClassQueue,
)
from .osd_ops import MOSDOp, MOSDOpReply
from ..common.device_attribution import canonical_owner
from ..common.tracer import default_tracer

# live daemons, for the prometheus mclock-depth gauge export
_DAEMONS: "weakref.WeakSet[OSDDaemon]" = weakref.WeakSet()


def live_daemons() -> list["OSDDaemon"]:
    return list(_DAEMONS)


@dataclass
class _QueuedOp:
    pgid: object
    run: Callable[[], None]
    cost: float = 1.0
    t_enqueue: float = 0.0          # daemon-clock stamp for queue-wait
    throttled: int = 0              # op-throttle units to release on run


class OSDDaemon:
    """One OSD's daemon shell hosting the PGs whose primary it is."""

    def __init__(self, whoami: int, num_shards: int = 2, clock=None,
                 meta_store=None, op_throttle=None):
        self.whoami = whoami
        self.num_shards = max(1, num_shards)
        self.clock = clock          # VirtualClock or None (monotonic int)
        self._ticks = 0.0
        self.pgs: dict = {}         # pgid -> PGGroup (engine + backend)
        self.epoch = 0
        self.meta_store = meta_store    # FileStore/MemStore for superblock
        self.shards = [MClockOpClassQueue() for _ in range(self.num_shards)]
        self.booted = False
        # optional admission throttle (exec.Throttle over op count): past
        # the bound, ms_dispatch answers ('throttled', epoch) and the
        # client backs off — the daemon-queue face of the same
        # backpressure the serving engine applies at the codec
        self.op_throttle = op_throttle
        # queue accounting for the exporter: enqueued/dequeued totals and
        # summed queue wait (daemon-clock seconds)
        self.queue_stats = {"enqueued": 0, "dequeued": 0,
                            "throttled_rejects": 0, "wait_sum": 0.0}
        _DAEMONS.add(self)

    # -- superblock (OSDSuperblock; src/osd/OSD.cc read_superblock) --------

    SUPERBLOCK = "osd_superblock"

    def _now(self) -> float:
        if self.clock is not None:
            return self.clock.now()
        self._ticks += 1e-3
        return self._ticks

    def advance_clock(self, dt: float) -> None:
        """Consume ``dt`` seconds of virtual time — how 'sleeping' works
        in the cooperative model.  The recovery scheduler uses this for
        ``osd_recovery_sleep`` and token-bucket debt between waves: the
        pacing is real on the daemon clock (queue-wait accounting, mClock
        tags) without ever blocking the single thread."""
        if dt <= 0:
            return
        if self.clock is not None:
            self.clock.advance(dt)
        else:
            self._ticks += dt

    def write_superblock(self) -> None:
        if self.meta_store is None:
            return
        from ..backend.memstore import GObject, Transaction
        t = Transaction().setattr(
            GObject(self.SUPERBLOCK), "sb",
            {"whoami": self.whoami, "epoch": self.epoch,
             "pgids": sorted(self.pgs, key=repr)})
        self.meta_store.queue_transaction(t)

    def read_superblock(self) -> dict | None:
        if self.meta_store is None:
            return None
        from ..backend.memstore import GObject
        try:
            return dict(self.meta_store.getattr(GObject(self.SUPERBLOCK),
                                                "sb"))
        except (FileNotFoundError, KeyError):
            return None

    def boot(self, pg_loader: Callable[[object], object] | None = None
             ) -> list:
        """OSD::init: read the superblock, re-register every hosted PG via
        ``pg_loader(pgid) -> PGGroup`` (the caller owns store opening /
        peering — MiniCluster.load's boot path), bump to booted."""
        sb = self.read_superblock()
        loaded = []
        if sb is not None:
            self.epoch = max(self.epoch, int(sb["epoch"]))
            if pg_loader is not None:
                for pgid in sb["pgids"]:
                    g = pg_loader(pgid)
                    if g is not None:
                        self.pgs[pgid] = g
                        loaded.append(pgid)
        self.booted = True
        return loaded

    # -- PG registry -------------------------------------------------------

    def register_pg(self, pgid, group) -> None:
        self.pgs[pgid] = group
        self.epoch = max(self.epoch, getattr(group, "epoch", 0))
        self.write_superblock()

    def advance_epoch(self, epoch: int) -> None:
        self.epoch = max(self.epoch, epoch)
        self.write_superblock()

    # -- op intake (ms_fast_dispatch + enqueue_op) -------------------------

    def _shard_for(self, pgid) -> MClockOpClassQueue:
        return self.shards[hash(pgid) % self.num_shards]

    def ms_dispatch(self, pgid, m: MOSDOp,
                    on_reply: Callable[[MOSDOpReply], None],
                    op_class: str = CLIENT_OP):
        """Accept a client op for a hosted PG.  Returns None when queued,
        or ``("stale", epoch)`` when the op's epoch predates the PG's
        acting set (client must refresh its map and resend)."""
        g = self.pgs.get(pgid)
        if g is None or g.backend.whoami != self.whoami:
            return ("stale", self.epoch)
        if m.epoch < g.epoch:
            return ("stale", self.epoch)
        if self.op_throttle is not None and \
                not self.op_throttle.get_or_fail(1):
            # bounded daemon queue: refuse instead of growing (the
            # reference's messenger policy throttles the same way; the
            # client treats it like a transient and resends with backoff)
            self.queue_stats["throttled_rejects"] += 1
            return ("throttled", self.epoch)
        cost = 1.0 + sum(len(op.params.get("data", b""))
                         for op in m.ops) / 65536.0
        now = self._now()
        self.queue_stats["enqueued"] += 1

        t_enq_mono = time.monotonic()   # real clock: _now() may be virtual

        def run(m=m, g=g, on_reply=on_reply, op_class=op_class,
                t_enq_mono=t_enq_mono):
            # the queued op runs much later (drain), on whatever thread
            # drives the bus: re-activate the context the CLIENT stamped
            # on the MOSDOp so this daemon's spans stitch under it, with
            # this OSD as their track
            tr = default_tracer()
            ctx = getattr(m, "trace", None)
            wait = max(0.0, time.monotonic() - t_enq_mono)
            if ctx is not None:
                # the op's daemon-queue wait, stamped into its trace —
                # the critical-path ledger's `queue` phase
                tr.complete("osd.queue_wait", time.time() - wait, wait,
                            ctx=ctx, osd=self.whoami)
            with tr.activate(ctx, track=f"osd.{self.whoami}"), \
                    tr.span("osd.op", oid=m.oid,
                            owner=canonical_owner(op_class)):
                g.engine.do_op(m, on_reply)
        self._shard_for(pgid).enqueue(
            op_class,
            _QueuedOp(pgid, run, cost, t_enqueue=now,
                      throttled=1 if self.op_throttle is not None else 0),
            now, cost=cost)
        return None

    def queue_background(self, pgid, fn: Callable[[], None],
                         op_class: str = BG_RECOVERY,
                         cost: float = 1.0) -> None:
        """Recovery/scrub work rides the same queue under its own QoS
        class (the reference queues PGRecovery/PGScrub items alongside
        client ops, src/osd/OSD.cc:9700+)."""
        now = self._now()
        self.queue_stats["enqueued"] += 1
        # background items run under their own root trace whose op class
        # is the dmClock class: every span (and device dispatch) below
        # them attributes to recovery/scrub instead of masquerading as
        # client work — unless the caller already carries a context
        # (e.g. the recovery scheduler's wave trace)
        owner = canonical_owner(op_class)
        # the ENQUEUING thread's context (e.g. the recovery scheduler's
        # wave trace) rides along; drain-time ambient context must not —
        # a client op draining the queue would misattribute the backlog
        ctx = default_tracer().current_ctx()

        t_enq_mono = time.monotonic()   # real clock: _now() may be virtual

        def run(fn=fn, owner=owner, ctx=ctx, t_enq_mono=t_enq_mono):
            tr = default_tracer()
            actx = ctx if ctx is not None else tr.new_trace(owner)
            wait = max(0.0, time.monotonic() - t_enq_mono)
            # background work pays queue wait too (scrub behind client
            # bursts): stamped so its class's attribution carries it
            tr.complete("osd.queue_wait", time.time() - wait, wait,
                        ctx=actx, osd=self.whoami)
            with tr.activate(actx, track=f"osd.{self.whoami}"), \
                    tr.span(f"osd.{owner}", owner=owner):
                fn()
        self._shard_for(pgid).enqueue(
            op_class, _QueuedOp(pgid, run, cost, t_enqueue=now), now,
            cost=cost)

    def queue_depths(self) -> dict:
        """Per-shard mClock depths (the prometheus gauge surface)."""
        return {i: s.depths() for i, s in enumerate(self.shards)
                if not s.empty()}

    def _run_item(self, item: _QueuedOp) -> None:
        self.queue_stats["dequeued"] += 1
        self.queue_stats["wait_sum"] += max(
            0.0, self._now() - item.t_enqueue)
        try:
            item.run()
        finally:
            if item.throttled and self.op_throttle is not None:
                self.op_throttle.put(item.throttled)

    # -- dispatch loop (dequeue_op) ----------------------------------------

    def drain(self, max_ops: int | None = None) -> int:
        """Dequeue in mClock order until empty (or max_ops); returns the
        number dispatched.  Items whose QoS limit pushes them into the
        future still run — 'limited' classes yield to eligible ones but a
        drain must not leave work behind (the reference blocks the shard
        thread on next_eligible_time the same way)."""
        ran = 0
        while max_ops is None or ran < max_ops:
            progressed = False
            for shard in self.shards:
                if shard.empty():
                    continue
                now = self._now()
                item = shard.dequeue(now)
                if item is None:
                    nxt = shard.next_eligible_time(now)
                    if nxt is None:
                        continue
                    if self.clock is not None:
                        self.clock.advance(nxt - now)
                    else:
                        self._ticks = nxt
                    item = shard.dequeue(self._now())
                    if item is None:
                        continue
                self._run_item(item)
                ran += 1
                progressed = True
                if max_ops is not None and ran >= max_ops:
                    break
            if not progressed:
                break
        return ran

    def pending(self) -> int:
        return sum(0 if s.empty() else 1 for s in self.shards)
