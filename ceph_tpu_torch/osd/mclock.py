"""mClock/dmClock QoS op scheduling.

Analog of the reference's mClock queues (reference:
src/osd/mClockOpClassQueue.{h,cc} + src/osd/mClockClientQueue.{h,cc}
bridging into the dmclock library, src/dmclock/ — the Gulati et al.
"mClock: Handling Throughput Variability for Hypervisor IO Scheduling"
algorithm).  Semantics mirrored:

- every client (or op CLASS — the mClockOpClassQueue adapter treats the
  op type as the client) has a QoS triple (reservation, weight, limit)
  in ops/sec;
- each request gets three tags at enqueue: R (reservation), P
  (proportional/weight), L (limit), each ``max(now, prev + 1/param)``;
- dequeue serves in two phases: the CONSTRAINT phase picks the smallest
  R tag <= now (reservations are hard guarantees), else the WEIGHT phase
  picks the smallest P tag among clients whose L tag <= now (limits are
  hard caps); a weight-phase pick credits the client's remaining R tags
  by 1/r so reservations are not double-counted (paper §III-B);
- strict-priority ops (peering messages etc.) bypass QoS entirely, like
  the reference's enqueue_strict path (OpQueue semantics).

Time is a virtual clock so tests drive deterministic schedules; the OSD
op-class defaults mirror ``osd_op_queue_mclock_*`` options
(src/common/options.cc).

A copy of ``ceph_tpu.osd.mclock``: the port keeps its own copy, so it
needs nothing of the JAX package.
"""
from __future__ import annotations

import heapq
import itertools
from collections import deque
from dataclasses import dataclass, field


@dataclass(frozen=True)
class ClientInfo:
    """dmclock ClientInfo: QoS triple in ops/sec (0 = unused)."""
    reservation: float = 0.0
    weight: float = 1.0
    limit: float = 0.0          # 0 => unlimited


@dataclass
class _Request:
    item: object
    r_tag: float
    p_tag: float
    l_tag: float
    cost: float


@dataclass
class _ClientRec:
    info: ClientInfo
    queue: deque = field(default_factory=deque)
    # -inf so a client's FIRST request tags at now (paper: a newly
    # active client starts fresh; max(now, prev + 1/param) handles both
    # the first request and the return-from-idle reset)
    last_r: float = float("-inf")
    last_p: float = float("-inf")
    last_l: float = float("-inf")


class MClockQueue:
    """Two-phase dmclock scheduler + strict-priority bypass."""

    def __init__(self, client_info_fn):
        """``client_info_fn(client) -> ClientInfo`` (the reference's
        op_class_client_info_f / ClientInfoFunc)."""
        self.client_info_fn = client_info_fn
        self.clients: dict[object, _ClientRec] = {}
        self._strict: list = []          # (-priority, seq, item)
        self._seq = itertools.count()
        self.served_reservation = 0
        self.served_weight = 0

    # -- enqueue -------------------------------------------------------------

    def enqueue_strict(self, priority: int, item) -> None:
        """Priority ops bypass QoS (OpQueue::enqueue_strict)."""
        heapq.heappush(self._strict, (-priority, next(self._seq), item))

    def enqueue(self, client, item, now: float, cost: float = 1.0) -> None:
        rec = self.clients.get(client)
        if rec is None:
            rec = self.clients[client] = _ClientRec(
                info=self.client_info_fn(client))
        info = rec.info
        r = max(now, rec.last_r + cost / info.reservation) \
            if info.reservation > 0 else float("inf")
        p = max(now, rec.last_p + cost / info.weight) \
            if info.weight > 0 else float("inf")
        l = max(now, rec.last_l + cost / info.limit) \
            if info.limit > 0 else 0.0
        rec.queue.append(_Request(item, r, p, l, cost))
        if info.reservation > 0:
            rec.last_r = r
        if info.weight > 0:
            rec.last_p = p
        if info.limit > 0:
            rec.last_l = l

    # -- dequeue -------------------------------------------------------------

    def empty(self) -> bool:
        return not self._strict and \
            all(not rec.queue for rec in self.clients.values())

    def dequeue(self, now: float):
        """Next item, or None when everything queued is over its limit
        and nothing is reservation-eligible (caller advances the clock;
        the reference's queue blocks on the same condition)."""
        if self._strict:
            return heapq.heappop(self._strict)[2]
        # constraint phase: hard reservations first
        best = None
        for client, rec in self.clients.items():
            if rec.queue and rec.queue[0].r_tag <= now:
                if best is None or rec.queue[0].r_tag < \
                        self.clients[best].queue[0].r_tag:
                    best = client
        if best is not None:
            self.served_reservation += 1
            return self.clients[best].queue.popleft().item
        # weight phase: proportional among clients under their limit
        best = None
        for client, rec in self.clients.items():
            if rec.queue and rec.queue[0].l_tag <= now:
                if best is None or rec.queue[0].p_tag < \
                        self.clients[best].queue[0].p_tag:
                    best = client
        if best is None:
            return None
        rec = self.clients[best]
        req = rec.queue.popleft()
        # credit the client's remaining reservation tags (paper §III-B:
        # a weight-phase grant must not also consume reservation budget)
        if rec.info.reservation > 0:
            delta = req.cost / rec.info.reservation
            for pending in rec.queue:
                pending.r_tag -= delta
            rec.last_r -= delta
        self.served_weight += 1
        return req.item

    def depths(self) -> dict:
        """Queue depth per client/class (+ strict-priority backlog) — the
        gauge surface the prometheus exporter renders as
        ``ceph_tpu_mclock_queue_depth``."""
        d = {str(client): len(rec.queue)
             for client, rec in self.clients.items() if rec.queue}
        if self._strict:
            d["strict"] = len(self._strict)
        return d

    def next_eligible_time(self, now: float) -> float | None:
        """Earliest future time anything becomes servable (for clock
        advancement in tests/ticks)."""
        t = None
        for rec in self.clients.values():
            if not rec.queue:
                continue
            head = rec.queue[0]
            cand = min(head.r_tag, max(head.l_tag, now))
            if cand > now and (t is None or cand < t):
                t = cand
            elif cand <= now:
                return now
        return t


# -- the op-class adapter (mClockOpClassQueue) --------------------------------

CLIENT_OP = "client_op"
OSD_SUBOP = "osd_subop"
BG_SNAPTRIM = "bg_snaptrim"
BG_RECOVERY = "bg_recovery"
BG_SCRUB = "bg_scrub"

# defaults mirroring osd_op_queue_mclock_* (src/common/options.cc):
# client ops dominate by weight; background classes are limited so they
# cannot starve clients, recovery keeps a small reservation so it always
# makes progress
DEFAULT_OP_CLASS_INFO = {
    CLIENT_OP: ClientInfo(reservation=0.0, weight=500.0, limit=0.0),
    OSD_SUBOP: ClientInfo(reservation=0.0, weight=500.0, limit=0.0),
    BG_SNAPTRIM: ClientInfo(reservation=0.0, weight=1.0, limit=0.001),
    BG_RECOVERY: ClientInfo(reservation=1.0, weight=5.0, limit=10.0),
    BG_SCRUB: ClientInfo(reservation=0.0, weight=1.0, limit=0.001),
}


class MClockOpClassQueue(MClockQueue):
    """QoS by op CLASS: the adapter the reference wraps around dmclock
    (mClockOpClassQueue.h: 'the class is osd_op_type_t')."""

    def __init__(self, class_info: dict | None = None):
        info = dict(DEFAULT_OP_CLASS_INFO)
        if class_info:
            info.update(class_info)
        super().__init__(lambda op_class: info[op_class])
