"""AsyncReserver: prioritized, preemptible in-flight reservation grants.

Analog of the reference's ``AsyncReserver`` (reference:
src/common/AsyncReserver.h — the template every OSD instantiates twice,
as ``local_reserver`` and ``remote_reserver``, to gate background
recovery/backfill admission).  Semantics mirrored:

- ``request_reservation(item, on_grant, prio, on_preempt)`` queues the
  item FIFO within its priority; ``do_queues`` grants the
  highest-priority waiter whenever fewer than ``max_allowed``
  reservations are in flight (AsyncReserver.h ``do_queues``).
- a queued request with priority strictly ABOVE an in-flight holder's
  preempts the lowest-priority preemptible holder: the holder's
  ``on_preempt`` fires (it must stop its work and usually re-request),
  and the grant goes to the higher-priority waiter
  (AsyncReserver.h ``preempt_by`` semantics).
- holders registered WITHOUT ``on_preempt`` are not preemptible — the
  reference only preempts requests that supplied a preemption context.
- ``cancel_reservation`` releases a grant or withdraws a queued request
  (idempotent here: late cancels after a preemption are inert) and
  immediately re-runs the queues.
- ``set_max`` / ``update_priority`` re-evaluate grants live, the
  ``osd_max_backfills`` runtime-update path.

Callbacks fire synchronously from ``do_queues`` (the framework's
deterministic single-thread design stands in for the reference's
Finisher thread); re-entrant requests/cancels from inside a callback are
legal — the dispatch loop re-runs until the queues are stable.

The queues are bounded by construction: one entry per requesting item
(a PG / a stalled-op batch), and duplicates of a queued or granted item
are rejected — depth can never exceed the number of distinct PGs.

A copy of ``ceph_tpu.recovery.reserver``.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field


@dataclass
class _Reservation:
    item: object
    prio: int
    on_grant: object
    on_preempt: object = None
    seq: int = 0                 # FIFO age, ties preemption victims


@dataclass
class ReserverStats:
    """Lifetime accounting (the perf-counter surface the scheduler sums)."""
    grants: int = 0
    preemptions: int = 0
    cancels: int = 0
    peak_in_flight: int = 0
    peak_queued: int = 0


class AsyncReserver:
    """Prioritized FIFO reservation queues with bounded in-flight grants."""

    def __init__(self, name: str = "reserver", max_allowed: int = 1,
                 min_priority: int = 0):
        self.name = name
        self.max_allowed = max(0, int(max_allowed))
        self.min_priority = int(min_priority)
        # prio -> FIFO list of _Reservation (bounded: one per distinct item)
        self._queues: dict[int, list[_Reservation]] = {}
        self._queued: dict[object, _Reservation] = {}
        self._granted: dict[object, _Reservation] = {}
        self._seq = itertools.count()
        self.stats = ReserverStats()
        # re-entrancy: callbacks may request/cancel; the outer loop re-runs
        self._stepping = False
        self._dirty = False

    # -- public surface (AsyncReserver.h names) ----------------------------

    def request_reservation(self, item, on_grant, prio: int = 0,
                            on_preempt=None) -> None:
        if item in self._queued or item in self._granted:
            raise ValueError(f"{self.name}: duplicate reservation for "
                             f"{item!r}")
        res = _Reservation(item=item, prio=int(prio), on_grant=on_grant,
                           on_preempt=on_preempt, seq=next(self._seq))
        self._queues.setdefault(res.prio, []).append(res)
        self._queued[item] = res
        self.stats.peak_queued = max(self.stats.peak_queued,
                                     len(self._queued))
        self.do_queues()

    def update_priority(self, item, prio: int) -> None:
        """Re-rank a QUEUED request (a granted one keeps its slot — the
        reference requeues only waiting requests too)."""
        res = self._queued.get(item)
        if res is None or res.prio == prio:
            return
        self._queues[res.prio].remove(res)
        res.prio = int(prio)
        self._queues.setdefault(res.prio, []).append(res)
        self.do_queues()

    def cancel_reservation(self, item) -> bool:
        """Release a grant or withdraw a queued request; True if the item
        was known.  Idempotent: cancelling after a preemption already
        removed the grant is a no-op."""
        res = self._queued.pop(item, None)
        if res is not None:
            self._queues[res.prio].remove(res)
        else:
            res = self._granted.pop(item, None)
        if res is None:
            return False
        self.stats.cancels += 1
        self.do_queues()
        return True

    def set_max(self, max_allowed: int) -> None:
        self.max_allowed = max(0, int(max_allowed))
        self.do_queues()

    def has_reservation(self, item) -> bool:
        return item in self._granted

    def queue_depth(self) -> int:
        return len(self._queued)

    def in_flight(self) -> int:
        return len(self._granted)

    def dump(self) -> dict:
        return {
            "name": self.name,
            "max_allowed": self.max_allowed,
            "min_priority": self.min_priority,
            "queues": {prio: [repr(r.item) for r in q]
                       for prio, q in sorted(self._queues.items())
                       if q},
            "in_progress": {repr(r.item): r.prio
                            for r in self._granted.values()},
            "stats": vars(self.stats).copy(),
        }

    # -- the grant/preempt engine ------------------------------------------

    def do_queues(self) -> None:
        """Grant/preempt until stable.  Re-entrant calls (from grant or
        preempt callbacks) just mark the loop dirty; the outermost call
        keeps stepping until a full pass changes nothing."""
        if self._stepping:
            self._dirty = True
            return
        self._stepping = True
        try:
            while True:
                self._dirty = False
                fired = self._step()
                if not fired and not self._dirty:
                    break
        finally:
            self._stepping = False

    def _head_prio(self) -> int | None:
        best = None
        for prio, q in self._queues.items():
            if q and prio >= self.min_priority and \
                    (best is None or prio > best):
                best = prio
        return best

    def _step(self) -> bool:
        """One batch of state transitions; callbacks fire only after the
        structures are fully consistent (a grant callback observing the
        reserver must see itself granted)."""
        to_preempt: list[_Reservation] = []
        to_grant: list[_Reservation] = []
        while True:
            prio = self._head_prio()
            if prio is None:
                break
            if len(self._granted) < self.max_allowed:
                res = self._queues[prio].pop(0)
                del self._queued[res.item]
                self._granted[res.item] = res
                to_grant.append(res)
                continue
            # full: preempt the lowest-priority PREEMPTIBLE holder, but
            # only for a strictly higher-priority waiter (preempt_by)
            victims = [r for r in self._granted.values()
                       if r.on_preempt is not None]
            if not victims:
                break
            victim = min(victims, key=lambda r: (r.prio, -r.seq))
            if victim.prio >= prio:
                break
            del self._granted[victim.item]
            to_preempt.append(victim)
            res = self._queues[prio].pop(0)
            del self._queued[res.item]
            self._granted[res.item] = res
            to_grant.append(res)
        self.stats.peak_in_flight = max(self.stats.peak_in_flight,
                                        len(self._granted))
        for res in to_preempt:
            self.stats.preemptions += 1
            res.on_preempt()
        for res in to_grant:
            self.stats.grants += 1
            res.on_grant()
        return bool(to_preempt or to_grant)
