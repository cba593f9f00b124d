"""Overload shedding by dmClock op class.

When the event loop's ingest outruns dispatch admission, SOMETHING must
absorb the excess; an unbounded queue just converts overload into
latency for everyone.  The shedding ladder refuses work instead, lowest
QoS class first (the reference's mClock never starves client ops to
feed scrub; this is the admission-side complement): each class may
occupy the dispatch queue only up to its fraction of the configured
limit, so background classes start bouncing while client ops still
have headroom, and client ops themselves bounce only at the hard
limit.

A shed is an explicit, cheap refusal — the caller gets ``EBUSY``
immediately (no queue time burned) and may back off and retry; counters
record sheds per class so the bench can report shed-rate under
overload.
"""
from __future__ import annotations

import errno
import threading

from ..osd.mclock import (BG_RECOVERY, BG_SCRUB, BG_SNAPTRIM, CLIENT_OP,
                          OSD_SUBOP)

# fraction of the dispatch-queue limit each class may fill before its
# arrivals shed: background work yields headroom to client ops long
# before the hard limit (CLIENT_OP sheds only when the queue is FULL)
DEFAULT_SHED_FRACTIONS = {
    BG_SCRUB: 0.50,
    BG_SNAPTRIM: 0.60,
    BG_RECOVERY: 0.70,
    OSD_SUBOP: 0.85,
    CLIENT_OP: 1.00,
}

EBUSY = getattr(errno, "EBUSY", 16)


class ShedPolicy:
    """Class-fraction shedding ladder over one queue-depth limit."""

    def __init__(self, limit: int, fractions: dict | None = None):
        if limit <= 0:
            raise ValueError("shed limit must be > 0")
        self.limit = int(limit)
        self.fractions = dict(DEFAULT_SHED_FRACTIONS)
        if fractions:
            self.fractions.update(fractions)
        self._lock = threading.Lock()
        self.shed_counts: dict[str, int] = {}
        self.admitted = 0

    def threshold(self, op_class: str) -> int:
        frac = self.fractions.get(op_class, 1.0)
        return max(1, int(self.limit * frac))

    def should_shed(self, op_class: str, depth: int, n: int = 1) -> bool:
        """Decide for one arrival of ``n`` logical ops (a mux batch
        frame sheds or admits as a unit) given the current queue depth
        IN OPS; the verdict is recorded per op in the counters."""
        if depth < self.threshold(op_class):
            with self._lock:
                self.admitted += n
            return False
        with self._lock:
            self.shed_counts[op_class] = \
                self.shed_counts.get(op_class, 0) + n
        return True

    @property
    def shed_total(self) -> int:
        with self._lock:
            return sum(self.shed_counts.values())

    def shed_rate(self) -> float:
        """Sheds as a fraction of all arrivals seen so far."""
        with self._lock:
            shed = sum(self.shed_counts.values())
            total = shed + self.admitted
        return shed / total if total else 0.0

    def snapshot(self) -> dict:
        with self._lock:
            return {"limit": self.limit,
                    "admitted": self.admitted,
                    "shed": dict(self.shed_counts),
                    "shed_total": sum(self.shed_counts.values())}
