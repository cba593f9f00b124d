"""Mark-down limiter: flap damping for OSD up/down transitions.

The reference's ``osd_markdown_log`` machinery (src/osd/OSD.cc
``handle_osd_map`` counts recent mark-downs against
``osd_max_markdown_count``/``osd_max_markdown_period`` and refuses to
rejoin): an OSD marked down too many times inside a sliding window is
FLAPPING — repeatedly bouncing between up and down churns peering,
client resends and recovery reservations far harder than staying down
would.  Once damped, boot attempts are refused until an operator clears
the record (``ceph osd clear-markdown`` analog), and the
``OSD_FLAPPING`` health check reports it.

Time is caller-provided (the monitor's virtual ``now``), so damping
timelines are deterministic in tests and the chaos harness.

The port's copy of ``ceph_tpu.failure.markdown``.
"""
from __future__ import annotations

from collections import deque


class MarkDownLimiter:
    """Sliding-window mark-down counter + damped set."""

    def __init__(self, count: int = 5, window: float = 600.0):
        self.count = max(1, int(count))
        self.window = float(window)
        # osd -> recent mark-down stamps (bounded: only the newest
        # ``count`` matter for the threshold)
        self._marks: dict[int, deque] = {}
        self._damped: set[int] = set()

    def _prune(self, osd: int, now: float) -> deque:
        q = self._marks.setdefault(osd, deque(maxlen=self.count))
        while q and now - q[0] > self.window:
            q.popleft()
        return q

    def record_down(self, osd: int, now: float) -> bool:
        """One mark-down at ``now``.  Returns True when this mark tripped
        the damping threshold (the caller logs the transition)."""
        q = self._prune(osd, now)
        q.append(now)
        if len(q) >= self.count and osd not in self._damped:
            self._damped.add(osd)
            return True
        return False

    def allow_up(self, osd: int) -> bool:
        """May this OSD be marked up?  False while damped — the flapping
        OSD stays down until :meth:`clear`."""
        return osd not in self._damped

    def clear(self, osd: int) -> bool:
        """Operator clear: forget the history, allow boots again."""
        self._marks.pop(osd, None)
        was = osd in self._damped
        self._damped.discard(osd)
        return was

    @property
    def damped(self) -> set[int]:
        return set(self._damped)

    def dump(self) -> dict[int, dict]:
        return {osd: {"marks": len(q), "damped": osd in self._damped}
                for osd, q in sorted(self._marks.items()) if q
                or osd in self._damped}
