"""Op tracker: per-op event history + in-flight/slow-op dumps.

Mirror of the reference's OpTracker (reference: src/common/TrackedOp.{h,cc};
``op->mark_event`` timeline entries surfaced over the admin socket as
``dump_ops_in_flight`` / ``dump_historic_ops``; the FUNCTRACE/OID event
usage at src/osd/OSD.cc:9549-9578 is the same mechanism at the dispatch
points).  Slow-op handling follows the reference's complaint path
(``osd_op_complaint_time``, TrackedOp.cc check_ops_in_flight): an op whose
duration exceeds the configurable threshold is flagged ``slow``, counted on
the owning subsystem's ``slow_ops`` perf counter, and kept in the historic
dump with the flag set.  Every ``mark_event`` also lands on the process
span tracer as an instant event, and ``finish`` emits the whole op as a
complete span, so ``trace dump`` interleaves op timelines with the
codec/kernel spans they caused.
"""
from __future__ import annotations

import itertools
import threading
import time
import weakref
from collections import deque
from dataclasses import dataclass, field

from .tracer import default_tracer


@dataclass
class TrackedOp:
    tracker: "OpTracker"
    seq: int
    description: str
    initiated_at: float = field(default_factory=time.time)
    events: list[tuple[float, str]] = field(default_factory=list)
    slow: bool = False
    _done: bool = False

    def mark_event(self, event: str) -> None:
        self.events.append((time.time(), event))
        default_tracer().instant(f"op.{event}", cat="optracker",
                                 seq=self.seq, desc=self.description)

    def finish(self) -> None:
        if not self._done:
            self._done = True
            self.mark_event("done")
            self.tracker._finish(self)
            default_tracer().complete("op", self.initiated_at,
                                      self.duration, cat="optracker",
                                      seq=self.seq, desc=self.description,
                                      slow=self.slow)

    @property
    def age(self) -> float:
        return time.time() - self.initiated_at

    @property
    def duration(self) -> float:
        end = self.events[-1][0] if self._done and self.events \
            else time.time()
        return end - self.initiated_at

    def dump(self) -> dict:
        return {
            "description": self.description,
            "initiated_at": self.initiated_at,
            "age": self.age,
            "duration": self.duration,
            "slow": self.slow,
            "type_data": {
                "events": [{"time": t, "event": e} for t, e in self.events],
            },
        }

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finish()
        return False


class OpTracker:
    """In-flight registry + bounded history of completed/slow ops.

    ``conf`` (a ConfigProxy) supplies — and live-updates, via observer —
    the ``osd_op_complaint_time`` slow threshold; ``perf`` is the owning
    subsystem's PerfCounters, bumped on its ``slow_ops`` key when present.
    """

    def __init__(self, history_size: int = 20, history_duration: float = 600.0,
                 complaint_time: float = 30.0, conf=None, perf=None):
        self._inflight: dict[int, TrackedOp] = {}
        self._history: deque[TrackedOp] = deque(maxlen=history_size)
        self._slow: deque[TrackedOp] = deque(maxlen=history_size)
        self._seq = itertools.count(1)
        self._lock = threading.Lock()
        self.history_duration = history_duration
        self.complaint_time = complaint_time
        self.perf = perf
        if conf is not None and "osd_op_complaint_time" in conf.schema:
            self.complaint_time = float(conf.get("osd_op_complaint_time"))
            # WEAK observer: the ConfigProxy outlives trackers (one per
            # PG backend, many per long-lived Context) and has no
            # removal API — a strong closure would pin every dead
            # tracker + its op history forever
            ref = weakref.ref(self)

            def _obs(_name, v, _ref=ref):
                t = _ref()
                if t is not None:
                    t.complaint_time = float(v)
            conf.add_observer("osd_op_complaint_time", _obs)

    def create_request(self, description: str) -> TrackedOp:
        op = TrackedOp(self, next(self._seq), description)
        op.mark_event("initiated")
        with self._lock:
            self._inflight[op.seq] = op
        return op

    def _finish(self, op: TrackedOp) -> None:
        slow = op.duration >= self.complaint_time
        with self._lock:
            self._inflight.pop(op.seq, None)
            self._history.append(op)
            if slow:
                op.slow = True
                self._slow.append(op)
        if slow and self.perf is not None:
            try:
                self.perf.inc("slow_ops")
            except KeyError:
                pass                     # owner declared no slow_ops counter

    def get_age_histogram(self) -> dict[str, int]:
        with self._lock:
            ops = list(self._inflight.values())
        hist: dict[str, int] = {}
        for op in ops:
            bucket = "<1s" if op.age < 1 else \
                "<10s" if op.age < 10 else "<60s" if op.age < 60 else ">=60s"
            hist[bucket] = hist.get(bucket, 0) + 1
        return hist

    def dump_ops_in_flight(self) -> dict:
        with self._lock:
            ops = [op.dump() for op in self._inflight.values()]
        return {"ops": ops, "num_ops": len(ops)}

    def dump_historic_ops(self) -> dict:
        with self._lock:
            ops = [op.dump() for op in self._history]
        return {"ops": ops, "num_ops": len(ops)}

    def dump_historic_slow_ops(self) -> dict:
        with self._lock:
            ops = [op.dump() for op in self._slow]
        return {"ops": ops, "num_ops": len(ops)}
