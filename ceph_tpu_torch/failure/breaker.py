"""Circuit breaker: N consecutive failures -> open -> half-open probes.

The device-path guard the codec pipeline wires in: when the device side
fails ``threshold`` times IN A ROW, the breaker opens and submitters stop
dialing the device: the pipeline fails their batches at once with
:class:`BreakerOpen` instead of hammering a wedged card.  After
``cooldown`` seconds the next submit is let through as a HALF-OPEN probe:
success re-closes, failure re-opens for another cooldown.  Any device
success (probe or not) re-closes and zeroes the consecutive count.

Breakers self-register in a process-wide weak set (the
``live_daemons``/``live_engines`` pattern) so a health check can report
every non-closed breaker without threading references around.

From ``ceph_tpu.failure.breaker``, less its host-fallback count: in the
port an open breaker fails fast, and nothing is served on the host.  The
port keeps its own copy, so it needs nothing of the JAX package.
"""
from __future__ import annotations

import threading
import time
import weakref

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

_STATE_RANK = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}

_BREAKERS: "weakref.WeakSet[CircuitBreaker]" = weakref.WeakSet()


class BreakerOpen(RuntimeError):
    """A submit refused because the device path's breaker is open."""


def live_breakers() -> list["CircuitBreaker"]:
    return sorted(_BREAKERS, key=lambda b: b.name)


def state_rank(state: str) -> int:
    """Numeric severity for gauges: closed=0, half_open=1, open=2."""
    return _STATE_RANK[state]


class CircuitBreaker:
    """Consecutive-failure breaker with half-open probing.

    ``threshold`` consecutive failures open it; ``cooldown`` seconds
    later :meth:`allow` admits ONE probe (half-open); the probe's
    outcome closes or re-opens.  ``clock`` is injectable so tests drive
    the cooldown deterministically.  ``on_transition(breaker, old, new)``
    fires outside the lock on every state change.
    """

    def __init__(self, name: str, threshold: int = 3,
                 cooldown: float = 5.0, clock=time.monotonic,
                 on_transition=None):
        self.name = name
        self.threshold = max(1, int(threshold))
        self.cooldown = float(cooldown)
        self._clock = clock
        self.on_transition = on_transition
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        self.opens = 0          # cumulative open transitions
        self.probes = 0         # half-open probes admitted
        _BREAKERS.add(self)

    # -- state -------------------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def consecutive_failures(self) -> int:
        with self._lock:
            return self._consecutive

    def _transition(self, new: str) -> None:
        # caller holds the lock; returns with it held
        old, self._state = self._state, new
        if old != new and self.on_transition is not None:
            cb, args = self.on_transition, (self, old, new)
            self._lock.release()
            try:
                cb(*args)
            finally:
                self._lock.acquire()

    # -- the gate ----------------------------------------------------------

    def allow(self) -> bool:
        """May this submission use the device path?  CLOSED: yes.
        OPEN: no — unless the cooldown elapsed, in which case this call
        CLAIMS the half-open probe slot (True) and subsequent calls get
        False until the probe's outcome lands."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN and \
                    self._clock() - self._opened_at >= self.cooldown:
                self._transition(HALF_OPEN)
                self.probes += 1
                return True
            return False

    # -- outcomes ----------------------------------------------------------

    def record_success(self) -> None:
        with self._lock:
            self._consecutive = 0
            if self._state != CLOSED:
                self._transition(CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self._consecutive += 1
            if self._state == HALF_OPEN or (
                    self._state == CLOSED and
                    self._consecutive >= self.threshold):
                self._opened_at = self._clock()
                self.opens += 1
                self._transition(OPEN)
            elif self._state == OPEN:
                # a batch dispatched before the breaker opened failed:
                # push the cooldown window out from this latest evidence
                self._opened_at = self._clock()

    # -- lifecycle / observability ----------------------------------------

    def close(self) -> None:
        """Drop out of the live registry (pipeline teardown): a discarded
        breaker must not keep raising DEVICE_DEGRADED."""
        _BREAKERS.discard(self)

    def reopen(self) -> None:
        """Rejoin the live registry (pipeline reopen after an engine
        restart) — a living breaker must be visible to DEVICE_DEGRADED."""
        _BREAKERS.add(self)

    def dump(self) -> dict:
        with self._lock:
            return {"name": self.name, "state": self._state,
                    "consecutive_failures": self._consecutive,
                    "threshold": self.threshold,
                    "cooldown": self.cooldown, "opens": self.opens,
                    "probes": self.probes}
