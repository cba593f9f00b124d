"""Exponential backoff with full jitter — the reconnect/retry pacing.

The AWS-architecture "full jitter" schedule (also what the reference's
msgr reconnect ramp approximates): attempt ``n`` sleeps a uniform random
duration in ``[0, min(cap, base * 2**n)]``.  Full jitter beats equal or
decorrelated jitter for thundering-herd spread while keeping the bound
trivial to verify.

Every loop built on this class is bounded BY CONSTRUCTION: ``delays()``
yields at most ``max_attempts`` values and respects an optional wall
deadline.  The port's copy of ``ceph_tpu.failure.backoff``.
"""
from __future__ import annotations

import random
import time


class RetriesExhausted(ConnectionError):
    """The bounded retry budget (attempts or deadline) ran out."""


class ExponentialBackoff:
    """Bounded full-jitter backoff.

    ``base``/``cap`` are seconds; ``max_attempts`` bounds the schedule;
    ``deadline`` (monotonic timestamp) additionally cuts it short.
    ``rng``/``clock``/``sleep`` are injectable for deterministic tests.
    """

    def __init__(self, base: float = 0.05, cap: float = 2.0,
                 max_attempts: int = 8, deadline: float | None = None,
                 rng: random.Random | None = None, clock=time.monotonic,
                 sleep=time.sleep):
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got "
                             f"{max_attempts}")
        self.base = float(base)
        self.cap = float(cap)
        self.max_attempts = int(max_attempts)
        self.deadline = deadline
        self._rng = rng if rng is not None else random.Random()
        self._clock = clock
        self._sleep = sleep

    def delay(self, attempt: int) -> float:
        """The full-jitter draw for attempt ``attempt`` (0-based):
        uniform in [0, min(cap, base * 2**attempt)]."""
        ceiling = min(self.cap, self.base * (2.0 ** attempt))
        return self._rng.uniform(0.0, ceiling)

    def delays(self):
        """Yield (attempt index, slept seconds) up to the bound; sleeps
        BETWEEN attempts (no sleep before the first).  Stops early when
        the deadline would be crossed."""
        for attempt in range(self.max_attempts):
            if attempt:
                d = self.delay(attempt - 1)
                if self.deadline is not None:
                    remaining = self.deadline - self._clock()
                    if remaining <= 0:
                        return
                    d = min(d, remaining)
                self._sleep(d)
            else:
                d = 0.0
            if self.deadline is not None and \
                    self._clock() >= self.deadline and attempt:
                return
            yield attempt, d

    def run(self, fn, retry_on=(ConnectionError, OSError, TimeoutError)):
        """Call ``fn()`` under the schedule; returns its value.  Raises
        :class:`RetriesExhausted` (chaining the last failure) when the
        attempt/deadline budget runs out."""
        last: BaseException | None = None
        for attempt, _slept in self.delays():
            try:
                return fn()
            except retry_on as e:
                last = e
        raise RetriesExhausted(
            f"gave up after {self.max_attempts} attempts") from last
