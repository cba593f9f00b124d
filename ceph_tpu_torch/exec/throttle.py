"""Admission throttles: bounded counting semaphores over bytes/ops.

Analog of the reference's ``Throttle`` (reference: src/common/Throttle.{h,cc}
— ``_wait`` FIFO condition queue :93-133, ``get``/``get_or_fail``/``put``
:134-221, per-throttle PerfCounters l_throttle_* :40-77).  Semantics
mirrored:

- ``get(c)`` blocks until ``count + c <= max`` **in FIFO order** (a large
  request cannot be starved by a stream of small ones slipping past it —
  the reference queues per-waiter condition variables for exactly this);
- ``get_or_fail(c)`` never blocks: False (and a perf tick) when the take
  would overshoot, also refusing while earlier waiters queue (fairness);
- ``put(c)`` releases and wakes the head waiter;
- a request larger than ``max`` itself is accepted once the throttle is
  EMPTY (the reference admits oversized singletons rather than deadlock).

The serving engine stacks two of these — bytes and op count — in front of
its admission queue; either limit hitting is backpressure (block or
fail-fast, option-controlled).

A copy of ``ceph_tpu.exec.throttle``: the port keeps its own copy, so it
needs nothing of the JAX package.
"""
from __future__ import annotations

import itertools
import threading
import time as _time

from ..common.perf_counters import PerfCountersBuilder


class ThrottleFull(IOError):
    """Fail-fast admission refusal: the throttle is at its limit."""

    def __init__(self, name: str, want: int, count: int, maximum: int):
        super().__init__(
            f"throttle {name!r} full: want {want}, {count}/{maximum} in use")
        self.throttle = name
        self.want = want
        self.count = count
        self.max = maximum


def _build_perf(name: str):
    return (PerfCountersBuilder(name)
            .add_u64("val", "currently taken units")
            .add_u64("max", "configured limit")
            .add_u64_counter("get", "successful blocking takes")
            .add_u64_counter("get_sum", "units taken by blocking takes")
            .add_u64_counter("get_or_fail_success",
                             "non-blocking takes that fit")
            .add_u64_counter("get_or_fail_fail",
                             "non-blocking takes refused (backpressure)")
            .add_u64_counter("put", "releases")
            .add_u64_counter("put_sum", "units released")
            .add_time_avg("wait", "blocking-take wait time")
            .create_perf_counters())


class Throttle:
    """FIFO bounded semaphore (src/common/Throttle.cc shape)."""

    def __init__(self, name: str, maximum: int, cct=None):
        if maximum <= 0:
            raise ValueError(f"throttle {name!r}: max must be > 0")
        self.name = name
        self._max = int(maximum)
        self._count = 0
        self._lock = threading.Lock()
        # FIFO waiters: ticket -> Condition; the head ticket is the only
        # one allowed to take (Throttle.cc queues cond-per-waiter)
        self._waiters: dict[int, threading.Condition] = {}
        self._tickets = itertools.count()
        self.perf = _build_perf(f"throttle.{name}")
        self.perf.set("max", self._max)
        if cct is not None:
            cct.perf.add(self.perf)

    # -- introspection -------------------------------------------------------

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def max(self) -> int:
        with self._lock:
            return self._max

    def set_max(self, maximum: int) -> None:
        with self._lock:
            self._max = int(maximum)
            self.perf.set("max", self._max)
            self._wake_head_locked()

    def waiters(self) -> int:
        with self._lock:
            return len(self._waiters)

    def _fits_locked(self, c: int) -> bool:
        # oversized singleton: admitted when empty (Throttle.cc:103-108
        # comment — blocking forever would deadlock the caller)
        if c > self._max:
            return self._count == 0
        return self._count + c <= self._max

    def _wake_head_locked(self) -> None:
        if self._waiters:
            head = next(iter(self._waiters))
            self._waiters[head].notify()

    # -- take / release ------------------------------------------------------

    def get(self, c: int = 1, timeout: float | None = None) -> bool:
        """Blocking take; returns True (or False on timeout, nothing
        taken).  FIFO: joins the waiter queue if anyone is ahead."""
        assert c >= 0
        with self._lock:
            if not self._waiters and self._fits_locked(c):
                self._count += c
                self.perf.set("val", self._count)
                self.perf.inc("get")
                self.perf.inc("get_sum", c)
                return True
            ticket = next(self._tickets)
            cond = threading.Condition(self._lock)
            self._waiters[ticket] = cond
            deadline = None if timeout is None else \
                threading.TIMEOUT_MAX if timeout < 0 else timeout
            t_end = None if deadline is None else \
                _time.monotonic() + deadline
            with self.perf.time("wait"):
                while True:
                    is_head = next(iter(self._waiters)) == ticket
                    if is_head and self._fits_locked(c):
                        break
                    left = None if t_end is None else \
                        t_end - _time.monotonic()
                    if left is not None and left <= 0 or \
                            not cond.wait(left):
                        del self._waiters[ticket]
                        self._wake_head_locked()
                        return False
            del self._waiters[ticket]
            self._count += c
            self.perf.set("val", self._count)
            self.perf.inc("get")
            self.perf.inc("get_sum", c)
            # the new head may also fit (e.g. after set_max growth)
            self._wake_head_locked()
            return True

    def get_or_fail(self, c: int = 1) -> bool:
        """Non-blocking take; False = backpressure (counted)."""
        assert c >= 0
        with self._lock:
            if self._waiters or not self._fits_locked(c):
                self.perf.inc("get_or_fail_fail")
                return False
            self._count += c
            self.perf.set("val", self._count)
            self.perf.inc("get_or_fail_success")
            return True

    def take(self, c: int = 1) -> int:
        """Unconditional take (the reference's ``take``: callers that
        already own the resource, e.g. requeues).  May overshoot max."""
        with self._lock:
            self._count += c
            self.perf.set("val", self._count)
            return self._count

    def put(self, c: int = 1) -> int:
        with self._lock:
            assert self._count >= c, \
                f"throttle {self.name!r}: put {c} > count {self._count}"
            self._count -= c
            self.perf.set("val", self._count)
            self.perf.inc("put")
            self.perf.inc("put_sum", c)
            self._wake_head_locked()
            return self._count
