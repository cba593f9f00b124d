"""Reactor: a readiness-driven event loop over ``selectors``.

The AsyncMessenger core (reference: src/msg/async/EventEpoll.cc,
AsyncMessenger's worker loop in src/msg/async/Stack.h): ONE thread
multiplexes every registered connection through a level-triggered
selector, so concurrency is bounded by file descriptors — not OS
threads.  Handlers are plain objects exposing readiness callbacks:

- ``on_readable()``  — the fd has bytes (or EOF) to consume;
- ``on_writable()``  — the fd can absorb queued bytes;
- ``wants_write()``  — whether EVENT_WRITE interest should be armed;
- ``on_io_error(e)`` — a callback raised; the reactor quarantines the
  handler (unregisters it) instead of dying.

Cross-thread work enters through :meth:`call_soon` (a self-pipe wakes
the selector, the reference's EventCenter::wakeup) and timed work
through :meth:`call_later` (a heap of monotonic deadlines, the
EventCenter time-event list).  Everything else — parsing, dispatch,
backpressure — lives in the handlers; the loop only moves readiness.
"""
from __future__ import annotations

import heapq
import itertools
import os
import selectors
import threading
import time


class Timer:
    """A cancellable :meth:`Reactor.call_later` handle."""

    __slots__ = ("when", "fn", "cancelled")

    def __init__(self, when: float, fn):
        self.when = when
        self.fn = fn
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True


class Reactor:
    """One event-loop thread over a ``selectors.DefaultSelector``."""

    def __init__(self, name: str = "msgr"):
        self.name = name
        self._sel = selectors.DefaultSelector()
        self._lock = threading.Lock()
        self._soon: list = []
        self._timers: list = []                  # heap of (when, seq, Timer)
        self._seq = itertools.count()
        self._stop = threading.Event()
        self._started = threading.Event()
        self._thread: threading.Thread | None = None
        # self-pipe: call_soon from another thread interrupts select()
        self._wake_r, self._wake_w = os.pipe()
        os.set_blocking(self._wake_r, False)
        os.set_blocking(self._wake_w, False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, None)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "Reactor":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name=f"reactor.{self.name}", daemon=True)
            self._thread.start()
            self._started.wait(5.0)
        return self

    def stop(self, join: bool = True) -> None:
        self._stop.set()
        self._wakeup()
        t = self._thread
        if join and t is not None and t is not threading.current_thread():
            t.join(5.0)

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive() and not self._stop.is_set()

    def in_reactor(self) -> bool:
        return threading.current_thread() is self._thread

    # -- registration (reactor-thread-affine; routed via call_soon) ----------

    def register(self, sock, handler) -> None:
        """Arm readiness callbacks for ``sock``.  Safe from any thread:
        off-loop callers are trampolined through :meth:`call_soon` so the
        selector is only mutated on the loop."""
        if self.in_reactor() or not self.running:
            self._register(sock, handler)
        else:
            self.call_soon(lambda: self._register(sock, handler))

    def _register(self, sock, handler) -> None:
        mask = selectors.EVENT_READ
        if handler.wants_write():
            mask |= selectors.EVENT_WRITE
        try:
            self._sel.register(sock, mask, handler)
        except KeyError:                  # re-register = interest update
            self._sel.modify(sock, mask, handler)

    def unregister(self, sock) -> None:
        if self.in_reactor() or not self.running:
            self._unregister(sock)
        else:
            self.call_soon(lambda: self._unregister(sock))

    def _unregister(self, sock) -> None:
        try:
            self._sel.unregister(sock)
        except (KeyError, ValueError, OSError):
            pass

    def update_interest(self, sock, handler) -> None:
        """Re-derive the EVENT_WRITE mask from ``handler.wants_write()``
        (called after a send queues bytes or a flush drains them)."""
        if self.in_reactor() or not self.running:
            self._update(sock, handler)
        else:
            self.call_soon(lambda: self._update(sock, handler))

    def _update(self, sock, handler) -> None:
        mask = selectors.EVENT_READ
        if handler.wants_write():
            mask |= selectors.EVENT_WRITE
        try:
            self._sel.modify(sock, mask, handler)
        except (KeyError, ValueError, OSError):
            pass

    # -- cross-thread entry points -------------------------------------------

    def call_soon(self, fn) -> None:
        with self._lock:
            self._soon.append(fn)
        self._wakeup()

    def call_later(self, delay: float, fn) -> Timer:
        t = Timer(time.monotonic() + max(0.0, delay), fn)
        with self._lock:
            heapq.heappush(self._timers, (t.when, next(self._seq), t))
        self._wakeup()
        return t

    def _wakeup(self) -> None:
        try:
            os.write(self._wake_w, b"x")
        except (BlockingIOError, OSError):
            pass                          # pipe full = wakeup already queued

    # -- the loop ------------------------------------------------------------

    def _poll_timeout(self) -> float | None:
        with self._lock:
            if self._soon:
                return 0.0
            while self._timers and self._timers[0][2].cancelled:
                heapq.heappop(self._timers)
            if not self._timers:
                return None
            return max(0.0, self._timers[0][0] - time.monotonic())

    def _run(self) -> None:
        self._started.set()
        while not self._stop.is_set():
            try:
                events = self._sel.select(self._poll_timeout())
            except OSError:
                continue                  # an fd closed under select()
            for key, mask in events:
                if key.data is None:      # the wake pipe
                    try:
                        while os.read(self._wake_r, 4096):
                            pass
                    except (BlockingIOError, OSError):
                        pass
                    continue
                handler = key.data
                try:
                    if mask & selectors.EVENT_READ:
                        handler.on_readable()
                    if mask & selectors.EVENT_WRITE:
                        handler.on_writable()
                except Exception as e:     # noqa: BLE001 — loop must live
                    self._unregister(key.fileobj)
                    try:
                        handler.on_io_error(e)
                    except Exception:      # noqa: BLE001
                        pass
            self._run_ready()
        self._drain_on_stop()

    def _run_ready(self) -> None:
        now = time.monotonic()
        due, soon = [], []
        with self._lock:
            while self._timers and self._timers[0][0] <= now:
                _, _, t = heapq.heappop(self._timers)
                if not t.cancelled:
                    due.append(t)
            soon, self._soon = self._soon, []
        for t in due:
            try:
                t.fn()
            except Exception:              # noqa: BLE001 — loop must live
                pass
        for fn in soon:
            try:
                fn()
            except Exception:              # noqa: BLE001
                pass

    def _drain_on_stop(self) -> None:
        """Final sweep so close callbacks queued behind stop() still run."""
        self._run_ready()
        try:
            self._sel.close()
        except OSError:
            pass
        for fd in (self._wake_r, self._wake_w):
            try:
                os.close(fd)
            except OSError:
                pass


# -- shared client reactor ---------------------------------------------------
#
# Client handles (TcpRados, MuxClient) share ONE process-wide reactor:
# a process holding N client connections costs one loop thread, not N
# reader threads (the bounded-thread contract tests pin).

_client_reactor: Reactor | None = None
_client_reactor_lock = threading.Lock()


def client_reactor() -> Reactor:
    global _client_reactor
    with _client_reactor_lock:
        if _client_reactor is None or not _client_reactor.running:
            _client_reactor = Reactor(name="client").start()
        return _client_reactor
