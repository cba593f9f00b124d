"""AsyncConnection: one non-blocking framed socket on a reactor.

The per-connection half of the async messenger (reference:
src/msg/async/AsyncConnection.cc): the reactor delivers readiness, this
object turns it into frames —

- **receive**: ``on_readable`` drains the socket into the zero-copy
  :class:`~ceph_tpu_torch.msg.parser.StreamParser`; each decoded message is
  handed to ``on_message(conn, msg)`` ON the reactor thread (keep those
  callbacks non-blocking: correlation-table pokes, queue enqueues);
- **send**: any thread may :meth:`send`; the encoded frame enters a
  bounded write queue whose byte budget is an ``exec/throttle.Throttle``
  — a slow or dead peer therefore backpressures senders through the
  SAME admission primitive the serving engine throttles with, instead
  of buffering without bound.  ``on_writable`` flushes queued
  memoryviews with partial-send slicing and releases throttle budget as
  bytes reach the kernel;
- **faults**: the ``faults`` zero-arg provider mirrors ``net.Channel``
  exactly (armed post-auth by the server; delay/truncate/reset on send
  consult the same seeded streams), so chaos campaigns see identical
  semantics on the async stack.

Sends from the reactor thread itself (handshake replies, shed
refusals) use :meth:`send_from_reactor`: unthrottled and fault-exempt,
because the loop must never block on its own write budget.
"""
from __future__ import annotations

import socket
import threading

from ..backend.wire import WireError, frame_encode  # noqa: F401
from ..common import wire_accounting
from ..exec.throttle import Throttle
from .parser import StreamParser

RECV_SIZE = 256 * 1024
DEFAULT_WRITE_QUEUE_BYTES = 4 << 20
SEND_TIMEOUT = 5.0

# vectored drain: gather up to this many queue entries / bytes into one
# sendmsg(2) — a sideband frame is several unjoined views (head, payload
# splices, tail), and per-entry send() would pay one syscall per view
_SENDMSG_MAX_BUFS = 64
_SENDMSG_MAX_BYTES = 1 << 20
_HAS_SENDMSG = hasattr(socket.socket, "sendmsg")


class AsyncConnection:
    """One framed, reactor-driven socket endpoint (Channel's async twin:
    same ``stats``/``acct``/``faults``/``secret`` surface)."""

    def __init__(self, sock: socket.socket, reactor, *,
                 secret: bytes | None = None, expect_banner: bool = False,
                 name: str = "conn", on_message=None, on_closed=None,
                 write_queue_bytes: int = DEFAULT_WRITE_QUEUE_BYTES,
                 send_banner: bool = False, register: bool = True,
                 staging=None):
        self.sock = sock
        self.reactor = reactor
        self.name = name
        self.secret = secret
        # sideband landing policy (net._decode): a msg/staging pool on
        # server connections (handlers get pooled views), None on
        # client/handshake connections (completions get owned bytes)
        self.staging = staging
        self.parser = StreamParser(secret, expect_banner=expect_banner)
        self.on_message = on_message
        self.on_closed = on_closed
        self.stats = {"tx_msgs": 0, "tx_bytes": 0,
                      "rx_msgs": 0, "rx_bytes": 0}
        self.acct = None
        self.faults = None
        self._wlock = threading.Lock()
        self._wq: list = []              # [[memoryview, throttled_left]]
        self._close_after_flush = False
        self._closed = False
        self._close_exc: BaseException | None = None
        self.wthrottle = Throttle(f"msgr.wq.{name}",
                                  int(write_queue_bytes))
        sock.setblocking(False)
        if send_banner:
            from ..backend.wire import BANNER
            self._enqueue_locked_entry(memoryview(BANNER), 0)
        if register:
            reactor.register(sock, self)

    # -- protocol state ------------------------------------------------------

    def secure(self, key: bytes) -> None:
        """Post-auth switch to HMAC frames, both directions."""
        self.secret = key
        self.parser.set_secret(key)

    @property
    def closed(self) -> bool:
        return self._closed

    # -- send path -----------------------------------------------------------

    def _encode(self, msg) -> bytes:
        from .. import net
        return net._encode(msg, self.secret)

    def _encode_parts(self, msg):
        from .. import net
        return net._encode_parts(msg, self.secret)

    def _send_parts(self, msg, parts: list, timeout: float) -> None:
        """Enqueue one frame as multiple write-queue entries (payload
        views unjoined).  Entries land atomically under _wlock, so
        concurrent senders cannot interleave mid-frame; each entry
        carries its own byte count as throttle budget, so partial-send
        release and close-time accounting stay exact per entry."""
        total = sum(len(p) for p in parts)
        if not self.wthrottle.get(total, timeout=timeout):
            self.close(ConnectionError(
                f"{self.name}: write backpressure timeout"))
            raise ConnectionError(f"{self.name}: write queue full")
        if self._closed:
            self.wthrottle.put(total)
            raise ConnectionError(f"{self.name}: connection closed")
        with self._wlock:
            self._stats_tx(total)
            for p in parts:
                self._enqueue_locked_entry(
                    p if isinstance(p, memoryview) else memoryview(p),
                    len(p))
        self._account_tx(msg, total)
        self.reactor.update_interest(self.sock, self)

    def _stats_tx(self, nbytes: int) -> None:
        # plain-dict read-modify-write: callers hold _wlock (pairs with
        # the rx bumps in on_readable)
        self.stats["tx_msgs"] += 1
        self.stats["tx_bytes"] += nbytes

    def _account_tx(self, msg, nbytes: int) -> None:
        # the accountant path runs OUTSIDE _wlock: perf-counter updates
        # need no caller lock (sharded cells), and instrument work under
        # the write lock is the contention class ceph-lint's
        # instrument-under-lock rule exists to keep out
        if self.acct is not None:
            ctx = getattr(msg, "trace", None)
            if ctx is None and type(msg).__name__ in (
                    "RpcBatch", "RpcResultBatch"):
                from .proto import batch_trace_ctx
                ctx = batch_trace_ctx(msg)
            if ctx is None:
                from ..common.tracer import default_tracer
                ctx = default_tracer().current_ctx()
            self.acct.account_msg(msg, nbytes=nbytes, ctx=ctx)

    def send(self, msg, timeout: float = SEND_TIMEOUT) -> None:
        """Thread-safe framed send with write-queue backpressure.  May
        block up to ``timeout`` for throttle budget; raises
        ConnectionError on a closed link, an injected transport fault,
        or exhausted backpressure budget (peer stopped reading)."""
        if self._closed:
            raise ConnectionError(f"{self.name}: connection closed")
        hooks = self.faults() if self.faults is not None else None
        if hooks is None:
            # zero-copy fast path: payload-bearing frames splice their
            # payload views into the write queue unjoined.  Fault
            # campaigns (hooks armed) keep the single-buffer frame so
            # truncate/reset see one contiguous image.
            parts = self._encode_parts(msg)
            if parts is not None:
                self._send_parts(msg, parts, timeout)
                return
        data = self._encode(msg)
        action = "ok"
        if hooks is not None:
            action = hooks.on_send(type(msg).__name__, len(data),
                                   target=type(msg).__name__)
        if not self.wthrottle.get(len(data), timeout=timeout):
            # the peer stopped draining for a whole budget window: the
            # link is as good as dead — close so readers learn too
            self.close(ConnectionError(
                f"{self.name}: write backpressure timeout"))
            raise ConnectionError(f"{self.name}: write queue full")
        if self._closed:
            self.wthrottle.put(len(data))
            raise ConnectionError(f"{self.name}: connection closed")
        from ..failure.transport import SEND_TRUNCATE
        if action == "ok":
            with self._wlock:
                self._stats_tx(len(data))
                self._enqueue_locked_entry(memoryview(data), len(data))
            self._account_tx(msg, len(data))
            self.reactor.update_interest(self.sock, self)
            return
        # injected transport failure: partial frame (truncate) or
        # nothing, then an abrupt close — the peer must reconnect+resend
        self.wthrottle.put(len(data))
        if action == SEND_TRUNCATE:
            half = data[:max(1, len(data) // 2)]
            with self._wlock:
                self._stats_tx(len(data))
                self._enqueue_locked_entry(memoryview(half), 0)
                self._close_after_flush = True
            self._account_tx(msg, len(data))
            self.reactor.update_interest(self.sock, self)
        else:
            self.close(ConnectionError("injected connection reset"))
        raise ConnectionError(f"injected connection {action}")

    def send_from_reactor(self, msg) -> None:
        """Unthrottled, fault-exempt enqueue for the reactor's own frames
        (handshake steps, shed refusals): the loop must never block on
        its own write budget, and a reconnecting peer's handshake is
        never faulted."""
        if self._closed:
            raise ConnectionError(f"{self.name}: connection closed")
        data = self._encode(msg)
        with self._wlock:
            self._stats_tx(len(data))
            self._enqueue_locked_entry(memoryview(data), 0)
        self._account_tx(msg, len(data))
        self.reactor.update_interest(self.sock, self)

    def _enqueue_locked_entry(self, mv: memoryview, throttled: int) -> None:
        self._wq.append([mv, throttled])

    def wants_write(self) -> bool:
        return bool(self._wq)

    # -- readiness callbacks (reactor thread) --------------------------------

    def on_readable(self) -> None:
        try:
            data = self.sock.recv(RECV_SIZE)
        except (BlockingIOError, InterruptedError):
            return
        except OSError as e:
            self.close(ConnectionError(f"recv failed: {e}"))
            return
        if not data:
            self.close(ConnectionError("peer closed"))
            return
        try:
            frames = self.parser.feed(data)
        except WireError as e:
            self.close(e)
            return
        sizes = self.parser.frame_sizes
        self.parser.frame_sizes = []
        for i, (tag, segs) in enumerate(frames):
            try:
                msg = self._decode(tag, segs)
            except WireError as e:
                self.close(e)
                return
            nbytes = sizes[i] if i < len(sizes) else \
                sum(len(s) for s in segs) + wire_accounting.MSG_OVERHEAD
            # tx bumps run under _wlock on sender threads; take it here
            # too so the read-modify-write pairs can't lose updates
            with self._wlock:
                self.stats["rx_msgs"] += 1
                self.stats["rx_bytes"] += nbytes
            if self.acct is not None:
                self.acct.account_rx(type(msg).__name__, nbytes,
                                     ctx=getattr(msg, "trace", None))
            if self.on_message is not None:
                self.on_message(self, msg)
            if self._closed:
                return

    def _decode(self, tag, segs):
        from .. import net
        return net._decode(tag, segs, authed=self.secret is not None,
                           staging=self.staging)

    def on_writable(self) -> None:
        released = 0
        err: BaseException | None = None
        with self._wlock:
            while self._wq:
                if _HAS_SENDMSG:
                    bufs, cap = [], 0
                    for e in self._wq:
                        bufs.append(e[0])
                        cap += len(e[0])
                        if len(bufs) >= _SENDMSG_MAX_BUFS or \
                                cap >= _SENDMSG_MAX_BYTES:
                            break
                    send = lambda: self.sock.sendmsg(bufs)  # noqa: E731
                else:
                    cap = len(self._wq[0][0])
                    send = lambda: self.sock.send(self._wq[0][0])  # noqa: E731
                try:
                    n = send()
                except (BlockingIOError, InterruptedError):
                    break
                except OSError as e:
                    err = ConnectionError(f"send failed: {e}")
                    break
                full = n >= cap
                # walk the sent count across entries (a gathered send
                # can complete several and split the last)
                while self._wq:
                    mv, throttled = self._wq[0]
                    take = min(n, len(mv))
                    if throttled:
                        rel = min(take, throttled)
                        self._wq[0][1] -= rel
                        released += rel
                    if take == len(mv):
                        self._wq.pop(0)
                    else:
                        self._wq[0][0] = mv[take:]
                    n -= take
                    if n <= 0:
                        break
                if not full:
                    break
            drained = not self._wq
        if released:
            self.wthrottle.put(released)
        if err is not None:
            self.close(err)
            return
        if drained:
            self.reactor.update_interest(self.sock, self)
            if self._close_after_flush:
                self.close(ConnectionError("injected connection truncate"))

    def on_io_error(self, exc: BaseException) -> None:
        self.close(exc if isinstance(exc, (ConnectionError, WireError))
                   else ConnectionError(f"io error: {exc!r}"))

    # -- teardown ------------------------------------------------------------

    def close(self, exc: BaseException | None = None) -> None:
        """Idempotent, any-thread teardown: shut the socket down NOW (the
        peer sees EOF immediately), release queued write budget, then
        let the reactor drop its registration."""
        with self._wlock:
            if self._closed:
                return
            self._closed = True
            self._close_exc = exc
            held = sum(t for _, t in self._wq)
            self._wq.clear()
        if held:
            self.wthrottle.put(held)
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        if self.reactor.running and not self.reactor.in_reactor():
            self.reactor.call_soon(self._finish_close)
        else:
            self._finish_close()
        cb, self.on_closed = self.on_closed, None
        if cb is not None:
            cb(self, exc)

    def _finish_close(self) -> None:
        self.reactor.unregister(self.sock)
        try:
            self.sock.close()
        except OSError:
            pass
