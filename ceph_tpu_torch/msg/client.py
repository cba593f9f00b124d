"""MuxClient: many logical sessions multiplexed over few connections.

``net.TcpRados`` is one-session-per-connection: a reader thread, a
correlation table, and a socket per client object.  That shape cannot
express 10k concurrent closed-loop clients — 10k sockets, 10k reader
threads.  MuxClient inverts it (reference analog: librados clients
sharing an AsyncMessenger worker pool):

- a :class:`MuxSession` is a LOGICAL client: a reqid namespace
  (``session`` uuid) and nothing else — thousands are cheap;
- all sessions' calls funnel through one submission queue, coalesce
  into :class:`~ceph_tpu_torch.msg.proto.RpcBatch` frames (one pickle, one
  MAC, one syscall per admission window) and spread round-robin over a
  small fixed set of :class:`AsyncConnection`\\ s on the shared client
  reactor;
- replies correlate by globally-unique rid on the reactor thread;
  completion either sets the caller's event (sync :meth:`MuxSession.call`)
  or fires the ``cb`` (closed-loop async callers);
- per-attempt timers (reactor ``call_later``) resend black-holed calls
  within the same ``ms_rpc_timeout`` deadline budget as TcpRados, and
  reqid-dedup on the server keeps those resends exactly-once;
- a dead connection is re-dialed by the single sender thread under
  bounded full-jitter backoff (``ms_reconnect_*``); in-flight calls
  ride their timers onto the fresh socket.

The blocking dial + cephx handshake lives in ``net.py``
(``net.dial_and_handshake``) — inside ``ceph_tpu_torch/msg/`` sockets are
only ever touched from readiness callbacks (tests/test_torch_no_blocking_socket
pins that), so the one legitimately-blocking step stays outside.
"""
from __future__ import annotations

import pickle
import threading
import time
import uuid

from ..common import copy_ledger, instruments
from ..osd.mclock import CLIENT_OP
from .connection import AsyncConnection
from .proto import RpcBatch
from .reactor import client_reactor
from .shed import EBUSY


class MuxCall:
    """One in-flight logical call: correlation + completion state."""

    __slots__ = ("rid", "session", "method", "args", "op_class", "trace",
                 "event", "result", "timer", "attempts", "deadline",
                 "per_attempt", "queued", "done", "cb", "t_submit")

    def __init__(self, rid, session, method, args, op_class, trace, cb):
        self.rid = rid
        self.session = session
        self.method = method
        self.args = args
        self.op_class = op_class
        self.trace = trace
        self.cb = cb
        self.event = threading.Event() if cb is None else None
        self.result = None               # RpcResult | exception
        self.timer = None
        self.attempts = 0
        self.deadline = 0.0
        self.per_attempt = 0.0
        self.queued = False
        self.done = False
        self.t_submit = 0.0

    def value(self):
        """Unwrap: the RPC's value, or raise what the call raised —
        ConnectionError/TimeoutError from the transport, IOError with
        the server's errno (EBUSY for a shed) otherwise."""
        r = self.result
        if isinstance(r, BaseException):
            raise r
        if not r.ok:
            raise IOError(r.errno or 0, r.error)
        return r.value


class MuxSession:
    """A logical client: one reqid namespace over the shared transport."""

    __slots__ = ("client", "session")

    def __init__(self, client: "MuxClient", session: str):
        self.client = client
        self.session = session

    def call_async(self, method: str, args: dict | None = None, *,
                   op_class: str = CLIENT_OP, timeout: float | None = None,
                   trace=None, cb=None) -> MuxCall:
        return self.client._submit(self.session, method, args or {},
                                   op_class=op_class, timeout=timeout,
                                   trace=trace, cb=cb)

    def call(self, method: str, args: dict | None = None, *,
             op_class: str = CLIENT_OP, timeout: float | None = None,
             trace=None):
        c = self.call_async(method, args, op_class=op_class,
                            timeout=timeout, trace=trace)
        c.event.wait(c.deadline - time.monotonic() + 1.0)
        if not c.done:
            raise TimeoutError(f"rpc {method} timed out")
        return c.value()


class MuxClient:
    """The shared transport: submission queue, batcher, connections."""

    def __init__(self, host: str, port: int, keyring, *, cct=None,
                 n_conns: int = 2, name: str = "mux"):
        from ..common import default_context
        from .. import net
        self._conf = (cct if cct is not None else default_context()).conf
        net.wire_zero_copy_config(self._conf)
        self._host, self._port = host, port
        with open(keyring, "rb") as f:
            self._key = pickle.load(f)["key"]
        self.name = name
        self.reactor = client_reactor()
        self._cond = threading.Condition()
        self._pending: dict[int, MuxCall] = {}
        self._out: list[MuxCall] = []
        self._rid = 0
        self._closed = False
        self._conns: list[AsyncConnection | None] = \
            [None] * max(1, int(n_conns))
        self._rr = 0
        self._batch_max = int(self._conf.get("ms_async_batch_max"))
        self._batch_delay = \
            float(self._conf.get("ms_async_batch_delay_ms")) / 1000.0
        self._rpc_timeout = float(self._conf.get("ms_rpc_timeout"))
        self._max_attempts = max(
            1, int(self._conf.get("ms_rpc_retry_attempts")))
        self.sessions_opened = 0
        self.reconnects = 0              # successful re-dials
        self.resends = 0                 # rpc attempts after the first
        self.timeouts = 0
        self.completed = 0
        self.sheds_seen = 0              # EBUSY refusals observed
        self.batches_sent = 0
        self.calls_sent = 0
        self._sender = threading.Thread(target=self._sender_loop,
                                        name=f"{name}.sender", daemon=True)
        self._sender.start()

    # -- sessions ------------------------------------------------------------

    def session(self) -> MuxSession:
        with self._cond:
            self.sessions_opened += 1
        return MuxSession(self, uuid.uuid4().hex)

    # -- submission ----------------------------------------------------------

    def _submit(self, session, method, args, *, op_class, timeout,
                trace, cb) -> MuxCall:
        total = self._rpc_timeout if timeout is None else float(timeout)
        with self._cond:
            if self._closed:
                raise ConnectionError("mux client closed")
            self._rid += 1
            call = MuxCall(self._rid, session, method, args, op_class,
                           trace, cb)
            call.per_attempt = max(0.05, total / self._max_attempts)
            now = time.monotonic()
            call.t_submit = now
            call.deadline = now + total
            self._pending[call.rid] = call
            call.queued = True
            self._out.append(call)
            self._cond.notify()
        call.timer = self.reactor.call_later(
            call.per_attempt, lambda: self._on_attempt_timeout(call))
        return call

    def _on_attempt_timeout(self, call: MuxCall) -> None:
        """Reactor timer: the attempt produced no reply (black-holed
        request or reply, dead link).  Resend within the deadline
        budget; reqid dedup makes the resend exactly-once."""
        rearm = False
        with self._cond:
            if call.done or self._closed:
                return
            call.attempts += 1
            now = time.monotonic()
            if now >= call.deadline or call.attempts >= self._max_attempts:
                self.timeouts += 1
                self._finish_locked(call, TimeoutError(
                    f"rpc {call.method} timed out "
                    f"after {call.attempts + 1} attempts"))
            else:
                self.resends += 1
                if not call.queued:
                    call.queued = True
                    self._out.append(call)
                    self._cond.notify()
                rearm = True
        if rearm:
            call.timer = self.reactor.call_later(
                call.per_attempt, lambda: self._on_attempt_timeout(call))
        else:
            self._signal(call)

    def _finish_locked(self, call: MuxCall, result) -> None:
        call.done = True
        call.result = result
        self._pending.pop(call.rid, None)
        if call.timer is not None:
            call.timer.cancel()

    def _signal(self, call: MuxCall) -> None:
        if call.event is not None:
            call.event.set()
        if call.cb is not None:
            try:
                call.cb(call)
            except Exception:            # noqa: BLE001 — the caller's callback
                pass

    # -- reply path (reactor thread) -----------------------------------------

    def _on_message(self, conn, msg) -> None:
        from .. import net
        if isinstance(msg, net.RpcResult):
            results = (msg,)
        elif type(msg).__name__ == "RpcResultBatch":
            results = msg.results
        else:
            return                       # pushes etc.: not a mux concern
        finished = []
        with self._cond:
            for r in results:
                call = self._pending.get(r.rid)
                if call is None or call.done:
                    continue             # late duplicate after a resend
                if not r.ok and r.errno == EBUSY:
                    self.sheds_seen += 1
                self.completed += 1
                self._finish_locked(call, r)
                finished.append(call)
        if instruments.enabled():
            # copy-ledger denominator: result payload bytes landing in
            # their consumer's completion (pairs with the server-side
            # request tally at dispatch)
            served = sum(len(r.value) for r in results
                         if net._sb_eligible(r.value))
            if served:
                copy_ledger.count_served(served)
        for call in finished:
            self._signal(call)

    def _on_closed(self, conn, exc) -> None:
        with self._cond:
            for i, c in enumerate(self._conns):
                if c is conn:
                    self._conns[i] = None
            # wake the sender so queued work re-dials promptly instead
            # of waiting out a batch window on a dead socket
            self._cond.notify()

    # -- sender thread -------------------------------------------------------

    def _sender_loop(self) -> None:
        from .. import net
        while True:
            with self._cond:
                while not self._out and not self._closed:
                    self._cond.wait(0.5)
                if self._closed:
                    return
                if len(self._out) < self._batch_max \
                        and self._batch_delay > 0:
                    self._cond.wait(self._batch_delay)  # coalesce window
                batch = self._out[:self._batch_max]
                del self._out[:len(batch)]
                for c in batch:
                    c.queued = False
            live = [c for c in batch if not c.done]
            if not live:
                continue
            calls = []
            for c in live:
                rc = net.RpcCall(c.rid, c.method, c.args, trace=c.trace,
                                 session=c.session)
                rc.op_class = c.op_class
                calls.append(rc)
            msg = RpcBatch(calls) if len(calls) > 1 else calls[0]
            conn = self._conn_for_send()
            if conn is None:
                # reconnect budget exhausted (or client closed): every
                # owner learns, none hangs
                self._fail_all(ConnectionError("reconnect exhausted"))
                continue
            try:
                t_send = time.monotonic()
                wall = time.time()
                conn.send(msg)
                if len(calls) > 1:
                    self._stamp_batch(live, wall,
                                      time.monotonic() - t_send,
                                      len(calls))
                with self._cond:
                    self.batches_sent += 1
                    self.calls_sent += len(calls)
            except (ConnectionError, OSError):
                # link died under the send (or an injected fault): the
                # calls stay pending; requeue them for the next socket
                with self._cond:
                    for c in live:
                        if not c.done and not c.queued:
                            c.queued = True
                            self._out.append(c)
                    self._cond.notify()

    @staticmethod
    def _stamp_batch(live, wall: float, dur: float, n: int) -> None:
        """Wire-phase spans for calls riding a batched RpcBatch frame:
        each riding call's trace gets one ``mux.batch_send`` child
        covering the coalesced serialize+enqueue, so critical-path
        attribution sees frame time the per-call rpc spans cannot."""
        from ..common import instruments
        if not instruments.enabled():
            return
        from ..common.tracer import default_tracer
        tr = default_tracer()
        for c in live:
            if getattr(c.trace, "trace_id", None):
                tr.complete("mux.batch_send", wall, dur, cat="mux",
                            ctx=c.trace, batched_calls=n)
        # sender-loop completion boundary: fold this thread's pending
        # batch into the ring once per frame, not once per riding call
        tr.flush()

    def _conn_for_send(self) -> AsyncConnection | None:
        with self._cond:
            if self._closed:
                return None
            self._rr += 1
            order = list(range(self._rr, self._rr + len(self._conns)))
        for i in order:
            slot = i % len(self._conns)
            with self._cond:
                conn = self._conns[slot]
            if conn is not None and not conn.closed:
                return conn
        # every slot is down: re-dial ONE under bounded backoff (the
        # sender is the only dialer, so this cannot stampede)
        return self._redial(order[0] % len(self._conns))

    def _redial(self, slot: int) -> AsyncConnection | None:
        from .. import net
        from ..auth.cephx import AuthError
        from ..backend.wire import WireError
        from ..failure.backoff import ExponentialBackoff, RetriesExhausted

        def dial():
            sock, session_key = net.dial_and_handshake(
                self._host, self._port, self._key)
            conn = AsyncConnection(
                sock, self.reactor, secret=session_key,
                name=f"{self.name}.{slot}",
                on_message=self._on_message, on_closed=self._on_closed)
            with self._cond:
                if self._closed:
                    conn.close()
                    raise ConnectionError("mux client closed")
                self._conns[slot] = conn
                self.reconnects += 1
            return conn
        try:
            return ExponentialBackoff(
                base=float(self._conf.get("ms_reconnect_backoff_base")),
                cap=float(self._conf.get("ms_reconnect_backoff_cap")),
                max_attempts=int(
                    self._conf.get("ms_reconnect_max_attempts")),
            ).run(dial, retry_on=(ConnectionError, OSError, AuthError,
                                  WireError))
        except (RetriesExhausted, ConnectionError, OSError, AuthError,
                WireError):
            return None

    def _fail_all(self, exc: BaseException) -> None:
        with self._cond:
            victims = [c for c in self._pending.values() if not c.done]
            for c in victims:
                self._finish_locked(c, exc)
            self._out.clear()
        for c in victims:
            self._signal(c)

    # -- stats / teardown ----------------------------------------------------

    def connect(self) -> None:
        """Eagerly dial every connection slot (optional: the sender
        dials lazily on first send otherwise)."""
        for slot in range(len(self._conns)):
            with self._cond:
                have = self._conns[slot]
            if have is None or have.closed:
                conn = self._redial(slot)
                if conn is None:
                    raise ConnectionError(
                        f"dial {self._host}:{self._port} failed")

    def live_connections(self) -> int:
        with self._cond:
            return sum(1 for c in self._conns
                       if c is not None and not c.closed)

    def stats(self) -> dict:
        with self._cond:
            return {"sessions": self.sessions_opened,
                    "pending": len(self._pending),
                    "connections": sum(
                        1 for c in self._conns
                        if c is not None and not c.closed),
                    "reconnects": self.reconnects,
                    "resends": self.resends,
                    "timeouts": self.timeouts,
                    "completed": self.completed,
                    "sheds_seen": self.sheds_seen,
                    "batches_sent": self.batches_sent,
                    "calls_sent": self.calls_sent}

    def close(self) -> None:
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        self._fail_all(ConnectionError("mux client closed"))
        with self._cond:
            conns = [c for c in self._conns if c is not None]
            self._conns = [None] * len(self._conns)
        for c in conns:
            c.close()
        self._sender.join(5.0)
