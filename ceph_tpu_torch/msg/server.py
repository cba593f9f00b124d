"""AsyncServerTransport: the reactor-driven serving front door.

Replaces ``ClusterServer``'s thread-per-connection accept loop
(reference analog: AsyncMessenger's Processor + Worker pool replacing
SimpleMessenger's Pipe threads):

- ONE reactor thread owns the listener and every accepted connection;
  accept, banner, the full cephx handshake, frame reassembly, and
  reply writes are readiness callbacks — no per-connection threads, no
  per-request threads;
- the cephx exchange runs as a per-connection STATE MACHINE.  Because
  the KeyServer holds a single challenge slot per entity
  (``auth/cephx.py _pending``), concurrent handshakes serialize through
  a FIFO token — the async form of the old ``_auth_lock``, held across
  the exchange but never blocking the loop;
- decoded calls land in a dmClock-ordered dispatch queue drained by a
  SMALL fixed worker pool (``ms_async_op_threads``) that executes
  against the cluster and sends replies with write-queue backpressure;
- when ingest outruns dispatch, arrivals shed by op class
  (:class:`~ceph_tpu_torch.msg.shed.ShedPolicy`): background classes bounce
  with EBUSY while client ops still queue, and nothing buffers without
  bound.

Fault semantics are bitwise-compatible with the threaded transport:
hooks arm only post-auth via the provider pattern (disarming applies to
live connections), recv-side faults (blackhole/reset) are consulted per
inner call, and a truncated/reset reply surfaces to the peer as a cut
frame + EOF.
"""
from __future__ import annotations

import socket
import threading
import time

from ..osd.mclock import (CLIENT_OP, ClientInfo, DEFAULT_OP_CLASS_INFO,
                          MClockOpClassQueue)
from .connection import AsyncConnection
from .reactor import Reactor
from .shed import EBUSY, ShedPolicy

AUTH_TIMEOUT = 10.0

# dispatch-queue QoS: keep the weights/reservations of the engine's
# class info but drop the rate LIMITS — at the dispatch tier, overload
# control is the shed ladder, not stranding queued ops on limit tags
DISPATCH_CLASS_INFO = {
    cls: ClientInfo(reservation=info.reservation, weight=info.weight,
                    limit=0.0)
    for cls, info in DEFAULT_OP_CLASS_INFO.items()
}

# handshake phases
WAIT_BEGIN = "wait_begin"
WAIT_AUTHENTICATE = "wait_authenticate"
WAIT_AUTHORIZE = "wait_authorize"
OPEN = "open"


class _AuthState:
    __slots__ = ("phase", "name", "now", "timer", "holds_token")

    def __init__(self):
        self.phase = WAIT_BEGIN
        self.name = ""
        self.now = 0.0
        self.timer = None
        self.holds_token = False


class _Listener:
    """Readiness handler for the accept socket."""

    def __init__(self, transport):
        self.transport = transport

    def wants_write(self) -> bool:
        return False

    def on_writable(self) -> None:
        pass

    def on_readable(self) -> None:
        while True:
            try:
                sock, _addr = self.transport.listener.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return                    # listener closed by stop()
            self.transport._accept(sock)

    def on_io_error(self, exc) -> None:
        pass


class Dispatcher:
    """dmClock-ordered dispatch queue + a bounded worker pool."""

    def __init__(self, core, n_threads: int, shed: ShedPolicy,
                 name: str = "msgr"):
        self.core = core
        self.shed = shed
        self.q = MClockOpClassQueue(DISPATCH_CLASS_INFO)
        self._cond = threading.Condition()
        self._depth = 0
        self._stopping = False
        self._n = max(1, int(n_threads))
        self._threads: list[threading.Thread] = []
        self._name = name

    def start(self) -> None:
        # the ONLY thread spawns in the serving path: a fixed pool,
        # sized by config, started once — never per connection/request
        for i in range(self._n):
            t = threading.Thread(target=self._worker,
                                 name=f"{self._name}.dispatch.{i}",
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        for t in self._threads:
            t.join(5.0)

    @property
    def depth(self) -> int:
        with self._cond:
            return self._depth

    def ingest(self, conn, msg, op_class: str) -> bool:
        """Reactor-thread arrival: queue under dmClock order, or shed by
        class with an immediate EBUSY refusal.  Never blocks.  Depth is
        measured in LOGICAL OPS (a batch frame counts its calls), so the
        shed thresholds mean the same thing batched or not."""
        n = len(msg.calls) if hasattr(msg, "calls") else 1
        with self._cond:
            depth = self._depth
        if self.shed.should_shed(op_class, depth, n=n):
            reply = self._shed_reply(msg, op_class)
            try:
                conn.send_from_reactor(reply)
            except (ConnectionError, OSError):
                pass
            return False
        with self._cond:
            self.q.enqueue(op_class, (conn, msg, n), now=time.monotonic(),
                           cost=float(n))
            self._depth += n
            self._cond.notify()
        return True

    @staticmethod
    def _shed_reply(msg, op_class: str):
        from .. import net
        from .proto import RpcResultBatch

        def one(call):
            return net.RpcResult(
                call.rid, False, None,
                f"EBUSY: shed ({op_class}) — dispatch queue over the "
                f"class threshold", EBUSY,
                trace=getattr(call, "trace", None))
        if hasattr(msg, "calls"):
            return RpcResultBatch([one(c) for c in msg.calls])
        return one(msg)

    @staticmethod
    def _stamp_batch_reply(calls, wall: float, dur: float) -> None:
        """Wire-phase spans for replies riding a batched RpcResultBatch
        frame: each riding call's trace gets one ``mux.batch_reply``
        child covering the coalesced reply serialize+enqueue (the send
        the per-method ``rpc.*`` server spans end before)."""
        from ..common import instruments
        if not instruments.enabled():
            return
        from ..common.tracer import default_tracer
        tr = default_tracer()
        for c in calls:
            ctx = getattr(c, "trace", None)
            if getattr(ctx, "trace_id", None):
                tr.complete("mux.batch_reply", wall, dur, cat="mux",
                            ctx=ctx, batched_calls=len(calls))

    def _worker(self) -> None:
        from .. import net
        from .proto import RpcResultBatch
        while True:
            with self._cond:
                item = None
                while item is None:
                    if self._depth:
                        item = self.q.dequeue(time.monotonic())
                        if item is not None:
                            self._depth -= item[2]
                            break
                        # everything queued is tag-ineligible right now
                        self._cond.wait(0.005)
                    elif self._stopping:
                        return
                    else:
                        self._cond.wait(0.5)
            conn, msg, _n = item
            if hasattr(msg, "calls"):     # RpcBatch: one worker, one frame
                reply = RpcResultBatch(
                    [self.core._dispatch(conn, c) for c in msg.calls])
            else:
                reply = self.core._dispatch(conn, msg)
            try:
                t0 = time.monotonic()
                wall = time.time()
                conn.send(reply)
                if hasattr(msg, "calls"):
                    self._stamp_batch_reply(msg.calls, wall,
                                            time.monotonic() - t0)
            except (ConnectionError, OSError):
                # link died (or an injected fault) before the reply got
                # out: results are cached under their reqids — the
                # client's resend on the next connection collects them
                pass
            # dispatcher completion boundary: fold this worker's pending
            # span batch into the ring once per frame, not per span
            from ..common.tracer import default_tracer
            default_tracer().flush()


class AsyncServerTransport:
    """Reactor + handshake state machines + dispatcher for one server.

    ``core`` is the RPC brain (``net.ClusterServer``): it provides
    ``keyserver``/``handler`` for cephx, ``_dispatch`` for execution,
    ``fault_hooks`` for injection, ``wire`` for accounting, and
    ``_note_ack``/``_conn_closed`` for notify bookkeeping.
    """

    def __init__(self, core, listener: socket.socket, *, cct=None,
                 name: str | None = None):
        self.core = core
        self.listener = listener
        port = listener.getsockname()[1]
        self.name = name or f"srv.{port}"
        conf = cct.conf if cct is not None else None

        def opt(key, default):
            return conf.get(key) if conf is not None else default
        if conf is not None:
            from .. import net
            net.wire_zero_copy_config(conf)
        # server connections land request sidebands in the pooled
        # staging buffers (the one sanctioned copy: wire -> staging)
        from .staging import default_pool
        self.staging = default_pool()
        self.reactor = Reactor(name=self.name)
        self.write_queue_bytes = int(opt("ms_async_write_queue_bytes",
                                         4 << 20))
        self.shed = ShedPolicy(int(opt("ms_async_dispatch_queue_max",
                                       1024)))
        self.dispatcher = Dispatcher(
            core, int(opt("ms_async_op_threads", 3)), self.shed,
            name=self.name)
        self._conns: set[AsyncConnection] = set()
        self._conns_lock = threading.Lock()
        # the async _auth_lock: a FIFO token serializing full cephx
        # exchanges (single challenge slot per entity in the KeyServer)
        self._auth_holder: AsyncConnection | None = None
        self._auth_fifo: list[tuple[AsyncConnection, object]] = []
        self._accepts = 0

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "AsyncServerTransport":
        self.listener.setblocking(False)
        self.reactor.start()
        self.reactor.register(self.listener, _Listener(self))
        self.dispatcher.start()
        return self

    def stop(self) -> None:
        try:
            self.listener.close()
        except OSError:
            pass
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            c.close()
        self.dispatcher.stop()
        self.reactor.stop()

    def connections(self) -> int:
        with self._conns_lock:
            return len(self._conns)

    # -- accept + handshake state machine (reactor thread) -------------------

    def _accept(self, sock: socket.socket) -> None:
        self._accepts += 1
        conn = AsyncConnection(
            sock, self.reactor, expect_banner=True, send_banner=True,
            name=f"{self.name}.c{self._accepts}",
            on_message=self._on_message, on_closed=self._on_closed,
            write_queue_bytes=self.write_queue_bytes,
            staging=self.staging)
        conn.acct = self.core.wire
        conn.auth = _AuthState()
        conn.auth.timer = self.reactor.call_later(
            AUTH_TIMEOUT, lambda c=conn: self._auth_timeout(c))
        with self._conns_lock:
            self._conns.add(conn)

    def _auth_timeout(self, conn: AsyncConnection) -> None:
        if conn.auth.phase != OPEN:
            conn.close(ConnectionError("handshake timeout"))

    def _on_closed(self, conn: AsyncConnection, exc) -> None:
        with self._conns_lock:
            self._conns.discard(conn)
        # auth promotion mutates reactor-affine state (_auth_holder /
        # _auth_fifo, next-waiter handshake sends): off-loop closes
        # (stop(), client-thread aborts) trampoline like register()
        # does instead of racing the in-flight _auth_step
        if self.reactor.in_reactor() or not self.reactor.running:
            self._release_auth(conn)
        else:
            self.reactor.call_soon(lambda: self._release_auth(conn))
        if conn.auth.timer is not None:
            conn.auth.timer.cancel()
        self.core._conn_closed(conn)

    def _release_auth(self, conn: AsyncConnection) -> None:
        self._auth_fifo = [(c, m) for c, m in self._auth_fifo
                           if c is not conn]
        if self._auth_holder is not conn:
            return
        self._auth_holder = None
        while self._auth_fifo:
            nxt, begin = self._auth_fifo.pop(0)
            if nxt.closed:
                continue
            self._auth_holder = nxt
            self._auth_begin(nxt, begin)
            break

    def _on_message(self, conn: AsyncConnection, msg) -> None:
        from ..backend.wire import WireError
        if conn.auth.phase != OPEN:
            self._auth_step(conn, msg)
            return
        self._route(conn, msg)

    def _auth_step(self, conn: AsyncConnection, msg) -> None:
        from ..auth.cephx import AuthError
        from ..backend.wire import WireError
        try:
            self._auth_step_inner(conn, msg)
        except (WireError, AuthError, KeyError, ValueError) as e:
            conn.close(e if isinstance(e, (WireError,))
                       else ConnectionError(f"auth failed: {e}"))

    def _auth_step_inner(self, conn: AsyncConnection, msg) -> None:
        from .. import net
        from ..backend.wire import WireError
        st = conn.auth
        if st.phase == WAIT_BEGIN:
            if not isinstance(msg, net.CephxBegin):
                raise WireError("expected CephxBegin")
            if self._auth_holder is not None and \
                    self._auth_holder is not conn:
                self._auth_fifo.append((conn, msg))
                return
            self._auth_holder = conn
            self._auth_begin(conn, msg)
        elif st.phase == WAIT_AUTHENTICATE:
            if not isinstance(msg, net.CephxAuthenticate):
                raise WireError("expected CephxAuthenticate")
            env = self.core.keyserver.issue_session_key(
                st.name, msg.client_challenge, msg.proof, st.now)
            ticket_env = self.core.keyserver.issue_service_ticket(
                st.name, net.SERVICE, st.now)
            conn.send_from_reactor(net.CephxSession(env, ticket_env))
            st.phase = WAIT_AUTHORIZE
        elif st.phase == WAIT_AUTHORIZE:
            if not isinstance(msg, net.CephxAuthorize):
                raise WireError("expected CephxAuthorize")
            _name, reply = self.core.handler.verify_authorizer(
                msg.authorizer, st.now)
            _, secret = self.core.keyserver.service_secret(
                net.SERVICE, msg.authorizer.secret_id)
            from ..auth.cephx import unseal
            session_key = unseal(secret, msg.authorizer.blob)[
                "session_key"]
            # Done rides the LAST crc-mode frame; both ends switch to
            # HMAC under the service session key right after it
            conn.send_from_reactor(net.CephxDone(reply))
            conn.secure(session_key)
            st.phase = OPEN
            if st.timer is not None:
                st.timer.cancel()
            # fault injection arms only POST-auth, via a provider so
            # disarming mid-run applies to live connections too
            conn.faults = lambda: self.core.fault_hooks
            self._release_auth(conn)
        else:                             # pragma: no cover — state error
            raise WireError(f"auth message in phase {st.phase}")

    def _auth_begin(self, conn: AsyncConnection, msg) -> None:
        from .. import net
        st = conn.auth
        st.name = msg.name
        st.now = time.time()
        conn.send_from_reactor(net.CephxChallenge(
            self.core.keyserver.get_challenge(msg.name)))
        st.phase = WAIT_AUTHENTICATE

    # -- post-auth routing (reactor thread) ----------------------------------

    def _route(self, conn: AsyncConnection, msg) -> None:
        from .. import net
        from ..backend.wire import WireError
        if isinstance(msg, net.NotifyAck):
            self.core._note_ack(msg)
            return
        calls = None
        if isinstance(msg, net.RpcCall):
            calls = [msg]
        elif hasattr(msg, "calls") and type(msg).__name__ == "RpcBatch":
            calls = list(msg.calls)
        if calls is None:
            conn.close(WireError(f"unexpected {type(msg).__name__}"))
            return
        hooks = self.core.fault_hooks
        if hooks is not None:
            from ..failure.transport import RECV_BLACKHOLE, RECV_RESET
            kept = []
            for call in calls:
                act = hooks.on_recv(type(call).__name__,
                                    target=call.method)
                if act == RECV_BLACKHOLE:
                    continue              # swallowed: no reply, ever
                if act == RECV_RESET:
                    conn.close(ConnectionError("injected recv reset"))
                    return
                kept.append(call)
            calls = kept
        if not calls:
            return
        op_class = getattr(calls[0], "op_class", "") or CLIENT_OP
        if len(calls) == 1 and isinstance(msg, net.RpcCall):
            self.dispatcher.ingest(conn, calls[0], op_class)
        else:
            from .proto import RpcBatch
            self.dispatcher.ingest(conn, RpcBatch(calls), op_class)
