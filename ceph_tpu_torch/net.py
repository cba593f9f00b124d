"""TCP transport for the v2 wire: a live cluster served over sockets.

The messenger's TCP half: the in-process MessageBus
carries intra-cluster traffic deterministically, and THIS module carries
client↔cluster traffic over real loopback/LAN sockets using the same v2
framing (reference: src/msg/async/AsyncMessenger.h:74, ProtocolV2.cc):

- banner + HELLO exchange in crc mode (wire.py frames);
- a REAL cephx handshake over the socket — server challenge, session
  key, service ticket, authorizer with mutual-auth reply (auth/cephx.py,
  the full KDC flow with the server embedding the key server the way a
  mon does) — after which both ends switch the connection to SECURE
  (HMAC) mode keyed by the negotiated service session key, exactly the
  cephx→wire-secure handoff ProtocolV2 performs;
- RPC frames against the cluster (put/get/operate-style calls), plus
  server→client watch/notify pushes with blocking acks, so two client
  PROCESSES can watch and notify each other through the cluster.

Secret distribution matches deployment practice: the server writes
``client.admin.keyring`` into the cluster's data dir; clients read it
from the shared filesystem.

Threading: the server runs the async messenger (msg/):
ONE reactor thread owns the listener and every connection — accept,
handshake state machines, frame reassembly, reply writes — and a small
fixed dmClock-ordered worker pool executes RPCs against the cluster
(every cluster call still serializes through one lock; the MiniCluster
is a single-threaded construct).  No per-connection or per-request
threads exist on either side: the client's replies arrive as readiness
callbacks on a shared client reactor.  NotifyAcks are handled inline on
the reactor so a notify blocked on remote acks can never deadlock
against the acking client's queued work.

The port's copy of ``ceph_tpu.net``.  The frames, the cephx handshake
and the keyring files are the reference's byte for byte (the handshake
carries no pickle, so a port client can authenticate against a
reference server and back); post-auth frames pickle the port's own
classes.  The cluster behind the server runs its EC pools on the card:
the dispatch workers launch the kernels from their own threads, each on
that thread's current stream (the default stream), and every kernel
call completes before its RPC returns.  A client never touches CUDA.
"""
from __future__ import annotations

import os
import pickle
import socket
import struct
import threading
import time
from dataclasses import dataclass
from pathlib import Path

from .auth.cephx import (AuthError, Authorizer, CephxClient,
                         CephxServiceHandler, KeyServer)
from .backend.wire import (BANNER, FrameParser, TAG_MESSAGE,
                           WireError, frame_encode, frame_encode_parts)
from .common import copy_ledger, instruments, wire_accounting
from .common.tracer import default_tracer

SERVICE = "osd"
KEYRING = "client.admin.keyring"
NOTIFY_TIMEOUT = 10.0

# interned "rpc.<method>" span names: dispatch records one tracer event
# per op, and building the name fresh each time is measurable at that rate
_RPC_SPAN_NAMES: dict[str, str] = {}


# -- socket RPC messages (own registry: these never ride the PG bus) ---------

@dataclass
class CephxBegin:
    name: str


@dataclass
class CephxChallenge:
    challenge: bytes


@dataclass
class CephxAuthenticate:
    client_challenge: bytes
    proof: bytes


@dataclass
class CephxSession:
    env: bytes                   # sealed session key envelope
    ticket_env: bytes            # sealed service-ticket envelope


@dataclass
class CephxAuthorize:
    authorizer: Authorizer


@dataclass
class CephxDone:
    reply: bytes                 # mutual-auth nonce+1 blob


@dataclass
class RpcCall:
    rid: int
    method: str
    args: dict
    # distributed-trace context (common/tracer.TraceContext): rides the
    # post-auth frame so the server's spans stitch under the remote
    # client's trace id — the cross-PROCESS half of trace propagation
    trace: object = None
    # client session id: (session, rid) is the reqid the server dedups
    # resent calls by, so a resend after a connection reset (or a
    # black-holed request) never re-applies a non-idempotent op — the
    # reference's reqid dedup for 'ms inject socket failures' resends
    session: str = ""
    # dmClock op class (osd/mclock constants): orders the async server's
    # dispatch queue and picks the overload-shedding threshold; absent on
    # frames from older peers — readers use getattr with this default
    op_class: str = "client_op"


@dataclass
class RpcResult:
    rid: int
    ok: bool
    value: object = None
    error: str = ""
    errno: int = 0
    # echo of the call's trace ctx: the reply frame's wire bytes charge
    # to the op class that asked (the send happens on the reader thread,
    # outside the dispatch activation)
    trace: object = None


@dataclass
class SidebandRef:
    """Placeholder left in a pickled control header where a bulk payload
    was extracted to the frame's raw sideband segment: ``i``
    indexes the sideband's length table.  Decode replaces every ref with
    its staged payload before the message reaches any consumer, so refs
    are never visible outside the codec."""
    i: int


@dataclass
class NotifyPush:
    cookie: int
    notify_id: int
    payload: bytes


@dataclass
class NotifyAck:
    cookie: int
    notify_id: int
    value: object = None


_TYPES = {c.__name__: c for c in (
    CephxBegin, CephxChallenge, CephxAuthenticate, CephxSession,
    CephxAuthorize, CephxDone, RpcCall, RpcResult, NotifyPush, NotifyAck)}

# wire accounting sizers (common/wire_accounting.py): the sockets have
# REAL frame lengths, so these estimates only serve the no-unmetered-
# types guard and non-framed callers; weigh the payload-bearing fields
_blob = wire_accounting.blob_size
wire_accounting.register_wire_sizes({
    CephxBegin: lambda m: len(m.name),
    CephxChallenge: lambda m: len(m.challenge),
    CephxAuthenticate: lambda m: len(m.client_challenge) + len(m.proof),
    CephxSession: lambda m: len(m.env) + len(m.ticket_env),
    CephxAuthorize: lambda m: _blob(m.authorizer.blob) + 48,
    CephxDone: lambda m: len(m.reply),
    RpcCall: lambda m: len(m.method) + _blob(m.args),
    RpcResult: lambda m: _blob(m.value) + len(m.error),
    # a sideband placeholder is one u32 index on the wire; the payload
    # it stands for is metered by the frame's real byte length
    SidebandRef: lambda m: 4,
    NotifyPush: lambda m: len(m.payload) + 16,
    NotifyAck: lambda m: _blob(m.value) + 16,
})

# ---- pre-auth codec: NO pickle before the peer is authenticated ----------
#
# Everything that arrives before the HMAC session is established is
# attacker-controlled, and unpickling attacker bytes is remote code
# execution.  The six handshake message types therefore serialize as
# plain length-prefixed primitive fields (str/bytes/int only); pickle is
# allowed ONLY for post-auth frames, whose HMAC a peer without the
# session key cannot forge (the same trust line ProtocolV2 draws at its
# auth-done frame).

_HANDSHAKE_FIELDS = {
    "CephxBegin": ("name",),
    "CephxChallenge": ("challenge",),
    "CephxAuthenticate": ("client_challenge", "proof"),
    "CephxSession": ("env", "ticket_env"),
    "CephxDone": ("reply",),
    # Authorizer flattened: the only nested handshake payload
    "CephxAuthorize": ("service", "blob", "secret_id", "nonce", "proof"),
}
_LEN = struct.Struct("<I")


def _pack_field(v) -> bytes:
    if isinstance(v, str):
        tag, payload = b"s", v.encode()
    elif isinstance(v, (bytes, bytearray)):
        tag, payload = b"b", bytes(v)
    elif isinstance(v, int):
        tag, payload = b"i", str(int(v)).encode()
    else:
        raise WireError(f"unsupported handshake field {type(v)}")
    return tag + _LEN.pack(len(payload)) + payload


def _unpack_fields(blob: bytes) -> list:
    out, off = [], 0
    while off < len(blob):
        tag = blob[off:off + 1]
        (ln,) = _LEN.unpack_from(blob, off + 1)
        payload = blob[off + 1 + _LEN.size:off + 1 + _LEN.size + ln]
        if len(payload) != ln:
            raise WireError("truncated handshake field")
        off += 1 + _LEN.size + ln
        if tag == b"s":
            out.append(payload.decode())
        elif tag == b"b":
            out.append(payload)
        elif tag == b"i":
            out.append(int(payload))
        else:
            raise WireError(f"bad handshake field tag {tag!r}")
    return out


def _handshake_dumps(msg) -> bytes:
    name = type(msg).__name__
    fields = _HANDSHAKE_FIELDS[name]
    if name == "CephxAuthorize":
        a = msg.authorizer
        values = [a.service, a.blob, a.secret_id, a.nonce, a.proof]
    else:
        values = [getattr(msg, f) for f in fields]
    return b"".join(_pack_field(v) for v in values)


def _handshake_loads(name: str, blob: bytes):
    values = _unpack_fields(blob)
    if len(values) != len(_HANDSHAKE_FIELDS[name]):
        raise WireError(f"bad field count for {name}")
    if name == "CephxAuthorize":
        return CephxAuthorize(Authorizer(*values))
    return _TYPES[name](*values)


def _encode(msg, secret: bytes | None) -> bytes:
    name = type(msg).__name__
    if name in _HANDSHAKE_FIELDS:
        payload = _handshake_dumps(msg)
    else:
        if secret is None:
            raise WireError(f"{name} may not ride an unauthenticated "
                            f"connection")
        payload = pickle.dumps(msg)
        if instruments.enabled():
            codec = _SIDEBAND_CODECS.get(name)
            if codec is not None:
                pb = codec.payload_bytes(msg)
                if pb:
                    # the legacy path's two tx-side payload copies:
                    # pickle.dumps above and frame_encode's b"".join
                    copy_ledger.count_copy("pickle", pb)
                    copy_ledger.count_copy("join", pb)
    return frame_encode(TAG_MESSAGE, [name.encode(), payload],
                        secret=secret)


# ---- raw-payload sideband (zero-copy batch frames) -------------
#
# A payload-bearing post-auth message may serialize as a THREE-segment
# frame: [type name, pickled control header, raw sideband].  Bulk
# bytes-like values are lifted out of the header before pickling (a
# SidebandRef marks each slot) and ride the third segment length-
# prefixed, so the encode side never pickles payload bytes (the views
# splice straight into the connection's write queue) and the decode
# side lands them with ONE copy — into a pooled staging buffer (server)
# or owned bytes (client/blocking channel).  Frames dispatch on segment
# count, so both formats decode regardless of ms_zero_copy: the option
# gates only the encode side and mixed peers interoperate.

_SB_MIN = copy_ledger.PAYLOAD_MIN
# encode-side splice threshold: lifting a value costs a header rewrite,
# a table entry, and an extra write-queue part — worth it only once the
# value dwarfs that overhead.  Smaller eligible values stay pickled
# (and still weigh in the ledger as legacy copies via _sb_eligible)
_SB_SPLICE_MIN = 1024
_SB_LEN = struct.Struct("<I")

_zero_copy = True


def zero_copy_enabled() -> bool:
    return _zero_copy


def set_zero_copy(on: bool) -> None:
    global _zero_copy
    _zero_copy = bool(on)


def wire_zero_copy_config(conf) -> None:
    """Adopt ``ms_zero_copy`` from a ConfigProxy and follow live
    updates (the transports call this; the switch is process-wide like
    the instruments kill-switch, and gates only the encode side)."""
    if "ms_zero_copy" not in conf.schema:
        return
    set_zero_copy(bool(conf.get("ms_zero_copy")))
    conf.add_observer("ms_zero_copy",
                      lambda _name, v: set_zero_copy(bool(v)))


def _sb_eligible(v) -> bool:
    return isinstance(v, (bytes, bytearray, memoryview)) \
        and len(v) >= _SB_MIN


def _sb_splice(v) -> bool:
    return isinstance(v, (bytes, bytearray, memoryview)) \
        and len(v) >= _SB_SPLICE_MIN


class _SidebandCodec:
    """One message type's sideband hooks: ``extract(msg)`` returns
    ``(header_msg, views)`` or None (nothing to lift — caller falls back
    to the pickled frame); ``reattach(msg, payloads)`` swaps every
    SidebandRef in a freshly-unpickled header for its landed payload;
    ``payload_bytes(msg)`` sizes the eligible payloads (the legacy
    path's ledger weights)."""

    __slots__ = ("extract", "reattach", "payload_bytes")

    def __init__(self, extract, reattach, payload_bytes):
        self.extract = extract
        self.reattach = reattach
        self.payload_bytes = payload_bytes


_SIDEBAND_CODECS: dict[str, _SidebandCodec] = {}


def _call_extract_args(call, views: list):
    """Lift eligible args values; returns a replacement args dict or
    None.  Never mutates the caller's dict — retries resend the same
    RpcCall objects, which must keep their real payloads."""
    repl = None
    for k, v in call.args.items():
        if _sb_splice(v):
            if repl is None:
                repl = dict(call.args)
            repl[k] = SidebandRef(len(views))
            views.append(v if isinstance(v, memoryview) else memoryview(v))
    return repl


def _call_reattach_args(call, payloads: list) -> None:
    for k, v in call.args.items():
        if type(v) is SidebandRef:
            call.args[k] = payloads[v.i]


def _rpc_call_extract(msg):
    views: list = []
    repl = _call_extract_args(msg, views)
    if repl is None:
        return None
    return RpcCall(msg.rid, msg.method, repl, trace=msg.trace,
                   session=msg.session, op_class=msg.op_class), views


def _rpc_call_payload_bytes(msg) -> int:
    return sum(len(v) for v in msg.args.values() if _sb_eligible(v))


def _rpc_result_extract(msg):
    if not _sb_splice(msg.value):
        return None
    v = msg.value
    return RpcResult(msg.rid, msg.ok, SidebandRef(0), msg.error,
                     msg.errno, trace=msg.trace), \
        [v if isinstance(v, memoryview) else memoryview(v)]


def _rpc_result_reattach(msg, payloads) -> None:
    if type(msg.value) is SidebandRef:
        msg.value = payloads[msg.value.i]


_SIDEBAND_CODECS["RpcCall"] = _SidebandCodec(
    _rpc_call_extract, _call_reattach_args, _rpc_call_payload_bytes)
_SIDEBAND_CODECS["RpcResult"] = _SidebandCodec(
    _rpc_result_extract, _rpc_result_reattach,
    lambda m: len(m.value) if _sb_eligible(m.value) else 0)


def _encode_parts(msg, secret: bytes | None) -> list | None:
    """Sideband encode: the frame as an ordered list of write buffers
    (payload views UNJOINED), or None when the message cannot or need
    not sideband — the caller falls back to :func:`_encode`."""
    if secret is None or not _zero_copy:
        return None
    codec = _SIDEBAND_CODECS.get(type(msg).__name__)
    if codec is None:
        return None
    ex = codec.extract(msg)
    if ex is None:
        return None
    header_msg, views = ex
    table = _SB_LEN.pack(len(views)) + b"".join(
        _SB_LEN.pack(len(v)) for v in views)
    return frame_encode_parts(
        TAG_MESSAGE,
        [type(msg).__name__.encode(), pickle.dumps(header_msg),
         [table, *views]],
        secret=secret)


def _sideband_payloads(seg, staging) -> list:
    """Land a sideband segment's payloads with ONE copy each: staged
    into a pooled buffer (views) when ``staging`` is a pool, or
    materialized to owned bytes otherwise (client completions and the
    reqid-dedup cache outlive the parser buffer)."""
    mv = seg if isinstance(seg, memoryview) else memoryview(seg)
    if len(mv) < _SB_LEN.size:
        raise WireError("truncated sideband table")
    (n,) = _SB_LEN.unpack_from(mv, 0)
    head = _SB_LEN.size * (1 + n)
    if len(mv) < head:
        raise WireError("truncated sideband table")
    lens = [_SB_LEN.unpack_from(mv, _SB_LEN.size * (1 + i))[0]
            for i in range(n)]
    body = mv[head:]
    if sum(lens) != len(body):
        raise WireError("sideband length mismatch")
    out: list = []
    off = 0
    if staging is not None:
        base = staging.stage(body)          # THE copy (ledger: staging)
        for ln in lens:
            out.append(base[off:off + ln])
            off += ln
    else:
        for ln in lens:
            b = bytes(body[off:off + ln])
            off += ln
            copy_ledger.count_copy("materialize", len(b))
            out.append(b)
    return out


def _decode(tag: int, segs: list[bytes], *, authed: bool, staging=None):
    # segs may be bytes (FrameParser) or memoryviews into the async
    # stream parser's receive buffer; only the tiny name/handshake
    # segments materialize — the pickle payload decodes in place
    if tag != TAG_MESSAGE or len(segs) not in (2, 3):
        raise WireError(f"unexpected frame tag {tag}")
    name = bytes(segs[0]).decode()
    klass = _TYPES.get(name)
    if klass is None:
        raise WireError(f"unknown rpc type {name!r}")
    if name in _HANDSHAKE_FIELDS:
        if len(segs) != 2:
            raise WireError(f"{name} cannot carry a sideband")
        return _handshake_loads(name, bytes(segs[1]))
    if not authed:
        # pickle is reachable ONLY behind the HMAC (pre-auth unpickling
        # of peer bytes would be remote code execution)
        raise WireError(f"{name} before authentication")
    msg = pickle.loads(segs[1])
    if type(msg) is not klass:
        raise WireError("rpc type name mismatch")
    codec = _SIDEBAND_CODECS.get(name)
    if len(segs) == 3:
        if codec is None:
            raise WireError(f"{name} cannot carry a sideband")
        try:
            codec.reattach(msg, _sideband_payloads(segs[2], staging))
        except (IndexError, AttributeError, TypeError) as e:
            raise WireError(f"bad sideband refs in {name}: {e}") from e
    elif codec is not None and instruments.enabled():
        pb = codec.payload_bytes(msg)
        if pb:
            copy_ledger.count_copy("unpickle", pb)
    return msg


class Channel:
    """One framed socket endpoint.  Starts in crc mode; ``secure(key)``
    switches both directions to HMAC mode (called at the same protocol
    point on both ends, like ProtocolV2's post-auth session switch)."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.parser = FrameParser(None)
        self.parser.track_sizes = True
        self.secret: bytes | None = None
        self._wlock = threading.Lock()
        self._banner_seen = False
        self._banner_buf = bytearray()
        # per-connection byte/op counters (the reference's per-Connection
        # messenger stats) + optional shared WireAccounting the server
        # attaches so every connection rolls up into wire.net.<port>
        self.stats = {"tx_msgs": 0, "tx_bytes": 0,
                      "rx_msgs": 0, "rx_bytes": 0}
        self.acct = None
        # transport fault hooks (failure/transport.py): a ZERO-ARG
        # PROVIDER returning the current hooks (or None), attached by
        # the server AFTER auth — a provider rather than a snapshot so
        # arming/disarming mid-run applies to live connections, and the
        # handshake is never faulted (reconnects always get back in)
        self.faults = None
        with self._wlock:
            self.sock.sendall(BANNER)

    def secure(self, key: bytes) -> None:
        self.secret = key
        self.parser = FrameParser(key)
        self.parser.track_sizes = True

    def send(self, msg) -> None:
        data = _encode(msg, self.secret)
        action = "ok"
        hooks = self.faults() if self.faults is not None else None
        if hooks is not None:
            # target is the MESSAGE TYPE, not the peer address: ephemeral
            # ports differ between runs and would break the same-seed
            # event-digest guarantee
            from .failure.transport import SEND_TRUNCATE
            action = hooks.on_send(
                type(msg).__name__, len(data),
                target=type(msg).__name__)
        if self.acct is not None:
            # real framed bytes; the op class comes from the riding
            # trace ctx (RpcCall) or the sender's active context.
            # Accounting is sharded per thread now — it needs no lock,
            # and keeping it OUT of _wlock keeps concurrent senders
            # from serializing on an instrument
            self.acct.account_msg(
                msg, nbytes=len(data),
                ctx=getattr(msg, "trace", None)
                or default_tracer().current_ctx())
        with self._wlock:
            # the plain stats dict still rides the lock that serializes
            # concurrent senders (dispatch reply vs notify push):
            # counting it outside would lose increments and drift from
            # the peer's rx side
            self.stats["tx_msgs"] += 1
            self.stats["tx_bytes"] += len(data)
            if action == "ok":
                self.sock.sendall(data)
        if action != "ok":
            # injected transport failure: a PARTIAL frame on the wire
            # (truncate) or nothing at all, then an abrupt close — the
            # peer sees a cut-off frame / RST and must reconnect+resend
            if action == SEND_TRUNCATE:
                try:
                    self.sock.sendall(data[:max(1, len(data) // 2)])
                except OSError:
                    pass
            self.close()
            raise ConnectionError(f"injected connection {action}")

    def recv_msgs(self) -> list:
        """Blocking read; returns >=1 decoded messages or raises
        ConnectionError on EOF."""
        while True:
            data = self.sock.recv(65536)
            if not data:
                raise ConnectionError("peer closed")
            if not self._banner_seen:
                self._banner_buf += data
                if len(self._banner_buf) < len(BANNER):
                    continue
                if self._banner_buf[:len(BANNER)] != BANNER:
                    raise WireError("banner mismatch")
                data = bytes(self._banner_buf[len(BANNER):])
                self._banner_seen = True
                self._banner_buf.clear()
            frames = self.parser.feed(data)
            if frames:
                # the parser reports each frame's REAL on-wire length
                # (preamble + crc/mac + body), so rx_bytes matches the
                # peer's tx_bytes for the same conversation; the segment
                # sum is only the fallback for a parser swapped mid-read
                sizes = self.parser.frame_sizes
                self.parser.frame_sizes = []
                out = []
                for i, (t, s) in enumerate(frames):
                    msg = _decode(t, s, authed=self.secret is not None)
                    nbytes = sizes[i] if i < len(sizes) else \
                        sum(len(seg) for seg in s) + \
                        wire_accounting.MSG_OVERHEAD
                    self.stats["rx_msgs"] += 1
                    self.stats["rx_bytes"] += nbytes
                    if self.acct is not None:
                        self.acct.account_rx(
                            type(msg).__name__, nbytes,
                            ctx=getattr(msg, "trace", None))
                    out.append(msg)
                return out

    def recv_one(self):
        msgs = self.recv_msgs()
        if len(msgs) != 1:
            raise WireError(f"expected one message, got {len(msgs)}")
        return msgs[0]

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


# -- server ------------------------------------------------------------------

class ClusterServer:
    """Serve a MiniCluster over TCP with cephx-authenticated, HMAC-secured
    connections.  ``port=0`` binds an ephemeral port (see ``.port``)."""

    def __init__(self, cluster, host: str = "127.0.0.1", port: int = 0):
        self.cluster = cluster
        self.lock = threading.Lock()          # ONE cluster at a time
        self.keyserver = KeyServer()
        self._load_or_create_keys()
        self.handler = CephxServiceHandler(SERVICE, self.keyserver)
        self._listener = socket.create_server((host, port))
        self.port = self._listener.getsockname()[1]
        # server-wide wire accounting: every connection's frames roll up
        # into ONE wire.net.<port> perf collection (per-message-type
        # bytes, per-op-class bytes, RPC latency histogram)
        self.wire = wire_accounting.WireAccounting(
            cct=getattr(cluster, "cct", None), name=f"net.{self.port}")
        self._stop = threading.Event()
        # the serving front door: reactor + handshake state machines +
        # dmClock dispatch (msg/server.py), created by start().  The
        # KeyServer's single per-entity challenge slot is serialized by
        # the transport's auth FIFO (the old _auth_lock, made async)
        self._transport = None
        # cookie -> connection for remote watchers
        self._watchers: dict[int, object] = {}
        self._watch_lock = threading.Lock()
        self._pending_acks: dict[tuple[int, int], list] = {}
        self._ack_cond = threading.Condition()
        # transport fault injection (failure/): hooks attached to every
        # authenticated connection once inject_faults() arms them —
        # explicitly, or auto-armed from the ms_inject_* options (the
        # reference's 'ms inject socket failures' config surface)
        self.fault_hooks = None
        self._maybe_auto_inject()
        # resend dedup: (client session, rid) -> cached RpcResult, so a
        # retried call after a reset/black-hole returns the FIRST
        # execution's answer instead of re-applying (reqid dedup)
        self._rpc_cache: "dict[tuple[str, int], RpcResult]" = {}
        self._rpc_cache_order: list[tuple[str, int]] = []
        self._rpc_cache_lock = threading.Lock()
        # reqids currently EXECUTING: a resend that arrives while the
        # original is still running waits for that execution instead of
        # starting a second one (slow notify + eager client resend)
        self._rpc_inflight: "dict[tuple[str, int], threading.Event]" = {}
        self.rpc_dedup_hits = 0

    RPC_CACHE_MAX = 4096

    # side-effect-free methods are safe to simply RE-EXECUTE on a
    # resend: caching them would pin every read payload in the dedup
    # cache (4 MiB gets x 4096 entries) for hits that barely happen
    IDEMPOTENT_RPCS = frozenset(
        {"get", "stat", "ls", "pools", "status", "health", "getxattr",
         "ping", "tier_read"})

    def inject_faults(self, injector) -> None:
        """Arm (or, with None, disarm) transport-plane fault injection:
        every authenticated connection consults the injector's seeded
        streams for resets, black-holes, truncations and delays."""
        from .failure.transport import TransportFaultHooks
        self.fault_hooks = TransportFaultHooks(injector) \
            if injector is not None else None

    def _maybe_auto_inject(self) -> None:
        """The ms_inject_* options arm the hooks without code: a reset
        roughly every ``ms_inject_socket_failures`` post-auth messages
        plus ``ms_inject_delay_prob``/``ms_inject_delay_ms`` stalls."""
        cct = getattr(self.cluster, "cct", None)
        if cct is None:
            return
        n = int(cct.conf.get("ms_inject_socket_failures"))
        dprob = float(cct.conf.get("ms_inject_delay_prob"))
        if n <= 0 and dprob <= 0:
            return
        from .failure import (FaultInjector, FaultPlan, TransportFaults)
        plan = FaultPlan(transport=TransportFaults(
            reset_prob=(1.0 / n) if n > 0 else 0.0,
            delay_prob=dprob,
            delay_ms=float(cct.conf.get("ms_inject_delay_ms"))))
        self._own_injector = FaultInjector(plan, cct=cct,
                                           name=f"net.{self.port}")
        self.inject_faults(self._own_injector)

    # -- keyring -------------------------------------------------------------

    SERVER_KEYS = "mon.keyserver"     # server-only: rotating secrets

    def _load_or_create_keys(self) -> None:
        """The CLIENT keyring carries ONLY the entity key (a real cephx
        keyring's content); the rotating service secrets stay in a
        separate server-only file — a keyring holder must never be able
        to seal ticket blobs and impersonate entities."""
        data_dir = getattr(self.cluster, "data_dir", None)
        base = Path(data_dir) if data_dir is not None else None
        if base is not None and (base / self.SERVER_KEYS).exists():
            with open(base / self.SERVER_KEYS, "rb") as f:
                saved = pickle.load(f)
            self.keyserver.entity_keys.update(saved["entity_keys"])
            self.keyserver.rotating = saved["rotating"]
            return
        self.keyserver.create_entity("client.admin")
        self.keyserver.rotate(SERVICE)
        if base is not None:
            save_keys(self.keyserver, base)

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        """Bring up the async serving transport (idempotent).  The
        listener, every connection's handshake, frame reassembly and
        reply writes all live on ONE reactor thread; dispatch runs on a
        small fixed worker pool — no per-connection or per-request
        thread is ever spawned."""
        if self._transport is None:
            from .msg.server import AsyncServerTransport
            self._transport = AsyncServerTransport(
                self, self._listener,
                cct=getattr(self.cluster, "cct", None),
                name=f"net.{self.port}")
            self._transport.start()
        return self._transport

    def serve_forever(self) -> None:
        """Blocking form (rados_cli serve): start + wait for stop()."""
        self.start()
        self._stop.wait()

    def stop(self) -> None:
        self._stop.set()
        if self._transport is not None:
            self._transport.stop()
            self._transport = None
        try:
            self._listener.close()
        except OSError:
            pass
        self.wire.close()
        if getattr(self, "_own_injector", None) is not None:
            # only the auto-armed injector is ours to close; an operator-
            # supplied one (inject_faults) belongs to its campaign
            self._own_injector.close()
            self._own_injector = None

    # -- transport callbacks (msg/server.py) ---------------------------------

    def _note_ack(self, msg: "NotifyAck") -> None:
        """A remote watcher's NotifyAck arrived: wake the notify that is
        blocked on it.  Runs INLINE on the reactor (never queued behind
        dispatch): the notify holding the cluster lock is what a queued
        ack would be stuck behind."""
        with self._ack_cond:
            key = (msg.cookie, msg.notify_id)
            self._pending_acks.setdefault(key, []).append(msg.value)
            self._ack_cond.notify_all()

    def _conn_closed(self, conn) -> None:
        """Connection teardown: drop the watches registered on it.  Under
        its own small lock, NOT the cluster lock — this runs on the
        reactor thread, which must never wait on a dispatch in flight."""
        with self._watch_lock:
            dead = [c for c, w in self._watchers.items() if w is conn]
            for cookie in dead:
                del self._watchers[cookie]

    # -- RPC dispatch --------------------------------------------------------

    def _dispatch(self, ch: Channel, call: RpcCall) -> RpcResult:
        t0 = time.perf_counter()
        if instruments.enabled():
            # copy-ledger denominator: request payload bytes reaching
            # their consumer (the handler) — pairs with the client-side
            # tally of result payloads at completion
            served = sum(len(v) for v in call.args.values()
                         if _sb_eligible(v))
            if served:
                copy_ledger.count_served(served)
        # resend dedup by reqid: a session-stamped call already answered
        # returns its FIRST execution's cached result — the property that
        # makes reset/black-hole resends safe for non-idempotent ops
        key = (call.session, call.rid) \
            if getattr(call, "session", "") \
            and call.method not in self.IDEMPOTENT_RPCS else None
        if key is not None:
            with self._rpc_cache_lock:
                hit = self._rpc_cache.get(key)
                running = None
                if hit is None:
                    running = self._rpc_inflight.get(key)
                    if running is None:
                        self._rpc_inflight[key] = threading.Event()
            if hit is not None:
                self.rpc_dedup_hits += 1
                return hit
            if running is not None:
                # the original execution is still on the cluster lock:
                # wait for ITS answer rather than double-applying
                self.rpc_dedup_hits += 1
                running.wait(NOTIFY_TIMEOUT * 6)
                with self._rpc_cache_lock:
                    hit = self._rpc_cache.get(key)
                if hit is not None:
                    return hit
                return RpcResult(call.rid, False, None,
                                 "duplicate of an execution that never "
                                 "finished", 0,
                                 trace=getattr(call, "trace", None))
        try:
            fn = getattr(self, f"_rpc_{call.method}", None)
            if fn is None:
                raise ValueError(f"unknown method {call.method!r}")
            tr = default_tracer()
            trace = getattr(call, "trace", None)
            sname = _RPC_SPAN_NAMES.get(call.method)
            if sname is None:
                sname = _RPC_SPAN_NAMES[call.method] = "rpc." + call.method
            if trace is not None:
                with self.lock, tr.activate(trace, track="server"), \
                        tr.span(sname, cat="rpc"):
                    value = fn(ch, **call.args)
            else:
                # untraced op: no context/track to adopt and nothing to
                # link — record through the allocation-light observe()
                # path instead of the full Span protocol
                with self.lock:
                    t0_span = time.perf_counter()
                    value = fn(ch, **call.args)
                    tr.observe(sname, t0_span, cat="rpc")
            return self._rpc_remember(
                key, RpcResult(call.rid, True, value,
                               trace=getattr(call, "trace", None)))
        except Exception as e:                 # noqa: BLE001 — RPC boundary
            return self._rpc_remember(
                key, RpcResult(call.rid, False, None,
                               f"{type(e).__name__}: {e}",
                               getattr(e, "errno", 0) or 0,
                               trace=getattr(call, "trace", None)))
        finally:
            # RPC latency lands in the wire histogram whether the call
            # succeeded or not — a failing method is still served time
            self.wire.observe_rpc(call.method,
                                  time.perf_counter() - t0)

    def _rpc_remember(self, key, res: RpcResult) -> RpcResult:
        if key is None:
            return res
        with self._rpc_cache_lock:
            if key not in self._rpc_cache:
                self._rpc_cache_order.append(key)
                while len(self._rpc_cache_order) > self.RPC_CACHE_MAX:
                    self._rpc_cache.pop(self._rpc_cache_order.pop(0),
                                        None)
            self._rpc_cache[key] = res
            ev = self._rpc_inflight.pop(key, None)
        if ev is not None:
            ev.set()
        return res

    def _rpc_mkpool(self, ch, name, profile=None, pg_num=8,
                    replicated=False, size=3):
        c = self.cluster
        if name in c.pool_ids:
            raise ValueError(f"pool {name!r} exists")
        if replicated:
            return c.create_replicated_pool(name, size=size, pg_num=pg_num)
        return c.create_ec_pool(name, profile or {}, pg_num=pg_num)

    def _rpc_pools(self, ch):
        return dict(self.cluster.pool_ids)

    def _rpc_put(self, ch, pool, oid, data):
        from .osd.osd_ops import ObjectOperation
        pid = self.cluster.pool_ids[pool]
        self.cluster.operate(pid, oid,
                             ObjectOperation().write_full(bytes(data)))
        return len(data)

    def _rpc_get(self, ch, pool, oid):
        from .osd.osd_ops import ObjectOperation
        pid = self.cluster.pool_ids[pool]
        r = self.cluster.operate(pid, oid, ObjectOperation().stat()
                                 .read(0, 0))
        size, _mtime = r.outdata(0)
        # the port's read hands back host bytes (primary_log_pg), never a
        # tensor: the reply's sideband splices bytes-likes only
        return bytes(r.outdata(1)[:size])

    def _rpc_stat(self, ch, pool, oid):
        from .osd.osd_ops import ObjectOperation
        pid = self.cluster.pool_ids[pool]
        r = self.cluster.operate(pid, oid, ObjectOperation().stat())
        return tuple(r.outdata(0))           # (size, mtime), like local

    def _rpc_remove(self, ch, pool, oid):
        from .osd.osd_ops import ObjectOperation
        pid = self.cluster.pool_ids[pool]
        self.cluster.operate(pid, oid, ObjectOperation().remove())
        return True

    def _rpc_ls(self, ch, pool):
        from .osd.hit_set import is_hit_set_oid
        from .osd.primary_log_pg import is_clone_oid
        pid = self.cluster.pool_ids[pool]
        # internal oids (snapshot clones, hit-set archives) stay hidden,
        # like the local IoCtx listing
        return sorted(o for o in self.cluster.objects.get(pid, set())
                      if not is_clone_oid(o) and not is_hit_set_oid(o))

    def _rpc_setxattr(self, ch, pool, oid, name, value):
        from .osd.osd_ops import ObjectOperation
        pid = self.cluster.pool_ids[pool]
        self.cluster.operate(pid, oid,
                             ObjectOperation().setxattr(name, value))
        return True

    def _rpc_getxattr(self, ch, pool, oid, name):
        from .osd.osd_ops import ObjectOperation
        pid = self.cluster.pool_ids[pool]
        return self.cluster.operate(
            pid, oid, ObjectOperation().getxattr(name)).outdata(0)

    def _rpc_status(self, ch):
        return self.cluster.status()

    def _rpc_health(self, ch):
        return self.cluster.health()

    def _rpc_ping(self, ch, payload=None, key=None):
        """Echo: the serving-path microbenchmark op (rados_bench mux
        mode) — round-trips the transport without touching the cluster.
        ``key`` carries the workload generator's object key (zipf /
        flash-crowd streams) so key-addressed load shapes ride the real
        wire format; the echo ignores it."""
        return payload

    def _rpc_tier_read(self, ch, pool, key):
        """Tiered read: when ``pool`` is a cache tier, serve ``key``
        through it (hit / proxy / recency-gated promote — the
        flash-crowd serving op); otherwise read straight from the pool
        with the tier's own base op vector, so the tiering bench's cold
        arm measures the exact path a miss proxies to.  Idempotent: a
        promotion is a copy-up, so re-executing on a resend is safe."""
        c = self.cluster
        pid = c.pool_ids[pool]
        tier = c.tiers.get(pid)
        if tier is not None:
            return tier[0].read(key)
        from .osd.osd_ops import ObjectOperation
        r = c.operate(pid, key, ObjectOperation().read(0, 0).getxattrs())
        return bytes(r.ops[0].outdata)

    def _rpc_tier_write(self, ch, pool, key, payload):
        """Tiered write: absorbed by the cache tier bound over ``pool``
        (writeback marks dirty, proxy forwards, readonly refuses) or
        written straight to the pool when no tier is bound — the cold
        arm's EC full-stripe write, encode and all.  Replay-deduped
        like ``put`` (NOT in IDEMPOTENT_RPCS)."""
        c = self.cluster
        pid = c.pool_ids[pool]
        tier = c.tiers.get(pid)
        if tier is not None:
            tier[0].write(key, bytes(payload))
            return len(payload)
        from .osd.osd_ops import ObjectOperation
        c.operate(pid, key, ObjectOperation().write_full(bytes(payload)))
        return len(payload)

    def _rpc_watch(self, ch, pool, oid, cookie):
        from .osd.osd_ops import ObjectOperation
        pid = self.cluster.pool_ids[pool]
        with self._watch_lock:
            self._watchers[cookie] = ch

        def on_notify(notify_id, ck, payload, _ch=ch, _cookie=cookie):
            # push OUTSIDE the ack wait; the remote client answers on its
            # own reader thread via NotifyAck
            _ch.send(NotifyPush(_cookie, notify_id, payload))
            deadline = time.monotonic() + NOTIFY_TIMEOUT
            key = (_cookie, notify_id)
            with self._ack_cond:
                while not self._pending_acks.get(key):
                    left = deadline - time.monotonic()
                    if left <= 0:
                        return TimeoutError("notify ack timeout")
                    self._ack_cond.wait(left)
                return self._pending_acks.pop(key)[0]
        self.cluster.operate(pid, oid,
                             ObjectOperation().watch(cookie, on_notify))
        return True

    def _rpc_unwatch(self, ch, pool, oid, cookie):
        from .osd.osd_ops import ObjectOperation
        pid = self.cluster.pool_ids[pool]
        self.cluster.operate(pid, oid, ObjectOperation().unwatch(cookie))
        with self._watch_lock:
            self._watchers.pop(cookie, None)
        return True

    def _rpc_notify(self, ch, pool, oid, payload):
        from .osd.osd_ops import ObjectOperation
        pid = self.cluster.pool_ids[pool]
        r = self.cluster.operate(pid, oid,
                                 ObjectOperation().notify(bytes(payload)))
        acks = r.outdata(0)
        # exceptions don't pickle reliably; stringify them
        return {ck: (repr(v) if isinstance(v, Exception) else v)
                for ck, v in acks.items()}


def save_keys(keyserver: KeyServer, base) -> None:
    """Write ``keyserver``'s server-only file (entity keys and rotating
    secrets, ``mon.keyserver``) and the client keyring (the entity key
    of ``client.admin`` alone) into the directory ``base``, as a server
    over a data dir does at its first start."""
    base = Path(base)
    with open(base / ClusterServer.SERVER_KEYS, "wb") as f:
        pickle.dump({"entity_keys": dict(keyserver.entity_keys),
                     "rotating": keyserver.rotating}, f)
    with open(base / KEYRING, "wb") as f:
        pickle.dump({"key": keyserver.entity_keys["client.admin"]}, f)


# -- CLI helper --------------------------------------------------------------

def cli_connect(connect: str, keyring: str | None, data_dir: str | None):
    """Shared --connect preamble for the rados/ceph CLIs: parse
    HOST:PORT, resolve the keyring (explicit or <data-dir>/keyring), and
    open an authenticated TcpRados.  Raises ValueError/IOError/AuthError
    with operator-readable messages; the CLIs map those to 'error: ...'
    + exit 2."""
    host, _, port_s = connect.rpartition(":")
    if not host or not port_s.isdigit():
        raise ValueError(f"--connect wants HOST:PORT, got {connect!r}")
    keyring = keyring or (os.path.join(data_dir, KEYRING)
                          if data_dir else None)
    if keyring is None:
        raise ValueError("--keyring (or --data-dir) required with "
                         "--connect")
    return TcpRados(host, int(port_s), keyring)


# -- client ------------------------------------------------------------------

def _client_handshake(ch: "Channel", cx: CephxClient) -> bytes:
    """Client side of the cephx exchange over a blocking Channel; fills
    ``cx`` with the session key + service ticket, switches ``ch`` to
    secure mode, and returns the service session key."""
    from .auth.cephx import Ticket, _proof, unseal
    now = time.time()
    ch.send(CephxBegin(cx.name))
    challenge = ch.recv_one()
    if not isinstance(challenge, CephxChallenge):
        raise AuthError("expected CephxChallenge")
    client_challenge = os.urandom(16)
    proof = _proof(cx.key, challenge.challenge, client_challenge)
    ch.send(CephxAuthenticate(client_challenge, proof))
    sess = ch.recv_one()
    if not isinstance(sess, CephxSession):
        raise AuthError("expected CephxSession")
    cx.session_key = unseal(cx.key, sess.env)["session_key"]
    t = unseal(cx.session_key, sess.ticket_env)
    cx.tickets[SERVICE] = Ticket(
        service=SERVICE, blob=t["blob"], secret_id=t["secret_id"],
        session_key=t["session_key"], expires=t["expires"])
    authz = cx.build_authorizer(SERVICE, now)
    ch.send(CephxAuthorize(authz))
    done = ch.recv_one()
    if not isinstance(done, CephxDone):
        raise AuthError("expected CephxDone")
    cx.verify_reply(SERVICE, done.reply, authz.nonce)  # mutual auth
    # both ends switch to HMAC frames under the service session key
    key = cx.tickets[SERVICE].session_key
    ch.secure(key)
    return key


def dial_and_handshake(host: str, port: int, key: bytes,
                       timeout: float = 10.0):
    """Blocking dial + full cephx handshake; returns the authenticated
    ``(socket, session_key)`` ready to hand to an async connection.
    This is the msg/ package's entry point for new connections — the
    only legitimately-blocking socket work stays HERE, outside the
    reactor's readiness discipline."""
    cx = CephxClient("client.admin", key)
    sock = socket.create_connection((host, port), timeout=timeout)
    sock.settimeout(None)
    ch = Channel(sock)
    try:
        session_key = _client_handshake(ch, cx)
    except BaseException:
        ch.close()
        raise
    return sock, session_key


class TcpRados:
    """A remote cluster handle: cephx-authenticated, HMAC-secured RPC.

    ``keyring`` is the path the server wrote (client.admin.keyring) —
    reading it from the shared filesystem IS the secret distribution.

    Self-healing: the link dropping (reset, truncated frame,
    server bounce) no longer kills the handle — :meth:`call` reconnects
    with bounded full-jitter exponential backoff and RESENDS the rpc
    under its original (session, rid) reqid, which the server dedups, so
    a reset between send and reply is neither a lost op nor a double
    apply.  A per-RPC deadline (``ms_rpc_timeout``) bounds the whole
    dance; a black-holed request times out per attempt and resends.
    """

    def __init__(self, host: str, port: int, keyring: str | os.PathLike,
                 cct=None):
        from .common import default_context
        self._conf = (cct if cct is not None else default_context()).conf
        self._host, self._port = host, port
        with open(keyring, "rb") as f:
            saved = pickle.load(f)
        self._key = saved["key"]
        import uuid
        self._session = uuid.uuid4().hex    # the reqid namespace
        self._rid = 0
        self._lock = threading.Lock()
        self._pending: dict[int, list] = {}
        # rids a call() is actively waiting on: the reader DROPS replies
        # for anything else (a late duplicate reply after a resend must
        # not recreate a popped _pending entry and pin its payload)
        self._waiting: set[int] = set()
        self._cond = threading.Condition()
        self._watch_cbs: dict[int, object] = {}
        self._watch_pools: dict[int, tuple] = {}   # cookie -> (pool, oid)
        self._dead = True
        self._closed = False
        # serializes reconnect attempts: two callers seeing _dead at
        # once must not dial two connections and clobber self.ch
        self._conn_lock = threading.Lock()
        self.reconnects = 0                 # successful re-dials
        self.resends = 0                    # rpc attempts after the first
        # one AsyncConnection on the shared client reactor (msg/): the
        # old per-client reader THREAD is gone — replies and pushes
        # arrive as readiness callbacks.  Same surface as before:
        # .ch.secret, .ch.stats, .ch.send(), .ch.close()
        self.ch = None
        self._connect()

    def _connect(self) -> None:
        """Dial + blocking cephx handshake, then hand the authenticated
        socket to the shared client reactor (one connection's worth).
        The new connection is PUBLISHED only after the handshake
        succeeds, so concurrent senders never see a half-authenticated
        ``self.ch`` (the old, closed connection stays in place until
        then — their sends fail with OSError and their retry loops come
        back around)."""
        self._cephx = CephxClient("client.admin", self._key)
        sock = socket.create_connection((self._host, self._port),
                                        timeout=10.0)
        sock.settimeout(None)
        ch = Channel(sock)
        try:
            self._handshake(ch)
        except BaseException:
            ch.close()
            raise
        # the Channel wrapper retires; the socket lives on, secured,
        # readiness-driven, on the shared reactor
        from .msg.connection import AsyncConnection
        from .msg.reactor import client_reactor
        self.ch = AsyncConnection(
            sock, client_reactor(),
            secret=self._cephx.tickets[SERVICE].session_key,
            name=f"rados.{self._session[:8]}",
            on_message=self._on_message,
            on_closed=self._on_conn_closed)
        with self._cond:
            self._dead = False

    def _reconnect(self) -> None:
        """Bounded reconnect: full-jitter exponential backoff between
        attempts (failure/backoff.py), then re-register watches.  Raises
        RetriesExhausted when the budget runs out.  Serialized: a second
        caller blocks on the lock and returns as soon as the first
        caller's fresh connection is up."""
        from .failure.backoff import ExponentialBackoff
        with self._conn_lock:
            if self._closed:
                # a concurrent close() must not be raced back to life by
                # an in-flight call's retry loop
                raise ConnectionError("client closed")
            with self._cond:
                if not self._dead:
                    return              # someone else already re-dialed
            old = self.ch
            if old is not None:
                old.close()
            ExponentialBackoff(
                base=float(self._conf.get("ms_reconnect_backoff_base")),
                cap=float(self._conf.get("ms_reconnect_backoff_cap")),
                max_attempts=int(
                    self._conf.get("ms_reconnect_max_attempts")),
            ).run(self._connect, retry_on=(ConnectionError, OSError,
                                           AuthError, WireError))
            self.reconnects += 1
        # watches live server-side per CONNECTION: re-arm them on the new
        # one (one shot each; a failure here just surfaces on the next
        # call's own retry loop)
        for cookie in list(self._watch_cbs):
            try:
                self._call_once(self._next_rid(), "watch",
                                {"pool": self._watch_pools[cookie][0],
                                 "oid": self._watch_pools[cookie][1],
                                 "cookie": cookie},
                                timeout=NOTIFY_TIMEOUT)
            except (KeyError, ConnectionError, OSError, IOError,
                    TimeoutError):
                pass

    def _handshake(self, ch: Channel) -> None:
        _client_handshake(ch, self._cephx)

    # -- reply / push callbacks (reactor thread) -----------------------------

    def _on_message(self, conn, msg) -> None:
        if isinstance(msg, RpcResult):
            with self._cond:
                if msg.rid in self._waiting:
                    self._pending.setdefault(msg.rid, []).append(msg)
                    self._cond.notify_all()
                # else: a late duplicate of an answered call — drop it,
                # don't pin its payload
        elif isinstance(msg, NotifyPush):
            # the watch callback is user code and may block (it often
            # answers with its own RPCs): off the reactor thread
            threading.Thread(target=self._run_watch_cb,
                             args=(msg,), daemon=True).start()

    def _on_conn_closed(self, conn, exc) -> None:
        # the link died (reset, truncated frame, server gone): flag it
        # and wake every waiter — call() reconnects and resends
        with self._cond:
            if self.ch is conn:           # not already superseded
                self._dead = True
            self._cond.notify_all()

    def _run_watch_cb(self, push: NotifyPush) -> None:
        cb = self._watch_cbs.get(push.cookie)
        value = None
        if cb is not None:
            try:
                value = cb(push.notify_id, push.cookie, push.payload)
            except Exception as e:             # noqa: BLE001
                value = repr(e)
        try:
            self.ch.send(NotifyAck(push.cookie, push.notify_id, value))
        except (ConnectionError, OSError, AttributeError):
            # link died under the ack (or is mid-reconnect): the server's
            # notify times out and reports it — nothing to heal here
            pass

    def _next_rid(self) -> int:
        with self._lock:
            self._rid += 1
            return self._rid

    def _call_once(self, rid: int, method: str, args: dict,
                   timeout: float):
        """One send + one bounded wait on the CURRENT connection.
        Raises ConnectionError (link died) or TimeoutError (no reply —
        e.g. a black-holed request) for the retry loop to handle."""
        tr = default_tracer()
        ctx = tr.current_ctx() or tr.new_trace("client")
        self.ch.send(RpcCall(rid, method, args, trace=ctx,
                             session=self._session))
        deadline = time.monotonic() + timeout
        with self._cond:
            while not self._pending.get(rid):
                if self._dead:
                    raise ConnectionError("link down")
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"rpc {method} rid={rid}: no reply within "
                        f"{timeout:.1f}s")
                self._cond.wait(left)
            return self._pending.pop(rid)[0]

    def call(self, method: str, timeout: float | None = None, **args):
        """One RPC under the self-healing contract: bounded resends
        (``ms_rpc_retry_attempts``) within one overall deadline
        (``ms_rpc_timeout``), reconnecting with backoff as needed; the
        stable (session, rid) reqid makes every resend dedup-safe."""
        if self._closed:
            raise ConnectionError("client closed")
        total = float(self._conf.get("ms_rpc_timeout")
                      if timeout is None else timeout)
        attempts = int(self._conf.get("ms_rpc_retry_attempts"))
        per_attempt = max(0.05, total / attempts)
        deadline = time.monotonic() + total
        rid = self._next_rid()
        with self._cond:
            self._waiting.add(rid)
        # every RPC is (part of) a client op: adopt the caller's trace
        # or root one, so resend/backoff time below stamps into a trace
        # the critical-path ledger can attribute to `retry`
        tr = default_tracer()
        ctx = tr.current_ctx() or tr.new_trace("client")
        try:
            with tr.activate(ctx, track="client"), \
                    tr.span("client.rpc", cat="client", method=method):
                # the INNER ctx (child of the client.rpc span): resend
                # events must nest UNDER the rpc span, or the span-tree
                # overlap clamp treats them as clipped sibling roots
                # and their time files under the span's self time
                return self._call_with_retries(rid, method, args, total,
                                               attempts, per_attempt,
                                               deadline,
                                               tr.current_ctx() or ctx)
        finally:
            with self._cond:
                self._waiting.discard(rid)
                self._pending.pop(rid, None)   # no ghost replies later

    def _call_with_retries(self, rid, method, args, total, attempts,
                           per_attempt, deadline, ctx=None):
        tr = default_tracer()
        last: BaseException | None = None
        timeouts = 0
        last_mark = time.monotonic()
        for attempt in range(attempts):
            if attempt:
                self.resends += 1
                # time burned since the previous attempt started (the
                # failed attempt + any reconnect backoff) is retry
                # overhead: stamp it into the op's trace
                now = time.monotonic()
                if ctx is not None:
                    tr.complete("net.resend",
                                time.time() - (now - last_mark),
                                now - last_mark, ctx=ctx,
                                method=method, attempt=attempt)
                last_mark = now
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                if self._dead:
                    self._reconnect()
                res = self._call_once(rid, method, args,
                                      min(per_attempt, remaining))
            except TimeoutError as e:
                last = e                  # black-holed: resend, same rid
                timeouts += 1
                if timeouts >= 2:
                    # two silent attempts on one connection: suspect a
                    # HALF-OPEN link (peer died without RST) — force a
                    # re-dial rather than shouting into the void again
                    with self._cond:
                        self._dead = True
                continue
            except (ConnectionError, OSError) as e:
                last = e                  # link died mid-call: mark it
                with self._cond:          # dead so the next attempt
                    self._dead = True     # re-dials instead of resending
                continue                  # on the same broken channel
            if not res.ok:
                err = IOError(res.error)
                err.errno = res.errno
                raise err
            return res.value
        if isinstance(last, TimeoutError):
            raise TimeoutError(f"rpc {method}: no reply within "
                               f"{total:.1f}s ({attempts} attempts)") \
                from last
        raise ConnectionError(
            f"rpc {method}: link down after {attempts} attempts") \
            from last

    # -- convenience surface -------------------------------------------------

    def mkpool(self, name, profile=None, pg_num=8, replicated=False,
               size=3):
        return self.call("mkpool", name=name, profile=profile,
                         pg_num=pg_num, replicated=replicated, size=size)

    def put(self, pool, oid, data):
        return self.call("put", pool=pool, oid=oid, data=bytes(data))

    def get(self, pool, oid) -> bytes:
        return self.call("get", pool=pool, oid=oid)

    def stat(self, pool, oid) -> int:
        return self.call("stat", pool=pool, oid=oid)

    def remove(self, pool, oid):
        return self.call("remove", pool=pool, oid=oid)

    def ls(self, pool):
        return self.call("ls", pool=pool)

    def pools(self):
        return self.call("pools")

    def status(self):
        return self.call("status")

    def setxattr(self, pool, oid, name, value):
        return self.call("setxattr", pool=pool, oid=oid, name=name,
                         value=value)

    def getxattr(self, pool, oid, name):
        return self.call("getxattr", pool=pool, oid=oid, name=name)

    def watch(self, pool, oid, cookie: int, on_notify):
        self._watch_cbs[cookie] = on_notify
        self._watch_pools[cookie] = (pool, oid)
        return self.call("watch", pool=pool, oid=oid, cookie=cookie)

    def unwatch(self, pool, oid, cookie: int):
        self._watch_cbs.pop(cookie, None)
        self._watch_pools.pop(cookie, None)
        return self.call("unwatch", pool=pool, oid=oid, cookie=cookie)

    def notify(self, pool, oid, payload: bytes) -> dict:
        return self.call("notify", pool=pool, oid=oid,
                         payload=bytes(payload))

    def close(self) -> None:
        self._closed = True
        with self._cond:
            self._dead = True
            self._cond.notify_all()
        # under the conn lock: any reconnect in flight finishes first,
        # then we close whatever channel is current — _closed above
        # keeps later retry loops from dialing again
        with self._conn_lock:
            if self.ch is not None:
                self.ch.close()
