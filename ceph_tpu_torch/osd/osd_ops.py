"""Client-visible object operations: the RADOS op vector.

Analog of the reference's ``OSDOp``/``ceph_osd_op`` op vector carried by
``MOSDOp`` (reference: src/osd/osd_types.h, src/messages/MOSDOp.h) and the
librados ``ObjectReadOperation``/``ObjectWriteOperation`` builders
(src/librados/librados_cxx.cc).  One MOSDOp holds an ordered vector of ops
executed atomically by the primary's op engine
(PrimaryLogPG::do_osd_ops — see primary_log_pg.py).

A copy of ``ceph_tpu.osd.osd_ops``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

# -- opcodes (CEPH_OSD_OP_* — src/include/rados.h) --------------------------

OP_READ = "read"
OP_SPARSE_READ = "sparse_read"
OP_STAT = "stat"
OP_CMPEXT = "cmpext"
OP_CREATE = "create"
OP_WRITE = "write"
OP_WRITEFULL = "writefull"
OP_APPEND = "append"
OP_ZERO = "zero"
OP_TRUNCATE = "truncate"
OP_DELETE = "delete"
OP_GETXATTR = "getxattr"
OP_GETXATTRS = "getxattrs"
OP_SETXATTR = "setxattr"
OP_RMXATTR = "rmxattr"
OP_CMPXATTR = "cmpxattr"
OP_OMAPGETKEYS = "omap_get_keys"
OP_OMAPGETVALS = "omap_get_vals"
OP_OMAPGETVALSBYKEYS = "omap_get_vals_by_keys"
OP_OMAPGETHEADER = "omap_get_header"
OP_OMAPSETVALS = "omap_set_vals"
OP_OMAPSETHEADER = "omap_set_header"
OP_OMAPRMKEYS = "omap_rm_keys"
OP_OMAPCLEAR = "omap_clear"
OP_OMAP_CMP = "omap_cmp"
OP_CALL = "call"
OP_ROLLBACK = "rollback"
OP_LIST_SNAPS = "list_snaps"
OP_WATCH = "watch"
OP_UNWATCH = "unwatch"
OP_NOTIFY = "notify"
OP_LIST_WATCHERS = "list_watchers"

# ops that mutate object state (CEPH_OSD_FLAG_WRITE classification)
WRITE_OPS = frozenset({
    OP_CREATE, OP_WRITE, OP_WRITEFULL, OP_APPEND, OP_ZERO, OP_TRUNCATE,
    OP_DELETE, OP_SETXATTR, OP_RMXATTR, OP_OMAPSETVALS, OP_OMAPSETHEADER,
    OP_OMAPRMKEYS, OP_OMAPCLEAR, OP_ROLLBACK,
})
# ops that need object DATA from the (possibly degraded) store
DATA_READ_OPS = frozenset({OP_READ, OP_SPARSE_READ, OP_CMPEXT})

# CEPH_OSD_CMPXATTR_OP_* (src/include/rados.h:305-312)
CMPXATTR_EQ, CMPXATTR_NE = 1, 2
CMPXATTR_GT, CMPXATTR_GTE = 3, 4
CMPXATTR_LT, CMPXATTR_LTE = 5, 6
# CEPH_OSD_CMPXATTR_MODE_*
CMPXATTR_MODE_STRING, CMPXATTR_MODE_U64 = 1, 2


@dataclass
class OSDOp:
    """One op of the vector: opcode + params + (after execution) result."""
    op: str
    params: dict[str, Any] = field(default_factory=dict)
    rval: int = 0
    outdata: Any = None


class ObjectOperation:
    """Ordered op-vector builder (librados ObjectRead/WriteOperation)."""

    def __init__(self):
        self.ops: list[OSDOp] = []

    def _add(self, op: str, **params) -> "ObjectOperation":
        self.ops.append(OSDOp(op, params))
        return self

    # reads
    def read(self, offset: int, length: int):
        return self._add(OP_READ, offset=offset, length=length)

    def sparse_read(self, offset: int, length: int):
        return self._add(OP_SPARSE_READ, offset=offset, length=length)

    def stat(self):
        return self._add(OP_STAT)

    def cmpext(self, offset: int, data: bytes):
        return self._add(OP_CMPEXT, offset=offset, data=bytes(data))

    def getxattr(self, name: str):
        return self._add(OP_GETXATTR, name=name)

    def getxattrs(self):
        return self._add(OP_GETXATTRS)

    def cmpxattr(self, name: str, op: int, value, mode: int | None = None):
        if mode is None:
            mode = (CMPXATTR_MODE_U64 if isinstance(value, int)
                    else CMPXATTR_MODE_STRING)
        return self._add(OP_CMPXATTR, name=name, cmp=op, mode=mode,
                         value=value)

    def omap_get_keys(self, start_after: str = "", max_return: int = 1 << 30):
        return self._add(OP_OMAPGETKEYS, start_after=start_after,
                         max_return=max_return)

    def omap_get_vals(self, start_after: str = "", filter_prefix: str = "",
                      max_return: int = 1 << 30):
        return self._add(OP_OMAPGETVALS, start_after=start_after,
                         filter_prefix=filter_prefix, max_return=max_return)

    def omap_get_vals_by_keys(self, keys):
        return self._add(OP_OMAPGETVALSBYKEYS, keys=list(keys))

    def omap_get_header(self):
        return self._add(OP_OMAPGETHEADER)

    def omap_cmp(self, assertions: dict):
        """assertions: key -> (value, cmp op) — all must hold."""
        return self._add(OP_OMAP_CMP, assertions=dict(assertions))

    # writes
    def create(self, exclusive: bool = False):
        return self._add(OP_CREATE, exclusive=exclusive)

    def write(self, offset: int, data: bytes):
        return self._add(OP_WRITE, offset=offset, data=bytes(data))

    def write_full(self, data: bytes):
        return self._add(OP_WRITEFULL, data=bytes(data))

    def append(self, data: bytes):
        return self._add(OP_APPEND, data=bytes(data))

    def zero(self, offset: int, length: int):
        return self._add(OP_ZERO, offset=offset, length=length)

    def truncate(self, size: int):
        return self._add(OP_TRUNCATE, size=size)

    def remove(self):
        return self._add(OP_DELETE)

    def setxattr(self, name: str, value):
        return self._add(OP_SETXATTR, name=name, value=value)

    def rmxattr(self, name: str):
        return self._add(OP_RMXATTR, name=name)

    def omap_set(self, kvs: dict):
        return self._add(OP_OMAPSETVALS, kvs=dict(kvs))

    def omap_set_header(self, header: bytes):
        return self._add(OP_OMAPSETHEADER, header=bytes(header))

    def omap_rm_keys(self, keys):
        return self._add(OP_OMAPRMKEYS, keys=list(keys))

    def omap_clear(self):
        return self._add(OP_OMAPCLEAR)

    # object classes
    def call(self, cls: str, method: str, indata: bytes = b""):
        return self._add(OP_CALL, cls=cls, method=method,
                         indata=bytes(indata))

    # watch/notify (librados watch2/notify2 shape)
    def watch(self, cookie: int, on_notify):
        """Register a watch: ``on_notify(notify_id, cookie, payload) ->
        reply bytes`` fires for every notify on the object."""
        return self._add(OP_WATCH, cookie=cookie, on_notify=on_notify)

    def unwatch(self, cookie: int):
        return self._add(OP_UNWATCH, cookie=cookie)

    def notify(self, payload: bytes = b""):
        """Deliver ``payload`` to every watcher; outdata maps each
        watcher cookie to its reply (notify_ack collection)."""
        return self._add(OP_NOTIFY, payload=bytes(payload))

    def list_watchers(self):
        return self._add(OP_LIST_WATCHERS)

    # snapshots
    def rollback(self, snapid: int):
        """CEPH_OSD_OP_ROLLBACK: restore the object to its state at
        ``snapid`` (must be the only mutation in the vector)."""
        return self._add(OP_ROLLBACK, snapid=snapid)

    def list_snaps(self):
        return self._add(OP_LIST_SNAPS)


@dataclass
class SnapContext:
    """The write-time snap context (SnapContext, src/include/rados.h):
    ``seq`` is the newest snap id the client knows, ``snaps`` the live
    snap ids newest-first."""
    seq: int = 0
    snaps: tuple = ()


@dataclass
class MOSDOp:
    """Client op message (src/messages/MOSDOp.h shape, trimmed)."""
    oid: str
    ops: list[OSDOp]
    epoch: int = 0
    client: str = "client"
    tid: int = 0
    snapid: int | None = None          # read AT this snap (None = head)
    snapc: SnapContext | None = None   # write-time snap context
    # internal ops (tiering agent, scrub helpers) must not count as
    # client accesses — they would keep every object artificially hot in
    # the hit sets (the reference's agent IO bypasses hit_set tracking)
    internal: bool = False
    # distributed-trace context (common/tracer.TraceContext): stamped at
    # dispatch, activated by the daemon when the queued op actually runs,
    # so the primary's spans stitch under the client's trace id
    trace: object = None


@dataclass
class MOSDOpReply:
    """(src/messages/MOSDOpReply.h): overall result + per-op rval/outdata."""
    result: int
    ops: list[OSDOp]
    version: int = 0

    def outdata(self, i: int = 0):
        return self.ops[i].outdata
