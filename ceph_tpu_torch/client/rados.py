"""librados facade: the Rados/IoCtx API surface.

Analog of the reference's librados C++/Python bindings (reference:
src/librados/librados_cxx.cc — IoCtx::operate :1482, rados_write in
librados_c.cc:1111; src/pybind/rados/rados.pyx shapes the method names):
a ``Rados`` handle opens ``IoCtx``s bound to pools; each IoCtx exposes
whole-object I/O, op vectors, xattrs, omap, snapshots, and watch/notify,
all routed through the Objecter's full client lifecycle (epoch-stamped
targets, stale rejects, resend on map change).

The port's copy of ``ceph_tpu.client.rados``.
"""
from __future__ import annotations

import itertools

from ..osd.osd_ops import (OP_CALL, OP_LIST_WATCHERS, OP_NOTIFY,
                           OP_UNWATCH, OP_WATCH, ObjectOperation,
                           WRITE_OPS)
from .objecter import Objecter

# ops that must always target the HEAD regardless of set_read (librados
# snap_set_read affects READS only; watches live on the head)
_HEAD_ONLY = WRITE_OPS | {OP_CALL, OP_WATCH, OP_UNWATCH, OP_NOTIFY,
                          OP_LIST_WATCHERS}

# watch cookies must be unique across ALL handles: the PG keys watchers
# by cookie alone, so per-IoCtx counters would collide between clients
_cookies = itertools.count(1)


class ObjectNotFound(IOError):
    pass


def _raise(e: IOError):
    if getattr(e, "errno", None) == -2:
        err = ObjectNotFound(str(e))
        err.errno = -2
        raise err from None
    raise e


class Completion:
    """An in-flight async op (librados::AioCompletion): poll
    ``is_complete`` or ``wait_for_complete`` (pumping the cluster's
    queues), then read ``result``/``reply``."""

    def __init__(self, cluster, pg_group):
        self._cluster = cluster
        self._g = pg_group
        self.reply = None
        self._callbacks: list = []

    @property
    def is_complete(self) -> bool:
        return self.reply is not None

    @property
    def result(self) -> int:
        """The op's result; raises while incomplete — defaulting to 0
        here would report success for a write that never applied."""
        if self.reply is None:
            raise ValueError("op not complete; poll is_complete")
        return self.reply.result

    def set_complete_callback(self, fn) -> None:
        if self.reply is not None:
            fn(self)
        else:
            self._callbacks.append(fn)

    def _done(self, reply) -> None:
        self.reply = reply
        for fn in self._callbacks:
            fn(self)
        self._callbacks.clear()

    def wait_for_complete(self) -> int:
        """Drive the daemon + bus until the op completes.  An op parked
        on an inactive PG cannot complete yet: raises BlockedWriteError
        (queued, not lost — it commits when the PG reactivates) instead
        of faking a success code."""
        daemon = self._cluster.osds[self._g.backend.whoami]
        daemon.drain()
        self._g.bus.deliver_all()
        if not self.is_complete:
            from ..cluster import BlockedWriteError
            raise BlockedWriteError("op parked on an inactive PG")
        return self.result


class Rados:
    """The cluster handle (librados::Rados)."""

    def __init__(self, cluster):
        self.cluster = cluster
        self.objecter = Objecter(cluster)
        if getattr(cluster, "monitor", None) is not None:
            self.objecter.attach(cluster.monitor)

    def open_ioctx(self, pool_name: str) -> "IoCtx":
        pool_id = self.cluster.pool_ids.get(pool_name)
        if pool_id is None:
            raise ValueError(f"no pool named {pool_name!r}")
        return IoCtx(self, pool_id)

    def pool_list(self) -> list[str]:
        return sorted(self.cluster.pool_ids)

    def cluster_stat(self) -> dict:
        return self.cluster.status()

    def health(self) -> dict:
        return self.cluster.health()

    def shutdown(self) -> None:
        """librados rados_shutdown: release the objecter's perf
        collection and live registration (a discarded handle must not
        keep exporting a frozen inflight gauge)."""
        self.objecter.close()

    # context-manager sugar: `with Rados(c) as r: ...` shuts down
    def __enter__(self) -> "Rados":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()


class IoCtx:
    """One pool's I/O context (librados::IoCtx)."""

    def __init__(self, rados: Rados, pool_id: int):
        self.rados = rados
        self.pool_id = pool_id
        self.snap_read: int | None = None     # set_read at a snap

    def _effective_snapid(self, op: ObjectOperation) -> int | None:
        """set_read's snapid for pure-read vectors; head otherwise
        (ONE copy of the librados snap_set_read rule)."""
        return (None if any(o.op in _HEAD_ONLY for o in op.ops)
                else self.snap_read)

    # -- op vectors (IoCtx::operate) ----------------------------------------

    def operate(self, oid: str, op: ObjectOperation):
        """Synchronous operate through the Objecter's full client
        lifecycle (epoch/resend); returns the MOSDOpReply.  set_read's
        snapid applies to pure-read vectors only — writes, cls calls,
        and watch ops always target the head (librados snap_set_read
        semantics)."""
        out: list = []
        tid = self.rados.objecter.operate(self.pool_id, oid, op,
                                          on_complete=out.append,
                                          snapid=self._effective_snapid(op))
        if not out:
            # parked on an inactive PG: it stays queued at the OSD and
            # commits when shards return (put()'s semantics) — but it
            # must leave the objecter's inflight list NOW, or a map
            # change would RESEND it and a non-idempotent op (append,
            # omap mutation) could apply twice
            self.rados.objecter.inflight.pop(tid, None)
            from ..cluster import BlockedWriteError
            raise BlockedWriteError(
                f"op on {oid} blocked: PG inactive (queued, not lost)")
        reply = out[0]
        if isinstance(reply, Exception):
            _raise(reply if isinstance(reply, IOError)
                   else IOError(str(reply)))
        if reply.result < 0:
            err = IOError(f"op on {oid} failed: result {reply.result}")
            err.errno = reply.result
            err.reply = reply
            _raise(err)
        return reply

    def aio_operate(self, oid: str, op: ObjectOperation) -> Completion:
        """Async operate (librados aio_operate): the op is QUEUED on the
        primary's daemon without draining; the returned Completion fires
        when the reply lands (wait_for_complete pumps the queues).
        Shares operate()'s snap_read/head-only logic and the Objecter's
        epoch-stamped lifecycle."""
        cluster = self.rados.cluster
        g = cluster.pg_group(self.pool_id, oid)
        comp = Completion(cluster, g)
        tid = self.rados.objecter.operate(
            self.pool_id, oid, op, on_complete=comp._done,
            snapid=self._effective_snapid(op), drain=False)
        # A queued op must NOT stay resendable: with no OSD-side reqid
        # dedup, a map change while it sits undrained would double-apply
        # a non-idempotent vector (same queued-not-lost choice the sync
        # path makes for parked ops).  It also pins the op to the PG
        # group captured in the Completion — the one wait_for_complete
        # pumps.
        self.rados.objecter.inflight.pop(tid, None)
        return comp

    # -- whole-object convenience -------------------------------------------

    def write_full(self, oid: str, data: bytes) -> None:
        self.operate(oid, ObjectOperation().write_full(data))

    def write(self, oid: str, data: bytes, offset: int = 0) -> None:
        self.operate(oid, ObjectOperation().write(offset, data))

    def append(self, oid: str, data: bytes) -> None:
        self.operate(oid, ObjectOperation().append(data))

    def read(self, oid: str, length: int = 0, offset: int = 0) -> bytes:
        r = self.operate(oid, ObjectOperation().read(offset, length))
        return r.outdata(0)

    def stat(self, oid: str) -> tuple[int, float]:
        return self.operate(oid, ObjectOperation().stat()).outdata(0)

    def remove_object(self, oid: str) -> None:
        self.operate(oid, ObjectOperation().remove())

    def list_objects(self) -> list[str]:
        from ..osd.hit_set import is_hit_set_oid
        from ..osd.primary_log_pg import is_clone_oid
        return sorted(o for o in
                      self.rados.cluster.objects.get(self.pool_id, ())
                      if not is_clone_oid(o) and not is_hit_set_oid(o))

    # -- xattrs --------------------------------------------------------------

    def get_xattr(self, oid: str, name: str):
        return self.operate(oid, ObjectOperation().getxattr(name)).outdata(0)

    def set_xattr(self, oid: str, name: str, value) -> None:
        self.operate(oid, ObjectOperation().setxattr(name, value))

    def rm_xattr(self, oid: str, name: str) -> None:
        self.operate(oid, ObjectOperation().rmxattr(name))

    def get_xattrs(self, oid: str) -> dict:
        return self.operate(oid, ObjectOperation().getxattrs()).outdata(0)

    # -- omap ---------------------------------------------------------------

    def omap_set(self, oid: str, kvs: dict) -> None:
        self.operate(oid, ObjectOperation().omap_set(kvs))

    def omap_get_vals(self, oid: str, **kw) -> dict:
        return self.operate(oid,
                            ObjectOperation().omap_get_vals(**kw)).outdata(0)

    # -- snapshots (IoCtx snap_create/remove/rollback/set_read) -------------

    def snap_create(self, name: str) -> int:
        return self.rados.cluster.create_pool_snap(self.pool_id, name)

    def snap_remove(self, name: str) -> None:
        self.rados.cluster.remove_pool_snap(self.pool_id, name)

    def snap_list(self) -> dict[int, str]:
        return dict(self.rados.cluster.pools[self.pool_id]["pool"].snaps)

    def snap_lookup(self, name: str) -> int:
        for sid, n in self.snap_list().items():
            if n == name:
                return sid
        raise KeyError(name)

    def snap_rollback(self, oid: str, name: str) -> None:
        self.operate(oid, ObjectOperation().rollback(self.snap_lookup(name)))

    def set_read(self, snapid: int | None) -> None:
        """Subsequent reads resolve at this snap (SNAP_HEAD = None)."""
        self.snap_read = snapid

    # -- watch/notify --------------------------------------------------------

    def watch(self, oid: str, on_notify, cookie: int | None = None) -> int:
        if cookie is None:
            cookie = next(_cookies)       # unique across ALL handles
        self.operate(oid, ObjectOperation().watch(cookie, on_notify))
        return cookie

    def unwatch(self, oid: str, cookie: int) -> None:
        self.operate(oid, ObjectOperation().unwatch(cookie))

    def notify(self, oid: str, payload: bytes = b"") -> dict:
        return self.operate(oid,
                            ObjectOperation().notify(payload)).outdata(0)
