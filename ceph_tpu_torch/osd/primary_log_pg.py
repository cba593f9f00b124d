"""The primary's object-op engine: PrimaryLogPG's do_osd_ops analog.

Executes a client op vector (``MOSDOp``) against one object, atomically:
reads resolve against the (possibly degraded) PG via the backend's
reconstructing read path, mutations stage into ONE ``PGTransaction`` that
rides the backend's ordered write pipeline (min_size gate, rollback,
recovery — all below this layer).

Reference call stack (SURVEY §3.1): PrimaryLogPG::do_request → do_op →
execute_ctx → do_osd_ops (the giant opcode switch,
src/osd/PrimaryLogPG.cc:5577) → prepare_transaction → issue_repop →
PGBackend::submit_transaction (src/osd/PrimaryLogPG.cc:1565,1756,3709,
8319,10422).  Object metadata is an ``object_info_t`` xattr "_" on every
shard and user xattrs are stored "_"-prefixed, both exactly like the
reference (src/osd/osd_types.h OI_ATTR).

Implemented surfaces: data/metadata reads, the write family, xattr and
omap ops with guards, object classes (cls registry), snapshots
(SnapContext COW + snap reads + rollback + list_snaps) and watch/notify.

Scope notes (deliberate divergences, all returning clean errors):
- cache tiering lives in osd/hit_set.py (per-period bloom hit sets
  accumulated here, archived as internal PG objects) + osd/tiering.py
  (writeback CacheTier facade + flush/evict TieringAgent); the in-engine
  proxy/flush OPS of the reference (COPY_FROM, CACHE_FLUSH/EVICT
  opcodes) stay out of the opcode switch — the facade + agent carry the
  same semantics at pool level;
- data READs inside a *write* vector are rejected with -EINVAL on EC
  pools (the reference queues them as pending_async_reads; here a vector
  is either data-reading or mutating — metadata reads work in both);
- CEPH_OSD_OP_ZERO never extends the object (the reference's behavior
  with the default truncate_seq handling);
- ROLLBACK must be the only mutation in its vector.

Ordering: mutating vectors take a per-object in-flight slot; any later op
on the same object queues until the commit callback fires — the obc
rw-lock ordering of the reference collapsed to its observable effect.

A copy of ``ceph_tpu.osd.primary_log_pg``: the op engine is host code;
its writes and reconstructing reads reach the card through the
backend below it.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable

from ..backend.memstore import GObject
from ..backend.transaction import PGTransaction
from .osd_ops import (
    CMPXATTR_EQ, CMPXATTR_GT, CMPXATTR_GTE, CMPXATTR_LT, CMPXATTR_LTE,
    CMPXATTR_MODE_STRING, CMPXATTR_MODE_U64, CMPXATTR_NE, DATA_READ_OPS,
    MOSDOp, MOSDOpReply, OP_APPEND, OP_CALL, OP_CMPEXT, OP_CMPXATTR,
    OP_CREATE, OP_DELETE, OP_GETXATTR, OP_GETXATTRS, OP_OMAPCLEAR,
    OP_OMAPGETHEADER, OP_OMAPGETKEYS, OP_OMAPGETVALS, OP_OMAPGETVALSBYKEYS,
    OP_LIST_SNAPS, OP_LIST_WATCHERS, OP_NOTIFY, OP_OMAPRMKEYS,
    OP_OMAPSETHEADER, OP_OMAPSETVALS,
    OP_OMAP_CMP, OP_READ, OP_RMXATTR, OP_ROLLBACK, OP_SETXATTR,
    OP_SPARSE_READ, OP_STAT, OP_TRUNCATE, OP_UNWATCH, OP_WATCH,
    OP_WRITE, OP_WRITEFULL, OP_ZERO, OSDOp, WRITE_OPS,
)

# errnos, negated like the reference's rvals
ENOENT, EEXIST, EINVAL = -2, -17, -22
ENODATA = -61
EOPNOTSUPP = -95
ECANCELED = -125
EROFS = -30
ENOTSUP_COMBINED = -22    # rollback combined with other mutations
MAX_ERRNO = 4095          # cmpext mismatch: -(MAX_ERRNO + offset)

OI_ATTR = "_"             # object_info_t xattr (src/osd/osd_types.h)
SS_ATTR = "snapset"       # SnapSet xattr (src/osd/osd_types.h SS_ATTR)
USER_PREFIX = "_"         # user xattr "foo" is stored as "_foo"
SNAP_SEP = "\x00snap\x00"  # clone object namespace (ghobject snap field
                           # analog; NUL keeps user oids collision-free)


def clone_oid(oid: str, snapid: int) -> str:
    return f"{oid}{SNAP_SEP}{snapid}"


def is_clone_oid(oid: str) -> bool:
    return SNAP_SEP in oid


def split_clone_oid(oid: str) -> tuple[str, int] | None:
    """(head, snapid) for a clone oid, None for a head."""
    if SNAP_SEP not in oid:
        return None
    head, _, cid = oid.rpartition(SNAP_SEP)
    return head, int(cid)


def empty_snapset() -> dict:
    # lbs[c] = snapset.seq at clone c's creation: clone c covers exactly
    # the snaps in (lbs[c], c] — the analog of the reference SnapSet's
    # per-clone clone_snaps list (src/osd/osd_types.h SnapSet), which is
    # what lets reads at PRE-creation snaps resolve to ENOENT even after
    # later clones exist
    return {"seq": 0, "clones": [], "sizes": {}, "lbs": {}}


def clone_lower_bound(ss: dict, c: int) -> int:
    """The oldest snap NOT covered by clone c (0 = covers everything
    below c; legacy snapsets without lbs keep the old semantics)."""
    lbs = ss.get("lbs", {})
    return lbs.get(c, lbs.get(str(c), 0))
# non-user attrs that share the "_" prefix (internal attrs otherwise use
# non-"_" prefixes — e.g. the replicated backend's "@version" — so they
# cannot collide with any user name)
INTERNAL_ATTRS = frozenset({OI_ATTR})


class OpError(Exception):
    def __init__(self, rval: int):
        self.rval = rval


@dataclass
class ClsMethod:
    fn: Callable
    mutates: bool


class ClsRegistry:
    """Object-class method registry (the reference's loadable cls plugins,
    src/cls/ + PrimaryLogPG's CEPH_OSD_OP_CALL dispatch)."""

    _methods: dict[tuple[str, str], ClsMethod] = {}

    @classmethod
    def register(cls, cls_name: str, method: str, fn: Callable,
                 mutates: bool = False) -> None:
        cls._methods[(cls_name, method)] = ClsMethod(fn, mutates)

    @classmethod
    def get(cls, cls_name: str, method: str) -> ClsMethod | None:
        return cls._methods.get((cls_name, method))


class ClsContext:
    """What a cls method sees: the op's staged object state."""

    def __init__(self, ectx: "_ExecCtx", indata: bytes):
        self._ctx = ectx
        self.indata = indata
        self.oid = ectx.m.oid

    def exists(self) -> bool:
        return self._ctx.exists

    def size(self) -> int:
        return self._ctx.size

    def getxattr(self, name: str):
        return self._ctx.get_attr(USER_PREFIX + name)

    # mutations stage into the surrounding op vector's transaction
    def setxattr(self, name: str, value) -> None:
        self._ctx.stage_attr(USER_PREFIX + name, value)

    def write_full(self, data: bytes) -> None:
        self._ctx.stage_write_full(data)

    def append(self, data: bytes) -> None:
        self._ctx.stage_write(self._ctx.size, data)


@dataclass
class _ExecCtx:
    """Mutable execute state: the reference's OpContext (new_obs + op_t)."""
    m: MOSDOp
    engine: "PrimaryLogPG"
    exists: bool
    size: int
    attrs: dict = field(default_factory=dict)       # overlay: name -> v|None
    attrs_cleared: bool = False     # staged delete dropped the base attrs
    omap: dict = field(default_factory=dict)        # overlay: key -> v|None
    omap_cleared: bool = False
    omap_header: bytes | None = None
    t: PGTransaction = field(default_factory=PGTransaction)
    mutated: bool = False
    user_modify: bool = False
    # watch/unwatch effects staged until the vector SUCCEEDS (the
    # reference's do_osd_op_effects runs only on success)
    watch_effects: list = field(default_factory=list)

    # -- staged-state readers ---------------------------------------------

    def _gobj(self) -> GObject:
        return GObject(self.m.oid, self.engine.backend.whoami)

    def get_attr(self, name: str):
        """Committed attr overlaid with this vector's staged updates."""
        if name in self.attrs:
            if self.attrs[name] is None:
                raise KeyError(name)
            return self.attrs[name]
        if self.attrs_cleared:      # staged delete: base attrs are gone
            raise KeyError(name)
        store = self.engine.backend.local_shard.store
        gobj = self._gobj()
        if not store.exists(gobj):
            raise KeyError(name)
        return store.getattr(gobj, name)

    def get_attrs(self) -> dict:
        store = self.engine.backend.local_shard.store
        gobj = self._gobj()
        base = ({} if self.attrs_cleared or not store.exists(gobj)
                else store.getattrs(gobj))
        base.update({k: v for k, v in self.attrs.items() if v is not None})
        for k, v in self.attrs.items():
            if v is None:
                base.pop(k, None)
        return base

    def get_omap(self) -> dict:
        store = self.engine.backend.local_shard.store
        gobj = self._gobj()
        base = ({} if self.omap_cleared or not store.exists(gobj)
                else store.get_omap(gobj))
        base.update({k: v for k, v in self.omap.items() if v is not None})
        for k, v in self.omap.items():
            if v is None:
                base.pop(k, None)
        return base

    def get_omap_header(self) -> bytes:
        if self.omap_header is not None:
            return self.omap_header
        if self.omap_cleared:
            return b""
        store = self.engine.backend.local_shard.store
        gobj = self._gobj()
        return store.get_omap_header(gobj) if store.exists(gobj) else b""

    # -- staged-state writers ----------------------------------------------

    def objop(self):
        return self.t.touch(self.m.oid)

    def stage_attr(self, name: str, value) -> None:
        self.attrs[name] = value
        if value is None:
            self.objop().rmattr(name)
        else:
            self.objop().setattr(name, value)
        self.mutated = True

    def stage_write(self, offset: int, data: bytes) -> None:
        self.objop().write(offset, data)
        self.size = max(self.size, offset + len(data))
        self.exists = True
        self.mutated = self.user_modify = True

    def stage_write_full(self, data: bytes) -> None:
        op = self.objop()
        op.buffer_updates = [(0, bytes(data))]
        op.truncate = (len(data), len(data))
        self.size = len(data)
        self.exists = True
        self.mutated = self.user_modify = True

    def stage_truncate(self, size: int) -> None:
        op = self.objop()
        # clip staged writes beyond the new size so a write-then-truncate
        # vector ends at exactly `size` (the reference applies ops in
        # order inside one transaction)
        clipped = []
        for off, data in op.buffer_updates:
            if off >= size:
                continue
            clipped.append((off, data[:size - off]) if off + len(data) > size
                           else (off, data))
        op.buffer_updates = clipped
        op.truncate = (size, size)
        self.size = size
        self.exists = True
        self.mutated = self.user_modify = True

    def stage_omap(self, kind: str, *args) -> None:
        self.objop().omap_ops.append((kind, *args))
        self.mutated = self.user_modify = True


class PrimaryLogPG:
    """The op engine bound to one PG's backend."""

    def __init__(self, backend, pool_type: str = "ec"):
        self.backend = backend
        self.pool_type = pool_type
        self.version = 0            # pg op version (eversion_t analog)
        self.user_version = 0
        self._busy: set[str] = set()
        self._waiting: dict[str, deque] = {}
        # watch/notify state (the obc watchers map, src/osd/Watch.cc)
        self.watchers: dict[str, dict[int, object]] = {}
        self.notify_id = 0
        # hit-set accumulation (PrimaryLogPG.h:952-966); configured by
        # the pool's hit_set_* params via configure_hit_sets
        self.hit_set = None
        self.hit_set_params: dict | None = None
        self.hit_set_archive_n = 0
        self._hit_set_ops = 0

    # -- hit sets (hit_set_setup/persist/trim, PrimaryLogPG.h:957-961) ------

    def configure_hit_sets(self, count: int, period: int,
                           target_size: int = 1000,
                           fpp: float = 0.05) -> None:
        """hit_set_setup: start accumulating per-period bloom hit sets,
        archived as internal PG objects in a ring of ``count``.  The
        period counts OPS (deterministic in-process; the reference uses
        wall-clock seconds — see osd/hit_set.py)."""
        from .hit_set import HIT_SET_PREFIX, BloomHitSet, is_hit_set_oid
        self.hit_set_params = {"count": int(count), "period": int(period),
                               "target_size": int(target_size),
                               "fpp": float(fpp)}
        self.hit_set = BloomHitSet(target_size, fpp)
        self._hit_set_ops = 0
        # restart: resume the archive ring after the persisted ones
        store = self.backend.local_shard.store
        ns = [int(g.oid[len(HIT_SET_PREFIX):])
              for g in store.list_objects()
              if g.shard == self.backend.whoami and is_hit_set_oid(g.oid)]
        self.hit_set_archive_n = max(ns, default=-1) + 1

    def _hit_set_record(self, oid: str) -> None:
        from .hit_set import is_hit_set_oid
        if self.hit_set is None or is_hit_set_oid(oid):
            return
        parsed = split_clone_oid(oid)
        self.hit_set.insert(parsed[0] if parsed else oid)
        self._hit_set_ops += 1
        if self._hit_set_ops >= self.hit_set_params["period"]:
            self.hit_set_persist()

    def hit_set_persist(self) -> None:
        """Archive the accumulating set as an internal PG object and trim
        the ring past hit_set_count (hit_set_persist + hit_set_trim)."""
        from .hit_set import BloomHitSet, archive_oid
        p = self.hit_set_params
        n = self.hit_set_archive_n
        self.hit_set_archive_n += 1
        t = PGTransaction().write(archive_oid(n), 0,
                                  self.hit_set.to_bytes())
        old = n - p["count"]
        if old >= 0:
            t.delete(archive_oid(old))
        self.backend.submit_transaction(t)
        self._hit_set_ops = 0
        self.hit_set = BloomHitSet(p["target_size"], p["fpp"])

    def hit_set_archives(self) -> list:
        """The persisted ring, oldest first (agent_load_hit_sets)."""
        from .hit_set import BloomHitSet, archive_oid
        if self.hit_set_params is None:
            return []
        store = self.backend.local_shard.store
        out = []
        lo = max(0, self.hit_set_archive_n - self.hit_set_params["count"])
        for n in range(lo, self.hit_set_archive_n):
            gobj = GObject(archive_oid(n), self.backend.whoami)
            if store.exists(gobj):
                out.append(BloomHitSet.from_bytes(bytes(
                    store.read(gobj))))
        return out

    def object_temperature(self, oid: str) -> int:
        """How many recent hit sets (current + archives) saw this object
        (agent_estimate_temp: 0 = cold, eviction candidate)."""
        temp = 0
        if self.hit_set is not None and self.hit_set.contains(oid):
            temp += 1
        for hs in self.hit_set_archives():
            if hs.contains(oid):
                temp += 1
        return temp

    # -- entry -------------------------------------------------------------

    def do_op(self, m: MOSDOp, on_reply: Callable[[MOSDOpReply], None]):
        """Execute one client op vector; on_reply fires with the reply —
        immediately for pure reads, at commit for mutations."""
        if not m.internal:
            self._hit_set_record(m.oid)
        if m.oid in self._busy:
            self._waiting.setdefault(m.oid, deque()).append((m, on_reply))
            return
        self._start(m, on_reply)

    def _op_mutates(self, op: OSDOp) -> bool:
        if op.op in WRITE_OPS:
            return True
        if op.op == OP_CALL:
            meth = ClsRegistry.get(op.params["cls"], op.params["method"])
            return bool(meth and meth.mutates)
        return False

    def _load_snapset(self, oid: str) -> dict:
        """The head's SnapSet.  An existing head without the attr simply
        has no clones (cheap).  Only a MISSING head (deleted under
        snapshots — the reference keeps a snapdir object for this case)
        pays a store scan to rediscover its clones."""
        store = self.backend.local_shard.store
        gobj = GObject(oid, self.backend.whoami)
        if store.exists(gobj):
            try:
                return dict(store.getattr(gobj, SS_ATTR))
            except KeyError:
                return empty_snapset()
        prefix = oid + SNAP_SEP
        clones = sorted(
            int(g.oid[len(prefix):]) for g in store.list_objects()
            if g.shard == self.backend.whoami and g.oid.startswith(prefix))
        ss = empty_snapset()
        ss["seq"] = max(clones, default=0)
        ss["clones"] = clones
        # per-clone lower bounds survive head deletion because each clone
        # is a copy of the PRE-COW head, whose own SS_ATTR recorded the
        # snapset.seq of that moment — exactly lbs[c].  (The reference
        # keeps a snapdir object for the deleted-head case instead.)
        for c in clones:
            try:
                old_ss = dict(store.getattr(
                    GObject(clone_oid(oid, c), self.backend.whoami),
                    SS_ATTR))
                ss["lbs"][c] = int(old_ss.get("seq", 0))
            except KeyError:
                pass                 # clone predates lbs / no snap context
        return ss

    def _resolve_snap(self, oid: str, snapid: int) -> str | None:
        """find_object_context's snap resolution: clone c covers the snap
        interval (lbs[c], c]; a read at snap s hits the oldest clone >= s
        IF s falls inside its coverage, else the head.  None = the object
        did not exist at that snap (it postdates the creation seq stamped
        on the snapset, or falls below the covering clone's lower bound)
        -> ENOENT."""
        ss = self._load_snapset(oid)
        for c in sorted(ss["clones"]):
            if c >= snapid:
                if snapid <= clone_lower_bound(ss, c):
                    # the clone postdates the object's creation at snapid
                    # (e.g. snap taken, THEN object created, THEN cloned):
                    # no state existed at snapid
                    return None
                return clone_oid(oid, c)
        if snapid <= ss["seq"]:
            return None
        return oid

    def _start(self, m: MOSDOp, on_reply) -> None:
        has_write = any(self._op_mutates(op) for op in m.ops)
        if m.snapid is not None:
            # snaps are read-only; resolve the whole vector onto the
            # covering clone (or the head)
            if has_write:
                on_reply(MOSDOpReply(EROFS, m.ops))
                return
            if any(op.op in (OP_WATCH, OP_UNWATCH, OP_NOTIFY,
                             OP_LIST_WATCHERS) for op in m.ops):
                # watches live on the HEAD; registering one under a
                # resolved clone oid would leak an unreachable entry
                on_reply(MOSDOpReply(EINVAL, m.ops))
                return
            resolved = self._resolve_snap(m.oid, m.snapid)
            if resolved is None:        # object postdates the snap
                on_reply(MOSDOpReply(ENOENT, m.ops))
                return
            m.oid = resolved
        if has_write:
            # take the per-object write slot BEFORE any async hop: a
            # second vector arriving while this one's data read is in
            # flight must queue, or both would read the same pre-state
            # and commit out of order (the obc write-lock ordering)
            self._busy.add(m.oid)
        data_reads = [op for op in m.ops if op.op in DATA_READ_OPS]
        oi = self._load_oi(m.oid)
        if data_reads:
            if has_write and self.pool_type == "ec":
                for op in m.ops:
                    op.rval = EINVAL
                self._finish(m, MOSDOpReply(EINVAL, m.ops),
                             has_write, on_reply)
                return
            if oi is None:
                self._finish(m, MOSDOpReply(ENOENT, m.ops),
                             has_write, on_reply)
                return
            extents = []
            for op in data_reads:
                off = op.params["offset"]
                length = op.params.get("length",
                                       len(op.params.get("data", b"")))
                if length == 0 and op.op != OP_CMPEXT:
                    length = max(oi["size"] - off, 0)   # len 0 = to end
                extents.append((off, length))

            def _got(result, errors):
                if errors:
                    self._finish(m, MOSDOpReply(EINVAL, m.ops),
                                 has_write, on_reply)
                    return
                got = {(off, ln): data
                       for off, ln, data in result.get(m.oid, [])}
                self._execute(m, oi, got, has_write, on_reply)
            self.backend.objects_read_and_reconstruct(
                {m.oid: extents}, lambda result, errors: _got(result, errors))
        else:
            self._execute(m, oi, {}, has_write, on_reply)

    # -- the opcode switch (do_osd_ops) ------------------------------------

    def _execute(self, m: MOSDOp, oi, readdata, has_write, on_reply) -> None:
        ctx = _ExecCtx(m=m, engine=self,
                       exists=oi is not None,
                       size=oi["size"] if oi else 0)
        # make_writable (PrimaryLogPG::make_writable): first mutation of
        # an existing head under a NEWER snap context clones the pre-op
        # state to <oid>@<newest snap> — copy-on-write at snap boundaries
        if has_write and m.snapc is not None and not is_clone_oid(m.oid):
            if ctx.exists:
                ss = self._load_snapset(m.oid)
                if m.snapc.seq > ss["seq"] and m.snapc.snaps:
                    newest = max(m.snapc.snaps)
                    ctx.objop().clone_to.append(clone_oid(m.oid, newest))
                    ss["clones"] = sorted(set(ss["clones"]) | {newest})
                    ss["sizes"] = dict(ss["sizes"])
                    ss["sizes"][newest] = ctx.size
                    # the clone covers (old seq, newest]: snaps at or
                    # below the pre-clone seq belong to older clones (or
                    # predate the object entirely)
                    ss["lbs"] = dict(ss.get("lbs", {}))
                    ss["lbs"][newest] = ss["seq"]
                    ss["seq"] = m.snapc.seq
                    ctx.stage_attr(SS_ATTR, ss)
            else:
                # creation under a snap context stamps the seq so reads
                # at PRE-creation snaps resolve to ENOENT, not to the
                # head (the reference stamps snapset.seq the same way).
                # _load_snapset DISCOVERS orphaned clones of a deleted
                # head, so re-creation keeps its snap history (snapdir).
                ss = self._load_snapset(m.oid)
                ss["seq"] = max(ss["seq"], m.snapc.seq)
                ctx.stage_attr(SS_ATTR, ss)
        result = 0
        try:
            for op in m.ops:
                op.rval = self._do_one(ctx, op, oi, readdata)
        except OpError as e:
            result = e.rval
        if result != 0 or not ctx.mutated:
            if result == 0:
                self._apply_watch_effects(ctx)    # do_osd_op_effects
            self._finish(m, MOSDOpReply(result, m.ops), has_write, on_reply)
            return
        # prepare_transaction: persist object_info on every shard with the
        # data (atomically — it rides the same PGTransaction)
        self.version += 1
        if ctx.user_modify:
            self.user_version += 1
        objop = ctx.t.touch(m.oid)
        if ctx.exists:
            objop.setattr(OI_ATTR, {
                "size": ctx.size, "version": self.version,
                "user_version": self.user_version, "mtime": time.time()})
        version = self.version
        deleted = not ctx.exists

        def _committed(tid):
            if deleted:
                # a deleted object loses its watchers (Watch.cc discard)
                self.watchers.pop(m.oid, None)
            self._apply_watch_effects(ctx)        # do_osd_op_effects
            self._finish(m, MOSDOpReply(0, m.ops, version=version),
                         has_write, on_reply)
        self.backend.submit_transaction(ctx.t, on_commit=_committed)

    def _apply_watch_effects(self, ctx: _ExecCtx) -> None:
        for eff in ctx.watch_effects:
            if eff[0] == "watch":
                self.watchers.setdefault(ctx.m.oid, {})[eff[1]] = eff[2]
            elif eff[0] == "unwatch":
                self.watchers.get(ctx.m.oid, {}).pop(eff[1], None)
            else:                                   # notify
                _, payload, notify_op = eff
                self.notify_id += 1
                acks = {}
                for cookie, fn in sorted(self.watchers.get(ctx.m.oid,
                                                           {}).items()):
                    try:
                        acks[cookie] = fn(self.notify_id, cookie, payload)
                    except Exception as e:  # one bad watcher can't block
                        acks[cookie] = e    # the notify (timeout analog)
                notify_op.outdata = acks

    def _finish(self, m, reply, has_write, on_reply) -> None:
        if has_write:
            self._busy.discard(m.oid)
        on_reply(reply)
        q = self._waiting.get(m.oid)
        while q and m.oid not in self._busy:
            nm, cb = q.popleft()
            self._start(nm, cb)
        if q is not None and not q:
            self._waiting.pop(m.oid, None)

    def _load_oi(self, oid: str) -> dict | None:
        store = self.backend.local_shard.store
        gobj = GObject(oid, self.backend.whoami)
        if not store.exists(gobj):
            return None
        try:
            return dict(store.getattr(gobj, OI_ATTR))
        except KeyError:
            # object written below the op-engine layer (e.g. MiniCluster.put)
            return {"size": self.backend.object_size(oid),
                    "version": 0, "user_version": 0, "mtime": 0.0}

    def _require(self, ctx: _ExecCtx) -> None:
        if not ctx.exists:
            raise OpError(ENOENT)

    def _do_one(self, ctx: _ExecCtx, op: OSDOp, oi, readdata) -> int:
        p = op.params
        kind = op.op

        # ---- data reads (pre-fetched through the reconstructing path)
        if kind in (OP_READ, OP_SPARSE_READ):
            self._require(ctx)
            off = p["offset"]
            length = p["length"] or max((oi["size"] if oi else 0) - off, 0)
            data = readdata.get((off, length), b"")[:length]
            op.outdata = ({off: bytes(data)} if kind == OP_SPARSE_READ
                          else bytes(data))
            return len(data)
        if kind == OP_CMPEXT:
            self._require(ctx)
            off, want = p["offset"], p["data"]
            got = bytes(readdata.get((off, len(want)), b""))
            got = got.ljust(len(want), b"\0")
            if got != want:
                mism = next(i for i in range(len(want)) if got[i] != want[i])
                raise OpError(-(MAX_ERRNO + mism))
            return len(want)

        # ---- metadata reads
        if kind == OP_STAT:
            self._require(ctx)
            op.outdata = (ctx.size, (oi or {}).get("mtime", 0.0))
            return 0
        if kind == OP_GETXATTR:
            if not p["name"]:
                raise OpError(EINVAL)   # "" would alias OI_ATTR
            self._require(ctx)
            try:
                op.outdata = ctx.get_attr(USER_PREFIX + p["name"])
            except KeyError:
                raise OpError(ENODATA)
            return 0
        if kind == OP_GETXATTRS:
            self._require(ctx)
            op.outdata = {k[len(USER_PREFIX):]: v
                          for k, v in ctx.get_attrs().items()
                          if k.startswith(USER_PREFIX)
                          and k not in INTERNAL_ATTRS}
            return 0
        if kind == OP_CMPXATTR:
            if not p["name"]:
                raise OpError(EINVAL)
            self._require(ctx)
            try:
                have = ctx.get_attr(USER_PREFIX + p["name"])
            except KeyError:
                raise OpError(ECANCELED if p["mode"] == CMPXATTR_MODE_STRING
                              else ENODATA)
            if p["mode"] == CMPXATTR_MODE_U64:
                try:
                    have = int(have)
                except (TypeError, ValueError):
                    raise OpError(EINVAL)
            ok = {CMPXATTR_EQ: have == p["value"],
                  CMPXATTR_NE: have != p["value"],
                  CMPXATTR_GT: have > p["value"],
                  CMPXATTR_GTE: have >= p["value"],
                  CMPXATTR_LT: have < p["value"],
                  CMPXATTR_LTE: have <= p["value"]}.get(p["cmp"])
            if ok is None:
                raise OpError(EINVAL)
            if not ok:
                raise OpError(ECANCELED)
            return 1

        # ---- omap (replicated pools only, like the reference)
        if kind.startswith("omap"):
            if self.pool_type == "ec":
                raise OpError(EOPNOTSUPP)
            return self._do_omap(ctx, op)

        # ---- mutations
        if kind == OP_CREATE:
            if ctx.exists and p.get("exclusive"):
                raise OpError(EEXIST)
            if not ctx.exists:
                ctx.stage_write(0, b"")     # touch
                ctx.size = 0
            return 0
        if kind == OP_WRITE:
            ctx.stage_write(p["offset"], p["data"])
            return 0
        if kind == OP_WRITEFULL:
            ctx.stage_write_full(p["data"])
            return 0
        if kind == OP_APPEND:
            ctx.stage_write(ctx.size, p["data"])
            return 0
        if kind == OP_ZERO:
            self._require(ctx)
            off = p["offset"]
            length = min(p["length"], max(ctx.size - off, 0))
            if length > 0:
                ctx.stage_write(off, b"\0" * length)
            return 0
        if kind == OP_TRUNCATE:
            self._require(ctx)
            ctx.stage_truncate(p["size"])
            return 0
        if kind == OP_DELETE:
            self._require(ctx)
            op_obj = ctx.objop()
            op_obj.delete_first = True
            op_obj.buffer_updates = []
            op_obj.truncate = None
            op_obj.attr_updates = {}
            op_obj.omap_ops = []
            ctx.exists = False
            ctx.size = 0
            ctx.attrs = {}
            ctx.attrs_cleared = True     # later reads must not see base
            ctx.omap = {}
            ctx.omap_cleared = True
            ctx.omap_header = None
            ctx.mutated = ctx.user_modify = True
            return 0
        if kind == OP_SETXATTR:
            if not p["name"]:
                raise OpError(EINVAL)   # "" would alias OI_ATTR
            if not ctx.exists:
                ctx.stage_write(0, b"")
            ctx.stage_attr(USER_PREFIX + p["name"], p["value"])
            return 0
        if kind == OP_RMXATTR:
            if not p["name"]:
                raise OpError(EINVAL)
            self._require(ctx)
            ctx.stage_attr(USER_PREFIX + p["name"], None)
            return 0

        # ---- watch/notify (PrimaryLogPG::do_osd_op_effects + Watch.cc:
        # watchers live on the primary; notifies fan to every watcher and
        # collect acks.  In-process, a watcher is a callback.)
        if kind == OP_WATCH:
            self._require(ctx)
            ctx.watch_effects.append(("watch", p["cookie"], p["on_notify"]))
            return 0
        if kind == OP_UNWATCH:
            ws = dict(self.watchers.get(ctx.m.oid, {}))
            for eff in ctx.watch_effects:     # staged view for validation
                if eff[0] == "watch":
                    ws[eff[1]] = eff[2]
                else:
                    ws.pop(eff[1], None)
            if p["cookie"] not in ws:
                raise OpError(ENOENT)
            ctx.watch_effects.append(("unwatch", p["cookie"]))
            return 0
        if kind == OP_NOTIFY:
            self._require(ctx)
            # staged like watch/unwatch: a FAILED vector must not have
            # delivered anything (do_osd_op_effects fires on success);
            # the effect fills op.outdata before the reply is sent
            ctx.watch_effects.append(("notify", p["payload"], op))
            return 0
        if kind == OP_LIST_WATCHERS:
            self._require(ctx)
            op.outdata = sorted(self.watchers.get(ctx.m.oid, {}))
            return 0

        # ---- snapshots
        if kind == OP_LIST_SNAPS:
            ss = self._load_snapset(ctx.m.oid)
            op.outdata = {"seq": ss["seq"],
                          "clones": [{"snapid": c,
                                      "size": ss["sizes"].get(c)}
                                     for c in sorted(ss["clones"])]}
            return 0
        if kind == OP_ROLLBACK:
            if any(o is not op and self._op_mutates(o) for o in ctx.m.ops):
                # rollback replaces the object wholesale at the store
                # level; mixing it with other mutations in one vector is
                # rejected (the reference serializes it through its own
                # transaction machinery instead)
                raise OpError(ENOTSUP_COMBINED)
            # the STAGED snapset wins: make_writable may have just COWed
            # the pre-rollback head in this very vector (rollback after a
            # newer snap) — re-reading the store would clobber that
            # update and orphan the fresh clone
            try:
                ss = dict(ctx.get_attr(SS_ATTR))
            except KeyError:
                ss = self._load_snapset(ctx.m.oid)
            cands = [c for c in sorted(ss["clones"]) if c >= p["snapid"]]
            if cands and p["snapid"] <= clone_lower_bound(ss, cands[0]):
                # the covering clone postdates the object's creation at
                # this snap: the object did not exist then — fall through
                # to the delete-the-head branch, matching what a read at
                # the snap reports (ENOENT)
                cands = []
            if not cands:
                self._require(ctx)
                if p["snapid"] <= ss["seq"]:
                    # the object did not exist at that snap (creation
                    # postdates it): rollback REMOVES the head — exactly
                    # what a read at that snap reports (the reference's
                    # _rollback_to on ENOENT deletes the head)
                    objop = ctx.objop()
                    objop.delete_first = True
                    objop.buffer_updates = []
                    objop.truncate = None
                    objop.attr_updates = {}
                    ctx.exists = False
                    ctx.size = 0
                    ctx.attrs = {}
                    ctx.attrs_cleared = True
                    ctx.omap = {}
                    ctx.omap_cleared = True
                    ctx.mutated = ctx.user_modify = True
                    return 0
                return 0    # snap postdates the head state: no-op
            src = clone_oid(ctx.m.oid, cands[0])
            snap = cands[0]
            objop = ctx.objop()
            objop.rollback_from = src
            # the clone's attrs replace the head's, EXCEPT the SnapSet:
            # the head keeps knowing all its clones (the reference's
            # snapset stays on the head/snapdir through rollback)
            objop.attr_updates[SS_ATTR] = ss
            fallback = ss["sizes"].get(snap, ss["sizes"].get(str(snap)))
            store = self.backend.local_shard.store
            try:
                src_oi = dict(store.getattr(
                    GObject(src, self.backend.whoami), OI_ATTR))
                ctx.size = src_oi["size"]
            except (FileNotFoundError, KeyError):
                ctx.size = fallback if fallback is not None else ctx.size
            ctx.exists = True             # a deleted head is recreated
            ctx.attrs_cleared = True      # head attrs replaced by clone's
            ctx.attrs = {}
            ctx.mutated = ctx.user_modify = True
            return 0

        # ---- object classes
        if kind == OP_CALL:
            meth = ClsRegistry.get(p["cls"], p["method"])
            if meth is None:
                raise OpError(EOPNOTSUPP)
            rval, out = meth.fn(ClsContext(ctx, p["indata"]))
            op.outdata = out
            if rval < 0:
                raise OpError(rval)
            return rval

        raise OpError(EOPNOTSUPP)

    def _do_omap(self, ctx: _ExecCtx, op: OSDOp) -> int:
        p = op.params
        kind = op.op
        if kind == OP_OMAPGETKEYS:
            self._require(ctx)
            keys = sorted(k for k in ctx.get_omap()
                          if k > p["start_after"])[:p["max_return"]]
            op.outdata = keys
            return 0
        if kind == OP_OMAPGETVALS:
            self._require(ctx)
            omap = ctx.get_omap()
            keys = sorted(k for k in omap if k > p["start_after"]
                          and k.startswith(p["filter_prefix"]))
            keys = keys[:p["max_return"]]
            op.outdata = {k: omap[k] for k in keys}
            return 0
        if kind == OP_OMAPGETVALSBYKEYS:
            self._require(ctx)
            omap = ctx.get_omap()
            op.outdata = {k: omap[k] for k in p["keys"] if k in omap}
            return 0
        if kind == OP_OMAPGETHEADER:
            self._require(ctx)
            op.outdata = ctx.get_omap_header()
            return 0
        if kind == OP_OMAP_CMP:
            self._require(ctx)
            omap = ctx.get_omap()
            for key, (value, cmp_op) in sorted(p["assertions"].items()):
                have = omap.get(key)
                if have is None:
                    raise OpError(ECANCELED)
                ok = {CMPXATTR_EQ: have == value, CMPXATTR_NE: have != value,
                      CMPXATTR_GT: have > value, CMPXATTR_GTE: have >= value,
                      CMPXATTR_LT: have < value, CMPXATTR_LTE: have <= value,
                      }.get(cmp_op)
                if not ok:
                    raise OpError(ECANCELED)
            return 0
        # mutations
        if not ctx.exists:
            ctx.stage_write(0, b"")
        if kind == OP_OMAPSETVALS:
            for k, v in p["kvs"].items():
                ctx.omap[k] = v
            ctx.stage_omap("set", dict(p["kvs"]))
            return 0
        if kind == OP_OMAPSETHEADER:
            ctx.omap_header = p["header"]
            ctx.stage_omap("header", p["header"])
            return 0
        if kind == OP_OMAPRMKEYS:
            for k in p["keys"]:
                ctx.omap[k] = None
            ctx.stage_omap("rm", list(p["keys"]))
            return 0
        if kind == OP_OMAPCLEAR:
            ctx.omap = {}
            ctx.omap_cleared = True
            ctx.omap_header = b""
            ctx.stage_omap("clear")
            return 0
        raise OpError(EOPNOTSUPP)


# -- built-in object classes (the reference ships src/cls/hello) -----------

def _hello_say_hello(ctx: ClsContext):
    who = ctx.indata.decode() if ctx.indata else "world"
    return 0, f"Hello, {who}!".encode()


def _hello_record_hello(ctx: ClsContext):
    who = ctx.indata.decode() if ctx.indata else "world"
    greeting = f"Hello, {who}!".encode()
    ctx.write_full(greeting)
    ctx.setxattr("recorded", b"1")
    return 0, b""


ClsRegistry.register("hello", "say_hello", _hello_say_hello, mutates=False)
ClsRegistry.register("hello", "record_hello", _hello_record_hello,
                     mutates=True)


# -- cls_lock: advisory object locks (the reference's src/cls/lock, the
# -- coordination primitive RBD/RGW build on).  Lock state lives in an
# -- object xattr and mutates atomically with the op vector.

LOCK_ATTR = "lock"              # per-object lock table xattr
LOCK_EXCLUSIVE = "exclusive"
LOCK_SHARED = "shared"
EBUSY = -16


def _locks(ctx: ClsContext) -> dict:
    """DEEP copy of the lock table: the stored xattr's inner dicts must
    never leak — in-place mutation would bypass the transaction (a failed
    vector would still release locks) and get_info callers could corrupt
    committed state through the returned aliases."""
    try:
        stored = ctx.getxattr(LOCK_ATTR)
    except KeyError:
        return {}
    return {name: {"type": lk["type"], "holders": list(lk["holders"])}
            for name, lk in stored.items()}


def _lock_lock(ctx: ClsContext):
    """indata: {name, cookie, type} — take/renew the lock.  EBUSY when an
    exclusive holder exists, or on a shared lock being taken exclusively
    (cls_lock lock_obj semantics; re-locking your own cookie renews)."""
    import pickle
    req = pickle.loads(ctx.indata)
    name, cookie = req["name"], req["cookie"]
    ltype = req.get("type", LOCK_EXCLUSIVE)
    locks = _locks(ctx)
    lk = locks.get(name)
    if lk is not None:
        if cookie in lk["holders"]:
            if lk["type"] != ltype:
                # no silent up/downgrade: an exclusive request against a
                # shared hold must not report success while the lock
                # stays shared (cls_lock refuses conflicting types)
                return EBUSY, b""
            # renewal: state unchanged
        else:
            if lk["type"] == LOCK_EXCLUSIVE or ltype == LOCK_EXCLUSIVE:
                return EBUSY, b""
            lk = {"type": lk["type"],
                  "holders": sorted(set(lk["holders"]) | {cookie})}
    else:
        lk = {"type": ltype, "holders": [cookie]}
    locks[name] = lk
    ctx.setxattr(LOCK_ATTR, locks)
    return 0, b""


def _lock_unlock(ctx: ClsContext):
    """indata: {name, cookie} — release; ENOENT when not held."""
    import pickle
    req = pickle.loads(ctx.indata)
    locks = _locks(ctx)
    lk = locks.get(req["name"])
    if lk is None or req["cookie"] not in lk["holders"]:
        return ENOENT, b""
    lk["holders"] = [h for h in lk["holders"] if h != req["cookie"]]
    if lk["holders"]:
        locks[req["name"]] = lk
    else:
        del locks[req["name"]]
    ctx.setxattr(LOCK_ATTR, locks)
    return 0, b""


def _lock_break(ctx: ClsContext):
    """indata: {name, cookie} — forcibly evict another client's cookie
    (cls_lock break_lock: recovery from dead lockers)."""
    return _lock_unlock(ctx)


def _lock_info(ctx: ClsContext):
    import pickle
    req = pickle.loads(ctx.indata) if ctx.indata else {}
    locks = _locks(ctx)          # deep copy: safe to hand to the caller
    if "name" in req:
        return 0, locks.get(req["name"])
    return 0, locks


ClsRegistry.register("lock", "lock", _lock_lock, mutates=True)
ClsRegistry.register("lock", "unlock", _lock_unlock, mutates=True)
ClsRegistry.register("lock", "break_lock", _lock_break, mutates=True)
ClsRegistry.register("lock", "get_info", _lock_info, mutates=False)
