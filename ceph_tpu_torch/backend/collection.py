"""Per-PG collections over ONE shared per-OSD ObjectStore.

The reference OSD hosts every PG against a single ObjectStore, with each
PG's objects living in their own collection (coll_t): boot iterates the
store's collections to rediscover PGs (reference: src/osd/OSD.cc:3971
load_pgs; src/os/ObjectStore.h Collection).  :class:`Collection` gives
this framework the same topology: it exposes the full ObjectStore API of
MemStore/FileStore but namespaces every GObject into its collection, so
N PG shards on one OSD share ONE store — one WAL, one checkpoint, one
restart — while the PG backends stay collection-oblivious.

A copy of ``ceph_tpu.backend.collection``.
"""
from __future__ import annotations

from collections.abc import Mapping

from .memstore import GObject, Transaction


class _ObjectsView(Mapping):
    """Dict-shaped view of one collection's slice of the shared store's
    ``objects`` map, with collection prefixes stripped.  Deletion is
    supported for the fault-injection paths (tests vaporise an object to
    model silent loss)."""

    def __init__(self, coll: "Collection"):
        self._c = coll

    def __getitem__(self, g: GObject):
        return self._c.base.objects[self._c._in(g)]

    def __delitem__(self, g: GObject) -> None:
        del self._c.base.objects[self._c._in(g)]

    def __contains__(self, g) -> bool:
        return isinstance(g, GObject) and \
            self._c._in(g) in self._c.base.objects

    def __iter__(self):
        p = self._c._p
        for g in self._c.base.objects:
            if g.oid.startswith(p):
                yield self._c._out(g)

    def __len__(self) -> int:
        return sum(1 for _ in self)

# oid namespace separator: NUL-delimited like the clone oids' SNAP_SEP so
# no user-visible object name can collide with a collection prefix
COLL_SEP = "\x00c\x00"


def collection_names(store) -> set[str]:
    """Collections present in a store (OSD::load_pgs discovery: which
    PGs does this store host?)."""
    out = set()
    for g in store.list_objects():
        if COLL_SEP in g.oid:
            out.add(g.oid.split(COLL_SEP, 1)[0])
    return out


class Collection:
    """One PG's namespace inside a shared store.

    Implements the ObjectStore read/write surface the PG backends use
    (queue_transaction, read/stat/exists, attrs, omap, list_objects) by
    rewriting oids to '<cname>\\x00c\\x00<oid>'.  ``close`` is a no-op:
    the OSD daemon owns the underlying store's lifecycle.
    """

    def __init__(self, store, cname: str):
        if COLL_SEP in cname:
            raise ValueError(f"collection name {cname!r} contains the "
                             f"namespace separator")
        self.base = store
        self.cname = cname
        self._p = cname + COLL_SEP

    # -- oid mapping --------------------------------------------------------

    def _in(self, obj: GObject) -> GObject:
        return GObject(self._p + obj.oid, obj.shard)

    def _out(self, obj: GObject) -> GObject:
        return GObject(obj.oid[len(self._p):], obj.shard)

    # -- writes -------------------------------------------------------------

    def queue_transaction(self, t: Transaction) -> int:
        nt = Transaction()
        nt.ops = [tuple(self._in(x) if isinstance(x, GObject) else x
                        for x in op)
                  for op in t.ops]
        return self.base.queue_transaction(nt)

    # -- reads --------------------------------------------------------------

    def read(self, obj: GObject, offset: int = 0,
             length: int | None = None) -> bytes:
        return self.base.read(self._in(obj), offset, length)

    def stat(self, obj: GObject) -> int:
        return self.base.stat(self._in(obj))

    def exists(self, obj: GObject) -> bool:
        return self.base.exists(self._in(obj))

    def getattr(self, obj: GObject, name: str):
        return self.base.getattr(self._in(obj), name)

    def getattrs(self, obj: GObject):
        return self.base.getattrs(self._in(obj))

    def get_omap(self, obj: GObject):
        return self.base.get_omap(self._in(obj))

    def get_omap_header(self, obj: GObject) -> bytes:
        return self.base.get_omap_header(self._in(obj))

    def list_objects(self) -> list[GObject]:
        return [self._out(g) for g in self.base.list_objects()
                if g.oid.startswith(self._p)]

    @property
    def objects(self) -> "_ObjectsView":
        """Mapping view over this collection's objects (the backends use
        ``store.objects`` for direct xattr peeks and membership)."""
        return _ObjectsView(self)

    # -- lifecycle ----------------------------------------------------------

    @property
    def committed_seq(self) -> int:
        return getattr(self.base, "committed_seq", 0)

    def close(self, checkpoint: bool = True) -> None:
        """No-op: the daemon owns the shared store (PGGroup teardown must
        not checkpoint/close a store other PGs are still using)."""

    def destroy(self) -> None:
        """Remove every object in this collection from the base store
        (ObjectStore::remove_collection): a remapped PG's outgoing
        incarnation must leave nothing — a later incarnation reopening
        the same collection name would otherwise boot from the stale
        pgmeta/pg-log it left behind."""
        t = Transaction()
        for g in self.base.list_objects():
            if g.oid.startswith(self._p):
                t.remove(g)
        if not t.empty():
            self.base.queue_transaction(t)
