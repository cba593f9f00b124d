"""In-memory object store with atomic transactions.

Analog of the reference's MemStore (reference: src/os/memstore/MemStore.cc —
the in-RAM ObjectStore used by fast OSD-level tests) exposing the
``ObjectStore::Transaction`` surface the EC path needs (reference:
src/os/ObjectStore.h, src/os/Transaction.h): write/zero/truncate/remove plus
object xattrs.  Object names carry a shard id the way ``ghobject_t`` does
(oid, NO_GEN, shard) — reference: src/osd/ECTransaction.cc:62-81.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

NO_SHARD = -1


@dataclass(frozen=True)
class GObject:
    """ghobject_t: an object name + shard id."""
    oid: str
    shard: int = NO_SHARD


@dataclass
class _Object:
    data: bytearray = field(default_factory=bytearray)
    xattrs: dict[str, Any] = field(default_factory=dict)
    omap: dict[str, bytes] = field(default_factory=dict)
    omap_header: bytes = b""

    def copy(self) -> "_Object":
        return _Object(bytearray(self.data), dict(self.xattrs),
                       dict(self.omap), self.omap_header)


class Transaction:
    """Ordered op list applied atomically (ObjectStore::Transaction shape)."""

    def __init__(self):
        self.ops: list[tuple] = []

    def write(self, obj: GObject, offset: int, data: bytes) -> "Transaction":
        self.ops.append(("write", obj, offset, bytes(data)))
        return self

    def zero(self, obj: GObject, offset: int, length: int) -> "Transaction":
        self.ops.append(("zero", obj, offset, length))
        return self

    def truncate(self, obj: GObject, size: int) -> "Transaction":
        self.ops.append(("truncate", obj, size))
        return self

    def remove(self, obj: GObject) -> "Transaction":
        self.ops.append(("remove", obj))
        return self

    def touch(self, obj: GObject) -> "Transaction":
        self.ops.append(("touch", obj))
        return self

    def clone(self, src: GObject, dst: GObject) -> "Transaction":
        self.ops.append(("clone", src, dst))
        return self

    def setattr(self, obj: GObject, name: str, value) -> "Transaction":
        self.ops.append(("setattr", obj, name, value))
        return self

    def rmattr(self, obj: GObject, name: str) -> "Transaction":
        self.ops.append(("rmattr", obj, name))
        return self

    def omap_setkeys(self, obj: GObject, kvs: dict[str, bytes]) -> "Transaction":
        self.ops.append(("omap_setkeys", obj, dict(kvs)))
        return self

    def omap_rmkeys(self, obj: GObject, keys) -> "Transaction":
        self.ops.append(("omap_rmkeys", obj, list(keys)))
        return self

    def omap_clear(self, obj: GObject) -> "Transaction":
        self.ops.append(("omap_clear", obj))
        return self

    def omap_setheader(self, obj: GObject, header: bytes) -> "Transaction":
        self.ops.append(("omap_setheader", obj, bytes(header)))
        return self

    def append(self, other: "Transaction") -> "Transaction":
        self.ops.extend(other.ops)
        return self

    def empty(self) -> bool:
        return not self.ops


class MemStore:
    """Flat in-RAM store; transactions apply all-or-nothing on op error."""

    def __init__(self):
        self.objects: dict[GObject, _Object] = {}
        self.committed_seq = 0

    # -- transactions ------------------------------------------------------

    def queue_transaction(self, t: Transaction) -> int:
        """Apply atomically; returns the commit sequence number.

        Atomicity by staging copies of only the objects the transaction
        names (not the whole store): on any op error nothing merges back."""
        touched: set[GObject] = set()
        for op in t.ops:
            touched.add(op[1])
            if op[0] == "clone":
                touched.add(op[2])
        staged: dict[GObject, _Object] = {}
        for obj in touched:
            o = self.objects.get(obj)
            if o is not None:
                staged[obj] = o.copy()
        for op in t.ops:
            self._apply(staged, op)
        for obj in touched:
            if obj in staged:
                self.objects[obj] = staged[obj]
            else:
                self.objects.pop(obj, None)
        self.committed_seq += 1
        return self.committed_seq

    def _apply(self, objs: dict[GObject, _Object], op: tuple) -> None:
        kind = op[0]
        if kind == "write":
            _, obj, offset, data = op
            o = objs.setdefault(obj, _Object())
            end = offset + len(data)
            if len(o.data) < end:
                o.data.extend(b"\0" * (end - len(o.data)))
            o.data[offset:end] = data
        elif kind == "zero":
            _, obj, offset, length = op
            o = objs.setdefault(obj, _Object())
            end = offset + length
            if len(o.data) < end:
                o.data.extend(b"\0" * (end - len(o.data)))
            o.data[offset:end] = b"\0" * length
        elif kind == "truncate":
            _, obj, size = op
            o = objs.setdefault(obj, _Object())
            if len(o.data) > size:
                del o.data[size:]
            else:
                o.data.extend(b"\0" * (size - len(o.data)))
        elif kind == "remove":
            objs.pop(op[1], None)
        elif kind == "touch":
            objs.setdefault(op[1], _Object())
        elif kind == "clone":
            _, src, dst = op
            objs[dst] = objs.get(src, _Object()).copy()
        elif kind == "setattr":
            _, obj, name, value = op
            objs.setdefault(obj, _Object()).xattrs[name] = value
        elif kind == "rmattr":
            _, obj, name = op
            objs.setdefault(obj, _Object()).xattrs.pop(name, None)
        elif kind == "omap_setkeys":
            _, obj, kvs = op
            objs.setdefault(obj, _Object()).omap.update(kvs)
        elif kind == "omap_rmkeys":
            _, obj, keys = op
            o = objs.setdefault(obj, _Object())
            for key in keys:
                o.omap.pop(key, None)
        elif kind == "omap_clear":
            o = objs.setdefault(op[1], _Object())
            o.omap.clear()
            o.omap_header = b""
        elif kind == "omap_setheader":
            objs.setdefault(op[1], _Object()).omap_header = op[2]
        else:
            raise ValueError(f"unknown op {kind}")

    # -- reads -------------------------------------------------------------

    def read(self, obj: GObject, offset: int = 0, length: int | None = None) -> bytes:
        o = self.objects.get(obj)
        if o is None:
            raise FileNotFoundError(obj)
        if length is None:
            return bytes(o.data[offset:])
        return bytes(o.data[offset:offset + length])

    def stat(self, obj: GObject) -> int:
        o = self.objects.get(obj)
        if o is None:
            raise FileNotFoundError(obj)
        return len(o.data)

    def exists(self, obj: GObject) -> bool:
        return obj in self.objects

    def getattr(self, obj: GObject, name: str):
        o = self.objects.get(obj)
        if o is None:
            raise FileNotFoundError(obj)
        return o.xattrs[name]

    def get_omap(self, obj: GObject) -> dict[str, bytes]:
        o = self.objects.get(obj)
        if o is None:
            raise FileNotFoundError(obj)
        return dict(o.omap)

    def get_omap_header(self, obj: GObject) -> bytes:
        o = self.objects.get(obj)
        if o is None:
            raise FileNotFoundError(obj)
        return o.omap_header

    def getattrs(self, obj: GObject) -> dict[str, Any]:
        o = self.objects.get(obj)
        if o is None:
            raise FileNotFoundError(obj)
        return dict(o.xattrs)

    def list_objects(self) -> list[GObject]:
        return sorted(self.objects, key=lambda g: (g.oid, g.shard))
