"""BlueStore-lite: an extent-allocator object store over one flat file.

The durable store modeled on the reference's flagship ObjectStore
(reference: src/os/bluestore/BlueStore.cc — structure, not scale):

- **data** lives in ONE flat block file, allocated in ``min_alloc``-sized
  units by a run-list allocator with bitmap semantics (the reference's
  BitmapAllocator, src/os/bluestore/BitmapAllocator.h);
- **blobs** are immutable physical regions: every write allocates a fresh
  blob and remaps logical extents onto it (the reference's copy-on-write
  blob model), so a crash mid-write leaves old metadata pointing at old
  bytes — never torn data;
- **checksums at rest**: each blob stores the crc32c of its physical
  bytes, verified on EVERY read (``bluestore_csum_type=crc32c``); a
  mismatch raises :class:`ChecksumError` (EIO), which deep scrub surfaces
  without any majority vote;
- **inline compression** via the CompressorRegistry: blobs compress when
  the configured compressor saves at least one allocation unit, storing
  ``raw_len`` for exact reconstruction (``bluestore_compression_mode``);
- **clones share blobs** by refcount — O(extent-map) clone, no data copy
  (the snapshot COW path rides this);
- **metadata** (onodes: size + extent maps + xattrs + omap; the blob
  table) journals through a WAL and periodic checkpoints, exactly like
  :class:`~ceph_tpu_torch.backend.filestore.FileStore` — but checkpoints carry
  ONLY metadata, so their cost scales with object count, not data volume
  (a whole-store pickle would scale with the data).  The allocator's free list is
  REBUILT from the blob table on open (self-healing, like the
  reference's freelist-from-RocksDB startup).

Implements the full MemStore/FileStore ObjectStore surface, so it can
back OSD daemons via collections unchanged.

The port's copy of ``ceph_tpu.backend.bluestore``.
"""
from __future__ import annotations

import os
import pickle
import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

from .ecutil import crc32c
from .memstore import GObject, Transaction, _Object

_FRAME = struct.Struct("<II")        # payload length, crc32c(payload)
_SNAP = "kv.snap"
_WAL = "kv.log"
_BLOCK = "block"


class ChecksumError(IOError):
    """A blob's bytes at rest no longer match their stored crc32c (the
    reference returns -EIO from _verify_csum)."""


@dataclass
class Blob:
    """An immutable physical region of the block file."""
    poff: int            # byte offset in the block file
    plen: int            # stored (possibly compressed) byte length
    alloc: int           # allocated bytes (plen rounded up to units)
    raw_len: int         # decompressed length
    csum: int            # crc32c of the STORED bytes
    comp: str | None     # compressor name, None = raw
    refs: int = 1        # extents (across all onodes) mapping this blob


@dataclass
class Extent:
    """A logical range of an object mapped onto part of a blob."""
    loff: int            # logical offset in the object
    length: int
    blob: int            # blob id
    boff: int            # offset into the blob's RAW content


@dataclass
class Onode:
    size: int = 0
    extents: list[Extent] = field(default_factory=list)   # sorted by loff
    xattrs: dict[str, Any] = field(default_factory=dict)
    omap: dict[str, bytes] = field(default_factory=dict)
    omap_header: bytes = b""

    def copy(self) -> "Onode":
        return Onode(self.size,
                     [Extent(e.loff, e.length, e.blob, e.boff)
                      for e in self.extents],
                     dict(self.xattrs), dict(self.omap), self.omap_header)


class RunListAllocator:
    """Free-space tracking with bitmap semantics over allocation units:
    sorted, coalesced (start, length) free runs below a growth watermark
    (BitmapAllocator.h behavior at run-list cost)."""

    def __init__(self, unit: int):
        self.unit = unit
        self.runs: list[list[int]] = []     # sorted [start_unit, n_units]
        self.watermark = 0                  # units ever claimed

    def alloc(self, nbytes: int) -> tuple[int, int]:
        """(byte offset, allocated bytes) — first-fit over the free runs,
        else grow the watermark."""
        units = max(1, -(-nbytes // self.unit))
        for i, (start, n) in enumerate(self.runs):
            if n >= units:
                self.runs[i][0] += units
                self.runs[i][1] -= units
                if self.runs[i][1] == 0:
                    del self.runs[i]
                return start * self.unit, units * self.unit
        start = self.watermark
        self.watermark += units
        return start * self.unit, units * self.unit

    def free(self, poff: int, nbytes: int) -> None:
        start, units = poff // self.unit, max(1, -(-nbytes // self.unit))
        import bisect
        i = bisect.bisect_left(self.runs, [start, 0])
        self.runs.insert(i, [start, units])
        # coalesce with neighbours
        if i + 1 < len(self.runs) and \
                self.runs[i][0] + self.runs[i][1] == self.runs[i + 1][0]:
            self.runs[i][1] += self.runs[i + 1][1]
            del self.runs[i + 1]
        if i > 0 and self.runs[i - 1][0] + self.runs[i - 1][1] == \
                self.runs[i][0]:
            self.runs[i - 1][1] += self.runs[i][1]
            del self.runs[i]

    def free_bytes(self) -> int:
        return sum(n for _s, n in self.runs) * self.unit

    def rebuild(self, blobs: dict[int, Blob]) -> None:
        """Free list = everything under the watermark not covered by a
        live blob (freelist-from-metadata startup)."""
        self.runs = []
        covered = sorted((b.poff // self.unit, b.alloc // self.unit)
                        for b in blobs.values())
        self.watermark = 0
        pos = 0
        for start, units in covered:
            if start > pos:
                self.runs.append([pos, start - pos])
            pos = max(pos, start + units)
        self.watermark = pos


class BlueStoreLite:
    """Durable ObjectStore over ONE block file + metadata WAL/checkpoint;
    same surface as MemStore/FileStore."""

    def __init__(self, path: str | os.PathLike, min_alloc: int = 4096,
                 compression: str | None = None, sync: bool = False,
                 checkpoint_every: int = 512):
        self.path = Path(path)
        self.path.mkdir(parents=True, exist_ok=True)
        self.min_alloc = min_alloc
        self.sync = sync
        self.checkpoint_every = checkpoint_every
        self.onodes: dict[GObject, Onode] = {}
        self.blobs: dict[int, Blob] = {}
        self.next_blob = 1
        self.committed_seq = 0
        self.alloc = RunListAllocator(min_alloc)
        self._compressor = None
        self.compression = compression
        if compression:
            from ..compressor import CompressorRegistry
            self._compressor = CompressorRegistry.instance().create(
                compression)
        self._wal_records = 0
        self._load()
        self._block = open(self.path / _BLOCK, "r+b")
        self._wal = open(self.path / _WAL, "ab")

    # -- persistence --------------------------------------------------------

    def _load(self) -> None:
        (self.path / _BLOCK).touch()
        snap = self.path / _SNAP
        if snap.exists():
            with open(snap, "rb") as f:
                (self.committed_seq, self.onodes, self.blobs,
                 self.next_blob) = pickle.load(f)
        wal = self.path / _WAL
        if wal.exists():
            with open(wal, "rb") as f:
                buf = f.read()
            off = 0
            snap_seq = self.committed_seq
            while off + _FRAME.size <= len(buf):
                length, crc = _FRAME.unpack_from(buf, off)
                payload = buf[off + _FRAME.size:off + _FRAME.size + length]
                if len(payload) < length or \
                        crc32c(0xFFFFFFFF, payload) != crc:
                    break             # torn tail: never committed
                off += _FRAME.size + length
                seq, onode_delta, blob_delta, freed, nb = \
                    pickle.loads(payload)
                if seq <= snap_seq:
                    continue          # predates the checkpoint
                self._apply_meta(onode_delta, blob_delta, freed)
                self.next_blob = max(self.next_blob, nb)
                self.committed_seq = seq
                self._wal_records += 1
            if off < len(buf):
                os.truncate(wal, off)
        # the free list is DERIVED state: rebuild from live blobs
        self.alloc.rebuild(self.blobs)

    def _apply_meta(self, onode_delta, blob_delta, freed) -> None:
        for bid in freed:
            self.blobs.pop(bid, None)
        self.blobs.update(blob_delta)
        for obj, onode in onode_delta.items():
            if onode is None:
                self.onodes.pop(obj, None)
            else:
                self.onodes[obj] = onode

    def checkpoint(self) -> None:
        """Metadata-only snapshot (onodes + blob table): cost scales with
        object count, never data volume — the block file IS the data."""
        self._block.flush()
        if self.sync:
            os.fsync(self._block.fileno())
        tmp = self.path / (_SNAP + ".tmp")
        with open(tmp, "wb") as f:
            pickle.dump((self.committed_seq, self.onodes, self.blobs,
                         self.next_blob), f,
                        protocol=pickle.HIGHEST_PROTOCOL)
            f.flush()
            if self.sync:
                os.fsync(f.fileno())
        os.replace(tmp, self.path / _SNAP)
        self._wal.close()
        self._wal = open(self.path / _WAL, "wb")
        self._wal_records = 0

    def close(self, checkpoint: bool = True) -> None:
        if checkpoint:
            self.checkpoint()
        self._wal.close()
        self._block.close()

    # -- blob IO ------------------------------------------------------------

    def _write_blob(self, data: bytes, new_blobs: dict[int, Blob]) -> int:
        """Store ``data`` as a fresh blob (maybe compressed); returns the
        blob id.  The bytes hit the block file NOW, before the metadata
        commits — old metadata never references them, so a crash in
        between leaks nothing and tears nothing (COW)."""
        raw_len = len(data)
        comp = None
        stored = data
        if self._compressor is not None and raw_len > self.min_alloc:
            candidate = self._compressor.compress(data)
            # worth it only if it saves at least one allocation unit
            # (bluestore_compression_required_ratio in spirit)
            if (-(-len(candidate) // self.min_alloc)
                    < -(-raw_len // self.min_alloc)):
                stored = candidate
                comp = self.compression
        poff, alloc = self.alloc.alloc(max(1, len(stored)))
        self._block.seek(poff)
        self._block.write(stored)
        bid = self.next_blob
        self.next_blob += 1
        blob = Blob(poff=poff, plen=len(stored), alloc=alloc,
                    raw_len=raw_len, csum=crc32c(0xFFFFFFFF, stored),
                    comp=comp)
        new_blobs[bid] = blob
        self.blobs[bid] = blob
        return bid

    def _read_blob(self, bid: int) -> bytes:
        b = self.blobs[bid]
        self._block.flush()
        self._block.seek(b.poff)
        stored = self._block.read(b.plen)
        if crc32c(0xFFFFFFFF, stored) != b.csum:
            raise ChecksumError(
                f"blob {bid} at {b.poff}+{b.plen}: stored crc mismatch "
                f"(bitrot at rest)")
        if b.comp is not None:
            from ..compressor import CompressorRegistry
            return CompressorRegistry.instance().create(
                b.comp).decompress(stored)
        return stored

    # -- extent-map surgery --------------------------------------------------

    @staticmethod
    def _punch(onode: Onode, off: int, length: int,
               deref: list[int], addref: list[int]) -> None:
        """Drop the logical range [off, off+length) from the extent map,
        splitting boundary extents.  Blob refs count EXTENTS: a fully
        unmapped extent collects in ``deref``; a mid-split (one extent
        becoming two remainders) collects in ``addref``."""
        end = off + length
        out: list[Extent] = []
        for e in onode.extents:
            e_end = e.loff + e.length
            if e_end <= off or e.loff >= end:
                out.append(e)
                continue
            pieces = 0
            if e.loff < off:                    # left remainder
                out.append(Extent(e.loff, off - e.loff, e.blob, e.boff))
                pieces += 1
            if e_end > end:                     # right remainder
                out.append(Extent(end, e_end - end, e.blob,
                                  e.boff + (end - e.loff)))
                pieces += 1
            if pieces == 0:
                deref.append(e.blob)
            elif pieces == 2:
                addref.append(e.blob)
        onode.extents = sorted(out, key=lambda e: e.loff)

    def _deref(self, bids, freed: list[int]) -> None:
        for bid in bids:
            b = self.blobs.get(bid)
            if b is None:
                continue
            b.refs -= 1
            if b.refs <= 0:
                del self.blobs[bid]
                self.alloc.free(b.poff, b.alloc)
                freed.append(bid)

    # -- transactions --------------------------------------------------------

    def queue_transaction(self, t: Transaction) -> int:
        """Apply atomically; journal the metadata delta; return the seq.

        Staging mirrors MemStore: copies of only the touched onodes; blob
        refcount changes are tracked and only applied on success."""
        touched: set[GObject] = set()
        for op in t.ops:
            touched.add(op[1])
            if op[0] == "clone":
                touched.add(op[2])
        staged: dict[GObject, Onode | None] = {}
        for obj in touched:
            o = self.onodes.get(obj)
            staged[obj] = o.copy() if o is not None else None
        new_blobs: dict[int, Blob] = {}
        deref: list[int] = []       # blob ids losing one reference
        addref: list[int] = []      # blob ids gaining one (clone/split)
        try:
            for op in t.ops:
                self._apply(staged, op, new_blobs, deref, addref)
        except Exception:
            # all-or-nothing: orphan the data already written for this
            # transaction (nothing references it) and free its space
            for bid, b in new_blobs.items():
                self.blobs.pop(bid, None)
                self.alloc.free(b.poff, b.alloc)
            raise
        # commit: refcounts, onode table, WAL
        for bid in addref:
            self.blobs[bid].refs += 1
        freed: list[int] = []
        self._deref(deref, freed)
        for obj, onode in staged.items():
            if onode is None:
                self.onodes.pop(obj, None)
            else:
                self.onodes[obj] = onode
        self.committed_seq += 1
        payload = pickle.dumps(
            (self.committed_seq, staged,
             {bid: self.blobs[bid] for bid in
              set(new_blobs) - set(freed)} |
             {bid: self.blobs[bid] for bid in addref + deref
              if bid in self.blobs},
             freed, self.next_blob),
            protocol=pickle.HIGHEST_PROTOCOL)
        self._block.flush()          # data precedes its metadata
        if self.sync:
            os.fsync(self._block.fileno())
        self._wal.write(_FRAME.pack(len(payload),
                                    crc32c(0xFFFFFFFF, payload)))
        self._wal.write(payload)
        self._wal.flush()
        if self.sync:
            os.fsync(self._wal.fileno())
        self._wal_records += 1
        if self._wal_records >= self.checkpoint_every:
            self.checkpoint()
        return self.committed_seq

    def _apply(self, staged, op, new_blobs, deref, addref) -> None:
        kind = op[0]
        obj = op[1]

        def node() -> Onode:
            if staged.get(obj) is None:
                staged[obj] = Onode()
            return staged[obj]

        if kind == "write":
            _, _, offset, data = op
            o = node()
            if data:
                self._punch(o, offset, len(data), deref, addref)
                bid = self._write_blob(bytes(data), new_blobs)
                o.extents.append(Extent(offset, len(data), bid, 0))
                o.extents.sort(key=lambda e: e.loff)
            o.size = max(o.size, offset + len(data))
        elif kind == "zero":
            _, _, offset, length = op
            o = node()
            self._punch(o, offset, length, deref, addref)
            o.size = max(o.size, offset + length)
        elif kind == "truncate":
            _, _, size = op
            o = node()
            if size < o.size:
                self._punch(o, size, o.size - size, deref, addref)
            o.size = size
        elif kind == "remove":
            o = staged.get(obj)
            if o is not None:
                deref.extend(e.blob for e in o.extents)
            staged[obj] = None
        elif kind == "touch":
            node()
        elif kind == "clone":
            _, src, dst = op
            so = staged.get(src)
            old = staged.get(dst)
            if old is not None:
                deref.extend(e.blob for e in old.extents)
            if so is None:
                staged[dst] = Onode()
            else:
                staged[dst] = so.copy()
                addref.extend(e.blob for e in so.extents)
        elif kind == "setattr":
            node().xattrs[op[2]] = op[3]
        elif kind == "rmattr":
            node().xattrs.pop(op[2], None)
        elif kind == "omap_setkeys":
            node().omap.update(op[2])
        elif kind == "omap_rmkeys":
            o = node()
            for key in op[2]:
                o.omap.pop(key, None)
        elif kind == "omap_clear":
            o = node()
            o.omap.clear()
            o.omap_header = b""
        elif kind == "omap_setheader":
            node().omap_header = op[2]
        else:
            raise ValueError(f"unknown op {kind}")

    # -- reads ---------------------------------------------------------------

    def _node(self, obj: GObject) -> Onode:
        o = self.onodes.get(obj)
        if o is None:
            raise FileNotFoundError(obj)
        return o

    def read(self, obj: GObject, offset: int = 0,
             length: int | None = None) -> bytes:
        o = self._node(obj)
        if length is None:
            length = max(o.size - offset, 0)
        end = min(offset + length, o.size)
        if end <= offset:
            return b""
        out = bytearray(end - offset)       # gaps read as zeros
        for e in o.extents:
            e_end = e.loff + e.length
            if e_end <= offset or e.loff >= end:
                continue
            s = max(e.loff, offset)
            t_ = min(e_end, end)
            raw = self._read_blob(e.blob)
            piece = raw[e.boff + (s - e.loff):e.boff + (t_ - e.loff)]
            out[s - offset:s - offset + len(piece)] = piece
        return bytes(out)

    def stat(self, obj: GObject) -> int:
        return self._node(obj).size

    def exists(self, obj: GObject) -> bool:
        return obj in self.onodes

    def getattr(self, obj: GObject, name: str):
        return self._node(obj).xattrs[name]

    def getattrs(self, obj: GObject):
        return dict(self._node(obj).xattrs)

    def get_omap(self, obj: GObject) -> dict[str, bytes]:
        return dict(self._node(obj).omap)

    def get_omap_header(self, obj: GObject) -> bytes:
        return self._node(obj).omap_header

    def list_objects(self) -> list[GObject]:
        return sorted(self.onodes, key=lambda g: (g.oid, g.shard))

    # -- compat: the dict-shaped objects view --------------------------------

    @property
    def objects(self) -> "_OnodeObjectsView":
        return _OnodeObjectsView(self)

    # -- introspection (admin socket / tests) --------------------------------

    def usage(self) -> dict:
        """Allocator + blob stats ('bluestore allocator dump' shape)."""
        stored = sum(b.plen for b in self.blobs.values())
        raw = sum(b.raw_len for b in self.blobs.values())
        return {
            "min_alloc": self.min_alloc,
            "blobs": len(self.blobs),
            "allocated_bytes": sum(b.alloc for b in self.blobs.values()),
            "stored_bytes": stored,
            "raw_bytes": raw,
            "compressed_blobs": sum(1 for b in self.blobs.values()
                                    if b.comp),
            "free_bytes": self.alloc.free_bytes(),
            "watermark_bytes": self.alloc.watermark * self.min_alloc,
        }


class _OnodeObjectsView:
    """Read-mostly mapping compat layer: ``store.objects[g]`` returns an
    _Object-shaped proxy (materialized data, live xattr/omap dicts) for
    the backend code paths that peek directly."""

    def __init__(self, store: BlueStoreLite):
        self._s = store

    def __getitem__(self, g: GObject) -> _Object:
        onode = self._s.onodes.get(g)
        if onode is None:
            raise KeyError(g)       # dict semantics: .get() relies on it
        return _Object(bytearray(self._s.read(g)), onode.xattrs,
                       onode.omap, onode.omap_header)

    def get(self, g: GObject, default=None):
        try:
            return self[g]
        except KeyError:
            return default

    def __contains__(self, g) -> bool:
        return g in self._s.onodes

    def __iter__(self):
        return iter(self._s.onodes)

    def __len__(self) -> int:
        return len(self._s.onodes)

    def keys(self):
        return self._s.onodes.keys()
