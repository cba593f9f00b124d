"""File-backed object store: write-ahead log + checkpoint snapshots.

Durable implementation of the ``ObjectStore::Transaction`` contract the EC
path uses (reference: src/os/ObjectStore.h semantics; the role BlueStore's
RocksDB WAL plays, src/os/bluestore/BlueStore.cc).  Design:

- the live state is a :class:`~ceph_tpu_torch.backend.memstore.MemStore` in RAM
  (the page-cache model);
- every transaction appends one length+crc framed record to ``wal.log``
  BEFORE the caller sees the commit, then applies in RAM;
- every ``checkpoint_every`` transactions the whole state snapshots to
  ``objects.snap`` via write-to-temp + atomic rename, and the WAL resets —
  the FileStore/BlueFS compaction analog;
- reopening loads the snapshot and replays WAL records past its sequence
  number; a torn tail record (crash mid-append) fails its crc/length check
  and is discarded — that transaction never committed.

``sync=True`` fsyncs the WAL on every commit (the durability mode);
the default leaves flushing to the OS — the same trade
``filestore_journal_sync`` style options expose in the reference.

Records are pickled ``(seq, ops)`` tuples: an internal on-disk format, the
honest Python analog of the reference's private encoding.

The port's copy of ``ceph_tpu.backend.filestore``.
"""
from __future__ import annotations

import os
import pickle
import struct
from pathlib import Path

from .ecutil import crc32c
from .memstore import GObject, MemStore, Transaction, _Object

_FRAME = struct.Struct("<II")        # payload length, crc32c(payload)
_SNAP = "objects.snap"
_WAL = "wal.log"


class FileStore:
    """Durable ObjectStore over a directory; same surface as MemStore."""

    def __init__(self, path: str | os.PathLike, sync: bool = False,
                 checkpoint_every: int = 512):
        self.path = Path(path)
        self.path.mkdir(parents=True, exist_ok=True)
        self.sync = sync
        self.checkpoint_every = checkpoint_every
        self._mem = MemStore()
        self._snap_seq = 0
        self._wal_records = 0
        self._load()
        self._wal = open(self.path / _WAL, "ab")

    # -- persistence -------------------------------------------------------

    def _load(self) -> None:
        snap = self.path / _SNAP
        if snap.exists():
            with open(snap, "rb") as f:
                seq, objects = pickle.load(f)
            self._mem.objects = objects
            self._mem.committed_seq = seq
            self._snap_seq = seq
        wal = self.path / _WAL
        if not wal.exists():
            return
        with open(wal, "rb") as f:
            buf = f.read()
        off = 0
        while off + _FRAME.size <= len(buf):
            length, crc = _FRAME.unpack_from(buf, off)
            payload = buf[off + _FRAME.size:off + _FRAME.size + length]
            if len(payload) < length or crc32c(0xFFFFFFFF, payload) != crc:
                break                 # torn tail: that txn never committed
            off += _FRAME.size + length
            seq, ops = pickle.loads(payload)
            if seq != self._mem.committed_seq + 1:
                continue              # predates the snapshot
            t = Transaction()
            t.ops = ops
            self._mem.queue_transaction(t)
            self._wal_records += 1
        if off < len(buf):
            # drop the torn tail NOW: appending new records after garbage
            # would make them unreachable on the next replay
            os.truncate(wal, off)

    def _append_wal(self, payload: bytes) -> None:
        self._wal.write(_FRAME.pack(len(payload),
                                    crc32c(0xFFFFFFFF, payload)))
        self._wal.write(payload)
        self._wal.flush()
        if self.sync:
            os.fsync(self._wal.fileno())

    def checkpoint(self) -> None:
        """Snapshot the full state atomically and reset the WAL."""
        tmp = self.path / (_SNAP + ".tmp")
        with open(tmp, "wb") as f:
            pickle.dump((self._mem.committed_seq, self._mem.objects), f,
                        protocol=pickle.HIGHEST_PROTOCOL)
            f.flush()
            if self.sync:
                os.fsync(f.fileno())
        os.replace(tmp, self.path / _SNAP)
        self._snap_seq = self._mem.committed_seq
        self._wal.close()
        self._wal = open(self.path / _WAL, "wb")
        self._wal_records = 0

    def close(self, checkpoint: bool = True) -> None:
        """Checkpoint (fast reopen) and release the WAL handle.  Pass
        ``checkpoint=False`` when the directory is about to be discarded
        (backfill to a new layout) — the snapshot would be wasted work."""
        if checkpoint:
            self.checkpoint()
        self._wal.close()

    # -- ObjectStore surface ----------------------------------------------

    @property
    def objects(self):
        return self._mem.objects

    @property
    def committed_seq(self) -> int:
        return self._mem.committed_seq

    def queue_transaction(self, t: Transaction) -> int:
        # apply first (all-or-nothing staging) so only transactions that
        # succeed reach the log; then journal before acking the caller
        seq = self._mem.queue_transaction(t)
        self._append_wal(pickle.dumps((seq, t.ops),
                                      protocol=pickle.HIGHEST_PROTOCOL))
        self._wal_records += 1
        if self._wal_records >= self.checkpoint_every:
            self.checkpoint()
        return seq

    def read(self, obj: GObject, offset: int = 0,
             length: int | None = None) -> bytes:
        return self._mem.read(obj, offset, length)

    def stat(self, obj: GObject) -> int:
        return self._mem.stat(obj)

    def exists(self, obj: GObject) -> bool:
        return self._mem.exists(obj)

    def getattr(self, obj: GObject, name: str):
        return self._mem.getattr(obj, name)

    def get_omap(self, obj: GObject) -> dict[str, bytes]:
        return self._mem.get_omap(obj)

    def get_omap_header(self, obj: GObject) -> bytes:
        return self._mem.get_omap_header(obj)

    def getattrs(self, obj: GObject):
        return self._mem.getattrs(obj)

    def list_objects(self) -> list[GObject]:
        return self._mem.list_objects()
