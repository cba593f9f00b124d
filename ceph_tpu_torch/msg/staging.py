"""Pooled staging buffers: where sideband payloads make their ONE copy.

The zero-copy receive path lands a batch frame's raw payload segment
here: the :class:`~ceph_tpu_torch.msg.parser.StreamParser`'s
memoryviews die at the next ``feed``, so anything that crosses the
reactor -> dispatch-worker boundary must move into a buffer the parser
does not own.  That move is the one sanctioned copy between socket and
device — it reports to the copy ledger as ``staging`` — and everything
downstream (dispatch handlers, the codec pack, the echoed reply's
write-queue splice) works on memoryview slices of the staged buffer.

Lifetime is GC-owned, deliberately: a staged buffer may simultaneously
be aliased by a dispatch handler's args, by the reqid-dedup cache's
retained RpcResult, and by a reply frame sitting in a connection write
queue behind a slow peer.  Each alias is a memoryview holding the
underlying bytearray alive, so dropping the last view frees the buffer
— whereas an explicit recycle would have to prove none of those aliases
remain (the classic reuse-after-splice corruption).  The pool therefore
recycles only buffers a caller *explicitly* hands back via
:meth:`recycle` after severing every view, and the hot path never does;
the size-class freelist exists for bounded, provably-single-owner uses
(the coalescer's pack scratch), not for wire payloads.

A staged view is read-write over a ``bytearray`` that other views may
alias: a consumer that keeps the bytes past the call (a store
transaction, a tensor built with ``torch.frombuffer``) copies them
first, as ``ClusterServer``'s handlers do with ``bytes(data)``.
"""
from __future__ import annotations

import threading

from ..common import copy_ledger

# freelist size classes: powers of two from 4 KiB to 1 MiB; larger
# buffers always allocate fresh (rare, and pinning MiBs in a freelist
# is worse than the malloc)
_MIN_CLASS = 12
_MAX_CLASS = 20
_PER_CLASS = 8


class StagingPool:
    """Size-classed bytearray lease pool with copy-ledger accounting."""

    def __init__(self, name: str = "staging"):
        self.name = name
        self._lock = threading.Lock()
        self._free: dict[int, list[bytearray]] = {}
        self.stats = {"staged_bytes": 0, "staged_buffers": 0,
                      "reused": 0, "allocated": 0}

    def _class_of(self, n: int) -> int | None:
        if n <= 0:
            return None
        c = max((n - 1).bit_length(), _MIN_CLASS)
        return c if c <= _MAX_CLASS else None

    def lease(self, n: int) -> bytearray:
        """A writable buffer of exactly ``n`` bytes (sliced view of a
        size-class buffer when one is free)."""
        c = self._class_of(n)
        if c is not None:
            with self._lock:
                bucket = self._free.get(c)
                if bucket:
                    self.stats["reused"] += 1
                    buf = bucket.pop()
                    # bytearray resize is O(1) shrink within capacity;
                    # safe: recycled buffers have no exported views
                    del buf[n:]
                    return buf
        with self._lock:
            self.stats["allocated"] += 1
        return bytearray(n)

    def recycle(self, buf: bytearray) -> None:
        """Return a buffer whose every view has been severed.  Callers
        must be the provable sole owner — see the module docstring."""
        c = self._class_of(len(buf))
        if c is None:
            return
        try:
            buf += b"\x00" * ((1 << c) - len(buf))   # restore capacity
        except BufferError:
            return                       # a view survives: not reusable
        with self._lock:
            bucket = self._free.setdefault(c, [])
            if len(bucket) < _PER_CLASS:
                bucket.append(buf)

    def stage(self, view, source: str = "staging") -> memoryview:
        """Copy one wire segment into a staged buffer (THE copy) and
        return a read-write memoryview over it."""
        n = len(view)
        buf = self.lease(n)
        buf[:] = view
        with self._lock:
            self.stats["staged_bytes"] += n
            self.stats["staged_buffers"] += 1
        copy_ledger.count_copy(source, n)
        return memoryview(buf)


_DEFAULT = StagingPool()


def default_pool() -> StagingPool:
    """The process-global pool the async server's connections stage
    request sidebands into."""
    return _DEFAULT
