"""Write-pinned stripe cache for the EC RMW pipeline.

Analog of the reference's ``ExtentCache`` (reference:
src/osd/ExtentCache.{h,cc}; design in
doc/dev/osd_internals/erasure_coding/ecbackend.rst:176-188): stripes written
by in-flight ops stay pinned so an overlapping later write reads them from
cache instead of re-reading shards — the pipeline never sees stale data and
never stalls on its own writes.
"""
from __future__ import annotations

from .extent import ExtentSet


class ExtentCache:
    def __init__(self):
        # oid -> {stripe-aligned offset interval: bytes}, flat byte map
        self._pinned: dict[str, dict[int, bytes]] = {}
        # oid -> tid -> extents pinned by that op
        self._by_op: dict[str, dict[int, ExtentSet]] = {}

    def present(self, oid: str) -> ExtentSet:
        es = ExtentSet()
        for off, buf in self._pinned.get(oid, {}).items():
            es.union_insert(off, len(buf))
        return es

    def claim(self, oid: str, tid: int, offset: int, data: bytes) -> None:
        """Pin [offset, offset+len(data)) with op tid's freshly-written bytes."""
        self._pinned.setdefault(oid, {})
        self._merge(oid, offset, bytes(data))
        self._by_op.setdefault(oid, {}).setdefault(tid, ExtentSet()) \
            .union_insert(offset, len(data))

    def _merge(self, oid: str, offset: int, data: bytes) -> None:
        spans = self._pinned[oid]
        end = offset + len(data)
        merged_off, merged = offset, bytearray(data)
        for off in sorted(list(spans)):
            buf = spans[off]
            if off + len(buf) < merged_off or off > end:
                continue
            # overlap/adjacency: splice (new data wins on overlap)
            del spans[off]
            new_off = min(off, merged_off)
            new_end = max(off + len(buf), merged_off + len(merged))
            out = bytearray(new_end - new_off)
            out[off - new_off:off - new_off + len(buf)] = buf
            out[merged_off - new_off:merged_off - new_off + len(merged)] = merged
            merged_off, merged = new_off, out
            end = merged_off + len(merged)
        spans[merged_off] = bytes(merged)

    def read(self, oid: str, offset: int, length: int) -> bytes | None:
        """The cached bytes for [offset, offset+length), or None if not fully pinned."""
        for off, buf in self._pinned.get(oid, {}).items():
            if off <= offset and offset + length <= off + len(buf):
                return buf[offset - off:offset - off + length]
        return None

    def release(self, oid: str, tid: int) -> None:
        """Drop op tid's pins; bytes stay until no op covers them."""
        ops = self._by_op.get(oid)
        if not ops or tid not in ops:
            return
        del ops[tid]
        still = ExtentSet()
        for es in ops.values():
            still = still.union(es)
        spans = self._pinned.get(oid, {})
        for off in sorted(list(spans)):
            buf = spans[off]
            del spans[off]
            # keep only sub-ranges still pinned by a live op
            for s, ln in still.intersection(
                    ExtentSet([(off, len(buf))])):
                spans[s] = buf[s - off:s - off + ln]
        if not ops:
            self._by_op.pop(oid, None)
        if not spans:
            self._pinned.pop(oid, None)
