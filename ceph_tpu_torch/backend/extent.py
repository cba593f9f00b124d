"""Interval (extent) set arithmetic.

Analog of the reference's ``extent_set``/``interval_set`` used throughout the
EC write-planning and cache code (reference: src/include/interval_set.h,
src/osd/ECTransaction.h:29-31).  Extents are half-open byte ranges
``[start, end)`` kept sorted and coalesced.
"""
from __future__ import annotations

from bisect import bisect_right
from collections.abc import Iterator


class ExtentSet:
    """Sorted, coalesced set of half-open intervals."""

    def __init__(self, extents=()):  # iterable of (start, len)
        self._spans: list[tuple[int, int]] = []  # (start, end)
        for off, length in extents:
            self.union_insert(off, length)

    # -- mutation ----------------------------------------------------------

    def union_insert(self, off: int, length: int) -> None:
        """Insert [off, off+length), merging overlaps (interval_set::union_insert)."""
        if length <= 0:
            return
        start, end = off, off + length
        spans = self._spans
        i = bisect_right(spans, (start,)) - 1
        if i >= 0 and spans[i][1] >= start:
            start = min(start, spans[i][0])
        else:
            i += 1
        j = i
        while j < len(spans) and spans[j][0] <= end:
            end = max(end, spans[j][1])
            j += 1
        spans[i:j] = [(start, end)]

    def subtract(self, other: "ExtentSet") -> None:
        for off, end in other._spans:
            self.erase(off, end - off)

    def erase(self, off: int, length: int) -> None:
        if length <= 0:
            return
        start, end = off, off + length
        out = []
        for s, e in self._spans:
            if e <= start or s >= end:
                out.append((s, e))
                continue
            if s < start:
                out.append((s, start))
            if e > end:
                out.append((end, e))
        self._spans = out

    # -- queries -----------------------------------------------------------

    def contains(self, off: int, length: int = 1) -> bool:
        i = bisect_right(self._spans, (off,))
        if i and self._spans[i - 1][0] <= off and off + length <= self._spans[i - 1][1]:
            return True
        # exact-start span
        if i < len(self._spans) and self._spans[i][0] == off:
            return off + length <= self._spans[i][1]
        return False

    def intersects(self, off: int, length: int) -> bool:
        end = off + length
        for s, e in self._spans:
            if s < end and off < e:
                return True
        return False

    def intersection(self, other: "ExtentSet") -> "ExtentSet":
        out = ExtentSet()
        a, b = self._spans, other._spans
        i = j = 0
        while i < len(a) and j < len(b):
            s = max(a[i][0], b[j][0])
            e = min(a[i][1], b[j][1])
            if s < e:
                out._spans.append((s, e))
            if a[i][1] < b[j][1]:
                i += 1
            else:
                j += 1
        return out

    def union(self, other: "ExtentSet") -> "ExtentSet":
        out = ExtentSet()
        for s, e in self._spans:
            out.union_insert(s, e - s)
        for s, e in other._spans:
            out.union_insert(s, e - s)
        return out

    def size(self) -> int:
        """Total bytes covered."""
        return sum(e - s for s, e in self._spans)

    def range_start(self) -> int:
        return self._spans[0][0]

    def range_end(self) -> int:
        return self._spans[-1][1]

    def __bool__(self) -> bool:
        return bool(self._spans)

    def __len__(self) -> int:
        return len(self._spans)

    def __iter__(self) -> Iterator[tuple[int, int]]:
        """Yield (start, length) pairs."""
        return ((s, e - s) for s, e in self._spans)

    def __eq__(self, other) -> bool:
        return isinstance(other, ExtentSet) and self._spans == other._spans

    def __repr__(self) -> str:
        return "ExtentSet([%s])" % ", ".join(
            f"{s}~{e - s}" for s, e in self._spans)
