"""Per-PG operation log: bounded history for log-based recovery.

Analog of the reference's ``PGLog`` (reference: src/osd/PGLog.{h,cc} ~3k
LoC; EC rollback-entry semantics described in
doc/dev/osd_internals/erasure_coding/ecbackend.rst:8-26): every committed
write appends an entry ``(version, oid, op)``; the log covers the window
``(tail, head]`` and is trimmed as it grows.  A shard that missed writes
is caught up by replaying exactly the entries past its ``last_update``
(O(missed writes)); only a shard whose ``last_update`` predates the tail
needs backfill (O(objects)).  Divergence — a shard holding entries the
authority does not — is detected by comparing entry streams from the
common point, like ``PGLog::merge_log``'s rewind.

The reference keys entries by ``eversion_t(epoch, version)``; here the
single-writer-per-PG pipeline makes the version counter alone total, and
the epoch lives in the map layer (osdmap/mon), so entries carry a plain
monotonic ``version``.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

OP_MODIFY = "modify"
OP_DELETE = "delete"


@dataclass(frozen=True)
class PGLogEntry:
    """pg_log_entry_t (reference: src/osd/osd_types.h pg_log_entry_t)."""
    version: int
    oid: str
    op: str = OP_MODIFY           # OP_MODIFY | OP_DELETE
    prior_version: int = 0        # last version that touched this oid


class PGLog:
    """Bounded ordered log; ``(tail, head]`` are the covered versions."""

    def __init__(self, max_entries: int = 1500):
        self.max_entries = max_entries
        self.entries: deque[PGLogEntry] = deque()
        self.head = 0                 # last_update.version
        self.tail = 0                 # horizon: entries start at tail+1
        self._last_by_oid: dict[str, int] = {}

    # -- append/trim -------------------------------------------------------

    def append(self, oid: str, op: str = OP_MODIFY) -> PGLogEntry:
        self.head += 1
        e = PGLogEntry(self.head, oid, op,
                       prior_version=self._last_by_oid.get(oid, 0))
        self.entries.append(e)
        self._last_by_oid[oid] = self.head
        return e

    def record(self, e: PGLogEntry) -> None:
        """Append a remotely-authored entry (shard side of ECSubWrite)."""
        assert e.version > self.head, f"out of order: {e} after {self.head}"
        self.entries.append(e)
        self.head = e.version
        self._last_by_oid[e.oid] = e.version

    def trim(self, to: int) -> int:
        """Drop entries with version <= ``to``; returns how many."""
        n = 0
        while self.entries and self.entries[0].version <= to:
            e = self.entries.popleft()
            if self._last_by_oid.get(e.oid) == e.version:
                del self._last_by_oid[e.oid]
            n += 1
        self.tail = max(self.tail, to)
        return n

    def rewind(self, to: int) -> list[PGLogEntry]:
        """Drop entries with version > ``to`` (the rollback half of the
        reference's two-phase EC write: entries past the roll-forward point
        are undone when a write fails to reach min_size — the divergent-
        entry rewind of PGLog::merge_log applied locally).  Returns the
        dropped entries, newest first."""
        dropped: list[PGLogEntry] = []
        while self.entries and self.entries[-1].version > to:
            dropped.append(self.entries.pop())
        self.head = max(min(self.head, to), self.tail)
        self._last_by_oid = {e.oid: e.version for e in self.entries}
        return dropped

    def trim_target(self) -> int:
        """Version the followers should trim to (primary piggybacks this on
        sub-writes the way the reference ships ``trim_to``)."""
        return max(0, self.head - self.max_entries)

    def maybe_trim(self) -> None:
        if len(self.entries) > self.max_entries:
            self.trim(self.trim_target())

    # -- queries -----------------------------------------------------------

    def last_version_of(self, oid: str) -> int:
        """Version of the newest in-window entry touching ``oid`` (0 when
        none): the recovery-vs-write race check compares this before and
        after a recovery read to detect an interleaved write."""
        return self._last_by_oid.get(oid, 0)

    def entries_after(self, v: int) -> list[PGLogEntry] | None:
        """Entries with version > v, or None when v predates the tail
        (past the horizon: log cannot catch this follower up)."""
        if v < self.tail:
            return None
        return [e for e in self.entries if e.version > v]

    def catch_up_plan(self, follower_last_update: int
                      ) -> tuple[str, list[PGLogEntry]]:
        """("clean"|"log"|"backfill", entries-to-replay).

        log: replay exactly the missed entries, newest-per-oid
        (PGLog-based recovery); backfill: follower is beyond the horizon.
        """
        if follower_last_update >= self.head:
            return ("clean", [])
        missed = self.entries_after(follower_last_update)
        if missed is None:
            return ("backfill", [])
        return ("log", dedup_latest(missed))

    def divergent_oids(self, follower_entries: list[PGLogEntry]
                       ) -> tuple[set[str], int]:
        """(divergent objects, rewind point) for a follower's log segment.

        Divergent = follower entries past our head, or disagreeing at a
        shared version (merge_log's divergent set); the rewind point is
        the last follower version consistent with this log — the follower
        must drop everything after it."""
        by_version = {e.version: e for e in self.entries}
        out: set[str] = set()
        rewind_to = self.head
        for e in sorted(follower_entries, key=lambda e: e.version):
            if e.version > self.head or (
                    e.version > self.tail and
                    by_version.get(e.version) != e):
                out.add(e.oid)
                rewind_to = min(rewind_to, e.version - 1)
        return out, rewind_to

    def merge_authoritative(self, entries: list[PGLogEntry],
                            last_update: int, rewind_to: int,
                            trim_to: int = 0) -> None:
        """Adopt an authority's segment (the follower half of merge_log):
        drop everything past ``rewind_to``, append the shipped entries,
        advance head to ``last_update``."""
        self.rewind(rewind_to)
        for e in entries:
            if e.version > self.head:
                self.record(e)
        self.head = max(self.head, last_update)
        if trim_to:
            self.trim(trim_to)


def dedup_latest(entries: list[PGLogEntry]) -> list[PGLogEntry]:
    """Collapse to one entry per oid, keeping the newest, in version
    order — replaying the final state per object is sufficient because
    recovery pushes whole current chunks, not deltas."""
    latest: dict[str, PGLogEntry] = {}
    for e in entries:
        latest[e.oid] = e
    return sorted(latest.values(), key=lambda e: e.version)
