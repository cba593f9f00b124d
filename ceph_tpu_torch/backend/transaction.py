"""Client-level object transactions and EC write planning.

Analog of the reference's ``PGTransaction`` (reference:
src/osd/PGTransaction.h) and ``ECTransaction::get_write_plan`` (reference:
src/osd/ECTransaction.h:40-183): computes which whole stripes must be read
(RMW head/tail partials) and which stripe-aligned extents will be written.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .ecutil import HashInfo, StripeInfo
from .extent import ExtentSet


@dataclass
class ObjectOperation:
    """One object's mutation set (PGTransaction::ObjectOperation shape)."""
    delete_first: bool = False
    # buffer updates: (logical offset, payload bytes)
    buffer_updates: list[tuple[int, bytes]] = field(default_factory=list)
    # (truncate_before_writes, truncate_after_writes) — ECTransaction.h:71,154
    truncate: tuple[int, int] | None = None
    source: str | None = None  # rename/clone source oid
    # pre-encoded chunk streams ({chunk index: bytes-like}) supplied by a
    # cross-op batch encoder (ecutil.encode_many): the backend uses them
    # instead of encoding, IF the assembled write bytes equal
    # ``precomputed_for`` exactly (a plan that turned into an RMW falls
    # back to a live encode) — the cross-PG coalescing hook SURVEY §3.2
    # marks as the main device restructuring
    precomputed_chunks: dict | None = None
    precomputed_for: bytes | None = None
    # object attribute updates (name -> value, None = remove), applied to
    # every shard like the reference's per-shard xattr replication
    # (PGTransaction::ObjectOperation::attr_updates, src/osd/PGTransaction.h)
    attr_updates: dict[str, object] = field(default_factory=dict)
    # omap mutations in order: ("set", {k: v}) | ("rm", [k]) | ("clear",)
    # — replicated pools only; EC pools reject omap like the reference
    omap_ops: list[tuple] = field(default_factory=list)
    # snapshot copy-on-write: clone this object's PRE-op state to each
    # listed oid before mutations apply (PGTransaction's clone op; the
    # make_writable COW, src/osd/PrimaryLogPG.cc).  Shard-local clones
    # are exact for both pool types (chunks clone chunk-wise).
    clone_to: list[str] = field(default_factory=list)
    # snapshot rollback: replace this object wholesale with the named
    # source object's state (CEPH_OSD_OP_ROLLBACK -> _rollback_to)
    rollback_from: str | None = None

    def write(self, offset: int, data: bytes) -> "ObjectOperation":
        self.buffer_updates.append((offset, bytes(data)))
        return self

    def setattr(self, name: str, value) -> "ObjectOperation":
        self.attr_updates[name] = value
        return self

    def rmattr(self, name: str) -> "ObjectOperation":
        self.attr_updates[name] = None
        return self


class PGTransaction:
    """oid -> ObjectOperation, applied in insertion order."""

    def __init__(self):
        self.ops: dict[str, ObjectOperation] = {}

    def touch(self, oid: str) -> ObjectOperation:
        return self.ops.setdefault(oid, ObjectOperation())

    def write(self, oid: str, offset: int, data: bytes) -> "PGTransaction":
        self.touch(oid).write(offset, data)
        return self

    def delete(self, oid: str) -> "PGTransaction":
        self.touch(oid).delete_first = True
        return self

    def truncate_to(self, oid: str, size: int) -> "PGTransaction":
        self.touch(oid).truncate = (size, size)
        return self


@dataclass
class WritePlan:
    """ECTransaction::WritePlan (ECTransaction.h:26-33)."""
    t: PGTransaction
    to_read: dict[str, ExtentSet] = field(default_factory=dict)
    will_write: dict[str, ExtentSet] = field(default_factory=dict)
    hash_infos: dict[str, HashInfo] = field(default_factory=dict)
    invalidates_cache: bool = False


def get_write_plan(sinfo: StripeInfo, t: PGTransaction, get_hinfo,
                   sub_chunk_count: int = 1) -> WritePlan:
    """Mirror of the reference planner (ECTransaction.h:40-183).

    ``get_hinfo(oid) -> HashInfo`` supplies the projected-size oracle.  For
    each object: unaligned truncates force a read+rewrite of their last
    stripe; every write extent reads its partial head/tail stripes when they
    overlap existing data; ``will_write`` is the stripe-aligned hull of the
    writes (a superset of ``to_read``).

    ``sub_chunk_count > 1`` (clay) additionally forces any PARTIAL write
    to a full-object read+rewrite: the sub-chunk interleave is a function
    of the WHOLE chunk height, so a write that left old bytes in place
    would stitch codewords of different geometries into one stored chunk
    and every later decode — degraded read, fractional repair — would
    reconstruct garbage (found by the clay thrash soak).  The reference
    never hits this because it encodes strictly per stripe; this
    codebase's whole-extent batched encode is bit-identical only for
    per-byte-linear codes, so sub-chunked codes pay the rewrite instead.
    """
    plan = WritePlan(t=t)
    for oid, op in t.ops.items():
        hinfo = get_hinfo(oid)
        plan.hash_infos[oid] = hinfo
        projected_size = hinfo.get_projected_total_logical_size(sinfo)

        if op.delete_first:
            projected_size = 0
        if op.source is not None:
            plan.invalidates_cache = True
            shinfo = get_hinfo(op.source)
            projected_size = shinfo.get_projected_total_logical_size(sinfo)
            plan.hash_infos[op.source] = shinfo

        will_write = plan.will_write.setdefault(oid, ExtentSet())

        if op.truncate is not None and op.truncate[0] < projected_size:
            if not sinfo.logical_offset_is_stripe_aligned(op.truncate[0]):
                prev = sinfo.logical_to_prev_stripe_offset(op.truncate[0])
                plan.to_read.setdefault(oid, ExtentSet()).union_insert(
                    prev, sinfo.stripe_width)
                will_write.union_insert(prev, sinfo.stripe_width)
            projected_size = sinfo.logical_to_next_stripe_offset(op.truncate[0])

        raw_write_set = ExtentSet()
        for off, data in op.buffer_updates:
            raw_write_set.union_insert(off, len(data))

        orig_size = projected_size
        for off, length in raw_write_set:
            head_start = sinfo.logical_to_prev_stripe_offset(off)
            head_finish = sinfo.logical_to_next_stripe_offset(off)
            if head_start > projected_size:
                head_start = projected_size
            if head_start != head_finish and head_start < orig_size:
                plan.to_read.setdefault(oid, ExtentSet()).union_insert(
                    head_start, sinfo.stripe_width)

            tail_start = sinfo.logical_to_prev_stripe_offset(off + length)
            tail_finish = sinfo.logical_to_next_stripe_offset(off + length)
            if (tail_start != tail_finish and
                    (head_start == head_finish or tail_start != head_start) and
                    tail_start < orig_size):
                plan.to_read.setdefault(oid, ExtentSet()).union_insert(
                    tail_start, sinfo.stripe_width)

            if head_start != tail_finish:
                will_write.union_insert(head_start, tail_finish - head_start)
                if tail_finish > projected_size:
                    projected_size = tail_finish

        if op.truncate is not None and op.truncate[1] > projected_size:
            truncating_to = sinfo.logical_to_next_stripe_offset(op.truncate[1])
            will_write.union_insert(projected_size,
                                    truncating_to - projected_size)
            projected_size = truncating_to

        if sub_chunk_count > 1 and len(list(will_write)):
            # one object = ONE codeword: extend a partial write to cover
            # the whole object, reading back every stripe the op's own
            # writes don't supply (the RMW machinery overlays reads and
            # writes before the single full-height encode)
            end = sinfo.logical_to_next_stripe_offset(projected_size)
            spans = list(will_write)
            if not (len(spans) == 1 and spans[0][0] == 0
                    and spans[0][1] >= end):
                old_end = min(sinfo.logical_to_next_stripe_offset(
                    orig_size), end)
                gaps = ExtentSet([(0, old_end)])
                gaps.subtract(will_write)
                to_read = plan.to_read.setdefault(oid, ExtentSet())
                for g_off, g_len in gaps:
                    to_read.union_insert(g_off, g_len)
                will_write.union_insert(0, end)

        hinfo.set_projected_total_logical_size(sinfo, projected_size)
    return plan
