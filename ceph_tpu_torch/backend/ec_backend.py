"""The erasure-coded backend: write pipeline, reconstructing reads, recovery.

Analog of the reference's ``ECBackend`` (reference: src/osd/ECBackend.{h,cc};
design note ECBackend.h:520-564) restructured for a device codec:

- Same three-stage ordered write pipeline — ``waiting_state ->
  waiting_reads -> waiting_commit`` — inherited from
  :class:`~ceph_tpu_torch.backend.pg_backend.PGBackend` (the PGBackend.h:628
  abstraction shared with the replicated backend), with this class
  supplying the EC-specific hooks:
  RMW write planning, batched encode, reconstructing reads, and
  minimum_to_decode-driven recovery.
- Same sub-op fan-out over a messenger (the deterministic
  :class:`~ceph_tpu_torch.backend.messages.MessageBus`), one shard-local
  transaction per acting shard (ECBackend.cc:2036-2070), self-delivery for
  the primary's own shard (:2059-2061).
- BUT encode/decode are **batched across all stripes of an op** into one
  device call via :mod:`ceph_tpu_torch.backend.ecutil` instead of the
  reference's per-stripe loop — the restructuring SURVEY.md §2.2 calls the main device
  hook.

Shards are ``OSDShard`` objects (ObjectStore + handler).  Failure is modelled
by ``bus.mark_down``: a dead shard drops requests, the primary routes around
it using ``minimum_to_decode`` exactly like degraded reads do in the
reference (ECBackend.cc:1588-1625), and ``recover_object`` runs the
IDLE->READING->WRITING->COMPLETE machine (ECBackend.h:249-293).

A copy of ``ceph_tpu.backend.ec_backend``.  Its device work is the
port's: ``ecutil.encode`` per op reaches the ``gf_apply`` kernel,
``ecutil.hinfo_append`` the ``crc32c`` kernel, reconstructing reads and
recovery waves (``ecutil.decode``, ``decode_shards_many``) ``gf_apply``
decode, for a plugin whose routing sends the call to the card (torch_rs
with no ``device`` key).  ``attach_serving`` takes the port's
``exec.ServingEngine`` and ``recovery_pipeline`` its
``ops.pipeline.CodecPipeline``; on either, a failure on the card fails
the op.

With an engine attached, a write's encode is a pipeline stage of its own,
as Ceph's ``ECBackend`` keeps a write waiting in one stage while the next
proceeds: the write hands its encode to the engine as a future and parks
at the head of ``waiting_reads`` (``waiting_encode`` lists the parked
writes, in order); the writes behind it in the PG hand theirs over too,
and so do the other PGs' writes, so one burst becomes one device batch.
When the bus has nothing left to deliver, its idle hook
(:meth:`ECBackend._resume_encoded`) flushes the engine and the writes
resume on the delivering thread: the scatter into shard transactions,
the HashInfo crcs, the sub-writes.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from .bluestore import ChecksumError
from .ecutil import HINFO_KEY, HashInfo, StripeInfo, crc32c, decode_shards
from . import ecutil
from .extent import ExtentSet
from .extent_cache import ExtentCache
from .memstore import GObject, Transaction
from .messages import (ECPartialSumAbort, ECPartialSumApplied, ECSubRead,
                       ECSubReadReply, MessageBus, PushOp)
from .pg_backend import (Op, OSDShard, PG_META, PGBackend, RecoveryOp,
                         shard_store,
                         RecoveryState, RepairState, ShardRepairOp,
                         _slice_subchunks)
from .transaction import get_write_plan
from ..common.tracer import default_tracer, trace_span
from ..osd.pg_log import OP_DELETE, OP_MODIFY

__all__ = ["ECBackend", "OSDShard", "RecoveryState", "RecoveryOp",
           "RepairState", "ShardRepairOp", "Op", "ReadOp", "PG_META",
           "make_cluster"]


@dataclass
class _RecoveryWave:
    """One batch-fused recovery wave (the recovery scheduler's unit of
    work): many degraded objects read together — one ECSubRead per source
    shard carrying every oid — and reconstructed through ONE
    ``ecutil.decode_shards_many`` dispatch per survivor signature."""
    tid: int
    oids: dict[str, set[int]]            # oid -> missing chunks
    on_each: object                      # on_each(oid, ok)
    at_version: dict[str, int] = field(default_factory=dict)
    pending_sources: set[int] = field(default_factory=set)
    results: dict[str, dict[int, bytes]] = field(default_factory=dict)
    attrs: dict[str, dict[int, dict]] = field(default_factory=dict)
    # oids dropping to the battle-tested per-object path (read errors,
    # version bumps mid-read, too few survivors)
    fallback: set[str] = field(default_factory=set)
    pending_pushes: dict[str, set[int]] = field(default_factory=dict)
    failed: set[str] = field(default_factory=set)
    # when the wave was dispatched (perf_counter): its objects'
    # recovery.object start
    t0: float = field(default_factory=time.perf_counter)


@dataclass
class ReadOp:
    """In-flight client read (ECBackend::ReadOp, ECBackend.h:155-190)."""
    tid: int
    to_read: dict[str, list[tuple[int, int]]]     # oid -> [(logical off, len)]
    on_complete: object
    shard_extents: dict[str, tuple[int, int]] = field(default_factory=dict)  # oid -> (chunk off, len)
    want_shards: dict[str, set[int]] = field(default_factory=dict)
    # shard -> outstanding reply count (retries can address a shard twice)
    pending_shards: dict[int, int] = field(default_factory=dict)
    results: dict[str, dict[int, bytes]] = field(default_factory=dict)  # oid -> {shard: chunk bytes}
    errors: dict[str, set[int]] = field(default_factory=dict)
    tried_shards: dict[str, set[int]] = field(default_factory=dict)
    for_recovery: bool = False


class ECBackend(PGBackend):
    """Primary-side EC backend over a set of shard OSDs on a message bus."""

    def __init__(self, ec_impl, sinfo: StripeInfo, bus: MessageBus,
                 acting: list[int], whoami: int = 0, cct=None,
                 name: str = "", min_size: int = 0, store=None):
        n = ec_impl.get_chunk_count()
        assert len(acting) == n, f"acting set must have {n} shards"
        self.ec_impl = ec_impl
        self.sinfo = sinfo
        # regenerating MBR chunks expand on disk: let the plugin pin the
        # stored size so shard extents/hinfo stay in real on-disk units
        # (one hook covers every StripeInfo construction site)
        stored_hook = getattr(ec_impl, "get_stored_chunk_size", None)
        if stored_hook is not None:
            sinfo.stored_chunk_size = int(stored_hook(sinfo.chunk_size))
        # min_size floored at k: an ack on fewer than k shards would be
        # unreadable data, which is exactly the loss the gate prevents
        super().__init__(bus, acting, whoami=whoami, cct=cct, name=name,
                         min_size=min_size,
                         min_size_floor=ec_impl.get_data_chunk_count(),
                         store=store, perf_prefix="ec_backend")
        # RMW pipeline reads get a fresh tid per dispatch so replies from a
        # superseded dispatch (shard death re-issue, rollback re-queue)
        # find no mapping and drop instead of polluting the op's buffers
        self._rmw_read_tids: dict[int, Op] = {}
        self.extent_cache = ExtentCache()
        self.in_progress_reads: dict[int, ReadOp] = {}
        self.hinfo_cache: dict[str, HashInfo] = {}
        # batched recovery waves in their READ phase, keyed by read tid
        # (push-phase tracking lives in PGBackend._wave_pushes)
        self._recovery_waves: dict[int, _RecoveryWave] = {}
        # in-flight partial-sum chains (recovery/chain.py), keyed by tid
        self._recovery_chains: dict[int, object] = {}
        # optional serving engine (exec/): when attached, encode/
        # decode dispatches route through its admission+coalescing queue
        # so CONCURRENT ops across PGs fuse into one device batch
        self.serving = None
        # the encode stage: writes whose encodes the engine holds, in
        # pipeline order (each is also in waiting_reads)
        self.waiting_encode: deque[Op] = deque()
        self._encodes_taken = 0
        # the pool's allow_ec_overwrites flag (PrimaryLogPG.ec_overwrites)
        self.ec_overwrites = True

    def attach_serving(self, engine) -> None:
        """Route this backend's codec dispatches through a
        :class:`~ceph_tpu_torch.exec.ServingEngine` (throttled admission,
        deadline-driven cross-op coalescing, QoS-ordered batching), with
        writes encoding in the encode stage (module docstring).  ``None``
        detaches it, once the writes parked on it have moved on."""
        hooks = self.bus.idle_hooks
        if self._resume_encoded in hooks:
            hooks.remove(self._resume_encoded)
        if self.serving is not None and self.waiting_encode:
            self.serving.flush()
            self.check_ops()
        self.serving = engine
        if engine is not None:
            hooks.append(self._resume_encoded)

    def _serving_decode(self, by_chunk) -> bytes:
        if self.serving is not None:
            return self.serving.decode(by_chunk, sinfo=self.sinfo,
                                       ec_impl=self.ec_impl)
        return ecutil.decode(self.sinfo, self.ec_impl, by_chunk)

    # -- the encode stage ----------------------------------------------------

    def _encode_pending(self, op: Op) -> bool:
        """The stage's gate (``try_reads_to_commit``): every write at the
        front of ``waiting_reads`` whose reads are in hands its encodes to
        the engine, in order; the head waits here until its results are
        back.  A write behind a write with reads outstanding keeps its
        place and hands its encode over later."""
        if self.serving is None:
            return False
        for w in self.waiting_reads:
            if w.pending_read_shards:
                break
            if w.encodes is None:
                self._stage_encodes(w)
        return any(not fut.done() for _p, _l, fut in op.encodes.values())

    def _stage_encodes(self, op: Op) -> None:
        """Submit the op's encodes (one an object it writes) to the engine
        and park the op in ``waiting_encode``.  Objects with nothing to
        encode, and chunks ``put_many`` computed beforehand, stay with
        :meth:`_generate_transactions`."""
        op.encodes = {}
        for oid, will_write in op.plan.will_write.items():
            objop = op.plan.t.ops[oid]
            if not will_write or objop.rollback_from is not None \
                    or objop.omap_ops:
                continue
            pieces, logical = self._logical_extents(op, oid, objop,
                                                    will_write)
            if self._precomputed(objop, pieces, logical) is not None:
                continue
            fut = self.serving.submit_encode(logical, sinfo=self.sinfo,
                                             ec_impl=self.ec_impl)
            op.encodes[oid] = (pieces, logical, fut)
        if op.encodes:
            op.trace = default_tracer().current_ctx()
            self.waiting_encode.append(op)
            self.perf.inc("encodes_staged", len(op.encodes))
            self.perf.set("encode_parked", len(self.waiting_encode))

    def _take_encode(self, op: Op, oid: str, staged) -> dict:
        """The staged encode's chunks (its error, raised); books the
        op's stay in the stage, from the engine's submit stamps, on
        ``ec.encode_wait`` and ``encode_wait_time``."""
        _pieces, logical, fut = staged
        encoded = fut.result(0)
        wait = time.monotonic() - fut.t_submit
        default_tracer().complete("ec.encode_wait", fut.t_submit_wall, wait,
                                  ctx=op.trace, oid=oid,
                                  bytes=int(logical.nbytes),
                                  backend=self.instance_name)
        self.perf.tinc("encode_wait_time", wait)
        self._encodes_taken += 1
        return encoded

    def _unstage(self, op: Op) -> None:
        """Take the op out of the stage (by identity: ops are dataclasses,
        and ``==`` would compare their transactions)."""
        if op.encodes is not None:
            for i, w in enumerate(self.waiting_encode):
                if w is op:
                    del self.waiting_encode[i]
                    self.perf.set("encode_parked", len(self.waiting_encode))
                    break
        op.encodes = None

    def _resume_encoded(self) -> bool:
        """The bus's idle hook: with writes parked in the encode stage,
        flush the engine (an engine without threads runs its batches
        here, a threaded one is waited for) and move the writes on, on
        this thread.  Returns whether one moved."""
        if not self.waiting_encode:
            return False
        head = self.waiting_encode[0]
        if any(not fut.done() for _p, _l, fut in head.encodes.values()):
            self.serving.flush()
        taken = self._encodes_taken
        self.check_ops()
        return self._encodes_taken != taken

    # -- EC metadata ---------------------------------------------------------

    def _hinfo(self, oid: str) -> HashInfo:
        if oid not in self.hinfo_cache:
            self.hinfo_cache[oid] = self._read_hinfo(oid)
        return self.hinfo_cache[oid]

    def _read_hinfo(self, oid: str) -> HashInfo:
        """The authoritative stored hinfo, bypassing the cache.  Recovery
        sizes its reads with this: the CACHE may hold an in-flight
        write's projected state, and conversely evicting the cache to
        force a re-read would yank that projection out from under the
        write — it would then commit a STALE hinfo to every shard while
        the data/object-info move forward (observed as permanently short
        reads in the seed-244 soak)."""
        n = self.ec_impl.get_chunk_count()
        stored = None
        # hinfo replicates on every shard's copy: when the primary's
        # own copy is gone (bitrot/lost shard object), any CURRENT
        # peer's attr is the same authority — without this fallback a
        # missing primary copy poisons scrub/size for the whole
        # object (fresh version-0 hinfo marks every shard stale).
        # Stale revived shards are excluded: their hinfo may predate
        # writes they missed (current_shards() semantics).  That
        # applies to the PRIMARY'S OWN copy too — while it is stale
        # (repairing itself), current peers are the authority and the
        # local attr is consulted last.
        peers = [s for s in self.acting if s != self.whoami
                 and s in self.current_shards()]
        local_current = self.whoami in self.current_shards()
        order = ([self.whoami] + peers if local_current
                 else peers + [self.whoami])
        for shard in order:
            if shard not in self.bus.handlers:
                continue
            try:
                stored = shard_store(self.bus, shard).getattr(
                    GObject(oid, shard), HINFO_KEY)
                break
            except (FileNotFoundError, KeyError):
                continue
        h = HashInfo(n)
        if stored is not None:
            h.total_chunk_size = stored["total_chunk_size"]
            h.cumulative_shard_hashes = list(
                stored["cumulative_shard_hashes"])
            h.projected_total_chunk_size = h.total_chunk_size
            h.version = stored.get("version", 0)
        return h

    def object_size(self, oid: str) -> int:
        return self._hinfo(oid).get_total_logical_size(self.sinfo)

    def _on_local_rollback(self) -> None:
        # the authority-side hinfo cache reflects the rolled-back write and
        # must be re-read from the restored xattrs before ops re-plan
        self.hinfo_cache.clear()

    # -- write pipeline hooks ------------------------------------------------

    def _admit_op(self, op: Op) -> None:
        """Plan the RMW (ECBackend.cc:1830-1848) and satisfy reads from the
        extent cache where pinned; the remainder is read remotely when the
        op moves to waiting_reads."""
        if op.plan is None:
            op.plan = get_write_plan(
                self.sinfo, op.t, self._hinfo,
                sub_chunk_count=self.ec_impl.get_sub_chunk_count())

    def _op_blocked(self, op: Op) -> bool:
        """An RMW read overlapping an earlier in-flight write must wait until
        that write's bytes are pinned in the cache — the ordering invariant
        the reference's ExtentCache reservation enforces
        (doc/dev/osd_internals/erasure_coding/ecbackend.rst:190-206)."""
        for oid, to_read in op.plan.to_read.items():
            for off, length in to_read:
                # NB: a cache hit does NOT lift the block — cached bytes may
                # be an older op's; any not-yet-committed overlapping write
                # ahead of us must land in the cache first
                for other in self.waiting_reads:
                    ww = other.plan.will_write.get(oid)
                    if ww is not None and ww.intersects(off, length):
                        return True
        return False

    def _start_op_reads(self, op: Op) -> None:
        """(ECBackend.cc:1856-1928): cache-satisfied extents complete here;
        the rest go to the k data shards as chunk reads."""
        need_remote: dict[str, ExtentSet] = {}
        for oid, to_read in op.plan.to_read.items():
            for off, length in to_read:
                cached = self.extent_cache.read(oid, off, length)
                if cached is not None:
                    op.remote_reads.setdefault(oid, {})[off] = cached
                else:
                    need_remote.setdefault(oid, ExtentSet()).union_insert(
                        off, length)
        if need_remote:
            self._start_rmw_reads(op, need_remote)

    def _start_rmw_reads(self, op: Op, need: dict[str, ExtentSet]) -> None:
        """Read the full stripes from k data shards (reads are stripe-aligned
        whole stripes, so the k data chunks suffice when healthy; degraded
        objects fall back to the reconstructing read path)."""
        k = self.ec_impl.get_data_chunk_count()
        cur = self.current_shards()
        want = {self.ec_impl.chunk_index(i) for i in range(k)}
        avail = {i for i, s in enumerate(self.acting) if s in cur}
        avail -= getattr(op, "_rmw_failed", set())   # rotten sources
        minimum = self.ec_impl.minimum_to_decode(want, avail)
        # degraded RMW of a sub-chunked code (clay): the reconstruction
        # decode needs FULL chunks — a chunk slice is not a smaller
        # codeword when the sub-chunk interleave spans the whole height
        # (same rule as objects_read_and_reconstruct; the gap reads of
        # the planner's forced full-object rewrite hit this degraded)
        whole_chunks = ((self.ec_impl.get_sub_chunk_count() > 1
                         and set(minimum) != want)
                        or getattr(self.ec_impl, "requires_full_chunk_io",
                                   False))
        per_shard: dict[int, dict[str, list[tuple]]] = {}
        for oid, es in need.items():
            for off, length in es:
                c_off = self.sinfo.aligned_logical_offset_to_chunk_offset(off)
                c_len = self.sinfo.aligned_logical_offset_to_chunk_offset(length)
                if whole_chunks:
                    c_off, c_len = 0, None
                for chunk in minimum:
                    shard = self.acting[chunk]
                    entry = (c_off, c_len)
                    ext_list = per_shard.setdefault(shard, {}).setdefault(
                        oid, [])
                    if entry not in ext_list:
                        ext_list.append(entry)
        op._rmw_chunks = {c: self.acting[c] for c in minimum}
        op._rmw_need = need
        op._rmw_buf: dict[str, dict[int, dict[int, bytes]]] = {}
        # restarts (rotten-source retry, stall recovery) may carry stale
        # pending entries/sentinels: this dispatch defines the set
        op.pending_read_shards.clear()
        self._rmw_read_tids.pop(getattr(op, "_rmw_read_tid", None), None)
        self.next_tid += 1
        op._rmw_read_tid = self.next_tid
        self._rmw_read_tids[op._rmw_read_tid] = op
        for shard, to_read in per_shard.items():
            op.pending_read_shards.add(shard)
            self.bus.send(shard, ECSubRead(self.whoami, op._rmw_read_tid,
                                           to_read))

    def _apply_attr_updates(self, oid: str, objop, shard_txns) -> None:
        """Replicate the op's attr updates to every shard's transaction."""
        for shard in self.acting:
            obj = GObject(oid, shard)
            for name, value in objop.attr_updates.items():
                if value is None:
                    shard_txns[shard].rmattr(obj, name)
                else:
                    shard_txns[shard].setattr(obj, name, value)

    def _generate_transactions(self, op: Op):
        """(ECBackend.cc:1930-2087 / ECTransaction.cc generate_transactions):
        encode the will-write extents in one batched device call and
        scatter per-shard chunk writes."""
        n = self.ec_impl.get_chunk_count()
        shard_txns = {shard: Transaction() for shard in self.acting}
        log_entries = []
        for oid, will_write in op.plan.will_write.items():
            objop = op.plan.t.ops[oid]
            if objop.clone_to:
                # snapshot COW: clone the PRE-op shard chunks (+ attrs,
                # incl. hinfo — a chunk-wise clone is exact for EC).
                # Each clone gets its OWN log entry: a shard that missed
                # this transaction must replay the clone too, or log
                # repair would resurrect the head and silently drop the
                # snapshot state (observed: revived shards lost clones).
                for shard in self.acting:
                    src = GObject(oid, shard)
                    for clone_oid in objop.clone_to:
                        shard_txns[shard].clone(src, GObject(clone_oid,
                                                             shard))
                for clone_oid in objop.clone_to:
                    log_entries.append(self.pg_log.append(clone_oid,
                                                          OP_MODIFY))
                if oid in self.inconsistent_objects:
                    # COW copies the DAMAGED state under a new name: the
                    # clone inherits the flag, or the snapshot would
                    # serve laundered corruption while the head's
                    # wholesale-overwrite exoneration erases all trace
                    self.inconsistent_objects.update(objop.clone_to)
            if objop.rollback_from is not None:
                # replace head wholesale with the clone's shard state;
                # the cached head hinfo is now stale — the cloned attrs
                # carry the authoritative one.  attr updates staged by
                # the op engine (object_info/snapset) land ON TOP of the
                # cloned attrs, in the same atomic transaction.
                for shard in self.acting:
                    shard_txns[shard].clone(
                        GObject(objop.rollback_from, shard),
                        GObject(oid, shard))
                # rollback REPLACES the head with the source's state —
                # including its damage status: restoring from a damaged
                # clone flags the head (the COW-laundering fix's mirror
                # direction), restoring from a clean one exonerates it
                if objop.rollback_from in self.inconsistent_objects:
                    self.inconsistent_objects.add(oid)
                else:
                    self.inconsistent_objects.discard(oid)
                self._apply_attr_updates(oid, objop, shard_txns)
                log_entries.append(self.pg_log.append(oid, OP_MODIFY))
                self.hinfo_cache.pop(oid, None)
                op.plan.hash_infos.pop(oid, None)
                continue
            hinfo = op.plan.hash_infos[oid]
            hinfo.version += 1      # down shards miss this bump -> stale
            # one pg_log entry per touched object (pg_log_entry_t); a pure
            # delete logs DELETE, anything that leaves data logs MODIFY
            is_delete = (objop.delete_first and not objop.buffer_updates
                         and objop.truncate is None)
            log_entries.append(self.pg_log.append(
                oid, OP_DELETE if is_delete else OP_MODIFY))
            if objop.delete_first:
                for chunk, shard in enumerate(self.acting):
                    shard_txns[shard].remove(GObject(oid, shard))
                hinfo.clear()
            if objop.truncate is not None:
                # truncate-before-writes: shrink every shard to the chunk
                # offset of the next stripe boundary, then let the rewritten
                # partial stripe (planned by get_write_plan) land on top
                # (reference: ECTransaction.cc generate_transactions truncate
                # handling; ECTransaction.h:70-86)
                t_logical = self.sinfo.logical_to_next_stripe_offset(
                    objop.truncate[0])
                t_chunk = self.sinfo.chunk_to_stored(
                    self.sinfo.aligned_logical_offset_to_chunk_offset(
                        t_logical))
                if t_chunk < hinfo.total_chunk_size:
                    for chunk, shard in enumerate(self.acting):
                        shard_txns[shard].truncate(GObject(oid, shard), t_chunk)
                    if t_chunk == 0 and not self.ec_overwrites:
                        # a pool without overwrites keeps its hashes: an
                        # empty chunk's crc is the seed, so the chain
                        # restarts (a write_full's truncate to 0)
                        hinfo.clear()
                    else:
                        hinfo.set_total_chunk_size_clear_hash(t_chunk)
            if objop.omap_ops:
                # EC pools do not support omap, exactly like the reference
                # (PrimaryLogPG rejects with -EOPNOTSUPP before it gets
                # here; this is the backend's own guard)
                raise ValueError("EC pools do not support omap operations")
            wholesale = objop.delete_first or (
                objop.truncate is not None and any(
                    off == 0 and len(d) >= objop.truncate[0]
                    for off, d in objop.buffer_updates))
            if wholesale:
                # WHOLESALE replacement re-derives every chunk from fresh
                # data: a damaged object is exonerated (operator restore).
                # A partial truncate+write is NOT enough — chunks below
                # the boundary could still hold laundered rot.
                self.inconsistent_objects.discard(oid)
            if objop.attr_updates and not is_delete:
                # object attrs replicate to every shard (the reference
                # stores xattrs on each shard's ghobject, PGTransaction.h).
                # A delete+recreate vector (delete_first AND new writes)
                # keeps its re-staged attrs: the remove is already queued
                # above, so these setattrs land on the fresh object.
                self._apply_attr_updates(oid, objop, shard_txns)
            if not will_write:
                if not objop.delete_first:
                    self._persist_hinfo(oid, hinfo, shard_txns)
                continue
            staged = op.encodes.pop(oid, None) if op.encodes else None
            if staged is not None:
                # the encode stage's result (_encode_pending)
                pieces, logical = staged[0], staged[1]
                encoded = self._take_encode(op, oid, staged)
            else:
                pieces, logical = self._logical_extents(op, oid, objop,
                                                        will_write)
                encoded = self._precomputed(objop, pieces, logical)
            if encoded is None:
                # ONE batched encode over all extents' stripes
                with trace_span("ec.encode", oid=oid,
                                bytes=int(logical.nbytes),
                                backend=self.instance_name), \
                        self.perf.time("encode_time"):
                    encoded = ecutil.encode(self.sinfo, self.ec_impl,
                                            logical)
            self.perf.inc("stripe_bytes_encoded", int(logical.nbytes))
            if op.tracked:
                op.tracked.mark_event("encoded")
            # scatter per-extent chunk ranges into shard transactions
            c_cursor = 0
            old_size = hinfo.total_chunk_size
            append_chunks: dict[int, np.ndarray] = {}
            appended = 0
            pure_append = True
            for off, data in pieces:
                # shard extents live in STORED units: the encoded chunk
                # streams may be wider than the logical shares (MBR
                # expansion), so offsets/lengths convert before slicing
                c_off = self.sinfo.chunk_to_stored(
                    self.sinfo.aligned_logical_offset_to_chunk_offset(off))
                c_len = self.sinfo.chunk_to_stored(
                    self.sinfo.aligned_logical_offset_to_chunk_offset(
                        len(data)))
                for chunk in range(n):
                    shard = self.acting[chunk]
                    payload = encoded[chunk][c_cursor:c_cursor + c_len]
                    shard_txns[shard].write(
                        GObject(oid, shard), c_off, payload.tobytes())
                if pure_append and c_off == old_size + appended:
                    for chunk in range(n):
                        prev = append_chunks.get(chunk)
                        seg = encoded[chunk][c_cursor:c_cursor + c_len]
                        append_chunks[chunk] = seg if prev is None else \
                            np.concatenate([prev, seg])
                    appended += c_len
                else:
                    pure_append = False
                c_cursor += c_len
                self.extent_cache.claim(oid, op.tid, off, data)
                op.cache_claims.append((oid, op.tid))
            # hash maintenance: pure appends chain the crc (HashInfo::append,
            # ECUtil.cc:161-177); every OVERWRITE clears the hashes —
            # a mid-stream crc is unknowable, and re-deriving fresh
            # digests from the primary's own encode would certify bytes
            # nothing independent ever checked (scrub would then "locate"
            # rot against a self-issued receipt).  Hash-less objects are
            # covered honestly instead: deep scrub's parity-consistency
            # fallback detects rot (and locates it when m >= 2), and
            # verified recovery over inconsistent sources records
            # OBJECT_DAMAGED when one spare equation can detect but not
            # place the rot — rather than laundering it as repaired.
            total = hinfo.projected_total_chunk_size
            if pure_append and appended:
                # fused path: one device crc dispatch over the stacked
                # appended rows when the plugin has a device codec
                ecutil.hinfo_append(hinfo, old_size, append_chunks,
                                    ec_impl=self.ec_impl)
            elif not pure_append:
                hinfo.set_total_chunk_size_clear_hash(total)
            self._persist_hinfo(oid, hinfo, shard_txns)
        self._unstage(op)
        return shard_txns, log_entries

    def _logical_extents(self, op: Op, oid: str, objop, will_write):
        """The logical bytes of every will_write extent: ``(pieces,
        logical)``, the extents as ``(offset, bytes)`` and their
        concatenation, what one batched encode takes."""
        pieces = [(off, self._assemble_extent(op, oid, objop, off, length))
                  for off, length in will_write]
        logical = np.concatenate(
            [np.frombuffer(b, dtype=np.uint8) for _, b in pieces])
        return pieces, logical

    def _precomputed(self, objop, pieces, logical) -> dict | None:
        """The chunks a cross-op batch encoder (ecutil.encode_many via
        put_many) computed for this write, IF the plan really is the
        single full-extent write they were computed for; else None."""
        pre = objop.precomputed_chunks
        if (pre is not None and len(pieces) == 1 and pieces[0][0] == 0 and
                logical.tobytes() == getattr(objop, "precomputed_for",
                                             None)):
            return {c: np.asarray(pre[c], dtype=np.uint8)
                    for c in range(self.ec_impl.get_chunk_count())}
        return None

    def _assemble_extent(self, op: Op, oid: str, objop, off: int,
                         length: int) -> bytes:
        """Merge read-in stripes, cached stripes, and the op's new writes
        into the stripe-aligned extent [off, off+length)."""
        buf = bytearray(length)
        reads = op.remote_reads.get(oid, {})
        for r_off, data in reads.items():
            if r_off >= off + length or r_off + len(data) <= off:
                continue
            s = max(r_off, off)
            e = min(r_off + len(data), off + length)
            buf[s - off:e - off] = data[s - r_off:e - r_off]
        if objop.truncate is not None and reads:
            # only read-in bytes can lie past the truncation point: the
            # buffer starts zeroed (a write_full's truncate to 0 reads
            # nothing)
            t0 = objop.truncate[0]
            if off <= t0 < off + length:
                buf[t0 - off:] = b"\0" * (off + length - t0)
        for w_off, data in objop.buffer_updates:
            if w_off >= off + length or w_off + len(data) <= off:
                continue
            s = max(w_off, off)
            e = min(w_off + len(data), off + length)
            buf[s - off:e - off] = data[s - w_off:e - w_off]
        return bytes(buf)

    def _persist_hinfo(self, oid: str, hinfo: HashInfo, shard_txns) -> None:
        for shard in self.acting:
            shard_txns[shard].setattr(GObject(oid, shard), HINFO_KEY,
                                      hinfo.to_dict())

    def _op_reset_extra(self, op: Op) -> None:
        self._unstage(op)
        for oid, tid in op.cache_claims:
            self.extent_cache.release(oid, tid)
        op.cache_claims.clear()
        self._rmw_read_tids.pop(getattr(op, "_rmw_read_tid", None), None)
        op._rmw_buf = {}

    # -- failure-handling hooks ----------------------------------------------

    def _reissue_rmw(self, op: Op) -> None:
        """Re-issue an op's RMW reads from the current shard set; when too
        few shards remain the op parks (the PG is effectively down, like
        the reference's incomplete state) and is re-driven by on_shard_up.
        The -1 sentinel keeps try_reads_to_commit from running with
        missing data (no real reply ever clears it)."""
        op.pending_read_shards.clear()
        try:
            self._start_rmw_reads(op, op._rmw_need)
            op._rmw_stalled = False
        except IOError:
            op.pending_read_shards.add(-1)
            op._rmw_stalled = True

    def _on_shard_down_reads(self, shard: int, chunk: int) -> None:
        # batched recovery waves: a lost SOURCE aborts the wave's read
        # phase — every object re-drives through the per-object path
        # (which widens, parks, or fails with the usual semantics)
        for tid, wave in list(self._recovery_waves.items()):
            if shard in wave.pending_sources:
                del self._recovery_waves[tid]
                for oid in sorted(wave.oids):
                    self._wave_fallback_one(wave, oid)
        # a lost PUSH TARGET fails that object, the rest of the wave
        # proceeds (the _failed_push analog the per-object path applies)
        for oid, wave in list(self._wave_pushes.items()):
            pend = wave.pending_pushes.get(oid)
            if pend and shard in pend:
                pend.discard(shard)
                wave.failed.add(oid)
                if not pend:
                    self._finish_wave_oid(wave, oid)
        # chained streaming repair: a dead HOP strands the partial sum —
        # pop the chain record first (late acks/aborts become inert),
        # then re-drive its unfinished objects per-object; a dead TARGET
        # was already handled by the push loop above
        for tid, chain in list(self._recovery_chains.items()):
            if shard in getattr(chain, "hop_shards", ()):
                del self._recovery_chains[tid]
                self.perf.inc(f"{getattr(chain, 'kind', 'chain')}_fallbacks")
                for oid in sorted(chain.pending_pushes):
                    self._wave_pushes.pop(oid, None)
                    self._wave_fallback_one(chain, oid)
                chain.pending_pushes.clear()
        for tid, chain in list(self._recovery_chains.items()):
            if not chain.pending_pushes:
                del self._recovery_chains[tid]
        # RMW pipeline reads: re-issue from the remaining shards
        for op in list(self.waiting_reads):
            if shard in op.pending_read_shards:
                self._reissue_rmw(op)
        # client reads: treat like an error reply from that shard
        for rop in list(self.in_progress_reads.values()):
            if shard in rop.pending_shards:
                rop.pending_shards.pop(shard, None)
                for oid in rop.to_read:
                    # tried_shards holds every chunk actually requested
                    # (including retry-widened ones); want_shards is only
                    # the initial minimum set
                    if (chunk in rop.tried_shards.get(oid, ()) and
                            chunk not in rop.results.get(oid, {})):
                        rop.errors.setdefault(oid, set()).add(chunk)
                        self._retry_remaining_shards(rop, oid)
                if not rop.pending_shards:
                    self._complete_read_op(rop)

    def _redrive_reads(self) -> None:
        for op in list(self.waiting_reads):
            if getattr(op, "_rmw_stalled", False):
                self._reissue_rmw(op)

    # -- read path ---------------------------------------------------------

    def objects_read_and_reconstruct(self, reads: dict[str, list[tuple[int, int]]],
                                     on_complete, fast_read: bool = False) -> int:
        """(ECBackend.cc:2331-2385): choose min shards per object, read
        chunk extents, reconstruct if any data shard is unavailable."""
        self.next_tid += 1
        tid = self.next_tid
        rop = ReadOp(tid=tid, to_read=reads, on_complete=on_complete)
        k = self.ec_impl.get_data_chunk_count()
        cur = self.current_shards()
        avail = {i for i, s in enumerate(self.acting) if s in cur}
        want = {self.ec_impl.chunk_index(i) for i in range(k)}
        try:
            base_minimum = self.ec_impl.minimum_to_decode(want, avail)
        except IOError:
            # degraded below k current shards: the read cannot reconstruct
            # right now — EIO to the caller (mirrors the replicated
            # backend's no-current-source answer) rather than an exception
            # unwinding through the daemon's drain loop
            self.in_progress_reads.pop(tid, None)
            on_complete({}, {oid: -5 for oid in reads})
            return tid
        # reconstructing a sub-chunked code (clay): the decode's
        # interleave is a function of the WHOLE chunk height, so a
        # (c_off, c_len) chunk SLICE is not a smaller codeword the way it
        # is for per-byte-linear RS — decode full chunks and slice the
        # logical result instead (the write-planner's full-object-rewrite
        # rule, applied to the read side; found by the clay thrash soak)
        whole_chunks = ((self.ec_impl.get_sub_chunk_count() > 1
                         and set(base_minimum) != want)
                        or getattr(self.ec_impl, "requires_full_chunk_io",
                                   False))
        per_shard: dict[int, dict[str, list[tuple]]] = {}
        for oid, extents in reads.items():
            lo = min(off for off, _ in extents)
            hi = max(off + ln for off, ln in extents)
            start, length = self.sinfo.offset_len_to_stripe_bounds(lo, hi - lo)
            c_off = self.sinfo.aligned_logical_offset_to_chunk_offset(start)
            c_len = self.sinfo.aligned_logical_offset_to_chunk_offset(length)
            if whole_chunks:
                c_off, c_len = 0, None
            rop.shard_extents[oid] = (c_off, c_len)
            minimum = base_minimum
            if fast_read and len(avail) > len(minimum):
                # redundant reads: ask every available shard (ECBackend.cc:1609-1615)
                minimum = {c: [(0, self.ec_impl.get_sub_chunk_count())]
                           for c in avail}
            rop.want_shards[oid] = set(minimum)
            rop.tried_shards[oid] = set(minimum)
            for chunk, subchunks in minimum.items():
                shard = self.acting[chunk]
                runs = None if whole_chunks or subchunks == \
                    [(0, self.ec_impl.get_sub_chunk_count())] else subchunks
                per_shard.setdefault(shard, {}).setdefault(oid, []).append(
                    (c_off, c_len, runs))
        rop.pending_shards = {shard: 1 for shard in per_shard}
        self.in_progress_reads[tid] = rop
        for shard, to_read in per_shard.items():
            self.bus.send(shard, ECSubRead(
                self.whoami, tid, to_read,
                sub_chunk_count=self.ec_impl.get_sub_chunk_count()))
        return tid

    def _handle_other_read_reply(self, reply: ECSubReadReply) -> None:
        """(ECBackend.cc:1153-1320): collect; on error widen the shard set
        (send_all_remaining_reads :2386)."""
        # batched recovery wave reads
        wave = self._recovery_waves.get(reply.tid)
        if wave is not None:
            self._handle_wave_read_reply(wave, reply)
            return
        # RMW pipeline reads
        op = self._rmw_read_tids.get(reply.tid)
        if op is not None:
            self._handle_rmw_read_reply(op, reply)
            return
        rop = self.in_progress_reads.get(reply.tid)
        if rop is None:
            return
        left = rop.pending_shards.get(reply.from_shard, 0) - 1
        if left <= 0:
            rop.pending_shards.pop(reply.from_shard, None)
        else:
            rop.pending_shards[reply.from_shard] = left
        chunk_of_shard = {s: c for c, s in enumerate(self.acting)}
        chunk = chunk_of_shard[reply.from_shard]
        for oid, bufs in reply.buffers_read.items():
            data = b"".join(b for _, b in bufs)
            store = rop.results.setdefault(oid, {})
            # a whole-chunk upgrade (clay retry) re-reads chunks whose
            # sliced replies may still be in flight: under reordered or
            # duplicated delivery the short straggler can land AFTER the
            # full-height reply — the longer buffer always wins (equal
            # extents produce equal lengths, so this is inert otherwise)
            if len(data) >= len(store.get(chunk, b"")):
                store[chunk] = data
        for oid in reply.errors:
            rop.errors.setdefault(oid, set()).add(chunk)
            self._retry_remaining_shards(rop, oid)
        if not rop.pending_shards:
            self._complete_read_op(rop)

    def _retry_remaining_shards(self, rop: ReadOp, oid: str) -> None:
        """Incremental recovery from shard read errors (ECBackend.cc:1627-1671)."""
        k = self.ec_impl.get_data_chunk_count()
        up = self.current_shards()
        avail = {c for c, s in enumerate(self.acting)
                 if s in up and c not in rop.errors.get(oid, set())}
        untried = avail - rop.tried_shards[oid]
        # chunks already read + still outstanding on live shards + the new
        # candidates must reach k (ECBackend.cc:1627-1671 counts pending
        # shards as available too)
        pending = {c for c, s in enumerate(self.acting)
                   if s in rop.pending_shards and s in up and
                   c in rop.tried_shards[oid]}
        have_or_pending = (set(rop.results.get(oid, {})) | pending | untried) \
            - rop.errors.get(oid, set())
        if len(have_or_pending) < k:
            return  # complete_read_op will surface the failure
        c_off, c_len = rop.shard_extents[oid]
        resend = set(untried)
        if self.ec_impl.get_sub_chunk_count() > 1 and \
                not (c_off, c_len) == (0, None):
            # the widened read will DECODE (a failed source means
            # reconstruction), and a sub-chunked code cannot decode
            # chunk slices (see objects_read_and_reconstruct): upgrade
            # this object to whole-chunk reads, dropping the sliced
            # buffers already collected — every contributing chunk is
            # re-fetched at full height (FIFO delivery makes the full
            # reply land after any sliced one still in flight;
            # _complete_read_op drops short stragglers regardless)
            rop.shard_extents[oid] = (0, None)
            c_off, c_len = 0, None
            # ...including chunks whose SLICED replies already landed or
            # are still in flight: every contributor needs a full-height
            # re-read (the stragglers' short buffers are dropped at
            # completion either way)
            resend |= (set(rop.results.get(oid, {})) | pending) & avail
            rop.results.get(oid, {}).clear()
        for chunk in resend:
            shard = self.acting[chunk]
            rop.tried_shards[oid].add(chunk)
            rop.pending_shards[shard] = rop.pending_shards.get(shard, 0) + 1
            self.bus.send(shard, ECSubRead(
                self.whoami, rop.tid, {oid: [(c_off, c_len, None)]}))

    def _handle_rmw_read_reply(self, op: Op, reply: ECSubReadReply) -> None:
        if reply.errors:
            # a source failed (rotten at rest / vanished): restart the
            # WHOLE rmw read excluding that chunk — minimum_to_decode
            # picks a replacement; dropping the chunk silently would hand
            # the decode k-1 chunks (same widening client reads do via
            # _retry_remaining_shards)
            chunk = {s: c for c, s in
                     enumerate(self.acting)}[reply.from_shard]
            op._rmw_failed = getattr(op, "_rmw_failed", set()) | {chunk}
            try:
                self._start_rmw_reads(op, op._rmw_need)
                op._rmw_stalled = False
            except IOError:
                # not enough clean sources: stall like shard loss until
                # a repair/revival re-drives
                op.pending_read_shards.add(-1)
                op._rmw_stalled = True
            return
        op.pending_read_shards.discard(reply.from_shard)
        chunk_of_shard = {s: c for c, s in enumerate(self.acting)}
        chunk = chunk_of_shard[reply.from_shard]
        for oid, bufs in reply.buffers_read.items():
            store = op._rmw_buf.setdefault(oid, {})
            for c_off, data in bufs:
                store.setdefault(c_off, {})[chunk] = data
        if not op.pending_read_shards:
            self._rmw_read_tids.pop(getattr(op, "_rmw_read_tid", None), None)
            self._finish_rmw_reads(op)
            self.check_ops()

    def _finish_rmw_reads(self, op: Op) -> None:
        """Decode each read stripe-run back to logical bytes."""
        for oid, runs in op._rmw_buf.items():
            for c_off, by_chunk in runs.items():
                logical_off = self.sinfo.aligned_chunk_offset_to_logical_offset(c_off)
                with trace_span("ec.decode", oid=oid, kind="rmw_read",
                                backend=self.instance_name), \
                        self.perf.time("decode_time"):
                    data = self._serving_decode(by_chunk)
                op.remote_reads.setdefault(oid, {})[logical_off] = data

    def _complete_read_op(self, rop: ReadOp) -> None:
        """Reassemble/reconstruct and trim (ECBackend.cc:2273-2329)."""
        k = self.ec_impl.get_data_chunk_count()
        result: dict[str, list[tuple[int, int, bytes]]] = {}
        errors: dict[str, int] = {}
        for oid, extents in rop.to_read.items():
            by_chunk = rop.results.get(oid, {})
            by_chunk = {c: v for c, v in by_chunk.items()
                        if c not in rop.errors.get(oid, set())}
            if len(by_chunk) > 0 and \
                    self.ec_impl.get_sub_chunk_count() > 1:
                # a whole-chunk upgrade mid-read (clay retry) may leave
                # sliced stragglers alongside full chunks: only equal
                # full-height buffers may decode together — drop the
                # short ones (better a clean EIO below than garbage)
                full = max(len(v) for v in by_chunk.values())
                by_chunk = {c: v for c, v in by_chunk.items()
                            if len(v) == full}
            if len(by_chunk) < k:
                errors[oid] = -5  # EIO
                continue
            # keep exactly k shards for decode
            chosen = dict(sorted(by_chunk.items())[:k])
            with trace_span("ec.decode", oid=oid, kind="client_read",
                            backend=self.instance_name), \
                    self.perf.time("decode_time"):
                logical = self._serving_decode(chosen)
            c_off, _ = rop.shard_extents[oid]
            base = self.sinfo.aligned_chunk_offset_to_logical_offset(c_off)
            obj_size = self.object_size(oid)
            out = []
            for off, length in extents:
                end = min(off + length, obj_size)
                seg = logical[off - base:end - base] if end > off else b""
                out.append((off, length, seg))
            result[oid] = out
        del self.in_progress_reads[rop.tid]
        if result:
            self.perf.inc("reads")
        if errors:
            self.perf.inc("read_errors", len(errors))
        self.perf.inc("read_bytes", sum(
            len(seg) for segs in result.values() for _, _, seg in segs))
        rop.on_complete(result, errors)

    # -- recovery hooks ------------------------------------------------------

    def is_recoverable(self, oid: str, missing: set[int]) -> bool:
        """ECRecPred analog (ECBackend.h:581-607)."""
        avail = {c for c, s in enumerate(self.acting)
                 if s in self.current_shards() and c not in missing}
        try:
            self.ec_impl.minimum_to_decode(set(missing), avail)
            return True
        except IOError:
            return False

    def _recovery_issue_reads(self, rop: RecoveryOp) -> None:
        avail = {c for c, s in enumerate(self.acting)
                 if s in self.current_shards()
                 and c not in rop.missing_shards}
        minimum = self.ec_impl.minimum_to_decode(rop.missing_shards, avail)
        # recovery sizes its reads from the FRESHEST authoritative hinfo,
        # read PAST the cache: a cached entry may be an empty placeholder
        # from a moment when no source had applied the object yet
        # (reordered delivery) — and evicting the cache instead would
        # corrupt an in-flight write's projection (_read_hinfo docstring)
        hinfo = self._read_hinfo(rop.oid)
        c_len = hinfo.get_total_chunk_size()
        # VERIFIED recovery: when the hinfo hashes are gone (overwrites
        # clear them) the reconstruction sources cannot be crc-checked —
        # a silently rotten source would bake its rot into the rebuilt
        # chunk and the new parity would make the corruption
        # SELF-CONSISTENT (observed via the soak: repair of a revived
        # shard laundered bitrot past every later scrub).  Reading every
        # available full chunk restores the spare equations, and the
        # payload step cross-checks before pushing.
        # Reading all spares also serves the HASH-PRESENT path: a source
        # failing its crc check is dropped and rebuilt, which needs a
        # replacement source in hand.
        # pm_regen repairs whole stored chunks despite sub > 1, so its
        # sources can be crc-checked (and spares held) the same way
        verify = (len(avail) > len(minimum)
                  and (self.ec_impl.get_sub_chunk_count() == 1
                       or getattr(self.ec_impl,
                                  "supports_regenerating_repair",
                                  lambda: False)()))
        want = ({c: [(0, self.ec_impl.get_sub_chunk_count())]
                 for c in sorted(avail)} if verify else minimum)
        per_shard = {}
        for chunk, subchunks in want.items():
            shard = self.acting[chunk]
            runs = None if subchunks == [(0, self.ec_impl.get_sub_chunk_count())] \
                else subchunks
            # whole-chunk reads: a point-in-time LOCAL hinfo can lag a
            # just-generated write whose sub-ops are still queued (log
            # appends at generation, stores apply at delivery), and
            # sizing by it TRUNCATES the sources' newer chunks — the
            # seed-244 soak pushed 512 bytes of a 1024-byte chunk that
            # way.  Each source serves its own current full chunk; only
            # clay's fractional sub-chunk runs still need c_len.
            length = c_len if runs is not None else None
            per_shard.setdefault(shard, {})[rop.oid] = [(0, length, runs)]
        rop._pending = set(per_shard)
        # the replicated attr set (object_info, snapset, user xattrs —
        # identical on every shard) must come from a CURRENT source: the
        # local copy is the right fallback only while the primary itself
        # is current, and when repairing the primary's own stale shard it
        # is exactly the copy that missed the latest attrs
        for shard, to_read in per_shard.items():
            self.bus.send(shard, ECSubRead(
                self.whoami, rop.read_tid, to_read, attrs_to_read={"*"},
                sub_chunk_count=self.ec_impl.get_sub_chunk_count()))

    def _recovery_prepare_sources(self, oid: str,
                                  read_results: dict[int, object],
                                  read_attrs: dict[int, dict],
                                  missing: set[int],
                                  verify_parity: bool = True
                                  ) -> tuple[dict[int, np.ndarray],
                                             HashInfo, set[int], dict]:
        """Turn raw recovery-read replies into decode-ready inputs — ONE
        copy shared by the per-object payload builder and the batched
        wave: adopt a coherent hinfo, normalize source lengths, drop
        (and mark for rebuild) crc- or parity-rotten sources, and build
        the replicated attr set the pushes must carry.  Returns
        ``(available, hinfo, missing, attrs)`` with ``missing`` possibly
        EXTENDED by located rotten sources."""
        missing = set(missing)
        available = {c: (v if isinstance(v, np.ndarray)
                         else np.frombuffer(v, dtype=np.uint8))
                     for c, v in read_results.items()}
        # the hinfo must be COHERENT with the data the sources served:
        # each read reply carries data and attrs from one store state, so
        # a source's attr hinfo describes exactly the bytes it returned —
        # while the local attr can lag (or lead) the read by in-flight
        # sub-writes.  Prefer the newest source hinfo; fall back to the
        # local stored one, then to sizing from the bytes read.
        hinfo = self._read_hinfo(oid)         # uncached: see _read_hinfo
        peer_base = max(
            (a for _c, a in sorted(read_attrs.items())
             if a and HINFO_KEY in a),
            key=lambda a: a[HINFO_KEY].get("version", 0), default=None)
        if peer_base is not None and \
                peer_base[HINFO_KEY].get("version", 0) >= hinfo.version:
            d = peer_base[HINFO_KEY]
            nh = HashInfo(self.ec_impl.get_chunk_count())
            nh.total_chunk_size = d["total_chunk_size"]
            nh.cumulative_shard_hashes = list(
                d["cumulative_shard_hashes"])
            nh.projected_total_chunk_size = nh.total_chunk_size
            nh.version = d.get("version", 0)
            hinfo = nh
        if not hinfo.get_total_chunk_size():
            if available:
                # last resort: size from the bytes actually read
                nh = HashInfo(self.ec_impl.get_chunk_count())
                nh.total_chunk_size = max(len(v) for v in
                                          available.values())
                nh.projected_total_chunk_size = nh.total_chunk_size
                hinfo = nh
        # whole-chunk reads may catch sources mid-update at different
        # lengths: normalize to the adopted hinfo's size — a source whose
        # bytes are from another version then fails its crc (or the
        # parity-consistency check) and is dropped/rebuilt below.
        # Sub-chunk codes (clay) are exempt: their repair reads are
        # INTENTIONALLY shorter than the chunk (fractional sub-chunk
        # runs), and padding them to full length makes the plugin
        # mistake them for whole chunks and full-decode garbage — the
        # seed's wrong-bytes clay recovery (ROADMAP item 1).
        # pm_regen is sub-chunked too, but its recovery reads are always
        # WHOLE stored chunks (requires_full_chunk_io / the regen gate),
        # so length normalization and the crc check below stay valid
        whole_reads = (self.ec_impl.get_sub_chunk_count() == 1
                       or getattr(self.ec_impl,
                                  "supports_regenerating_repair",
                                  lambda: False)())
        total = hinfo.get_total_chunk_size()
        if total and whole_reads:
            available = {
                c: (v if len(v) == total else np.frombuffer(
                    v.tobytes()[:total].ljust(total, b"\0"),
                    dtype=np.uint8))
                for c, v in available.items()}
        k = self.ec_impl.get_data_chunk_count()
        if hinfo.has_chunk_hash() and whole_reads:
            # the reference CRC-verifies recovery reads against the
            # hinfo before reconstructing (ECBackend handle_recovery_
            # read_complete checks the cumulative hash): a source whose
            # crc mismatches is itself rotten — drop it and rebuild it
            # too rather than bake its rot into the new chunk
            rotten = [c for c, v in available.items()
                      if crc32c(0xFFFFFFFF, v) != hinfo.get_chunk_hash(c)]
            if rotten and len(available) - len(rotten) >= k:
                for c in rotten:
                    del available[c]
                missing |= set(rotten)
            elif rotten:
                # not enough clean sources to rebuild everything: the
                # reconstruction would embed rot — record damage
                self.inconsistent_objects.add(oid)
        if verify_parity and not hinfo.has_chunk_hash() \
                and len(available) > k \
                and self.ec_impl.get_sub_chunk_count() == 1:
            # verified recovery (see _recovery_issue_reads): cross-check
            # the sources with the spare equations and DROP a located
            # rotten source instead of baking it into the rebuilt chunk.
            # (The batched wave passes verify_parity=False and runs ONE
            # fused check per survivor signature instead.)
            available, missing = self._verify_parity_sources(
                oid, available, missing)
        # pushes REPLACE the target object, so the replicated attrs
        # (user xattrs, object_info, snapset — identical on every shard)
        # must travel too, from a CURRENT copy; without them, repairing a
        # located rotten source would WIPE the xattrs that shard held
        # correctly.  Prefer a recovery-read source's attrs (sources are
        # current by construction — the local copy is stale exactly when
        # the primary's own shard is the one being repaired); each
        # source's shard-specific hinfo is stripped.
        attrs = {HINFO_KEY: hinfo.to_dict()}
        base = next((a for _c, a in sorted(read_attrs.items())
                     if a), None)
        if base is None:
            try:
                base = self.local_shard.store.getattrs(
                    GObject(oid, self.whoami))
            except FileNotFoundError:
                base = {}
        attrs = {**{a: v for a, v in base.items() if a != HINFO_KEY},
                 **attrs}
        return available, hinfo, missing, attrs

    def _verify_parity_sources(self, oid: str,
                               available: dict[int, np.ndarray],
                               missing: set[int]
                               ) -> tuple[dict[int, np.ndarray], set[int]]:
        """Per-object spare-equation cross-check of hash-less recovery
        sources: a LOCATED rotten source is dropped and rebuilt; rot the
        spare equations can detect but not place marks OBJECT_DAMAGED
        (rebuilding would launder it, and erasing the trace is the seed
        regression this PR's satellite pins)."""
        k = self.ec_impl.get_data_chunk_count()
        out_map = {c: True for c in available}
        self._parity_consistency_scrub(
            oid, {c: v.tobytes() for c, v in available.items()}, out_map)
        bad = [c for c, ok in out_map.items() if not ok]
        if len(bad) == 1 and len(available) - 1 >= k:
            missing = missing | set(bad)
            available = {c: v for c, v in available.items() if c != bad[0]}
        elif bad:
            # inconsistent but unlocatable (one spare equation can
            # DETECT rot, never place it): the rebuild may launder
            # corruption — record the object as damaged
            self.inconsistent_objects.add(oid)
        return available, missing

    def _spare_equations_consistent(self,
                                    chunks: dict[int, np.ndarray]) -> bool:
        """ONE-decode detection over > k normalized chunk streams:
        reconstruct every spare chunk from a k-subset and compare against
        what the sources served.  For the MDS codes this path serves
        (torch_rs/isa/jerasure RS, xor) any single-chunk delta propagates
        into at least one reconstructed spare, so clean == consistent;
        plugins whose k-subsets are not all decodable (shec/lrc) raise
        and fall back to the thorough per-target scan.  This is the
        batched wave's fused verification: linear codes make the check
        distribute over concatenation, so one call covers every object
        sharing the survivor signature."""
        k = self.ec_impl.get_data_chunk_count()
        ids = sorted(chunks)
        spares = ids[k:]
        if not spares:
            return True                # no redundancy: vacuously consistent
        length = int(len(chunks[ids[0]]))
        try:
            rec = self.ec_impl.decode(
                set(spares), {i: chunks[i] for i in ids[:k]}, length)
        except (IOError, ValueError):  # non-MDS subset: thorough fallback
            out_map = {c: True for c in ids}
            self._parity_consistency_scrub(
                "", {c: v.tobytes() for c, v in chunks.items()}, out_map)
            return all(out_map.values())
        return all(np.array_equal(np.asarray(rec[s], dtype=np.uint8),
                                  chunks[s]) for s in spares)

    def _recovery_push_payloads(self, rop: RecoveryOp
                                ) -> dict[
            int, tuple[bytes, dict, dict | None, bytes]]:
        # reconstruct the missing chunks; chunk_size tells sub-chunk codes
        # (clay) the helpers are fractional
        available, hinfo, missing, attrs = self._recovery_prepare_sources(
            rop.oid, rop._read_results, rop._read_attrs,
            set(rop.missing_shards))
        rop.missing_shards = missing
        rec = decode_shards(self.sinfo, self.ec_impl, available,
                            rop.missing_shards,
                            chunk_size=hinfo.get_total_chunk_size())
        return {chunk: (bytes(rec[chunk]), dict(attrs), None, b"")
                for chunk in rop.missing_shards}

    # -- batch-fused recovery waves (the recovery scheduler's dispatch) ----

    def _recover_many(self, oids: dict[str, set[int]], on_each) -> None:
        """Recover a wave of degraded objects with ONE read per source
        shard and ONE ``decode_shards_many`` dispatch per survivor
        signature — instead of the per-object machine's N reads and N
        decodes.  Objects the batch cannot serve safely (sub-chunk codes,
        too few survivors, singletons with nothing to fuse) drop to the
        verified per-object path."""
        k = self.ec_impl.get_data_chunk_count()
        cur = self.current_shards()
        # regenerating codes (product-matrix MSR/MBR) take every
        # single-erasure object FIRST — d helper inner products move
        # fewer bytes than any decode-based path; leftovers (multi-loss,
        # too few helpers, plan gaps) fall through unchanged.  The probe
        # keeps non-regenerating codes entirely untouched.
        if oids and getattr(self.ec_impl, "supports_regenerating_repair",
                            lambda: False)():
            from ..recovery.regen import plan_regens
            oids = plan_regens(self, oids, on_each)
            if not oids:
                return
        if self.ec_impl.get_sub_chunk_count() != 1 or len(oids) < 2:
            # clay's fractional repair reads are not positionwise across
            # objects; a singleton has nothing to fuse — per-object keeps
            # the minimum-read plan
            super()._recover_many(oids, on_each)
            return
        singles: dict[str, set[int]] = {}
        batch: dict[str, set[int]] = {}
        for oid, missing in oids.items():
            avail = {c for c, s in enumerate(self.acting)
                     if s in cur and c not in missing}
            (batch if len(avail) >= k else singles)[oid] = set(missing)
        if singles:
            super()._recover_many(singles, on_each)
        if not batch:
            return
        # chained streaming repair takes every eligible object first
        # (linear whole-chunk codes, targets up, plan metadata present);
        # its leftovers fall through to the centralized wave below
        from ..recovery.chain import plan_chains
        batch = plan_chains(self, batch, on_each)
        if not batch:
            return
        if len(batch) == 1:
            super()._recover_many(batch, on_each)
            return
        self.next_tid += 1
        tid = self.next_tid
        wave = _RecoveryWave(tid=tid, oids=batch, on_each=on_each)
        per_shard: dict[int, dict[str, list[tuple]]] = {}
        for oid, missing in sorted(batch.items()):
            wave.at_version[oid] = self.pg_log.last_version_of(oid)
            for chunk in sorted({c for c, s in enumerate(self.acting)
                                 if s in cur and c not in missing}):
                # every available chunk, whole (the verified-recovery
                # read: spare equations cross-check the sources, and
                # each source serves its own current full chunk —
                # _recovery_issue_reads' sizing rationale)
                per_shard.setdefault(self.acting[chunk],
                                     {})[oid] = [(0, None, None)]
        wave.pending_sources = set(per_shard)
        self._recovery_waves[tid] = wave
        for shard, to_read in sorted(per_shard.items()):
            self.bus.send(shard, ECSubRead(self.whoami, tid, to_read,
                                           attrs_to_read={"*"}))

    def _handle_wave_read_reply(self, wave: _RecoveryWave,
                                reply: ECSubReadReply) -> None:
        chunk = {s: c for c, s in enumerate(self.acting)}[reply.from_shard]
        for oid in reply.errors:
            if oid in wave.oids:
                # ENOENT/EIO from one source: the per-object path knows
                # how to widen/park for this oid — don't fail the wave
                wave.fallback.add(oid)
        for oid, bufs in reply.buffers_read.items():
            if oid in wave.oids:
                wave.results.setdefault(oid, {})[chunk] = b"".join(
                    b for _, b in bufs)
        for oid, attrs in reply.attrs_read.items():
            if oid in wave.oids:
                wave.attrs.setdefault(oid, {})[chunk] = attrs
        wave.pending_sources.discard(reply.from_shard)
        if not wave.pending_sources:
            self._finish_wave_reads(wave)

    def _finish_wave_reads(self, wave: _RecoveryWave) -> None:
        """Every source replied: prepare each object's sources exactly
        like the per-object path (hinfo adoption, crc/parity verify),
        then reconstruct ALL of them through decode_shards_many and push."""
        self._recovery_waves.pop(wave.tid, None)
        k = self.ec_impl.get_data_chunk_count()
        ready: list[tuple[str, dict, set, dict]] = []
        # hash-less objects needing the spare-equation cross-check,
        # grouped by survivor signature for ONE fused check per group
        unverified: dict[frozenset, list[int]] = {}
        for oid in sorted(wave.oids):
            if oid in wave.fallback:
                continue
            if oid in self._wave_pushes:
                # ANOTHER wave (a sibling shard repair of the same batch
                # sharing this oid) registered its pushes first: the
                # push slot is per-oid, so this wave's copy re-drives
                # per-object — both pushes land, replies disambiguate by
                # from_shard (the targets are distinct shards)
                wave.fallback.add(oid)
                continue
            if self.pg_log.last_version_of(oid) != wave.at_version[oid]:
                # a write committed while the wave read was in flight:
                # the reconstructed bytes would be stale — re-drive
                wave.fallback.add(oid)
                continue
            available, hinfo, missing, attrs = \
                self._recovery_prepare_sources(
                    oid, wave.results.get(oid, {}),
                    wave.attrs.get(oid, {}), set(wave.oids[oid]),
                    verify_parity=False)
            if len(available) < k or not missing:
                wave.fallback.add(oid)
                continue
            if not hinfo.has_chunk_hash() and len(available) > k:
                unverified.setdefault(frozenset(available),
                                      []).append(len(ready))
            ready.append((oid, available, missing, attrs))
        # fused verified recovery: the code is linear, so a signature
        # group's CONCATENATED streams are spare-equation-consistent iff
        # every member object is — one decode verifies the whole group
        # (the per-object scan cost one decode per chunk per object,
        # which dwarfed the fused reconstruct the wave exists for).
        # Only an inconsistent group pays the per-object localization.
        for sig, idxs in sorted(unverified.items(),
                                key=lambda kv: kv[1][0]):
            concat = {c: np.concatenate([ready[i][1][c] for i in idxs])
                      for c in sorted(sig)}
            if self._spare_equations_consistent(concat):
                continue
            for i in idxs:
                oid, available, missing, attrs = ready[i]
                # _verify_parity_sources drops at most one source, and
                # only while >= k remain; missing only ever grows from a
                # non-empty entry — so the member stays decodable (and a
                # future violation surfaces via the decode's exception
                # fallback below)
                available, missing = self._verify_parity_sources(
                    oid, dict(available), set(missing))
                ready[i] = (oid, available, missing, attrs)
        ready = [r for r in ready if r[0] not in wave.fallback]
        rebuilt: list[dict] = []
        if ready:
            try:
                with trace_span("ec.decode_wave", objects=len(ready),
                                backend=self.instance_name), \
                        self.perf.time("decode_time"):
                    # scheduler-attached backends carry a shared device
                    # pipeline: signature groups dispatch async so group
                    # i+1's host pack overlaps group i's device decode
                    rebuilt = ecutil.decode_shards_many(
                        self.sinfo, self.ec_impl,
                        [(avail, missing)
                         for _o, avail, missing, _a in ready],
                        pipeline=getattr(self, "recovery_pipeline", None))
            except (IOError, ValueError, AssertionError):
                # a signature group failed to decode: every object drops
                # to the per-object path, which localizes the failure
                wave.fallback.update(oid for oid, *_ in ready)
                ready, rebuilt = [], []
        up = self.up_shards()
        for (oid, _avail, missing, attrs), rec in zip(ready, rebuilt):
            wave.pending_pushes[oid] = set()
            self._wave_pushes[oid] = wave
            for chunk in sorted(missing):
                shard = self.acting[chunk]
                if shard not in up:
                    # target died while the reads were in flight: the op
                    # fails for this object (_failed_push), the rest of
                    # the wave proceeds
                    wave.failed.add(oid)
                    continue
                data = bytes(rec[chunk])
                wave.pending_pushes[oid].add(shard)
                self.perf.inc("recovery_bytes", len(data))
                self.bus.send(shard, PushOp(self.whoami, oid, data,
                                            attrs=dict(attrs), omap=None,
                                            omap_header=b""))
            if not wave.pending_pushes[oid]:
                self._finish_wave_oid(wave, oid)
        for oid in sorted(wave.fallback):
            self._wave_fallback_one(wave, oid)

    def _wave_fallback_one(self, wave: _RecoveryWave, oid: str) -> None:
        def done(rec, _oid=oid, _wave=wave):
            _wave.on_each(_oid, rec.state == RecoveryState.COMPLETE)
        # a concurrent per-object recovery may have appeared (e.g. scrub):
        # the shared helper chains behind it per the one-op-per-object rule
        self._chain_or_recover(oid, set(wave.oids[oid]), done)

    def _wave_push_reply(self, wave: _RecoveryWave, reply) -> None:
        pend = wave.pending_pushes.get(reply.oid)
        if pend is None:
            return
        pend.discard(reply.from_shard)
        if not pend:
            self._finish_wave_oid(wave, reply.oid)

    def _finish_wave_oid(self, wave: _RecoveryWave, oid: str) -> None:
        self._wave_pushes.pop(oid, None)
        wave.pending_pushes.pop(oid, None)
        ok = oid not in wave.failed
        self.perf.inc("recoveries" if ok else "recovery_failures")
        if ok:
            if isinstance(wave, _RecoveryWave):
                self.perf.inc("decode_wave_objects")
            self._object_recovered(oid, wave.t0)
        wave.on_each(oid, ok)

    # -- chained streaming repair completion (recovery/chain.py) -----------

    def handle_message(self, msg) -> None:
        if isinstance(msg, ECPartialSumApplied):
            self._chain_applied(msg)
        elif isinstance(msg, ECPartialSumAbort):
            self._chain_abort(msg)
        else:
            super().handle_message(msg)

    def _chain_applied(self, msg: ECPartialSumApplied) -> None:
        chain = self._recovery_chains.get(msg.tid)
        if chain is None:
            return                        # late ack of an aborted chain
        pend = chain.pending_pushes.get(msg.oid)
        if pend is None or msg.from_shard not in pend:
            return                        # dup delivery
        pend.discard(msg.from_shard)
        # recovery_bytes counts chunk bytes LANDED on targets; the
        # centralized paths count at push-send — a chain's payloads
        # never transit the primary, so the ack is where the byte is
        # known delivered
        self.perf.inc("recovery_bytes", chain.lengths.get(msg.oid, 0))
        if pend:
            return
        if self.pg_log.last_version_of(msg.oid) != chain.at_version[msg.oid]:
            # a write raced the chain (the target-side stale gate already
            # refused genuinely older data): re-drive through the
            # verified per-object path rather than trust the mix
            self._wave_pushes.pop(msg.oid, None)
            chain.pending_pushes.pop(msg.oid, None)
            self._wave_fallback_one(chain, msg.oid)
        else:
            self.perf.inc(f"{getattr(chain, 'kind', 'chain')}_objects")
            self._finish_wave_oid(chain, msg.oid)
        if not chain.pending_pushes:
            self._recovery_chains.pop(msg.tid, None)
            self.perf.inc(f"{getattr(chain, 'kind', 'chain')}_repairs")

    def _chain_abort(self, msg: ECPartialSumAbort) -> None:
        """A hop refused its leg (missing/rotten/raced local chunk): the
        whole chain re-drives through the centralized verified path."""
        chain = self._recovery_chains.pop(msg.tid, None)
        if chain is None:
            return
        self.perf.inc(f"{getattr(chain, 'kind', 'chain')}_fallbacks")
        for oid in sorted(chain.pending_pushes):
            self._wave_pushes.pop(oid, None)
            self._wave_fallback_one(chain, oid)
        chain.pending_pushes.clear()

    # -- deep scrub (ECBackend.cc:2461-2546) -------------------------------

    def be_deep_scrub(self, oid: str) -> dict[int, bool]:
        """Recompute each up shard's cumulative crc vs its stored HashInfo;
        True = clean.  When overwrites have CLEARED the chunk hashes, fall
        back to parity-consistency checking: the code itself is the
        checksum (m redundant equations over the chunks), so silent bitrot
        is still detectable — and with a leave-one-out scan, locatable —
        without any stored digest."""
        out: dict[int, bool] = {}
        chunks_read: dict[int, bytes] = {}
        hash_cleared = False
        for chunk, shard in enumerate(self.acting):
            if shard in self.bus.down:
                continue
            store = shard_store(self.bus, shard)
            obj = GObject(oid, shard)
            try:
                data = store.read(obj)
                stored = store.getattr(obj, HINFO_KEY)
            except (FileNotFoundError, KeyError, ChecksumError):
                # ChecksumError: the store's at-rest crc located the rot
                out[chunk] = False
                continue
            # version check first: a shard that missed writes while down is
            # stale even when overwrites cleared the chunk hashes (the
            # PG-log-version role; see HashInfo.version)
            if stored.get("version", 0) != self._hinfo(oid).version:
                out[chunk] = False
                continue
            hashes = stored.get("cumulative_shard_hashes") or []
            if not hashes:
                hash_cleared = True
                chunks_read[chunk] = data
                out[chunk] = True          # provisional; parity check below
                continue
            out[chunk] = crc32c(0xFFFFFFFF, data) == hashes[chunk] and \
                len(data) == stored["total_chunk_size"]
        k = self.ec_impl.get_data_chunk_count()
        if hash_cleared and len(chunks_read) > k:
            # any spare equation suffices for DETECTION, even degraded
            self._parity_consistency_scrub(oid, chunks_read, out)
        return out

    def _parity_consistency_scrub(self, oid: str,
                                  chunks: dict[int, bytes],
                                  out: dict[int, bool]) -> None:
        """No stored digests (overwrites cleared them): the CODE is the
        checksum.  A chunk set with > k members is consistent iff every
        member is reproducible from k of the others; on inconsistency,
        leave-one-out localisation accepts a candidate only when it is
        UNIQUE (single rot with m >= 2).  Ambiguous rot — m=1, multi-chunk,
        or too-degraded-to-localise — flags every scanned chunk so the
        report surfaces it; repair skips such unrecoverable sets."""
        k = self.ec_impl.get_data_chunk_count()
        length = max(len(b) for b in chunks.values())
        stack = {c: np.frombuffer(b.ljust(length, b"\0"), dtype=np.uint8)
                 for c, b in chunks.items()}

        def consistent(ids) -> bool:
            ids = sorted(ids)
            if len(ids) <= k:
                return True          # no redundancy: vacuously consistent
            for target in ids:
                others = {i: stack[i] for i in ids if i != target}
                try:
                    rec = self.ec_impl.decode({target}, others, length)
                except (IOError, ValueError):   # not decodable; a card
                    return False                    # failure propagates
                if not np.array_equal(
                        np.asarray(rec[target], dtype=np.uint8),
                        stack[target]):
                    return False
            return True

        present = sorted(stack)
        if consistent(present):
            return
        cands = [c for c in present
                 if consistent([i for i in present if i != c])]
        if len(cands) == 1:
            out[cands[0]] = False
        else:
            for c in present:        # detected but unlocatable
                out[c] = False


def make_cluster(ec_impl, chunk_size: int = 4096, cct=None):
    """Build a primary + shard OSDs wired on one bus; returns (backend, bus).

    Chunk i lives on shard id i (identity crush mapping) with the primary
    colocated on shard 0, the common layout in the standalone EC tests
    (reference: qa/standalone/erasure-code/test-erasure-code.sh:21-66).
    """
    n = ec_impl.get_chunk_count()
    k = ec_impl.get_data_chunk_count()
    bus = MessageBus()
    backend = ECBackend(ec_impl, StripeInfo(k, chunk_size), bus,
                        acting=list(range(n)), whoami=0, cct=cct)
    for shard in range(1, n):
        OSDShard(shard, bus)
    return backend, bus
