"""PGBackend: the shared core both pool types build on.

Analog of the reference's ``PGBackend`` abstraction (reference:
src/osd/PGBackend.h:628 — the interface ``ReplicatedBackend`` and
``ECBackend`` both implement), holding everything that is NOT specific to
how bytes are laid out across shards:

- the shard-side OSD (:class:`OSDShard`): transaction apply with rollback
  capture, PG log + rollback-info persistence in the pgmeta omap, reads,
  recovery pushes;
- the three-stage ordered write pipeline with the min_size availability
  gate and two-phase rollback/rollforward (ecbackend.rst:149-206);
- the recovery state machine skeleton (IDLE->READING->WRITING->COMPLETE,
  ECBackend.h:249-293) with subclass hooks for issuing reads and building
  push payloads;
- stale-shard tracking + shard repair (log catch-up / backfill, the
  PGLog::merge_log and backfill roles) and boot peering (authoritative-log
  election + witness-counted rollback, PeeringState);
- observability wiring (perf counters, op tracker, admin socket).

Subclass hooks (see :class:`~ceph_tpu_torch.backend.ec_backend.ECBackend`;
the JAX package's ``ReplicatedBackend`` is the other, still to port):

=====================  ====================================================
``_admit_op(op)``       plan the op at pipeline admission; issue any reads
``_op_blocked(op)``     ordering block against in-flight overlapping writes
``_encode_pending(op)``  the head write waits on an encode in flight
``_generate_transactions(op)``  per-shard transactions + pg_log entries
``_recovery_issue_reads(rop)``  start the READING phase (may raise IOError)
``_recovery_push_payloads(rop)``  chunk -> (bytes, attrs, omap|None,
                                  omap_header) to push (omap None =
                                  target keeps its own)
``_handle_other_read_reply(r)``  non-recovery ECSubReadReply routing
``object_size(oid)``    logical object size
``be_deep_scrub(oid)``  per-shard consistency check
=====================  ====================================================

A copy of ``ceph_tpu.backend.pg_backend``.  The chain hop and the
regenerating legs run their GF products where the message's ``device``
says (``ecutil.partial_sum_accumulate``, ``regen_project``,
``regen_combine``): on the card for a plugin with no ``device`` key, on
the plain PyTorch versions for ``device=cpu``, on the host GF math only
where the plugin routes the call to its numpy codec.  A failure on the
card fails the leg: nothing is served on the host instead.
"""
from __future__ import annotations

import contextlib
import pickle
import time
from collections import deque
from dataclasses import dataclass, field
from enum import Enum

from .bluestore import ChecksumError
from .memstore import GObject, MemStore, Transaction
from .messages import (ECPartialSum, ECPartialSumAbort, ECPartialSumApplied,
                       ECPartialSumApply, ECRegenHelper, ECRegenRead,
                       ECSubRead, ECSubReadReply, ECSubWrite, ECSubWriteReply,
                       MessageBus, PGActivate, PGActivateAck, PGLogInfo,
                       PGLogQuery, PGLogUpdate,
                       PGScan, PGScanReply, PushOp, PushReply,
                       RollForward, Rollback)
from .transaction import PGTransaction
from ..common.tracer import default_tracer, trace_span
from ..osd.pg_log import OP_DELETE, OP_MODIFY, PGLog, dedup_latest


PG_META = "_pgmeta_"          # the reference's pgmeta object: PG log +
                              # rollback info live in its omap so they
                              # commit atomically with the data they cover


def _log_key(version: int) -> str:
    return f"log.{version:016d}"


def _rb_key(version: int) -> str:
    return f"rb.{version:016d}"


def shard_store(bus: MessageBus, shard: int):
    """The store behind a bus handler — an OSDShard's own, or the
    primary backend's local shard (ONE copy of this resolution)."""
    handler = bus.handlers[shard]
    return handler.store if isinstance(handler, OSDShard) \
        else handler.local_shard.store


class OSDShard:
    """One shard OSD: an ObjectStore plus the server side of the sub-ops
    (handle_sub_write ECBackend.cc:910-983, handle_sub_read :985-1031,
    recovery push :511-563) and a per-shard PG log that advances with
    every applied sub-write (the reference logs entries in
    handle_sub_write before queueing the transaction, ECBackend.cc:956).

    The PG log, its (head, tail) and per-write rollback info persist in
    the ``_pgmeta_`` object's omap INSIDE the same transaction as the data
    they describe — the reference stores the PG log in the pgmeta omap the
    same way — so a durable store (FileStore) survives restart with log
    and rollback state intact and boots via ``_load_pg_state``."""

    def __init__(self, shard: int, bus: MessageBus, store=None, perf=None):
        self.shard = shard
        self.store = store if store is not None else MemStore()
        self.bus = bus
        # the PG's counters (its primary backend's), where this shard
        # books the time it spends applying sub-writes (sub_write_time)
        self.perf = perf
        self.pg_log = PGLog()
        self.peered_epoch = 0     # last PGActivate epoch (ReplicaActive)
        self.peered_head = 0      # authority log head at that activation
        self.activation_regressions = 0   # rollbacks below peered_head
        # at_version -> inverse transaction restoring the pre-write state:
        # the rollback info the reference's log entries carry until the
        # write is rolled forward (ecbackend.rst:149-174)
        self.pending_rollbacks: dict[int, Transaction] = {}
        self._load_pg_state()
        bus.register(shard, self)

    def _meta(self) -> GObject:
        return GObject(PG_META, self.shard)

    def reload(self) -> None:
        """Drop the in-RAM PG log, rollback map and activation stamps and
        rebuild them from the store: after the OSD's collections were
        destroyed (``MiniCluster.replace_osd``) the shard serves the
        empty store a recreated OSD boots with."""
        self.pg_log = PGLog()
        self.peered_epoch = 0
        self.peered_head = 0
        self.pending_rollbacks = {}
        self._load_pg_state()

    def _push_is_stale(self, msg: PushOp, obj: GObject) -> bool:
        """Is this push older than the object state already applied here?
        Compared on the per-object version attrs both pool types carry
        (EC: hinfo_key.version; replicated: @version) — each is monotone
        per object, so incoming < stored means the push predates a write
        this shard has already applied."""
        if not self.store.exists(obj):
            return False
        for key, field_ in (("hinfo_key", "version"), ("@version", None)):
            incoming = msg.attrs.get(key)
            try:
                stored = self.store.getattr(obj, key)
            except (KeyError, FileNotFoundError):
                continue
            if incoming is None:
                continue
            if field_ is not None:
                incoming = incoming.get(field_, 0)
                stored = stored.get(field_, 0) if isinstance(stored, dict) \
                    else 0
            if incoming < stored:
                return True
        return False

    def _load_pg_state(self) -> None:
        """Boot: rebuild the in-RAM log + rollback map from the pgmeta
        omap (the OSD::init superblock/PG-load path, OSD.cc:2719)."""
        if not self.store.exists(self._meta()):
            return
        omap = self.store.get_omap(self._meta())
        head, tail = pickle.loads(omap["vi"]) if "vi" in omap else (0, 0)
        self.pg_log.tail = tail
        self.pg_log.head = tail
        for key in sorted(k for k in omap if k.startswith("log.")):
            e = pickle.loads(omap[key])
            if e.version > self.pg_log.head:
                self.pg_log.record(e)
        self.pg_log.head = max(self.pg_log.head, head)
        for key in (k for k in omap if k.startswith("rb.")):
            inv = Transaction()
            inv.ops = pickle.loads(omap[key])
            self.pending_rollbacks[int(key[3:])] = inv

    def _persist_vi(self, t: Transaction) -> None:
        t.omap_setkeys(self._meta(), {"vi": pickle.dumps(
            (self.pg_log.head, self.pg_log.tail))})

    def _capture_rollback(self, t: Transaction) -> Transaction:
        """Inverse transaction: snapshot every touched object's prior state
        (chunk-sized objects make whole-object capture cheap).  The pgmeta
        object is never captured — its log/rb keys are unwound explicitly
        by _rollback, and snapshotting it would embed every prior rb blob
        in each new one."""
        touched = {op[1] for op in t.ops}
        touched |= {op[2] for op in t.ops if op[0] == "clone"}
        touched = {obj for obj in touched if obj.oid != PG_META}
        inv = Transaction()
        for obj in sorted(touched, key=lambda g: (g.oid, g.shard)):
            try:
                o = self.store.objects.get(obj)
            except ChecksumError:
                # pre-state unreadable (rotten at rest): the best honest
                # inverse is removal — a rollback leaves the object
                # missing, which scrub/recovery detect and rebuild
                o = None
            inv.remove(obj)
            if o is not None:
                inv.write(obj, 0, bytes(o.data))
                for name, value in o.xattrs.items():
                    inv.setattr(obj, name, value)
                if o.omap:
                    inv.omap_setkeys(obj, dict(o.omap))
        return inv

    def _roll_forward(self, to: int, txn: Transaction | None = None) -> None:
        """Drop rollback data for entries <= ``to``; the key removals ride
        ``txn`` when given (piggybacked roll-forward) or commit on their
        own (the standalone kick)."""
        dropped = [v for v in self.pending_rollbacks if v <= to]
        if not dropped:
            return
        for v in dropped:
            del self.pending_rollbacks[v]
        t = txn if txn is not None else Transaction()
        t.omap_rmkeys(self._meta(), [_rb_key(v) for v in dropped])
        if txn is None:
            self.store.queue_transaction(t)

    def _rollback(self, to: int) -> None:
        """Undo logged-but-not-rolled-forward entries past ``to``, newest
        first, and rewind the log — one atomic transaction."""
        t = Transaction()
        rb = sorted((v for v in self.pending_rollbacks if v > to),
                    reverse=True)
        for v in rb:
            t.append(self.pending_rollbacks.pop(v))
        dropped = self.pg_log.rewind(to)
        if not rb and not dropped:
            return
        t.omap_rmkeys(self._meta(),
                      [_rb_key(v) for v in rb] +
                      [_log_key(e.version) for e in dropped])
        self._persist_vi(t)
        self.store.queue_transaction(t)

    def _apply_sub_write(self, msg: ECSubWrite) -> None:
        """Apply one sub-write to this shard's store: its transaction, the
        rollback info and log entries it carries, and the roll-forward
        and trim points it piggybacks, as one store transaction."""
        t = msg.t
        if msg.log_entries:
            # capture rollback info FIRST — before roll-forward/meta
            # ops are appended to t — so the inverse covers only the
            # data objects; log keys are unwound explicitly by
            # _rollback
            inv = self._capture_rollback(t)
            self.pending_rollbacks[msg.at_version] = inv
            kvs = {_rb_key(msg.at_version):
                   pickle.dumps(inv.ops,
                                protocol=pickle.HIGHEST_PROTOCOL)}
            for e in msg.log_entries:
                if e.version > self.pg_log.head:
                    self.pg_log.record(e)
                kvs[_log_key(e.version)] = pickle.dumps(
                    e, protocol=pickle.HIGHEST_PROTOCOL)
            t.omap_setkeys(self._meta(), kvs)
        if msg.roll_forward_to:
            self._roll_forward(msg.roll_forward_to, txn=t)
        if msg.trim_to:
            old_tail = self.pg_log.tail
            if self.pg_log.trim(msg.trim_to):
                t.omap_rmkeys(self._meta(), [
                    _log_key(v)
                    for v in range(old_tail + 1, msg.trim_to + 1)])
            self._roll_forward(msg.trim_to, txn=t)
        if msg.log_entries or msg.trim_to:
            self._persist_vi(t)
        self.store.queue_transaction(t)

    def handle_message(self, msg) -> None:
        if isinstance(msg, ECSubWrite):
            if msg.log_entries and msg.at_version <= self.pg_log.head:
                # duplicate delivery of an already-applied write: re-ack
                # without re-applying (reqid dedup in the reference)
                self.bus.send(msg.from_shard,
                              ECSubWriteReply(self.shard, msg.tid,
                                              gen=msg.gen))
                return
            timer = self.perf.time("sub_write_time") \
                if self.perf is not None else contextlib.nullcontext()
            with trace_span("ec.sub_write", tid=msg.tid,
                            shard=self.shard), timer:
                self._apply_sub_write(msg)
            self.bus.send(msg.from_shard,
                          ECSubWriteReply(self.shard, msg.tid, gen=msg.gen))
        elif isinstance(msg, RollForward):
            self._roll_forward(msg.to)
        elif isinstance(msg, Rollback):
            if msg.to < self.peered_head:
                # the primary is rewinding below the head it ACTIVATED us
                # at — acked state regressing.  Legitimate only in crash
                # recovery where < min_size witnesses survive; surfaced
                # as a counter so scrub/ops can tell the two apart.
                self.activation_regressions += 1
            self._rollback(msg.to)
        elif isinstance(msg, PGLogQuery):
            self.bus.send(msg.from_shard, PGLogInfo(
                self.shard, self.pg_log.head, self.pg_log.tail,
                entries=self.pg_log.entries_after(msg.since) or []))
        elif isinstance(msg, PGScan):
            self.bus.send(msg.from_shard, PGScanReply(
                self.shard, oids=sorted({g.oid for g in self.store.objects
                                         if g.shard == self.shard
                                         and g.oid != PG_META})))
        elif isinstance(msg, PGActivate):
            # Stray -> ReplicaActive: adopt the primary's epoch and the
            # authority head it activated at (a later repair rewinding
            # past this head would mean the primary regressed), then ack
            # (reference: PeeringState::ReplicaActive on MOSDPGLog)
            self.peered_epoch = msg.epoch
            self.peered_head = msg.head
            self.bus.send(msg.from_shard,
                          PGActivateAck(self.shard, msg.epoch))
        elif isinstance(msg, PGLogUpdate):
            # divergent entries past the rewind point were superseded by the
            # repair's pushes: drop their rollback data without applying it
            dropped_rb = [v for v in self.pending_rollbacks
                          if v > msg.rewind_to]
            for v in dropped_rb:
                del self.pending_rollbacks[v]
            pre = {_log_key(e.version) for e in self.pg_log.entries}
            self.pg_log.merge_authoritative(
                msg.entries, msg.last_update, msg.rewind_to, msg.trim_to)
            post = {e.version: e for e in self.pg_log.entries}
            t = Transaction()
            gone = sorted(pre - {_log_key(v) for v in post}) + \
                [_rb_key(v) for v in dropped_rb]
            if gone:
                t.omap_rmkeys(self._meta(), gone)
            # only the shipped segment can contain new/changed entries;
            # surviving pre-merge keys are already on disk
            new_kvs = {_log_key(e.version): pickle.dumps(
                           e, protocol=pickle.HIGHEST_PROTOCOL)
                       for e in msg.entries if post.get(e.version) == e}
            if new_kvs:
                t.omap_setkeys(self._meta(), new_kvs)
            self._persist_vi(t)
            self.store.queue_transaction(t)
        elif isinstance(msg, ECSubRead):
            reply = ECSubReadReply(self.shard, msg.tid)
            for oid, extents in msg.to_read.items():
                obj = GObject(oid, self.shard)
                try:
                    bufs = []
                    for ext in extents:
                        off, length = ext[0], ext[1]
                        subchunks = ext[2] if len(ext) > 2 else None
                        data = self.store.read(obj, off, length)
                        if length is not None and len(data) < length:
                            data = data + b"\0" * (length - len(data))
                        if subchunks is not None:
                            data = _slice_subchunks(data, subchunks,
                                                    msg.sub_chunk_count)
                        bufs.append((off, data))
                    reply.buffers_read[oid] = bufs
                    if msg.attrs_to_read:
                        xat = self.store.objects[obj].xattrs
                        if "*" in msg.attrs_to_read:
                            # recovery wants the FULL replicated attr set
                            # (object_info, snapset, user xattrs): pushes
                            # REPLACE the target object, so partial attr
                            # reads would wipe whatever isn't carried
                            reply.attrs_read[oid] = dict(xat)
                        else:
                            reply.attrs_read[oid] = {
                                a: self.store.getattr(obj, a)
                                for a in msg.attrs_to_read if a in xat}
                    if msg.include_omap:
                        reply.omap_read[oid] = (
                            self.store.get_omap(obj),
                            self.store.get_omap_header(obj))
                except FileNotFoundError:
                    reply.errors[oid] = -2  # ENOENT
                except ChecksumError:
                    # at-rest checksum failure (BlueStore): the shard's
                    # copy is rotten — EIO, like the reference's
                    # bluestore read path
                    reply.errors[oid] = -5
            self.bus.send(msg.from_shard, reply)
        elif isinstance(msg, PushOp):
            obj = GObject(msg.oid, self.shard)
            if self._push_is_stale(msg, obj):
                # per-object recovery serialization (the reference holds
                # recovery locks): a push reconstructed from a PRE-write
                # snapshot can already be in flight when a newer client
                # write applies on this shard — applying it would regress
                # the shard to the old state while the PG log stays at
                # the new version (observed: seed-244 soak served mixed-
                # version garbage).  Drop it; ack so the rop completes —
                # the shard already holds newer-or-equal state.
                self.bus.send(msg.from_shard, PushReply(self.shard,
                                                        msg.oid))
                return
            self._apply_push(obj, msg.data, msg.attrs, msg.omap,
                             msg.omap_header)
            self.bus.send(msg.from_shard, PushReply(self.shard, msg.oid))
        elif isinstance(msg, ECPartialSum):
            self._partial_sum_hop(msg)
        elif isinstance(msg, ECPartialSumApply):
            # a chain's final hop pushing a finished chunk: same stale
            # rule as PushOp (ack without applying so the chain
            # completes — this shard already holds newer state)
            obj = GObject(msg.oid, self.shard)
            if not self._push_is_stale(msg, obj):
                self._apply_push(obj, msg.data, msg.attrs, None, b"")
            self.bus.send(msg.coordinator,
                          ECPartialSumApplied(self.shard, msg.tid, msg.oid))
        elif isinstance(msg, ECRegenRead):
            if msg.combine:
                self._regen_prime(msg)
            else:
                self._regen_helper_leg(msg)
        elif isinstance(msg, ECRegenHelper):
            self._regen_ingest(msg)
        else:
            raise TypeError(f"shard {self.shard}: unexpected {msg!r}")

    def _apply_push(self, obj: GObject, data: bytes, attrs: dict,
                    omap, omap_header: bytes) -> None:
        """Replace this shard's copy with pushed recovery state (shared by
        PushOp and the chain's ECPartialSumApply), under one
        ``recovery.push`` span."""
        with trace_span("recovery.push", oid=obj.oid, shard=self.shard,
                        nbytes=len(data)):
            t = Transaction()
            # the remove wipes everything, so omap=None ("leave alone")
            # must re-apply the PRE-push omap to honour its contract
            if omap is not None:
                keep_omap, keep_header = dict(omap), omap_header
            elif self.store.exists(obj):
                keep_omap = self.store.get_omap(obj)
                keep_header = self.store.get_omap_header(obj)
            else:
                keep_omap, keep_header = {}, b""
            t.remove(obj).write(obj, 0, data)
            for name, value in attrs.items():
                t.setattr(obj, name, value)
            if keep_omap or keep_header:
                t.omap_setkeys(obj, keep_omap)
                t.omap_setheader(obj, keep_header)
            self.store.queue_transaction(t)

    def _partial_sum_hop(self, msg: ECPartialSum) -> None:
        """One leg of a chained streaming repair (recovery/chain.py):
        GF-scale the local chunk of every plan object by this hop's
        decode coefficients, XOR into the running accumulator, forward
        to the next hop — the final hop pushes finished chunks straight
        to the repair targets.  ANY validation failure aborts the WHOLE
        chain back to the coordinator, which re-drives unfinished
        objects through the centralized verified path; a hop never
        guesses around bad state."""
        from . import ecutil
        from .ecutil import HINFO_KEY, crc32c

        def abort(reason: str) -> None:
            self.bus.send(msg.coordinator,
                          ECPartialSumAbort(self.shard, msg.tid, reason))

        if not msg.hops or msg.hops[0][0] != self.shard:
            abort(f"misrouted to shard {self.shard}")
            return
        _, chunk, coeffs = msg.hops[0]
        bufs: list[bytes] = []
        for oid, length, version in zip(msg.oids, msg.lengths,
                                        msg.versions):
            obj = GObject(oid, self.shard)
            try:
                data = self.store.read(obj, 0, None)
                stored = self.store.getattr(obj, HINFO_KEY)
            except (FileNotFoundError, KeyError):
                abort(f"{oid}: no local copy")
                return
            except ChecksumError:
                # at-rest rot: centralized recovery re-verifies sources
                # and routes around the rotten shard
                abort(f"{oid}: rotten chunk")
                return
            if stored.get("version", 0) != version:
                # a write landed here after the plan was cut — the other
                # hops' contributions may predate it, so the sum would
                # mix versions; the coordinator re-drives coherently
                abort(f"{oid}: version skew")
                return
            if len(data) > length:
                abort(f"{oid}: longer than plan")
                return
            if len(data) < length:
                data = data + b"\0" * (length - len(data))
            hashes = (msg.attrs.get(oid, {}).get(HINFO_KEY) or {}).get(
                "cumulative_shard_hashes") or []
            if hashes and crc32c(0xFFFFFFFF, data) != hashes[chunk]:
                abort(f"{oid}: chunk hash mismatch")
                return
            bufs.append(data)
        stream = b"".join(bufs)
        with trace_span("recovery.chain_hop", owner="recovery",
                        objects=len(msg.oids), nbytes=len(stream)):
            acc = ecutil.partial_sum_accumulate(
                coeffs, stream, msg.acc,
                pipeline=getattr(self, "recovery_pipeline", None),
                device=msg.device)
        if len(msg.hops) > 1:
            # forward a FRESH message (the bus's dup-delivery injection
            # may still hold a reference to this one); the trace ctx
            # rides along so every leg keeps recovery attribution
            self.bus.send(msg.hops[1][0], ECPartialSum(
                from_shard=self.shard, tid=msg.tid,
                coordinator=msg.coordinator, oids=msg.oids,
                lengths=msg.lengths, versions=msg.versions,
                rows=msg.rows, targets=msg.targets, hops=msg.hops[1:],
                attrs=msg.attrs, acc=acc, device=msg.device,
                trace=msg.trace))
            return
        # final hop: slice each accumulator row per object and push the
        # finished chunks to their targets; the coordinator completes
        # each object on the targets' ECPartialSumApplied acks
        for row, target in enumerate(msg.targets):
            off = 0
            for oid, length in zip(msg.oids, msg.lengths):
                self.bus.send(target, ECPartialSumApply(
                    self.shard, msg.tid, msg.coordinator, oid,
                    acc[row][off:off + length],
                    attrs=dict(msg.attrs.get(oid, {}))))
                off += length

    # -- regenerating repair legs (recovery/regen.py) ----------------------
    #
    # Helper shards project their stored chunk down to one beta-stream
    # and ship it to the newcomer; the newcomer combines d streams into
    # the lost chunk.  Validation mirrors _partial_sum_hop: any mismatch
    # aborts the tid back to the coordinator (centralized fallback) —
    # a leg never guesses around bad state.

    # bounded stash for beta-streams arriving before this shard's own
    # ECRegenRead prime (cross-sender delivery order is not guaranteed)
    REGEN_ORPHAN_CAP = 32
    # newcomer-side in-flight repair cap: aborted/fallen-back tids are
    # evicted oldest-first rather than leaking
    REGEN_PENDING_CAP = 64

    def _regen_abort(self, msg, reason: str) -> None:
        self.bus.send(msg.coordinator,
                      ECPartialSumAbort(self.shard, msg.tid, reason))
        pend = getattr(self, "_regen_pending", None)
        if pend is not None:
            pend.pop(msg.tid, None)
        orph = getattr(self, "_regen_orphans", None)
        if orph is not None:
            orph.pop(msg.tid, None)

    def _regen_read_local(self, msg, oid: str, length: int,
                          version: int) -> bytes | None:
        """Read + validate one plan object's local stored chunk (the
        _partial_sum_hop ladder); None means the tid was aborted."""
        from .ecutil import HINFO_KEY, crc32c
        obj = GObject(oid, self.shard)
        try:
            data = self.store.read(obj, 0, None)
            stored = self.store.getattr(obj, HINFO_KEY)
        except (FileNotFoundError, KeyError):
            self._regen_abort(msg, f"{oid}: no local copy")
            return None
        except ChecksumError:
            self._regen_abort(msg, f"{oid}: rotten chunk")
            return None
        if stored.get("version", 0) != version:
            self._regen_abort(msg, f"{oid}: version skew")
            return None
        if len(data) > length:
            self._regen_abort(msg, f"{oid}: longer than plan")
            return None
        if len(data) < length:
            data = data + b"\0" * (length - len(data))
        hashes = (msg.attrs.get(oid, {}).get(HINFO_KEY) or {}).get(
            "cumulative_shard_hashes") or []
        if hashes and crc32c(0xFFFFFFFF, data) != hashes[msg.chunk]:
            self._regen_abort(msg, f"{oid}: chunk hash mismatch")
            return None
        return data

    def _regen_helper_leg(self, msg: ECRegenRead) -> None:
        """Helper leg: project every plan object's stored chunk by the
        1 x alpha coefficient row and ship the beta-streams to the
        newcomer in ONE ECRegenHelper."""
        from . import ecutil
        if len(msg.proj) != msg.sub_count:
            self._regen_abort(msg, "sub-chunk mismatch")
            return
        streams: dict[str, bytes] = {}
        total = 0
        for oid, length, version in zip(msg.oids, msg.lengths,
                                        msg.versions):
            if length % max(msg.sub_count, 1):
                self._regen_abort(msg, f"{oid}: sub-chunk mismatch")
                return
            data = self._regen_read_local(msg, oid, length, version)
            if data is None:
                return
            total += len(data)
            with trace_span("recovery.regen_hop", owner="recovery",
                            nbytes=len(data)):
                streams[oid] = ecutil.regen_project(
                    msg.proj, data, msg.sub_count,
                    pipeline=getattr(self, "recovery_pipeline", None),
                    device=msg.device)
        self.bus.send(msg.target, ECRegenHelper(
            from_shard=self.shard, tid=msg.tid,
            coordinator=msg.coordinator, chunk=msg.chunk,
            streams=streams, trace=msg.trace))

    def _regen_prime(self, msg: ECRegenRead) -> None:
        """Newcomer leg: remember the plan (combine matrix, helper
        stream order, per-oid lengths/attrs) and drain any beta-streams
        that arrived before it."""
        pend = getattr(self, "_regen_pending", None)
        if pend is None:
            pend = self._regen_pending = {}
        if msg.sub_count < 1 or len(msg.combine) != \
                msg.sub_count * len(msg.helpers):
            self._regen_abort(msg, "sub-chunk mismatch")
            return
        while len(pend) >= self.REGEN_PENDING_CAP:
            pend.pop(next(iter(pend)))
        pend[msg.tid] = {"msg": msg, "streams": {}}
        orphans = getattr(self, "_regen_orphans", None)
        for early in (orphans.pop(msg.tid, []) if orphans else []):
            self._regen_ingest(early)

    def _regen_ingest(self, msg: ECRegenHelper) -> None:
        """One helper's beta-streams landing on the newcomer; combine +
        verify + apply once all d helpers reported."""
        pend = getattr(self, "_regen_pending", None)
        rec = pend.get(msg.tid) if pend else None
        if rec is None:
            orphans = getattr(self, "_regen_orphans", None)
            if orphans is None:
                orphans = self._regen_orphans = {}
            stash = orphans.setdefault(msg.tid, [])
            stash.append(msg)
            while sum(len(v) for v in orphans.values()) > \
                    self.REGEN_ORPHAN_CAP:
                orphans.pop(next(iter(orphans)))
            return
        plan: ECRegenRead = rec["msg"]
        if msg.chunk not in plan.helpers:
            self._regen_abort(plan, f"stream from non-helper {msg.chunk}")
            return
        rec["streams"][msg.chunk] = msg.streams
        if len(rec["streams"]) < len(plan.helpers):
            return
        self._regen_complete(plan, rec["streams"])

    def _regen_complete(self, plan: ECRegenRead,
                        streams: dict[int, dict]) -> None:
        from types import SimpleNamespace

        from . import ecutil
        from .ecutil import HINFO_KEY, crc32c
        pend = getattr(self, "_regen_pending", {})
        pend.pop(plan.tid, None)
        beta_per = {oid: length // plan.sub_count
                    for oid, length in zip(plan.oids, plan.lengths)}
        for oid, length in zip(plan.oids, plan.lengths):
            rows = []
            for h in plan.helpers:          # combine-matrix stream order
                s = streams[h].get(oid)
                if s is None or len(s) != beta_per[oid]:
                    self._regen_abort(plan, f"{oid}: sub-chunk mismatch")
                    return
                rows.append(s)
            with trace_span("recovery.regen_hop", owner="recovery",
                            nbytes=length):
                data = ecutil.regen_combine(
                    plan.combine, rows, plan.sub_count,
                    pipeline=getattr(self, "recovery_pipeline", None),
                    device=plan.device)
            oattrs = dict(plan.attrs.get(oid, {}))
            hashes = (oattrs.get(HINFO_KEY) or {}).get(
                "cumulative_shard_hashes") or []
            if hashes and crc32c(0xFFFFFFFF, data) != hashes[plan.chunk]:
                # the regenerated chunk must match the newcomer's own
                # recorded hash chain bit-for-bit — the end-to-end
                # verification a decode-and-push repair gets for free
                self._regen_abort(plan, f"{oid}: combined hash mismatch")
                return
            obj = GObject(oid, self.shard)
            if not self._push_is_stale(SimpleNamespace(attrs=oattrs), obj):
                self._apply_push(obj, data, oattrs, None, b"")
            self.bus.send(plan.coordinator,
                          ECPartialSumApplied(self.shard, plan.tid, oid))


def _slice_subchunks(data: bytes, runs: list[tuple[int, int]],
                     sub_chunk_count: int) -> bytes:
    """Extract (offset, count) sub-chunk runs out of ``sub_chunk_count``
    equal sub-chunks (clay fractional reads, ECBackend.cc:1002-1024)."""
    sub_size = len(data) // max(sub_chunk_count, 1)
    return b"".join(data[off * sub_size:(off + c) * sub_size]
                    for off, c in runs)


class RecoveryState(Enum):
    IDLE = "IDLE"
    READING = "READING"
    WRITING = "WRITING"
    COMPLETE = "COMPLETE"
    # a push target died before acking: the object is still degraded there
    # (the reference's _failed_push path, ECBackend.cc:211-248)
    FAILED = "FAILED"


@dataclass
class RecoveryOp:
    """ECBackend::RecoveryOp (ECBackend.h:249-293)."""
    oid: str
    missing_shards: set[int]
    state: RecoveryState = RecoveryState.IDLE
    read_tid: int | None = None
    # pg_log version of the object when the recovery read was issued; a
    # bump while the read was in flight means a write landed and the
    # reconstructed bytes are stale — re-read instead of pushing them
    # (the reference serializes this with per-object recovery locks)
    at_version: int = 0
    pending_pushes: set[int] = field(default_factory=set)
    # sources whose copy failed its at-rest checksum (EIO from the
    # store): excluded from further reads AND added to missing_shards so
    # the rebuild repairs them too
    bad_sources: set[int] = field(default_factory=set)
    # sticky: a push target died before acking; even if the remaining
    # pushes ack, the op must finish FAILED (reference _failed_push fails
    # the whole op for any dead push target)
    failed: bool = False
    on_complete: object = None
    # when the op was dispatched (perf_counter): its recovery.object start
    t0: float = field(default_factory=time.perf_counter)


class RepairState(Enum):
    QUERY = "QUERY"               # waiting for the shard's PGLogInfo
    SCAN = "SCAN"                 # backfill: waiting for the object list
    RECOVERING = "RECOVERING"     # pushes/deletes in flight
    COMPLETE = "COMPLETE"
    FAILED = "FAILED"


@dataclass
class ShardRepairOp:
    """Catch one stale/revived shard up, cheapest plan first: log equality
    (free) -> log replay (O(missed writes), PGLog.cc semantics) -> full
    backfill (O(objects), only past the log horizon)."""
    shard: int
    chunk: int
    state: RepairState = RepairState.QUERY
    plan: str = ""                # "clean" | "log" | "backfill"
    rewind_to: int = 0
    # authority log head when the repair's todo set was computed; writes
    # committing past it mid-repair skipped the stale target and must be
    # caught up before the shard is declared current
    caught_up_to: int = 0
    pending: set = field(default_factory=set)   # ("recover"|"delete", oid)
    objects_repaired: int = 0
    failed: bool = False
    on_complete: object = None
    # scheduler hand-off (the recovery scheduler): with a driver attached the
    # repair planner OFFERS the missing-object list instead of recovering
    # inline; the driver paces it in waves through repair_wave and the
    # not-yet-dispatched remainder parks here
    driver: object = None
    deferred: list = field(default_factory=list)


@dataclass
class Op:
    """In-flight client write (ECBackend::Op, ECBackend.h:390-440)."""
    tid: int
    t: PGTransaction
    on_commit: object
    # computed at pipeline admission (_admit_op) so a rolled-back op
    # re-plans against the restored object state when re-admitted
    plan: object | None = None
    pending_read_shards: set[int] = field(default_factory=set)
    remote_reads: dict[str, dict[int, bytes]] = field(default_factory=dict)  # oid -> {logical off: stripe data}
    pending_commit_shards: set[int] = field(default_factory=set)
    acked_shards: set[int] = field(default_factory=set)
    cache_claims: list[tuple[str, int]] = field(default_factory=list)
    # version span (first_version, at_version] of this op's log entries,
    # recorded at fan-out; rollback rewinds to first_version - 1
    first_version: int = 0
    at_version: int = 0
    # dispatch generation: bumped each fan-out so stale acks from a
    # rolled-back dispatch are ignored
    gen: int = 0
    # reads unrecoverable with current up set; re-driven by on_shard_up
    _rmw_stalled: bool = False
    tracked: object = None      # OpTracker request (mark_event timeline)
    # the encode stage (ECBackend with a serving engine): oid -> (pieces,
    # logical bytes, the engine's future) of each encode handed over;
    # None until the op reaches the stage
    encodes: dict | None = None
    # the trace context the op was staged under: it resumes from the
    # stage on another call stack, and its fan-out rejoins its trace
    trace: object = None


class PGBackend:
    """Shared primary-side machinery; see module docstring for the hook
    surface each pool type implements."""

    def __init__(self, bus: MessageBus, acting: list[int], whoami: int = 0,
                 cct=None, name: str = "", min_size: int = 0,
                 min_size_floor: int = 1, store=None,
                 perf_prefix: str = "pg_backend"):
        # `name` disambiguates observability registrations when several
        # backends (e.g. one per PG) share a Context and a primary OSD id
        self.bus = bus
        self.acting = list(acting)
        self.whoami = whoami
        # write availability floor: a write is never acked with fewer than
        # min_size current shards holding it (the pool min_size the
        # reference's PeeringState enforces by going inactive).  The floor
        # is k for EC (below it the data is unreadable) and 1 for
        # replicated.
        self.min_size = max(min_size or 0, min_size_floor)
        self.local_shard = OSDShard(whoami, bus, store=store)
        bus.handlers[whoami] = self  # primary intercepts its own queue
        self.next_tid = 0
        # write pipeline (ECBackend.h:562-564)
        self.waiting_state: deque[Op] = deque()
        self.waiting_reads: deque[Op] = deque()
        self.waiting_commit: deque[Op] = deque()
        self.tid_to_op: dict[int, Op] = {}
        # recovery
        self.recovery_ops: dict[str, RecoveryOp] = {}
        self._recovery_read_tids: dict[int, RecoveryOp] = {}
        self._stalled_recoveries: list[RecoveryOp] = []
        # The authority log advances at fan-out; the local shard's own log
        # advances only when its self-delivered sub-write APPLIES.  Keeping
        # them separate is what lets a revived primary detect its own
        # staleness (writes committed by the other shards while it was
        # down) and repair itself through the same query/replay machinery.
        # On boot from a durable store, the local shard's persisted log IS
        # the authority (the reference elects the authoritative log during
        # peering; the primary's own is the single-primary analog) — half-
        # applied writes it logged roll FORWARD by repairing the peers.
        # objects with detected-but-unlocatable inconsistency (see the EC
        # backend's verified recovery; replicated majority-vote ties could
        # populate it too): surfaced by scrub/health until exonerated
        self.inconsistent_objects: set[str] = set()
        self.pg_log = PGLog()
        self.pg_log.tail = self.local_shard.pg_log.tail
        self.pg_log.head = self.local_shard.pg_log.tail
        for e in self.local_shard.pg_log.entries:
            self.pg_log.record(e)
        self.pg_log.head = max(self.pg_log.head,
                               self.local_shard.pg_log.head)
        # two-phase commit bookkeeping: committed_to = newest version acked
        # by >= min_size shards (the roll-forward point); _rolled_forward_to
        # = the point already announced to the shards
        self.committed_to = self.pg_log.head
        self._rolled_forward_to = self.pg_log.head
        self._rollback_pending = 0
        # shards that revived but have not been repaired yet: excluded from
        # reads AND from write fan-out until a shard repair completes (the
        # reference keeps stale shards out of the acting set until
        # recovery/backfill, PeeringState.cc)
        self.stale: set[int] = set()
        # boot peering (crash recovery): shard -> PGLogInfo while collecting
        self._boot_peering: dict[int, PGLogInfo] | None = None
        self._boot_peering_expect: set[int] = set()
        self.shard_repairs: dict[int, "ShardRepairOp"] = {}
        # tid -> (rop, oid, on_done|None) for in-flight repair deletes
        self._repair_write_tids: dict[int, tuple] = {}
        self._scan_waiters: dict[int, "ShardRepairOp"] = {}
        # background repair orchestration (a recovery scheduler): when a
        # scheduler is attached, shard revival and stalled-recovery
        # re-drives route through its reservation gate instead of firing
        # inline; None keeps the pre-scheduler inline behavior
        self.recovery_scheduler = None
        # oid -> batched recovery wave with pushes in flight (the EC
        # backend's decode_many-fused recovery path; empty elsewhere)
        self._wave_pushes: dict[str, object] = {}
        bus.down_listeners.append(self.on_shard_down)
        bus.up_listeners.append(self.on_shard_up)
        # observability (SURVEY.md §5): counters + op tracking + admin cmds
        from ..common import OpTracker, PerfCountersBuilder, default_context
        self.cct = cct if cct is not None else default_context()
        self.instance_name = name or str(whoami)
        self.perf = (
            PerfCountersBuilder(f"{perf_prefix}.{self.instance_name}")
            .add_u64_counter("writes", "client writes committed")
            .add_u64_counter("write_rollbacks",
                             "in-flight writes rolled back (min_size)")
            .add_u64_counter("reads", "client reads completed")
            .add_u64_counter("read_errors", "per-object read failures (EIO)")
            .add_u64_counter("write_bytes", "client bytes written")
            .add_u64_counter("stripe_bytes_encoded",
                             "stripe-aligned bytes through encode (>= "
                             "write_bytes: RMW pads to whole stripes)")
            .add_u64_counter("read_bytes", "logical bytes returned")
            .add_u64_counter("recoveries", "recovery ops completed")
            .add_u64_counter("recovery_bytes",
                             "chunk bytes pushed to recovery targets "
                             "(the mgr digest's recovery B/s source)")
            .add_u64_counter("recovery_failures", "recovery ops failed")
            .add_u64_counter("objects_recovered",
                             "objects brought back to full redundancy "
                             "(the reference's num_objects_recovered)")
            .add_u64_counter("bytes_recovered",
                             "logical size of each object recovered (the "
                             "reference's num_bytes_recovered, ceph -s "
                             "recovery B/s)")
            .add_u64_counter("chain_repairs",
                             "partial-sum chain waves completed")
            .add_u64_counter("decode_wave_objects",
                             "objects rebuilt by a fused decode wave")
            .add_u64_counter("chain_objects",
                             "objects repaired via streaming chains")
            .add_u64_counter("chain_fallbacks",
                             "chains aborted to centralized repair")
            .add_u64_counter("regen_repairs",
                             "regenerating-code repair rounds completed")
            .add_u64_counter("regen_objects",
                             "objects repaired from helper inner products")
            .add_u64_counter("regen_fallbacks",
                             "regen repairs aborted to centralized repair")
            .add_u64_counter("log_repairs_clean",
                             "shard repairs satisfied by log equality alone")
            .add_u64_counter("log_repairs", "log-based shard catch-ups")
            .add_u64_counter("log_repair_objects",
                             "objects replayed by log catch-up")
            .add_u64_counter("shard_backfills",
                             "repairs past the log horizon (full backfill)")
            .add_u64_counter("backfill_objects",
                             "objects moved by shard backfill")
            .add_u64_counter("slow_ops",
                             "ops exceeding osd_op_complaint_time")
            .add_time_avg("encode_time", "batched encode wall time")
            .add_time_avg("encode_wait_time",
                          "a write parked in the encode stage, from "
                          "handing its encode to the serving engine to "
                          "taking the result")
            .add_u64_counter("encodes_staged",
                             "encodes handed to the serving engine by "
                             "the encode stage")
            .add_u64("encode_parked",
                     "writes parked in the encode stage")
            .add_time_avg("sub_write_time",
                          "a shard applying one of the PG's sub-writes "
                          "to its store")
            .add_time_avg("decode_time", "batched decode wall time")
            .add_u64("pipeline_depth", "ops across the three wait lists")
            .create_perf_counters())
        self.cct.perf.add(self.perf)
        self.local_shard.perf = self.perf
        self.op_tracker = OpTracker(conf=self.cct.conf, perf=self.perf)
        for cmd, fn in ((f"dump_ops_in_flight.{self.instance_name}",
                         lambda **kw: self.op_tracker.dump_ops_in_flight()),
                        (f"dump_historic_ops.{self.instance_name}",
                         lambda **kw: self.op_tracker.dump_historic_ops())):
            # a re-created backend with the same name takes over the hook
            # (leaving the old registration would serve — and pin — the
            # dead backend's tracker)
            self.cct.admin_socket.unregister(cmd)
            self.cct.admin_socket.register(cmd, fn)

    # -- subclass hook surface ---------------------------------------------

    def _admit_op(self, op: Op) -> None:
        """Plan the op and issue any pre-commit reads; default: nothing."""
        op.plan = op.plan or True

    def _op_blocked(self, op: Op) -> bool:
        return False

    def _encode_pending(self, op: Op) -> bool:
        """Does the head write still wait on an encode in flight?"""
        return False

    def _generate_transactions(self, op: Op):
        raise NotImplementedError

    def _recovery_issue_reads(self, rop: RecoveryOp) -> None:
        raise NotImplementedError

    def _recovery_push_payloads(self, rop: RecoveryOp
                                ) -> dict[int, tuple[bytes, dict, dict | None, bytes]]:
        raise NotImplementedError

    def _handle_other_read_reply(self, reply: ECSubReadReply) -> None:
        pass

    def _on_shard_down_reads(self, shard: int, chunk: int) -> None:
        pass

    def _redrive_reads(self) -> None:
        pass

    def _on_local_rollback(self) -> None:
        pass

    def _op_reset_extra(self, op: Op) -> None:
        pass

    def object_size(self, oid: str) -> int:
        raise NotImplementedError

    def be_deep_scrub(self, oid: str) -> dict[int, bool]:
        raise NotImplementedError

    def is_recoverable(self, oid: str, missing: set[int]) -> bool:
        raise NotImplementedError

    # -- helpers -----------------------------------------------------------

    def up_shards(self) -> set[int]:
        return {s for s in self.acting if s not in self.bus.down}

    def current_shards(self) -> set[int]:
        """Up AND repaired: the shards that may serve reads and receive
        write fan-out (the reference's acting set after peering; stale
        revived shards rejoin once their shard repair completes)."""
        return {s for s in self.acting
                if s not in self.bus.down and s not in self.stale}

    def is_active(self) -> bool:
        """Writes proceed only while >= min_size current shards exist (the
        PG-active gate of PeeringState; below it client writes park in
        waiting_state until shards return — never acked, never lost).
        NOTE: a bus-down primary is gated at the DAEMON dispatch layer
        (a dead OSD accepts no client ops), not here — the backend
        coordinator running with its own shard down is a legitimate
        divergence scenario (it commits on peers and self-repairs)."""
        return len(self.current_shards()) >= self.min_size

    # -- message dispatch --------------------------------------------------

    def handle_message(self, msg) -> None:
        if isinstance(msg, ECSubWriteReply):
            self.handle_sub_write_reply(msg)
        elif isinstance(msg, ECSubReadReply):
            self.handle_sub_read_reply(msg)
        elif isinstance(msg, PushReply):
            self.handle_push_reply(msg)
        elif isinstance(msg, PGLogInfo):
            self.handle_pg_log_info(msg)
        elif isinstance(msg, PGActivateAck):
            peering = getattr(self, "peering", None)
            if peering is not None:
                peering.on_activate_ack(msg)
        elif isinstance(msg, PGScanReply):
            self.handle_pg_scan_reply(msg)
        elif isinstance(msg, Rollback):
            # primary's own shard rolls back; subclass caches of the rolled-
            # back state must refresh before re-queued ops re-plan
            self.local_shard.handle_message(msg)
            self._on_local_rollback()
            self._rollback_pending = max(0, self._rollback_pending - 1)
            self.check_ops()
        else:
            self.local_shard.handle_message(msg)

    def handle_sub_read_reply(self, reply: ECSubReadReply) -> None:
        rop_rec = self._recovery_read_tids.get(reply.tid)
        if rop_rec is not None:
            self.handle_recovery_read_reply(rop_rec, reply)
            return
        self._handle_other_read_reply(reply)

    def shutdown(self, checkpoint_store: bool = True) -> None:
        """Unhook from the shared Context and bus so a discarded backend is
        collectable (registration without teardown pins the backend — and
        its trackers/stores — for the context's lifetime)."""
        self.cct.perf.remove(self.perf.name)
        self.cct.admin_socket.unregister(
            f"dump_ops_in_flight.{self.instance_name}")
        self.cct.admin_socket.unregister(
            f"dump_historic_ops.{self.instance_name}")
        for lst in (self.bus.down_listeners, self.bus.up_listeners,
                    self.bus.idle_hooks):
            for cb in list(lst):
                if getattr(cb, "__self__", None) is self:
                    lst.remove(cb)
        # hand the shard queue back to the plain shard handler so the bus
        # no longer references this backend
        if self.bus.handlers.get(self.whoami) is self:
            self.bus.handlers[self.whoami] = self.local_shard
        if hasattr(self.local_shard.store, "close"):
            self.local_shard.store.close(checkpoint=checkpoint_store)

    # -- failure handling --------------------------------------------------

    def on_shard_down(self, shard: int) -> None:
        """Route around a shard that died with requests outstanding — the
        analog of the reference's on_change/check_recovery_sources paths
        re-driving in-flight ops when the acting set changes
        (ECBackend.cc check_recovery_sources, _failed_push)."""
        if shard not in set(self.acting):
            return
        chunk = self.acting.index(shard)
        self._on_shard_down_reads(shard, chunk)
        # recovery reads: restart the op's READING phase from live shards
        from ..common.tracer import root_or_ambient
        for tid, rop in list(self._recovery_read_tids.items()):
            if shard in rop._pending:
                del self._recovery_read_tids[tid]
                rop.state = RecoveryState.IDLE
                try:
                    # re-planned reads are still recovery traffic (wire
                    # accounting / device ledger), same as recover_object
                    with root_or_ambient("recovery"):
                        self.continue_recovery_op(rop)
                except IOError:
                    # too few survivors: park; re-driven by on_shard_up
                    self._stalled_recoveries.append(rop)
        # recovery pushes: a dead target never acks and is still degraded —
        # the op FAILS (the reference's _failed_push), it is not COMPLETE
        for oid, rop in list(self.recovery_ops.items()):
            if shard in rop.pending_pushes:
                rop.pending_pushes.discard(shard)
                rop.failed = True
                if not rop.pending_pushes and \
                        rop.state == RecoveryState.WRITING:
                    self._finish_recovery_op(rop, failed=True)
        # a shard under repair that dies again: the repair fails (its
        # revival restarts it via the boot path)
        srop = self.shard_repairs.get(shard)
        if srop is not None:
            srop.failed = True
            srop.deferred = []
            self._repair_write_tids = {
                tid: v for tid, v in self._repair_write_tids.items()
                if v[0] is not srop}
            srop.pending.clear()
            self._finish_shard_repair(srop)
        self.try_finish_rmw()
        self.check_ops()

    def on_shard_up(self, shard: int) -> None:
        """A revived shard is stale — it missed every write since it died —
        so it is kept out of reads and write fan-out and a shard repair
        starts automatically (the reference re-peers on the osdmap epoch
        bump, which drives log-based recovery the same way).  Parked work
        re-drives now and again when the repair completes."""
        if shard in self.acting:
            # stale until repair completes: serving reads could return old
            # bytes; receiving new writes would make its log head current
            # while mid-history entries are missing, defeating log catch-up
            self.stale.add(shard)
            if shard not in self.shard_repairs:
                if self.recovery_scheduler is not None:
                    # reservation-gated: the repair starts when the
                    # scheduler grants this PG its local+remote slots
                    self.recovery_scheduler.schedule_backend(
                        self, targets=[shard])
                else:
                    self.start_shard_repair(shard)
        self._redrive_parked()

    def _redrive_parked(self) -> None:
        """Re-drive ops parked by unrecoverable shard loss (called on shard
        revival and on repair completion, when current_shards() grows)."""
        self._redrive_reads()
        stalled, self._stalled_recoveries = self._stalled_recoveries, []
        if stalled and self.recovery_scheduler is not None:
            # stalled recoveries must RE-ENTER via the scheduler
            # (reservation-gated), not bypass it on shard revival
            self.recovery_scheduler.requeue_stalled(self, stalled)
        else:
            from ..common.tracer import root_or_ambient
            for rop in stalled:
                try:
                    # re-driven repair bytes stay recovery-class (the
                    # ambient ctx here is usually a peering/up event's,
                    # not a recovery root)
                    with root_or_ambient("recovery"):
                        self.continue_recovery_op(rop)
                except IOError:
                    self._stalled_recoveries.append(rop)
        # a stale shard whose repair FAILED (a peer died mid-repair) gets a
        # fresh repair on the next cluster event — the role re-peering on
        # a map change plays in the reference
        for shard in sorted(self.stale & self.up_shards()):
            if shard not in self.shard_repairs:
                if self.recovery_scheduler is not None:
                    self.recovery_scheduler.schedule_backend(
                        self, targets=[shard])
                else:
                    self.start_shard_repair(shard)
        self.check_ops()

    # -- write pipeline ----------------------------------------------------

    def submit_transaction(self, t: PGTransaction, on_commit=None) -> int:
        """Client entry point (ECBackend.cc:1477 -> start_rmw :1830).

        While the PG is inactive (< min_size current shards) the op parks
        in waiting_state — queued, unacked, unapplied — and is re-driven
        when shards return (the reference blocks I/O on an inactive PG)."""
        self.next_tid += 1
        tid = self.next_tid
        op = Op(tid=tid, t=t, on_commit=on_commit)
        op.tracked = self.op_tracker.create_request(
            f"osd_op(write tid={tid} objects={sorted(t.ops)})")
        op.tracked.mark_event("queued_for_pg")
        self.tid_to_op[tid] = op
        self.waiting_state.append(op)
        self._update_pipeline_depth()
        self.check_ops()
        return tid

    def _update_pipeline_depth(self) -> None:
        self.perf.set("pipeline_depth",
                      len(self.waiting_state) + len(self.waiting_reads) +
                      len(self.waiting_commit))

    def check_ops(self) -> None:
        """Advance each pipeline stage's head as far as possible
        (ECBackend.cc:2137-2145).  Re-loops because an op reaching the
        commit stage pins its result in the extent cache, which can unblock
        a stalled overlapping op behind it.  Gated on the PG being active
        (min_size current shards) and on no rollback being mid-flight (a
        re-queued op must re-plan against the restored state)."""
        if not self.is_active() or self._rollback_pending:
            return
        progress = True
        while progress:
            progress = False
            if self.waiting_state and self.try_state_to_reads():
                progress = True
            if self.waiting_reads and self.try_reads_to_commit():
                progress = True

    def try_state_to_reads(self) -> bool:
        """(ECBackend.cc:1856-1928): plan, satisfy cached reads, issue
        remote reads (all via the _admit_op hook)."""
        op = self.waiting_state[0]
        self._admit_op(op)
        if self._op_blocked(op):
            return False
        self.waiting_state.popleft()
        self.waiting_reads.append(op)
        self._start_op_reads(op)
        return True

    def _start_op_reads(self, op: Op) -> None:
        pass

    def try_reads_to_commit(self) -> bool:
        """(ECBackend.cc:1930-2087): generate per-shard transactions (the
        subclass hook encodes/replicates) and fan them out to every current
        shard with the piggybacked roll-forward point."""
        op = self.waiting_reads[0]
        if op.pending_read_shards or self._encode_pending(op):
            return False
        self.waiting_reads.popleft()
        self.waiting_commit.append(op)
        op.first_version = self.pg_log.head + 1
        with default_tracer().activate(
                op.trace, track=f"osd.{self.whoami}" if op.trace else None):
            self._fan_out(op)
        return True

    def _fan_out(self, op: Op) -> None:
        """Generate the op's shard transactions and send its sub-writes."""
        with trace_span("pg.generate_transactions", tid=op.tid,
                        backend=self.instance_name):
            shard_txns, log_entries = self._generate_transactions(op)
        # fan out to every current shard (down/stale shards miss the write
        # and are repaired later by the log — the reference's peering
        # likewise keeps them out of the acting set)
        cur = self.current_shards()
        op.at_version = self.pg_log.head
        op.gen += 1
        op.acked_shards = set()
        op.pending_commit_shards = set(cur)
        trim_to = self.pg_log.trim_target()
        for shard in self.acting:
            if shard in cur:
                self.bus.send(shard, ECSubWrite(
                    self.whoami, op.tid, shard_txns[shard],
                    at_version=op.at_version, trim_to=trim_to,
                    log_entries=list(log_entries),
                    roll_forward_to=self.committed_to, gen=op.gen))
        self._rolled_forward_to = max(self._rolled_forward_to,
                                      self.committed_to)
        self.pg_log.maybe_trim()

    def handle_sub_write_reply(self, reply: ECSubWriteReply) -> None:
        """(ECBackend.cc:1120-1152) -> try_finish_rmw (:2089)."""
        rep = self._repair_write_tids.pop(reply.tid, None)
        if rep is not None:                 # a shard-repair delete acked
            rop, oid, on_done = rep
            rop.pending.discard(("delete", oid))
            if on_done:
                on_done()
            self._maybe_finish_shard_repair(rop)
            return
        op = self.tid_to_op.get(reply.tid)
        if op is None or reply.gen != op.gen:
            return                      # stale ack from a rolled-back dispatch
        op.acked_shards.add(reply.from_shard)
        op.pending_commit_shards.discard(reply.from_shard)
        self.try_finish_rmw()

    def try_finish_rmw(self) -> None:
        while self.waiting_commit:
            op = self.waiting_commit[0]
            # shards that died after dispatch can never ack
            op.pending_commit_shards &= self.up_shards()
            if op.pending_commit_shards:
                return
            # write-availability gate (ecbackend.rst:149-174): the write is
            # durable only if >= min_size shards hold it.  Shards that died
            # after acking still hold it on disk but can't serve; count
            # only live acks.  Below the floor the write — and every later
            # in-flight write — rolls back; nothing was ever acked to the
            # client, so nothing is lost.
            live_acked = op.acked_shards & self.up_shards()
            if len(live_acked) < self.min_size:
                self._rollback_incomplete()
                return
            self.waiting_commit.popleft()
            self.committed_to = max(self.committed_to, op.at_version)
            self._op_reset_extra(op)
            del self.tid_to_op[op.tid]
            self.perf.inc("writes")
            self.perf.inc("write_bytes", sum(
                len(d) for objop in op.t.ops.values()
                for _, d in objop.buffer_updates))
            self._update_pipeline_depth()
            if op.tracked:
                op.tracked.mark_event("commit_sent")
                op.tracked.finish()
            if op.on_commit:
                op.on_commit(op.tid)
        # pipeline drained with an unannounced roll-forward point: kick it
        # to the shards so they drop rollback data (the reference's dummy
        # transaction, ECBackend.cc:2106-2120)
        if self.committed_to > self._rolled_forward_to:
            self._rolled_forward_to = self.committed_to
            for shard in sorted(self.current_shards()):
                self.bus.send(shard, RollForward(self.whoami,
                                                 self.committed_to))

    def _rollback_incomplete(self) -> None:
        """Undo every in-flight commit-stage write (head first failed; all
        later ones have higher versions and must unwind with it), rewind
        the authority log, and re-queue the ops at the pipeline head to
        re-plan and re-execute once the PG is active again.

        Ops still in waiting_reads / waiting_state are reset too: their
        plans and reads were computed against state of the writes being
        rolled back."""
        ops = list(self.waiting_commit)
        self.waiting_commit.clear()
        to = ops[0].first_version - 1
        self.perf.inc("write_rollbacks", len(ops))
        read_ops = list(self.waiting_reads)
        self.waiting_reads.clear()
        state_ops = list(self.waiting_state)
        self.waiting_state.clear()
        ops = ops + read_ops + state_ops    # original pipeline order
        for shard in sorted(self.up_shards()):
            # FIFO per-shard queues order the Rollback after any still-
            # undelivered sub-writes of these ops, so every shard unwinds
            # exactly what it applied
            if shard == self.whoami:
                self._rollback_pending += 1
            self.bus.send(shard, Rollback(self.whoami, to))
        if self.whoami not in self.up_shards():
            # local shard marked down: its queue was cleared, so no sub-
            # write can race a synchronous local unwind
            self.local_shard._rollback(to)
            self._on_local_rollback()
        self.pg_log.rewind(to)
        self.committed_to = min(self.committed_to, to)
        for op in ops:
            self._op_reset_extra(op)
            op.plan = None
            op.pending_read_shards.clear()
            op.remote_reads.clear()
            op.pending_commit_shards.clear()
            op.acked_shards.clear()
            op._rmw_stalled = False
            if op.tracked:
                op.tracked.mark_event("rolled_back")
        self.waiting_state.extend(ops)
        self._update_pipeline_depth()

    # -- recovery (ECBackend.cc:565-732; state ECBackend.h:249-293) --------

    def recover_object(self, oid: str, missing_chunks: set[int],
                       on_complete=None) -> RecoveryOp:
        rop = RecoveryOp(oid=oid, missing_shards=set(missing_chunks),
                         on_complete=on_complete)
        self.recovery_ops[oid] = rop
        # the recovery conversation (reads -> replies -> pushes) rides
        # the root context stamped HERE: an ambient one (scrub repair,
        # a scheduler wave) is adopted, otherwise a fresh recovery root
        # — so every byte it moves attributes to the recovery op class
        # in the wire accounting and device ledger
        from ..common.tracer import root_or_ambient
        with root_or_ambient("recovery"):
            try:
                self.continue_recovery_op(rop)
            except IOError:
                # too few current shards right now: park; re-driven when
                # a shard returns (the reference defers recovery the same
                # way when sources are missing)
                self._stalled_recoveries.append(rop)
        return rop

    def continue_recovery_op(self, rop: RecoveryOp) -> None:
        if rop.state == RecoveryState.IDLE:
            self.next_tid += 1
            rop.read_tid = self.next_tid
            rop.at_version = self.pg_log.last_version_of(rop.oid)
            rop._read_results = {}
            rop._read_attrs = {}
            rop._read_omap = {}            # chunk -> (omap kvs, header)
            self._recovery_issue_reads(rop)   # may raise IOError (parked)
            rop.state = RecoveryState.READING
            self._recovery_read_tids[rop.read_tid] = rop

    def handle_recovery_read_reply(self, rop: RecoveryOp,
                                   reply: ECSubReadReply) -> None:
        if rop.state != RecoveryState.READING:
            return                      # stale/duplicate reply
        if rop.oid in reply.errors:
            if reply.errors[rop.oid] == -5:
                # the source's copy is ROTTEN at rest (store checksum):
                # don't fail the op — drop the source, mark its shard for
                # rebuild too, and restart the read from the remaining
                # clean sources (mirrors the hash-present rotten-source
                # drop in _recovery_push_payloads)
                chunk = {s: c for c, s in
                         enumerate(self.acting)}[reply.from_shard]
                rop.bad_sources.add(chunk)
                rop.missing_shards = set(rop.missing_shards) | {chunk}
                self._recovery_read_tids.pop(rop.read_tid, None)
                rop.state = RecoveryState.IDLE
                try:
                    self.continue_recovery_op(rop)
                except IOError:
                    self._finish_recovery_op(rop, failed=True)
                return
            # the source no longer has the object (e.g. a delete committed
            # while the read was in flight): the op fails cleanly; a later
            # repair pass re-plans from the log
            self._recovery_read_tids.pop(rop.read_tid, None)
            self._finish_recovery_op(rop, failed=True)
            return
        chunk_of_shard = {s: c for c, s in enumerate(self.acting)}
        chunk = chunk_of_shard[reply.from_shard]
        # recovery reads exactly ONE oid: key every slot by rop.oid so a
        # hypothetical multi-oid reply cannot last-oid-wins overwrite
        if rop.oid in reply.buffers_read:
            rop._read_results[chunk] = b"".join(
                b for _, b in reply.buffers_read[rop.oid])
        if rop.oid in reply.attrs_read:
            rop._read_attrs[chunk] = reply.attrs_read[rop.oid]
        if rop.oid in reply.omap_read:
            rop._read_omap[chunk] = reply.omap_read[rop.oid]
        rop._pending.discard(reply.from_shard)
        if rop._pending:
            return
        self._recovery_read_tids.pop(rop.read_tid, None)
        if self.pg_log.last_version_of(rop.oid) != rop.at_version:
            # a write to this oid committed between the recovery read and
            # now: the reconstructed bytes predate it.  Re-read (the new
            # data is on the survivors) instead of pushing stale bytes.
            rop.state = RecoveryState.IDLE
            self.continue_recovery_op(rop)
            return
        # READING -> WRITING: build the payloads, push them
        payloads = self._recovery_push_payloads(rop)
        rop.state = RecoveryState.WRITING
        up = self.up_shards()
        for chunk in rop.missing_shards:
            shard = self.acting[chunk]
            if shard not in up:
                # target died while the reads were in flight: a push would
                # drop silently and never ack — fail now exactly as
                # on_shard_down fails an already-sent push (_failed_push)
                rop.failed = True
                continue
            data, attrs, omap, header = payloads[chunk]
            rop.pending_pushes.add(shard)
            self.perf.inc("recovery_bytes", len(data))
            self.bus.send(shard, PushOp(self.whoami, rop.oid, data,
                                        attrs=attrs, omap=omap,
                                        omap_header=header))
        if not rop.pending_pushes:
            self._finish_recovery_op(rop, failed=rop.failed)

    def handle_push_reply(self, reply: PushReply) -> None:
        wave = self._wave_pushes.get(reply.oid)
        if wave is not None and reply.from_shard in \
                wave.pending_pushes.get(reply.oid, ()):
            # a batched recovery wave's push.  The from_shard check
            # disambiguates against a CONCURRENT per-object RecoveryOp
            # for the same oid (e.g. scrub repair): replies the wave is
            # not waiting on fall through to the per-object path below
            self._wave_push_reply(wave, reply)
            return
        rop = self.recovery_ops.get(reply.oid)
        if rop is None:
            return
        rop.pending_pushes.discard(reply.from_shard)
        if not rop.pending_pushes and rop.state == RecoveryState.WRITING:
            self._finish_recovery_op(rop, failed=rop.failed)

    def _finish_recovery_op(self, rop: RecoveryOp, failed: bool = False) -> None:
        """COMPLETE (or FAILED) + drop tracking state so late replies are
        inert (the reference erases the RecoveryOp from recovery_ops on
        on_global_recover; failures go through _failed_push)."""
        rop.state = RecoveryState.FAILED if failed else RecoveryState.COMPLETE
        self.recovery_ops.pop(rop.oid, None)
        self._recovery_read_tids.pop(rop.read_tid, None)
        self.perf.inc("recovery_failures" if failed else "recoveries")
        if not failed:
            self._object_recovered(rop.oid, rop.t0)
        if rop.on_complete:
            rop.on_complete(rop)

    def _object_recovered(self, oid: str, t0: float) -> None:
        """One object back to full redundancy, its last push committed:
        the ``recovery.object`` span from ``t0`` (``time.perf_counter`` at
        its dispatch in a wave, chain or per-object op), and the reference's
        ``num_objects_recovered`` / ``num_bytes_recovered``."""
        size = self.object_size(oid)
        self.perf.inc("objects_recovered")
        self.perf.inc("bytes_recovered", size)
        default_tracer().observe("recovery.object", t0)

    # -- shard repair: log catch-up or backfill ----------------------------
    # (the role PGLog::merge_log + log-based recovery + backfill play in the
    # reference, src/osd/PGLog.cc)

    def start_shard_repair(self, shard: int, on_complete=None,
                           driver=None) -> ShardRepairOp:
        """Bring a revived/stale shard current.  Queries its log; replays
        exactly the missed entries when they are within the horizon, falls
        back to a scan+push backfill when not.  COMPLETE means the shard's
        data AND log match the authority's.  Works for the primary's own
        shard too: its local log lags the authority log by exactly the
        writes that committed while it was down, and the recovery pushes
        self-deliver over the bus.

        ``driver`` (a recovery-scheduler job) turns the repair into a
        PACED one: the planner hands the missing-object list to
        ``driver.offer_work`` and the driver dispatches it in waves via
        :meth:`repair_wave` instead of recovering everything inline."""
        existing = self.shard_repairs.get(shard)
        if existing is not None:
            # one repair per shard at a time: revival auto-starts one, an
            # explicit caller joins it
            if on_complete is not None:
                prev = existing.on_complete

                def chained(r, _prev=prev, _cb=on_complete):
                    if _prev:
                        _prev(r)
                    _cb(r)
                existing.on_complete = chained
            return existing
        chunk = self.acting.index(shard)
        rop = ShardRepairOp(shard=shard, chunk=chunk,
                            on_complete=on_complete, driver=driver)
        self.shard_repairs[shard] = rop
        # root the repair conversation on a recovery-class trace (see
        # recover_object): the log query, its reply, and every replay/
        # backfill push it triggers stitch — and account — as recovery
        from ..common.tracer import root_or_ambient
        with root_or_ambient("recovery"):
            self.bus.send(shard, PGLogQuery(self.whoami,
                                            since=self.pg_log.tail))
        return rop

    # -- boot peering (crash recovery) -------------------------------------

    def start_boot_peering(self) -> None:
        """After a restart from durable stores, decide what survived BEFORE
        serving: query every up peer's persisted log, adopt the best
        (furthest-ahead witnessed) log as the authority, and roll back any
        entry persisted on fewer than min_size shards — such a write was
        never acked, and repairing peers toward it would push never-acked
        state (for EC it would even mix chunk versions into garbage).
        This is the single-primary analog of the reference's peering
        (PeeringState GetInfo/GetLog; authoritative-log election +
        divergent-entry rollback)."""
        peers = {s for s in self.acting
                 if s != self.whoami and s not in self.bus.down}
        if not peers:
            return
        self._boot_peering = {}
        self._boot_peering_expect = peers
        for shard in sorted(peers):
            self.bus.send(shard, PGLogQuery(self.whoami, since=0))

    def _finish_boot_peering(self) -> None:
        infos = self._boot_peering
        self._boot_peering = None
        self._boot_peering_expect = set()
        self.elect_and_adopt_authority(infos)

    def elect_and_adopt_authority(self, infos: dict[int, PGLogInfo]) -> int:
        """Authoritative-log election + divergent-entry rollback: adopt the
        furthest-ahead witnessed log and roll back entries persisted on
        < min_size shards (never acked).  Shared by boot peering and the
        live peering statechart (osd/peering.py GetLog); returns the
        commit boundary.  Reference: PeeringState GetLog merge +
        ecbackend rollback semantics."""
        # adopt the furthest-ahead log: the primary may itself have been
        # down while peers committed (its RAM authority died with it)
        local = self.local_shard.pg_log
        best_shard, best_head = self.whoami, self.pg_log.head
        for shard, info in infos.items():
            if info.last_update > best_head:
                best_shard, best_head = shard, info.last_update
        if best_shard != self.whoami:
            binfo = infos[best_shard]
            if binfo.tail > self.pg_log.head:
                # our persisted log is beyond the best peer's horizon:
                # adopt its log wholesale (the data repairs via backfill)
                self.pg_log = PGLog()
                self.pg_log.tail = self.pg_log.head = binfo.tail
            for e in sorted(binfo.entries, key=lambda e: e.version):
                if e.version > self.pg_log.head:
                    self.pg_log.record(e)
            self.pg_log.head = max(self.pg_log.head, binfo.last_update)
        # witness count per version: a shard witnesses v if its log
        # provably contains the authority's entry at v
        auth = {e.version: e for e in self.pg_log.entries}
        shard_logs = {self.whoami: (local.head, local.tail,
                                    {e.version: e for e in local.entries})}
        for shard, info in infos.items():
            shard_logs[shard] = (info.last_update, info.tail,
                                 {e.version: e for e in info.entries})

        def witnesses(v: int) -> int:
            n = 0
            for head, tail, by_v in shard_logs.values():
                if head < v:
                    continue
                if v > tail and by_v.get(v) != auth.get(v):
                    continue
                n += 1
            return n

        boundary = self.pg_log.head
        if len(shard_logs) >= self.min_size:
            while boundary > self.pg_log.tail and \
                    witnesses(boundary) < self.min_size:
                boundary -= 1
        # roll back everything past the boundary, everywhere (FIFO-safe:
        # nothing else is in flight during boot), then roll the kept
        # prefix forward so stale rollback data drops
        if boundary < self.pg_log.head:
            for shard in sorted(self.up_shards()):
                if shard == self.whoami:
                    self._rollback_pending += 1
                self.bus.send(shard, Rollback(self.whoami, boundary))
            if self.whoami not in self.up_shards():
                self.local_shard._rollback(boundary)
            self.pg_log.rewind(boundary)
            self._on_local_rollback()
        self.committed_to = boundary
        self._rolled_forward_to = boundary
        for shard in sorted(self.up_shards()):
            self.bus.send(shard, RollForward(self.whoami, boundary))
        return boundary

    def handle_pg_log_info(self, info: PGLogInfo) -> None:
        if self._boot_peering is not None and \
                info.from_shard in self._boot_peering_expect:
            self._boot_peering[info.from_shard] = info
            if set(self._boot_peering) == self._boot_peering_expect:
                self._finish_boot_peering()
            return
        # The live peering statechart and a shard-repair op may BOTH be
        # waiting on this shard's log state (PGLogQuery carries no
        # correlation id, and the answer is identical either way), so the
        # reply feeds both: peering collects it AND the repair planner
        # still sees it — consuming it exclusively would stall whichever
        # consumer asked second.
        peering = getattr(self, "peering", None)
        if peering is not None:
            peering.offer_pg_log_info(info)
        rop = self.shard_repairs.get(info.from_shard)
        if rop is None or rop.state != RepairState.QUERY:
            return
        divergent, div_rewind = self.pg_log.divergent_oids(info.entries)
        plan, entries = self.pg_log.catch_up_plan(info.last_update)
        # the rewind point: last shard version consistent with our log
        rop.rewind_to = min(info.last_update, self.pg_log.head, div_rewind)
        rop.caught_up_to = self.pg_log.head
        if plan == "backfill":
            rop.plan = "backfill"
            rop.state = RepairState.SCAN
            self.perf.inc("shard_backfills")
            self._start_scan(rop)
            return
        rop.plan = plan
        todo: dict[str, str] = {}          # oid -> op
        for e in entries:
            todo[e.oid] = e.op
        for oid in divergent:
            # authority wins: re-push our state, or delete what we lack
            todo[oid] = OP_MODIFY if self._object_exists(oid) else OP_DELETE
        if not todo:
            self.perf.inc("log_repairs_clean")
            self._finish_shard_repair(rop)
            return
        self.perf.inc("log_repairs")
        rop.state = RepairState.RECOVERING
        if rop.driver is not None:
            # scheduler-paced: the driver dispatches repair_wave batches
            rop.driver.offer_work(self, rop, sorted(todo.items()))
            return
        for oid, op in sorted(todo.items()):
            self._repair_one(rop, oid, op)
        self._maybe_finish_shard_repair(rop)

    def _start_scan(self, rop: ShardRepairOp) -> None:
        """Backfill needs the authoritative object list.  Repairing a
        replica: the primary's own store is the authority, scan the stale
        target for extras.  Repairing the primary itself: any other up
        (hence current) shard supplies the authority list, and the stale
        local store supplies the extras."""
        target = rop.shard
        if rop.shard == self.whoami:
            others = [s for s in self.acting
                      if s != self.whoami and s in self.current_shards()]
            if not others:
                rop.failed = True
                self._finish_shard_repair(rop)
                return
            target = others[0]
        self._scan_waiters[target] = rop
        self.bus.send(target, PGScan(self.whoami))

    def handle_pg_scan_reply(self, reply: PGScanReply) -> None:
        rop = self._scan_waiters.pop(reply.from_shard, None)
        if rop is None or rop.state != RepairState.SCAN:
            return
        if rop.shard == self.whoami:
            authority = set(reply.oids)        # a current replica's list
            target_list = self._local_oids()   # the stale local store
        else:
            authority = self._local_oids()
            target_list = set(reply.oids)
        # the object lists reflect this moment: writes after it are the
        # delta _maybe_finish_shard_repair catches up
        rop.caught_up_to = self.pg_log.head
        rop.state = RepairState.RECOVERING
        items = [(oid, OP_MODIFY) for oid in sorted(authority)] + \
            [(oid, OP_DELETE) for oid in sorted(target_list - authority)]
        if rop.driver is not None and items:
            rop.driver.offer_work(self, rop, items)
            return
        for oid, op in items:
            self._repair_one(rop, oid, op)
        self._maybe_finish_shard_repair(rop)

    def _local_oids(self) -> set[str]:
        return {g.oid for g in self.local_shard.store.objects
                if g.shard == self.whoami and g.oid != PG_META}

    def _object_exists(self, oid: str) -> bool:
        return GObject(oid, self.whoami) in self.local_shard.store.objects

    def _repair_one(self, rop: ShardRepairOp, oid: str, op: str) -> None:
        if op == OP_DELETE:
            self._repair_delete(rop, oid)
        else:
            self._repair_recover_one(rop, oid)

    def _repair_delete(self, rop: ShardRepairOp, oid: str,
                       on_done=None) -> None:
        rop.objects_repaired += 1
        self.next_tid += 1
        tid = self.next_tid
        rop.pending.add(("delete", oid))
        self._repair_write_tids[tid] = (rop, oid, on_done)
        t = Transaction().remove(GObject(oid, rop.shard))
        self.bus.send(rop.shard, ECSubWrite(self.whoami, tid, t))

    def _repair_bookkeeping(self, rop: ShardRepairOp, oid: str,
                            ok: bool, on_done=None) -> None:
        """ONE copy of the per-object completion accounting shared by the
        chained per-object path and the batched wave path."""
        rop.pending.discard(("recover", oid))
        if not ok:
            rop.failed = True
        if on_done:
            on_done()
        self._maybe_finish_shard_repair(rop)

    def _chain_or_recover(self, oid: str, missing: set[int],
                          on_done) -> None:
        """ONE RecoveryOp per object at a time: start the recovery, or
        chain behind the in-flight op and re-issue when it completes —
        the per-object serialization rule every repair path shares."""
        existing = self.recovery_ops.get(oid)
        if existing is None:
            self.recover_object(oid, set(missing), on_complete=on_done)
            return
        prev = existing.on_complete

        def chained(rec, _prev=prev, _oid=oid, _missing=frozenset(missing),
                    _done=on_done):
            if _prev:
                _prev(rec)
            self.recover_object(_oid, set(_missing), on_complete=_done)
        existing.on_complete = chained

    def _repair_recover_one(self, rop: ShardRepairOp, oid: str,
                            on_done=None) -> None:
        rop.objects_repaired += 1
        rop.pending.add(("recover", oid))

        def done(rec, _rop=rop, _oid=oid, _cb=on_done):
            self._repair_bookkeeping(
                _rop, _oid, rec.state == RecoveryState.COMPLETE, _cb)

        self._chain_or_recover(oid, {rop.chunk}, done)

    # -- paced repair waves (driven by a recovery scheduler) ---------------

    def repair_wave(self, rop: ShardRepairOp, items, on_done=None) -> None:
        """Dispatch ONE wave of repair work: deletes go per-object (they
        are cheap sub-writes), recovers batch through the subclass's
        :meth:`_recover_many` (the EC backend fuses them into one
        ``decode_shards_many`` dispatch).  ``on_done`` fires when every
        item of THIS wave completed — the scheduler's cue to queue the
        next wave (overall repair completion still flows through
        ``_maybe_finish_shard_repair``)."""
        remaining = {"n": 0}

        def _item_done():
            remaining["n"] -= 1
            if remaining["n"] == 0 and on_done:
                on_done()
        recovers: list[str] = []
        for oid, op in items:
            remaining["n"] += 1
            if op == OP_DELETE:
                self._repair_delete(rop, oid, on_done=_item_done)
            else:
                recovers.append(oid)
        if recovers:
            self._repair_recover_many(rop, recovers, _item_done)
        elif remaining["n"] == 0 and on_done:
            on_done()

    def _repair_recover_many(self, rop: ShardRepairOp, oids: list[str],
                             each_done) -> None:
        """Wave recovers: objects already mid-recovery (or mid-wave) take
        the chained per-object path; the rest batch via _recover_many."""
        batch: dict[str, set[int]] = {}
        for oid in oids:
            if oid in self.recovery_ops or oid in self._wave_pushes:
                self._repair_recover_one(rop, oid, on_done=each_done)
            else:
                rop.objects_repaired += 1
                rop.pending.add(("recover", oid))
                batch[oid] = {rop.chunk}
        if batch:
            self._recover_many(
                batch,
                lambda oid, ok, _rop=rop, _cb=each_done:
                    self._repair_bookkeeping(_rop, oid, ok, _cb))

    def _recover_many(self, oids: dict[str, set[int]], on_each) -> None:
        """Recover several objects; ``on_each(oid, ok)`` per object.  The
        default is the per-object path (replicated pools have nothing to
        batch); the EC backend overrides with the decode-fused wave."""
        for oid, missing in sorted(oids.items()):
            def done(rec, _oid=oid):
                on_each(_oid, rec.state == RecoveryState.COMPLETE)
            self.recover_object(oid, set(missing), on_complete=done)

    def _wave_push_reply(self, wave, reply) -> None:
        """Only the EC backend creates waves; a stray reply here means a
        lifecycle bug, not a silent drop."""
        raise TypeError(f"wave push reply for {reply.oid!r} on a backend "
                        f"without a batched recovery path")

    def _maybe_finish_shard_repair(self, rop: ShardRepairOp) -> None:
        if rop.state != RepairState.RECOVERING or rop.pending or \
                rop.deferred:
            return                  # driver still holds undispatched waves
        # writes that committed while the repair was in flight skipped the
        # stale target (it is out of the fan-out): repair the delta before
        # declaring it current, else its log would claim writes whose data
        # it never received
        if not rop.failed and self.pg_log.head > rop.caught_up_to:
            delta = dedup_latest([e for e in self.pg_log.entries
                                  if e.version > rop.caught_up_to])
            rop.caught_up_to = self.pg_log.head
            for e in delta:
                self._repair_one(rop, e.oid, e.op)
            if rop.pending:
                return
        self._finish_shard_repair(rop)

    def _finish_shard_repair(self, rop: ShardRepairOp) -> None:
        self.shard_repairs.pop(rop.shard, None)
        if rop.failed:
            rop.state = RepairState.FAILED
        else:
            # repaired: the shard is current again — it rejoins reads and
            # write fan-out, and its return may reactivate a parked PG
            self.stale.discard(rop.shard)
            # data is current: ship the authoritative log segment so the
            # shard's next repair takes the clean fast path
            self.bus.send(rop.shard, PGLogUpdate(
                self.whoami,
                entries=self.pg_log.entries_after(rop.rewind_to) or [],
                last_update=self.pg_log.head,
                rewind_to=rop.rewind_to,
                trim_to=self.pg_log.tail))
            rop.state = RepairState.COMPLETE
            self.perf.inc("log_repair_objects" if rop.plan != "backfill"
                          else "backfill_objects", rop.objects_repaired)
        if rop.on_complete:
            rop.on_complete(rop)
        if not rop.failed:
            self._redrive_parked()
