"""ReplicatedBackend: full-copy pools behind the PGBackend abstraction.

Analog of the reference's ``ReplicatedBackend`` (reference:
src/osd/ReplicatedBackend.cc, 2392 LoC; the other concrete PGBackend next
to ECBackend, src/osd/PGBackend.h:628).  Semantics mirrored:

- the primary applies each client transaction to its own full copy and
  fans the SAME transaction to every replica (``issue_op`` /
  ``submit_transaction`` — each replica holds identical whole objects);
- writes ack only after min_size copies are durable — inherited from
  :class:`~ceph_tpu_torch.backend.pg_backend.PGBackend`'s gate, with the
  replicated default min_size = floor(size/2)+1;
- reads are served from the primary's copy (the reference reads locally on
  the primary, PrimaryLogPG::do_op); a non-current primary pulls from a
  current replica instead;
- recovery pushes whole-object copies from any current source
  (``prep_push``/``handle_pull`` shape);
- deep scrub compares each replica's bytes against the primary's
  (be_deep_scrub comparing object digests across replicas).

A per-object ``version`` xattr (the role object_info_t::version plays,
reference: src/osd/osd_types.h object_info_t) travels with every write and
push so scrub can tell a stale copy from a clean one even when sizes match.

A copy of ``ceph_tpu.backend.replicated``: a replicated pool issues no
kernel (no encode, no HashInfo).
"""
from __future__ import annotations

from .bluestore import ChecksumError
from .memstore import GObject, Transaction
from .messages import ECSubRead, ECSubReadReply, MessageBus
from .pg_backend import Op, OSDShard, PGBackend, RecoveryOp, shard_store
from ..osd.pg_log import OP_DELETE, OP_MODIFY

VERSION_KEY = "@version"      # object_info_t::version analog; the "@"
                              # prefix keeps it out of the user-xattr
                              # namespace ("_"+name) so a user xattr
                              # named "version" cannot collide with it


class ReplicatedBackend(PGBackend):
    """Primary-side replicated backend over full-copy shard OSDs."""

    def __init__(self, size: int, bus: MessageBus, acting: list[int],
                 whoami: int = 0, cct=None, name: str = "",
                 min_size: int = 0, store=None):
        assert len(acting) == size, f"acting set must have {size} shards"
        self.size = size
        super().__init__(bus, acting, whoami=whoami, cct=cct, name=name,
                         min_size=min_size or size // 2 + 1,
                         min_size_floor=1, store=store,
                         perf_prefix="replicated_backend")
        # remote whole-object reads in flight (non-current primary)
        self._remote_read_tids: dict[int, dict] = {}

    # -- metadata ------------------------------------------------------------

    def object_size(self, oid: str) -> int:
        try:
            return self.local_shard.store.stat(GObject(oid, self.whoami))
        except FileNotFoundError:
            return 0

    def _object_version(self, oid: str) -> int:
        try:
            return self.local_shard.store.getattr(
                GObject(oid, self.whoami), VERSION_KEY)
        except (FileNotFoundError, KeyError):
            return 0

    # -- write pipeline hooks ------------------------------------------------

    def _generate_transactions(self, op: Op):
        """Each acting shard gets the same whole-object mutation — the
        replica transactions ReplicatedBackend::issue_op ships."""
        shard_txns = {shard: Transaction() for shard in self.acting}
        log_entries = []
        for oid, objop in op.t.ops.items():
            is_delete = (objop.delete_first and not objop.buffer_updates
                         and objop.truncate is None)
            entry = self.pg_log.append(
                oid, OP_DELETE if is_delete else OP_MODIFY)
            log_entries.append(entry)
            for clone_oid in objop.clone_to:
                # clones replay independently on log repair (see the EC
                # backend's clone_to note)
                log_entries.append(self.pg_log.append(clone_oid,
                                                      OP_MODIFY))
            if objop.clone_to and oid in self.inconsistent_objects:
                # damaged state COWs into the clone (see EC note)
                self.inconsistent_objects.update(objop.clone_to)
            if objop.rollback_from is not None:
                # head state replaced by the source's — flag included
                if objop.rollback_from in self.inconsistent_objects:
                    self.inconsistent_objects.add(oid)
                else:
                    self.inconsistent_objects.discard(oid)
            elif is_delete or (objop.truncate is not None and any(
                    off == 0 and len(d) >= objop.truncate[0]
                    for off, d in objop.buffer_updates)):
                # wholesale replacement exonerates (mirrors the EC rule;
                # also covers snaptrim's clone deletes)
                self.inconsistent_objects.discard(oid)
            for shard in self.acting:
                obj = GObject(oid, shard)
                t = shard_txns[shard]
                for clone_oid in objop.clone_to:
                    t.clone(obj, GObject(clone_oid, shard))   # COW first
                if objop.rollback_from is not None:
                    t.clone(GObject(objop.rollback_from, shard), obj)
                if objop.delete_first:
                    t.remove(obj)
                if objop.truncate is not None:
                    t.truncate(obj, objop.truncate[0])
                for w_off, data in objop.buffer_updates:
                    t.write(obj, w_off, data)
                for name, value in objop.attr_updates.items():
                    if value is None:
                        t.rmattr(obj, name)
                    else:
                        t.setattr(obj, name, value)
                for oop in objop.omap_ops:
                    if oop[0] == "set":
                        t.omap_setkeys(obj, oop[1])
                    elif oop[0] == "rm":
                        t.omap_rmkeys(obj, oop[1])
                    elif oop[0] == "clear":
                        t.omap_clear(obj)
                    elif oop[0] == "header":
                        t.omap_setheader(obj, oop[1])
                    else:
                        raise ValueError(f"unknown omap op {oop[0]!r}")
                if not is_delete:
                    t.setattr(obj, VERSION_KEY, entry.version)
            self.perf.inc("stripe_bytes_encoded", sum(
                len(d) for _, d in objop.buffer_updates))
        return shard_txns, log_entries

    # -- read path -----------------------------------------------------------

    def objects_read_and_reconstruct(self, reads, on_complete,
                                     fast_read: bool = False) -> int:
        """Read extents per object.  The primary serves from its own full
        copy when current (the reference's primary-local read path); a
        stale/down primary pulls from a current replica.  Same signature
        as the EC backend so callers are pool-type agnostic."""
        self.next_tid += 1
        tid = self.next_tid
        if self.whoami in self.current_shards():
            result, errors = self._read_local(reads)
            on_complete(result, errors)
            return tid
        sources = sorted(self.current_shards())
        if not sources:
            on_complete({}, {oid: -5 for oid in reads})   # EIO: inactive
            return tid
        src = sources[0]
        self._remote_read_tids[tid] = {"reads": dict(reads),
                                       "on_complete": on_complete,
                                       "source": src}
        self.bus.send(src, ECSubRead(
            self.whoami, tid,
            {oid: [(0, None)] for oid in reads}))
        return tid

    def _read_local(self, reads):
        result: dict[str, list[tuple[int, int, bytes]]] = {}
        errors: dict[str, int] = {}
        store = self.local_shard.store
        for oid, extents in reads.items():
            obj = GObject(oid, self.whoami)
            try:
                out = []
                for off, length in extents:
                    out.append((off, length, store.read(obj, off, length)))
                result[oid] = out
            except FileNotFoundError:
                errors[oid] = -2      # ENOENT
            except ChecksumError:
                errors[oid] = -5      # EIO: rotten at rest (bluestore)
        if result:
            self.perf.inc("reads")
        if errors:
            self.perf.inc("read_errors", len(errors))
        self.perf.inc("read_bytes", sum(
            len(seg) for segs in result.values() for _, _, seg in segs))
        return result, errors

    def _handle_other_read_reply(self, reply: ECSubReadReply) -> None:
        ctx = self._remote_read_tids.pop(reply.tid, None)
        if ctx is None:
            return
        result: dict[str, list[tuple[int, int, bytes]]] = {}
        errors: dict[str, int] = dict(reply.errors)
        for oid, extents in ctx["reads"].items():
            if oid in errors:
                continue
            bufs = reply.buffers_read.get(oid)
            if bufs is None:
                errors[oid] = -5
                continue
            whole = b"".join(b for _, b in bufs)
            result[oid] = [(off, length,
                            whole[off:off + length if length is not None
                                  else None])
                           for off, length in extents]
        if result:
            self.perf.inc("reads")
        if errors:
            self.perf.inc("read_errors", len(errors))
        self.perf.inc("read_bytes", sum(
            len(seg) for segs in result.values() for _, _, seg in segs))
        ctx["on_complete"](result, errors)

    def _on_shard_down_reads(self, shard: int, chunk: int) -> None:
        # remote reads addressed to a dying source: retry elsewhere
        for tid, ctx in list(self._remote_read_tids.items()):
            if ctx["source"] == shard:
                del self._remote_read_tids[tid]
                self.objects_read_and_reconstruct(ctx["reads"],
                                                  ctx["on_complete"])

    # -- recovery hooks ------------------------------------------------------

    def is_recoverable(self, oid: str, missing: set[int]) -> bool:
        """Recoverable iff any current shard outside the missing set can
        supply a full copy (MissingLoc::readable_with_acting shape)."""
        return any(c not in missing
                   for c, s in enumerate(self.acting)
                   if s in self.current_shards())

    def _recovery_issue_reads(self, rop: RecoveryOp) -> None:
        sources = [c for c, s in enumerate(self.acting)
                   if s in self.current_shards()
                   and c not in rop.missing_shards]
        if not sources:
            raise IOError("no current source for replicated recovery")
        src_shard = self.acting[sources[0]]
        rop._pending = {src_shard}
        # "*": the push replaces the whole object, so EVERY xattr must
        # travel (a {VERSION_KEY}-only read once pushed attr-less objects
        # — invisible while only never-read replicas were repaired, data
        # loss once the shared-bus topology started repairing primaries)
        self.bus.send(src_shard, ECSubRead(
            self.whoami, rop.read_tid,
            {rop.oid: [(0, None)]}, attrs_to_read={"*"},
            include_omap=True))

    def _recovery_push_payloads(self, rop: RecoveryOp):
        (data,) = rop._read_results.values()
        attrs = next(iter(rop._read_attrs.values()), {}) or {}
        omap, header = next(iter(rop._read_omap.values()), ({}, b""))
        return {chunk: (data, dict(attrs), dict(omap), header)
                for chunk in rop.missing_shards}

    # -- deep scrub ----------------------------------------------------------

    def be_deep_scrub(self, oid: str) -> dict[int, bool]:
        """MAJORITY-vote scrub: replicas group by (bytes, version); the
        largest group is the authority and the minority is flagged.
        Trusting the primary's copy blindly would MISLOCATE rot on the
        primary itself — flagging every healthy replica and letting a
        repair push the rotten copy over them (the reference's scrub
        likewise compares maps across replicas and picks an
        authoritative object, PG::scrub_compare_maps).  A tie (e.g.
        size 2) flags everyone: detected, honestly unlocatable."""
        copies: dict[int, tuple] = {}
        out: dict[int, bool] = {}
        for chunk, shard in enumerate(self.acting):
            if shard in self.bus.down:
                continue
            store = shard_store(self.bus, shard)
            obj = GObject(oid, shard)
            try:
                # identity covers omap too: replicated pools serve omap
                # reads, so a diverged omap is user-visible corruption
                copies[chunk] = (bytes(store.read(obj)),
                                 store.getattr(obj, VERSION_KEY),
                                 tuple(sorted(store.get_omap(obj).items())),
                                 store.get_omap_header(obj))
            except (FileNotFoundError, KeyError, ChecksumError):
                # ChecksumError: bluestore-style at-rest crc failure —
                # the store itself located the rot, no vote needed
                copies[chunk] = None
        groups: dict = {}
        for chunk, ident in copies.items():
            groups.setdefault(ident, []).append(chunk)
        best = max(groups.values(), key=len)
        if len(groups) > 1 and \
                sum(1 for g in groups.values() if len(g) == len(best)) > 1:
            return {c: False for c in copies}      # tie: flag everything
        authority = next(ident for ident, cs in groups.items()
                         if cs is best)
        for chunk, ident in copies.items():
            out[chunk] = ident == authority and ident is not None
        return out


def make_replicated_cluster(size: int = 3, cct=None):
    """Primary + replica OSDs on one bus; returns (backend, bus)."""
    bus = MessageBus()
    backend = ReplicatedBackend(size, bus, acting=list(range(size)),
                                whoami=0, cct=cct)
    for shard in range(1, size):
        OSDShard(shard, bus)
    return backend, bus
