"""RadosStriper: large objects striped across RADOS objects.

Analog of the reference's libradosstriper (reference:
src/libradosstriper/RadosStriperImpl.cc — RAID-0 striping with
stripe_unit/stripe_count/object_size layout, piece objects named
"<soid>.%016x", and the layout+size stored as xattrs on the first
piece).  SURVEY §2.4 lists striping as one of the reference's
parallelism axes; here it is ALSO the device batching hook: a striped
write produces many whole RADOS objects at once, which EC pools encode
in ONE device dispatch via put_many's cross-PG coalescing
(ecutil.encode_many — the restructuring SURVEY §3.2 stars).

Layout semantics (Ceph file-layout striping): data advances in
stripe_unit chunks round-robin over a SET of stripe_count objects;
when every object of the set reaches object_size, the next set starts.

The port's copy of ``ceph_tpu.client.striper``.
"""
from __future__ import annotations

from ..osd.osd_ops import ObjectOperation
from .rados import ObjectNotFound

LAYOUT_ATTR = "striper.layout"      # {su, sc, os, size} on piece 0


def piece_name(soid: str, idx: int) -> str:
    return f"{soid}.{idx:016x}"


class RadosStriper:
    def __init__(self, ioctx, stripe_unit: int = 65536,
                 stripe_count: int = 4, object_size: int = 1 << 20):
        if object_size % stripe_unit:
            raise ValueError("object_size must be a stripe_unit multiple")
        self.io = ioctx
        self.su = stripe_unit
        self.sc = stripe_count
        self.os = object_size

    # -- layout math --------------------------------------------------------

    def _piece_extents(self, length: int) -> list[tuple[int, list]]:
        """[(piece idx, [(piece off, logical off, n)])] covering length."""
        per_set = self.os * self.sc          # bytes per object set
        pieces: dict[int, list] = {}
        off = 0
        while off < length:
            set_no, set_off = divmod(off, per_set)
            row, row_off = divmod(set_off, self.su * self.sc)
            col, unit_off = divmod(row_off, self.su)
            idx = set_no * self.sc + col
            n = min(self.su - unit_off, length - off)
            pieces.setdefault(idx, []).append(
                (row * self.su + unit_off, off, n))
            off += n
        return sorted(pieces.items())

    # -- I/O -----------------------------------------------------------------

    def _layout_pieces(self, soid: str, lay: dict) -> set[str]:
        """Piece names implied by a recorded layout — the reference derives
        piece sets from the layout/size xattr (RadosStriperImpl.cc
        truncate/remove), never from a pool-wide name scan, because user
        objects may legitimately be named '<soid>.<16 hex>'.  A staged
        ``pending`` sub-layout (write_full's crash window between piece
        writes and the final xattr) contributes its piece set too, so an
        interrupted write can never orphan pieces."""
        pend = lay.get("pending") or []
        if isinstance(pend, dict):
            pend = [pend]
        names = {piece_name(soid, 0)}       # layout piece always exists
        for sub in (lay, *pend):
            if not sub:
                continue
            reader = RadosStriper(self.io, int(sub["su"]), int(sub["sc"]),
                                  int(sub["os"]))
            names |= {piece_name(soid, idx)
                      for idx, _ in reader._piece_extents(int(sub["size"]))}
        return names

    def write_full(self, soid: str, data: bytes) -> int:
        """Stripe ``data`` over piece objects; EC pools encode the whole
        batch in one device dispatch.  Returns the piece count.  A
        shrinking rewrite deletes the stale trailing pieces (the
        reference truncates/removes them on shrink) — the stale set is
        derived from the PREVIOUS layout xattr, so unrelated user objects
        whose names merely match the piece pattern are never touched."""
        data = bytes(data)
        old = self._load_layout(soid)        # None = no prior object
        pieces = self._piece_extents(len(data))
        bufs: dict[str, bytearray] = {}
        for idx, extents in pieces:
            buf = bufs.setdefault(piece_name(soid, idx), bytearray())
            for p_off, l_off, n in extents:
                if len(buf) < p_off + n:
                    buf.extend(b"\0" * (p_off + n - len(buf)))
                buf[p_off:p_off + n] = data[l_off:l_off + n]
        new_lay = {"su": self.su, "sc": self.sc, "os": self.os,
                   "size": len(data)}
        # STAGE the incoming layout before touching any other piece: if
        # the batched piece write (or this process) dies mid-way, the
        # layout on piece 0 still enumerates every piece either layout
        # could have produced, so the next write's sweep — and remove() —
        # reclaim the partial state instead of orphaning it
        staged = dict(old) if old is not None else dict(new_lay, size=0)
        prior_pend = staged.get("pending") or []
        if isinstance(prior_pend, dict):
            prior_pend = [prior_pend]
        # earlier interrupted writes keep their pending entries until THIS
        # write's commit point sweeps their pieces
        staged["pending"] = [new_lay, *prior_pend]
        p0 = piece_name(soid, 0)
        op0 = ObjectOperation()
        if p0 in bufs:
            # piece 0's data rides the SAME atomic vector as the staged
            # layout: the op engine keeps its object_info in sync (a
            # below-engine overwrite would leave a stale size on the
            # engine-created object and truncate reads to it)
            op0.write_full(bytes(bufs[p0]))
        op0.setxattr(LAYOUT_ATTR, staged)
        self.io.operate(p0, op0)
        cluster = self.io.rados.cluster
        # ONE batched device encode for all remaining pieces
        # (cross-PG coalescing)
        rest = {oid: bytes(b) for oid, b in bufs.items() if oid != p0}
        if rest:
            cluster.put_many(self.io.pool_id, rest)
        # switch the RECORDED layout to the new one BEFORE sweeping: the
        # base layout must never enumerate pieces the sweep has deleted
        # (a crash mid-sweep would otherwise leave reads dereferencing
        # removed trailing pieces).  The old layout — whose pieces the
        # sweep is about to reclaim — moves into pending until the sweep
        # finishes, so a crash mid-sweep stays reclaimable.
        old_pend = ([{f: old[f] for f in ("su", "sc", "os", "size")}]
                    if old is not None else []) + prior_pend
        mid = dict(new_lay)
        if old_pend:
            mid["pending"] = old_pend
            self.io.operate(p0, ObjectOperation().setxattr(
                LAYOUT_ATTR, mid))
        else:
            # fresh object, nothing to sweep: the staged write above is
            # superseded by this single clean commit
            self.io.operate(p0, ObjectOperation().setxattr(
                LAYOUT_ATTR, new_lay))
            return max(len(bufs), 1)
        # piece 0 always survives the sweep: an EMPTY object has no data
        # pieces but its layout piece holds the xattr
        stale = (self._layout_pieces(soid, staged) - set(bufs)
                 - {piece_name(soid, 0)})
        for oid in stale:
            try:
                self.io.remove_object(oid)
            except ObjectNotFound:
                pass                         # already gone — idempotent
        # the COMMIT point: sweep done, pending dropped
        self.io.operate(p0, ObjectOperation().setxattr(
            LAYOUT_ATTR, new_lay))
        return max(len(bufs), 1)

    def _layout(self, soid: str) -> dict:
        return self.io.get_xattr(piece_name(soid, 0), LAYOUT_ATTR)

    def _load_layout(self, soid: str) -> dict | None:
        """The recorded layout, or None when the striped object genuinely
        does not exist (no piece 0 / no layout attr).  Transient errors —
        a blocked PG, an I/O failure — PROPAGATE: treating them as
        'absent' would skip the shrink sweep and permanently orphan
        pieces that remove() (layout-derived) can no longer reach."""
        try:
            return self._layout(soid)
        except ObjectNotFound:
            return None
        except IOError as e:
            if getattr(e, "errno", None) == -61:    # ENODATA: no attr
                return None
            raise

    def stat(self, soid: str) -> int:
        return int(self._layout(soid)["size"])

    def read(self, soid: str, length: int | None = None,
             offset: int = 0) -> bytes:
        lay = self._layout(soid)
        su, sc, osz = int(lay["su"]), int(lay["sc"]), int(lay["os"])
        size = int(lay["size"])
        if length is None:
            length = size - offset
        end = min(offset + length, size)
        if end <= offset:
            return b""
        # reassemble with the WRITER's layout (it may differ from ours),
        # reading only the WINDOWED byte range of each piece — a small
        # read must not pull whole megabyte pieces through the decode
        reader = RadosStriper(self.io, su, sc, osz)
        out = bytearray(end - offset)
        for idx, extents in reader._piece_extents(size):
            wanted = []                   # (piece off, logical start, n)
            for p_off, l_off, n in extents:
                s = max(l_off, offset)
                e = min(l_off + n, end)
                if s < e:
                    wanted.append((p_off + (s - l_off), s, e - s))
            if not wanted:
                continue
            lo = min(w[0] for w in wanted)
            hi = max(w[0] + w[2] for w in wanted)
            data = self.io.read(piece_name(soid, idx), hi - lo, offset=lo)
            for p_off, s, n in wanted:
                out[s - offset:s - offset + n] = \
                    data[p_off - lo:p_off - lo + n].ljust(n, b"\0")
        return bytes(out)

    def remove(self, soid: str) -> int:
        """Delete every piece of the recorded layout (write_full's
        layout-derived shrink sweep guarantees no pieces outlive the
        layout, so the recorded set IS the complete set).  Piece 0 goes
        last: the layout must outlive the rest."""
        lay = self._load_layout(soid)
        if lay is None:
            raise ObjectNotFound(f"no striped object {soid!r}")
        pieces = sorted(self._layout_pieces(soid, lay), reverse=True)
        removed = 0
        for oid in pieces:
            try:
                self.io.remove_object(oid)
                removed += 1
            except ObjectNotFound:
                pass                         # sparse piece never written
        return removed
