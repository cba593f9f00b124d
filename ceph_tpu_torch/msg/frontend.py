"""Sharded serving front end: per-OSD engines behind one admission door.

One :class:`~ceph_tpu_torch.exec.engine.ServingEngine` per OSD shard
(reference analog: the OSD's sharded op work queue — osd_op_num_shards),
so codec work for different placement targets batches and throttles
independently instead of convoying through one queue.  The front end
adds:

- **striper-aware routing**: a striped logical object's pieces
  (``piece_name(soid, idx)``) route by the SAME placement the data
  plane uses — a locate callable (normally the cluster's
  ``object_pg(...).acting[0]``) — so a stripe fans its pieces across
  shards and a whole-object write becomes per-shard batched encodes;
- **overload shedding by dmClock class** on the way IN: each shard's
  dispatch depth is measured against the shed ladder
  (:class:`~ceph_tpu_torch.msg.shed.ShedPolicy`), and over-threshold arrivals
  raise :class:`FrontendBusy` (EBUSY) instead of queuing — background
  classes bounce first, client ops only at the hard limit.  The
  engine's own throttles still backpressure admitted work; the ladder
  is the REFUSAL tier above them.
"""
from __future__ import annotations

import threading

from ..backend.ecutil import crc32c
from ..client.striper import piece_name
from ..osd.mclock import CLIENT_OP
from .shed import EBUSY, ShedPolicy


class FrontendBusy(IOError):
    """An arrival shed by class: explicit EBUSY refusal, queue untouched."""

    def __init__(self, shard, op_class: str, depth: int, threshold: int):
        super().__init__(
            EBUSY,
            f"shard {shard}: shed {op_class} (depth {depth} >= "
            f"threshold {threshold})")
        self.shard = shard
        self.op_class = op_class


class ShardedFrontend:
    """Route + shed + submit over ``{shard_id: ServingEngine}``."""

    def __init__(self, shards: dict, locate=None, *,
                 queue_limit: int = 256, shed_fractions: dict | None = None):
        if not shards:
            raise ValueError("frontend needs at least one shard")
        self.shards = dict(shards)
        self._ids = sorted(self.shards)
        self._locate = locate
        self._lock = threading.Lock()
        self.shed = {sid: ShedPolicy(queue_limit, shed_fractions)
                     for sid in self._ids}
        self.routed = {sid: 0 for sid in self._ids}

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ShardedFrontend":
        for eng in self.shards.values():
            eng.start()
        return self

    def stop(self) -> None:
        for eng in self.shards.values():
            eng.stop()

    def flush(self, timeout: float | None = 60.0) -> None:
        for eng in self.shards.values():
            eng.flush(timeout)

    # -- routing -------------------------------------------------------------

    def shard_for(self, name: str):
        """The shard owning ``name``: the data plane's placement when a
        locate callable is wired (``object_pg(...).acting[0]``), else a
        stable crc32c hash over the shard set."""
        if self._locate is not None:
            sid = self._locate(name)
            if sid in self.shards:
                return sid
        h = crc32c(0, name.encode()) if isinstance(name, str) \
            else crc32c(0, bytes(name))
        return self._ids[h % len(self._ids)]

    def stripe_routes(self, soid: str, length: int, *,
                      stripe_unit: int = 65536, stripe_count: int = 4,
                      object_size: int = 1 << 20) -> list:
        """[(piece name, shard id, [(piece off, logical off, n)])] for a
        striped object of ``length`` bytes — the striper's layout math
        joined with this front end's placement."""
        from ..client.striper import RadosStriper
        lay = RadosStriper(_NullIo(), stripe_unit, stripe_count,
                           object_size)
        return [(piece_name(soid, idx), self.shard_for(piece_name(soid, idx)),
                 extents)
                for idx, extents in lay._piece_extents(length)]

    # -- admission -----------------------------------------------------------

    def _admit(self, name: str, op_class: str):
        sid = self.shard_for(name)
        eng = self.shards[sid]
        depth = eng.depths()["_total"]
        policy = self.shed[sid]
        if policy.should_shed(op_class, depth):
            raise FrontendBusy(sid, op_class, depth,
                               policy.threshold(op_class))
        with self._lock:
            self.routed[sid] += 1
        return sid, eng

    def serve_read(self, name: str, reader, op_class: str = CLIENT_OP):
        """Admit one already-resident read (a cache-tier hit) through
        the owning shard's shed ladder, then run ``reader()`` inline;
        returns ``(shard_id, reader())``.  The hit costs no codec
        dispatch, but it still competes for admission — an overloaded
        shard sheds tier hits by class exactly like codec work (raises
        :class:`FrontendBusy`) instead of letting the "free" path
        bypass overload control."""
        sid, _eng = self._admit(name, op_class)
        return sid, reader()

    def submit_encode(self, name: str, buf, op_class: str = CLIENT_OP,
                      **kw):
        """Admit one encode on the owning shard; returns
        ``(shard_id, BatchFuture)``.  Raises :class:`FrontendBusy` when
        the class is over its shed threshold."""
        sid, eng = self._admit(name, op_class)
        return sid, eng.submit_encode(buf, op_class, **kw)

    def submit_decode(self, name: str, chunks: dict,
                      op_class: str = CLIENT_OP, **kw):
        sid, eng = self._admit(name, op_class)
        return sid, eng.submit_decode(chunks, op_class, **kw)

    def submit_striped_encode(self, soid: str, data, *,
                              op_class: str = CLIENT_OP,
                              stripe_unit: int = 65536,
                              stripe_count: int = 4,
                              object_size: int = 1 << 20, **kw) -> list:
        """Stripe ``data`` and submit each piece's encode on ITS shard;
        returns ``[(piece name, shard id, BatchFuture)]``.  A shed on
        any piece aborts the whole submission (no partial stripes) —
        callers retry the object, not a piece."""
        data = bytes(data)
        routes = self.stripe_routes(soid, len(data),
                                    stripe_unit=stripe_unit,
                                    stripe_count=stripe_count,
                                    object_size=object_size)
        out = []
        for pname, sid, extents in routes:
            buf = bytearray()
            for p_off, l_off, n in extents:
                if len(buf) < p_off + n:
                    buf.extend(b"\0" * (p_off + n - len(buf)))
                buf[p_off:p_off + n] = data[l_off:l_off + n]
            sid2, eng = self._admit(pname, op_class)
            out.append((pname, sid2, eng.submit_encode(
                bytes(buf), op_class, **kw)))
        return out

    # -- observability -------------------------------------------------------

    def pressures(self) -> dict:
        """Per-shard admission occupancy (0..1+): the overload signal."""
        return {sid: eng.pressure() for sid, eng in self.shards.items()}

    def stats(self) -> dict:
        with self._lock:
            routed = dict(self.routed)
        return {"shards": len(self.shards),
                "routed": routed,
                "pressures": self.pressures(),
                "shed": {sid: p.snapshot() for sid, p in self.shed.items()}}


class _NullIo:
    """Layout-math-only stand-in: RadosStriper never touches it here."""
