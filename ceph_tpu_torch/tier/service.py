"""TierService: the promote/proxy read-write paths of a cache tier.

One service binds a replicated cache pool to an EC base pool on the same
cluster (the mon's ``osd tier add`` + ``osd tier cache-mode``):

- **read**: the cache pool is tried first — a resident object is a
  *hit* and serves without touching the EC base at all.  When a sharded
  frontend is wired, the hit is admitted through its shed ladder first
  (:meth:`~ceph_tpu_torch.msg.frontend.ShardedFrontend.serve_read`): the
  "free" path still competes for admission, so an overloaded shard
  sheds tier hits by dmClock class instead of letting them bypass
  overload control.  A miss *proxies* the read to the base pool and
  promotes the object into the cache when its hit-set recency reaches
  ``tier_promote_min_recency`` (PrimaryLogPG::maybe_handle_cache's
  min_read_recency_for_promote) — one cold read does not thrash the
  tier, a re-read within the recency window does promote.
- **write** (by cache mode): ``writeback`` absorbs the write in the
  cache pool as ONE atomic op vector (write_full + the dirty xattr),
  which runs through the hosting OSD's ordinary op engine and store WAL
  — the ack means the same thing it means for any other write, and
  survives ``kill -9`` the same way; ``proxy`` forwards writes to the
  base pool and drops any now-stale cached copy; ``readonly`` refuses
  writes (EROFS) — the reference's readonly mode is for immutable data
  and has the same coherence caveat.

Dirtiness rides an object xattr (``tier.dirty``, shared with the
seed agent in osd/tiering.py) so it is exactly as durable as the data
it describes.

The port's copy of ``ceph_tpu.tier.service``.
"""
from __future__ import annotations

import threading
import weakref

from ..common.tracer import default_tracer
from ..osd.hit_set import is_hit_set_oid
from ..osd.mclock import CLIENT_OP
from ..osd.osd_ops import ObjectOperation
from ..osd.tiering import DIRTY_ATTR

MODES = ("writeback", "proxy", "readonly")

_SERVICES: "weakref.WeakSet[TierService]" = weakref.WeakSet()


def live_tier_services() -> list["TierService"]:
    """Every live tier service (prometheus family source)."""
    return list(_SERVICES)


class TierService:
    """Promote/proxy paths over a (cache pool, base pool) binding."""

    def __init__(self, cluster, cache_pool: int, base_pool: int, *,
                 mode: str = "writeback", frontend=None,
                 name: str | None = None):
        if mode not in MODES:
            raise ValueError(f"unknown cache mode {mode!r} "
                             f"(one of {MODES})")
        self.c = cluster
        self.cache = cache_pool
        self.base = base_pool
        self.mode = mode
        self.frontend = frontend
        self.name = name or f"p{cache_pool}"
        self.cct = cluster.cct
        self._lock = threading.Lock()
        # per-dmClock-class hit/miss/proxy tallies (the fixed class set
        # bounds this dict; perf counters stay class-blind like the
        # reference's l_osd_tier_* slots)
        self.class_ops: dict[str, dict[str, int]] = {}
        from ..common.perf_counters import PerfCountersBuilder
        b = PerfCountersBuilder(f"tier.{self.name}")
        b.add_u64_counter("hit", description="reads served from the "
                          "cache pool (no base-pool touch)")
        b.add_u64_counter("miss", description="reads not resident in "
                          "the cache pool")
        b.add_u64_counter("proxy_read", description="missed reads "
                          "forwarded to the EC base pool")
        b.add_u64_counter("proxy_write", description="writes forwarded "
                          "to the base pool (proxy cache mode)")
        b.add_u64_counter("promote", description="objects copied into "
                          "the cache pool after recency crossed "
                          "tier_promote_min_recency")
        b.add_u64_counter("promote_skip", description="missed reads "
                          "whose hit-set recency stayed below the "
                          "promotion threshold (served via proxy only)")
        b.add_u64_counter("writeback", description="writes absorbed "
                          "dirty in the cache pool (writeback mode)")
        b.add_u64_counter("flush", description="dirty objects written "
                          "back to the EC base pool")
        b.add_u64_counter("evict", description="clean objects removed "
                          "from the cache pool by the agent")
        b.add_u64_counter("invalidate", description="stale cached "
                          "copies dropped after a proxied write")
        b.add_u64("objects", description="objects resident in the "
                  "cache pool at the agent's last pass")
        b.add_u64("dirty", description="dirty objects in the cache "
                  "pool at the agent's last pass")
        self.perf = b.create_perf_counters()
        self.cct.perf.add(self.perf)
        _SERVICES.add(self)

    def close(self) -> None:
        self.cct.perf.remove(self.perf.name)
        _SERVICES.discard(self)

    # -- read path (maybe_handle_cache: hit / proxy / promote) --------------

    def read(self, oid: str, op_class: str = CLIENT_OP) -> bytes:
        """Serve one read through the tier.  Raises FrontendBusy when
        the owning frontend shard sheds the class, IOError(ENOENT) when
        the object exists in neither pool.  A cache PG that went
        INACTIVE (tier OSD deaths below min_size) degrades the read to
        a base-pool proxy instead of blocking the client — and skips
        promotion, since the cache pool cannot absorb the copy."""
        from ..cluster import BlockedWriteError
        tr = default_tracer()
        with tr.span("tier.read", owner="client", oid=oid):
            degraded = False
            try:
                if self.frontend is not None:
                    _sid, data = self.frontend.serve_read(
                        oid, lambda: self._cache_read(oid)[0], op_class)
                else:
                    data = self._cache_read(oid)[0]
            except BlockedWriteError:
                degraded = True
            except IOError as e:
                if getattr(e, "errno", None) != -2:
                    raise
            else:
                self.perf.inc("hit")
                self._class_tally(op_class, "hit")
                return data
            # miss: proxy the read to the EC base (the client is NOT
            # blocked behind the promotion copy — proxy first, like
            # do_proxy_read ahead of promote_object)
            self.perf.inc("miss")
            self._class_tally(op_class, "miss")
            with tr.span("tier.proxy_read", owner="client", oid=oid):
                data, attrs = self._base_read(oid)
            self.perf.inc("proxy_read")
            self._class_tally(op_class, "proxy")
            if degraded:
                self.perf.inc("promote_skip")
                return data
            min_rec = self.cct.conf.get("tier_promote_min_recency")
            if self.recency(oid) >= min_rec:
                # promotion is OPPORTUNISTIC: a cache PG that can serve
                # reads but not absorb writes (degraded below min_size)
                # must not block the client behind the copy
                try:
                    self.promote(oid, data, attrs)
                except BlockedWriteError:
                    self.perf.inc("promote_skip")
            else:
                self.perf.inc("promote_skip")
            return data

    def _cache_read(self, oid: str):
        """Read data + xattrs from the cache pool.  NOT internal: the
        access lands in the cache PG's hit set — misses included (the
        engine records before executing, exactly the evidence recency-
        gated promotion needs).  An inactive cache PG is refused UP
        FRONT: parking the op would leave a zombie that resurfaces as a
        late error after the PG revives, when the client was already
        answered by the base-pool proxy."""
        self._require_active(oid)
        op = ObjectOperation().read(0, 0).getxattrs()
        reply = self.c.operate(self.cache, oid, op)
        return bytes(reply.ops[0].outdata), dict(reply.ops[1].outdata)

    def _require_active(self, oid: str) -> None:
        from ..cluster import BlockedWriteError
        g = self.c.pg_group(self.cache, oid)
        if self.c.pg_state(g) == "inactive":
            raise BlockedWriteError(
                f"cache PG {g.pgid} inactive (tier OSDs down)")

    def _base_read(self, oid: str):
        op = ObjectOperation().read(0, 0).getxattrs()
        reply = self.c.operate(self.base, oid, op, internal=True)
        return bytes(reply.ops[0].outdata), dict(reply.ops[1].outdata)

    def recency(self, oid: str) -> int:
        """Consecutive most-recent hit sets (current first, then the
        archive ring newest-first) containing ``oid`` — the reference's
        min_read_recency_for_promote evidence."""
        eng = self.c.pg_group(self.cache, oid).engine
        sets = []
        if eng.hit_set is not None:
            sets.append(eng.hit_set)
        sets.extend(reversed(eng.hit_set_archives()))
        r = 0
        for hs in sets:
            if not hs.contains(oid):
                break
            r += 1
        return r

    def temperature(self, oid: str) -> int:
        """Membership count across ALL of the cache PG's hit sets (the
        agent's heat rank; 0 = cold)."""
        return self.c.pg_group(self.cache, oid).engine \
            .object_temperature(oid)

    def promote(self, oid: str, data: bytes, attrs: dict) -> None:
        """Copy a base object into the cache pool, CLEAN (it matches the
        base, so an eviction needs no flush).  Internal: promotion
        traffic is system work and must not heat its own hit set."""
        tr = default_tracer()
        self._require_active(oid)        # never park a promotion copy
        with tr.span("tier.promote", owner="client", oid=oid):
            op = ObjectOperation().write_full(bytes(data))
            for k in sorted(attrs):
                if k != DIRTY_ATTR:
                    op.setxattr(k, attrs[k])
            self.c.operate(self.cache, oid, op, internal=True)
        self.perf.inc("promote")

    # -- write path (by cache mode) -----------------------------------------

    def write(self, oid: str, data: bytes,
              op_class: str = CLIENT_OP) -> None:
        tr = default_tracer()
        if self.mode == "writeback":
            # ONE atomic vector: the data and its dirty mark commit (and
            # replay from the WAL) together — there is no window where a
            # crash leaves absorbed data the flush agent cannot see
            with tr.span("tier.write", owner="client", oid=oid):
                op = ObjectOperation().write_full(bytes(data)) \
                    .setxattr(DIRTY_ATTR, True)
                self.c.operate(self.cache, oid, op)
            self.perf.inc("writeback")
            return
        if self.mode == "readonly":
            err = IOError(f"pool {self.cache} is a readonly cache tier: "
                          f"write {oid} to the base pool directly")
            err.errno = -30          # EROFS
            raise err
        # proxy: the base pool is the write target; any cached copy is
        # stale the moment the base write commits
        with tr.span("tier.proxy_write", owner="client", oid=oid):
            self.c.operate(self.base, oid,
                           ObjectOperation().write_full(bytes(data)))
        self.perf.inc("proxy_write")
        self._invalidate(oid)

    def _invalidate(self, oid: str) -> None:
        try:
            self.c.operate(self.cache, oid,
                           ObjectOperation().remove(), internal=True)
        except IOError as e:
            if getattr(e, "errno", None) != -2:
                raise
        else:
            self.perf.inc("invalidate")

    # -- flush / evict primitives (the agent's verbs) -----------------------

    def is_dirty(self, oid: str) -> bool:
        try:
            self.c.operate(self.cache, oid,
                           ObjectOperation().getxattr(DIRTY_ATTR),
                           internal=True)
        except IOError:
            return False
        return True

    def flush(self, oid: str) -> None:
        """Write a dirty cached object back through the EC base pool's
        small-write path, then clear its dirty mark.  Order matters for
        crash safety: the base write commits BEFORE the mark clears, so
        a crash between the two re-flushes (idempotent) instead of
        losing the write."""
        tr = default_tracer()
        with tr.span("tier.flush", owner="rebalance", oid=oid):
            op = ObjectOperation().read(0, 0).getxattrs()
            reply = self.c.operate(self.cache, oid, op, internal=True)
            data = bytes(reply.ops[0].outdata)
            attrs = dict(reply.ops[1].outdata)
            out = ObjectOperation().write_full(data)
            for k in sorted(attrs):
                if k != DIRTY_ATTR:
                    out.setxattr(k, attrs[k])
            self.c.operate(self.base, oid, out, internal=True)
            self.c.operate(self.cache, oid,
                           ObjectOperation().rmxattr(DIRTY_ATTR),
                           internal=True)
        self.perf.inc("flush")

    def evict(self, oid: str) -> None:
        """Drop a CLEAN cached copy (the caller flushes first when
        dirty); the base pool still holds the object, so the next read
        is a miss + proxy, not a loss."""
        tr = default_tracer()
        with tr.span("tier.evict", owner="rebalance", oid=oid):
            self.c.operate(self.cache, oid,
                           ObjectOperation().remove(), internal=True)
        self.perf.inc("evict")

    # -- bookkeeping ---------------------------------------------------------

    def resident(self) -> list[str]:
        """Objects currently resident in the cache pool (hit-set archive
        objects excluded — they are the instrument, not the cargo)."""
        return sorted(o for o in self.c.objects.get(self.cache, set())
                      if not is_hit_set_oid(o))

    def _class_tally(self, op_class: str, kind: str) -> None:
        with self._lock:
            per = self.class_ops.setdefault(
                op_class, {"hit": 0, "miss": 0, "proxy": 0})
            per[kind] += 1

    def stats(self) -> dict:
        with self._lock:
            by_class = {k: dict(v) for k, v in self.class_ops.items()}
        hits, misses = self.perf.get("hit"), self.perf.get("miss")
        total = hits + misses
        return {"mode": self.mode,
                "cache_pool": self.cache,
                "base_pool": self.base,
                "objects": len(self.resident()),
                "hit_rate": (hits / total) if total else 0.0,
                "counters": {k: self.perf.get(k) for k in
                             ("hit", "miss", "proxy_read", "proxy_write",
                              "promote", "promote_skip", "writeback",
                              "flush", "evict", "invalidate")},
                "by_class": by_class}
