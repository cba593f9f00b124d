"""Cache tiering: a writeback cache pool in front of a base pool.

Analog of the reference's cache-tier machinery (reference:
src/osd/PrimaryLogPG.h:971-992 TierAgentState/agent_work/agent_maybe_flush/
agent_maybe_evict; osd_types.h cache_mode_t CACHEMODE_WRITEBACK and
object_info_t FLAG_DIRTY):

- :class:`CacheTier` is the IO facade (the role the OSD's cache-mode
  dispatch plays when the OSDMap overlays a base pool with its tier):
  reads and writes go to the CACHE pool; a read miss promotes the object
  from the base pool first (promote_object), then serves from cache.
  Every cache write sets the DIRTY flag atomically in the same op vector
  — the object_info_t FLAG_DIRTY the reference's OSD sets internally.
- :class:`TieringAgent` is the background worker: it flushes DIRTY cache
  objects down to the base pool (clearing the flag) and evicts COLD
  clean objects — temperature 0 across the cache PG's hit sets
  (agent_estimate_temp) — so the cache holds only the working set.

The port's copy of ``ceph_tpu.osd.tiering``.
"""
from __future__ import annotations

from .hit_set import is_hit_set_oid
from .osd_ops import ObjectOperation

DIRTY_ATTR = "tier.dirty"            # object_info_t FLAG_DIRTY analog


class CacheTier:
    """Writeback cache-mode IO facade over (cache pool, base pool)."""

    def __init__(self, cluster, cache_pool: int, base_pool: int):
        self.c = cluster
        self.cache = cache_pool
        self.base = base_pool

    # -- promote (PrimaryLogPG::promote_object) -----------------------------

    def _promote(self, oid: str) -> bool:
        """Copy base -> cache on a miss; False when the object exists in
        neither tier.  A fresh promote is CLEAN (no dirty flag): it is
        byte-identical to the base copy."""
        try:
            r = self.c.operate(self.base, oid,
                               ObjectOperation().read(0, 0).getxattrs())
        except IOError:
            return False
        data, attrs = r.outdata(0), r.outdata(1)
        op = ObjectOperation().write_full(bytes(data))
        for name, value in sorted(attrs.items()):
            op.setxattr(name, value)
        self.c.operate(self.cache, oid, op)
        return True

    # -- client IO ----------------------------------------------------------

    def read(self, oid: str) -> bytes:
        try:
            return bytes(self.c.operate(
                self.cache, oid, ObjectOperation().read(0, 0)).outdata(0))
        except IOError as e:
            if getattr(e, "errno", None) != -2:
                raise
        if not self._promote(oid):
            raise FileNotFoundError(oid)
        return bytes(self.c.operate(self.cache, oid,
                                    ObjectOperation().read(0, 0))
                     .outdata(0))

    def write(self, oid: str, data: bytes) -> None:
        """CACHEMODE_WRITEBACK: the write lands in the cache only, with
        the dirty flag riding the SAME atomic op vector; the agent
        flushes to the base pool later."""
        self.c.operate(self.cache, oid, ObjectOperation()
                       .write_full(bytes(data)).setxattr(DIRTY_ATTR, True))


class TieringAgent:
    """The background flush/evict worker (agent_work)."""

    def __init__(self, cluster, cache_pool: int, base_pool: int):
        self.c = cluster
        self.cache = cache_pool
        self.base = base_pool
        self.stats = {"flushes": 0, "evictions": 0, "skipped_hot": 0}

    def is_dirty(self, oid: str) -> bool:
        try:
            self.c.operate(self.cache, oid,
                           ObjectOperation().getxattr(DIRTY_ATTR),
                           internal=True)
            return True
        except IOError:
            return False              # no flag (or no object): clean

    def temperature(self, oid: str) -> int:
        return self.c.pg_group(self.cache, oid).engine.object_temperature(
            oid)

    # -- agent work (agent_maybe_flush / agent_maybe_evict) -----------------

    def flush(self, oid: str) -> None:
        """Copy the cache object down to the base pool, then clear the
        dirty flag (agent_maybe_flush)."""
        r = self.c.operate(self.cache, oid,
                           ObjectOperation().read(0, 0).getxattrs(),
                           internal=True)
        data, attrs = r.outdata(0), r.outdata(1)
        op = ObjectOperation().write_full(bytes(data))
        for name, value in sorted(attrs.items()):
            if name != DIRTY_ATTR:
                op.setxattr(name, value)
        self.c.operate(self.base, oid, op, internal=True)
        self.c.operate(self.cache, oid,
                       ObjectOperation().rmxattr(DIRTY_ATTR),
                       internal=True)
        self.stats["flushes"] += 1

    def evict(self, oid: str) -> None:
        """Drop a CLEAN object from the cache (agent_maybe_evict)."""
        self.c.operate(self.cache, oid, ObjectOperation().remove(),
                       internal=True)
        self.stats["evictions"] += 1

    def age(self) -> None:
        """Roll every cache PG's hit-set ring forward one slot.  The
        reference ages by wall-clock (hit_set_period seconds); with this
        framework's deterministic op-count periods an idle PG would
        never age, so the agent's periodic pass IS the clock — one
        ``age()`` per pass makes 'cold' mean 'untouched for the last
        hit_set_count agent periods'."""
        for g in self.c.pools[self.cache]["pgs"].values():
            if g.engine.hit_set_params is not None:
                g.engine.hit_set_persist()

    def agent_work(self, max_ops: int = 1 << 30,
                   age: bool = False) -> dict:
        """One agent pass: flush every dirty object; evict the clean AND
        cold (temperature 0) ones.  ``age=True`` rolls the hit-set rings
        first (see :meth:`age`).  Returns cumulative stats."""
        if age:
            self.age()
        done = 0
        for oid in sorted(self.c.objects.get(self.cache, set())):
            if is_hit_set_oid(oid) or done >= max_ops:
                continue
            if self.is_dirty(oid):
                self.flush(oid)
                done += 1
            if self.temperature(oid) == 0:
                if not self.is_dirty(oid):
                    self.evict(oid)
                    done += 1
            else:
                self.stats["skipped_hot"] += 1
        return dict(self.stats)
