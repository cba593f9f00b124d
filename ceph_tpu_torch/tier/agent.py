"""TierAgent: watermark-driven flush/evict over a TierService.

The background half of the cache tier (TierAgentState.h): each
:meth:`tick` measures the tier against its watermarks and moves data —

- **flush mode** arms when the dirty fraction of ``tier_target_max_
  objects`` passes ``tier_dirty_ratio_high``: dirty objects flush back
  through the EC base pool coldest-first (hit-set heat rank ascending)
  until the fraction drops under ``tier_dirty_ratio_low`` — hysteresis,
  so the agent is not re-armed by the very next absorbed write;
- **evict mode** arms when residency passes ``tier_full_ratio``: cold
  CLEAN objects drop (dirty ones flush first), again coldest-first,
  skipping anything the hit sets still call hot — unless the tier is
  at/over its hard capacity, where Ceph's agent also stops being
  polite.

Every pass is bounded by ``tier_agent_max_ops`` (one flush or evict =
one op): the agent shares the cluster with clients and must not convoy
them.  All watermarks read live from the config — ``ceph config set``
retunes a running agent.

Consecutive passes that END still above the high-dirty watermark mean
the base pool is not absorbing flushes as fast as writes arrive: that
counter feeds the ``TIER_FLUSH_BACKLOG`` health check
(mgr/health.py), and residency feeds ``TIER_FULL``.

The port's copy of ``ceph_tpu.tier.agent``.
"""
from __future__ import annotations

from ..common.tracer import default_tracer


class TierAgent:
    """Flush/evict agent bound to one :class:`TierService`."""

    def __init__(self, service):
        self.svc = service
        self.conf = service.cct.conf
        # consecutive ticks that ended dirty-ratio > high: the flush
        # backlog signal (0 = keeping up)
        self.backlog_ticks = 0
        self.last = {"flushes": 0, "evictions": 0, "skipped_hot": 0,
                     "dirty_ratio": 0.0, "fullness": 0.0}

    # -- measurement ---------------------------------------------------------

    def measure(self) -> dict:
        """Residency and dirtiness against tier_target_max_objects.
        O(resident) xattr probes — the tier is RAM-resident and bounded
        by the target, so this stays cheap."""
        objs = self.svc.resident()
        dirty = [o for o in objs if self.svc.is_dirty(o)]
        target = max(1, self.conf.get("tier_target_max_objects"))
        return {"objects": objs, "dirty": dirty, "target": target,
                "fullness": len(objs) / target,
                "dirty_ratio": len(dirty) / target}

    def _heat_order(self, oids) -> list[str]:
        """Coldest first (heat rank ascending, oid tie-break): the
        eviction/flush order — hot data stays resident longest."""
        return sorted(oids, key=lambda o: (self.svc.temperature(o), o))

    # -- one agent pass ------------------------------------------------------

    def tick(self, max_ops: int | None = None, age: bool = False) -> dict:
        """One bounded agent pass; returns what moved.  ``age=True``
        force-persists the cache PGs' accumulating hit sets first (a
        deterministic stand-in for the reference's period timer) so
        heat decays even on an idle tier."""
        if age:
            self.age()
        budget = max_ops if max_ops is not None \
            else self.conf.get("tier_agent_max_ops")
        tr = default_tracer()
        stats = {"flushes": 0, "evictions": 0, "skipped_hot": 0}
        with tr.span("tier.agent", owner="rebalance"):
            m = self.measure()
            high = self.conf.get("tier_dirty_ratio_high")
            low = self.conf.get("tier_dirty_ratio_low")
            full = self.conf.get("tier_full_ratio")
            dirty = set(m["dirty"])
            n_dirty, n_objs = len(dirty), len(m["objects"])
            if m["dirty_ratio"] > high:
                for oid in self._heat_order(dirty):
                    if budget <= 0 or n_dirty / m["target"] <= low:
                        break
                    self.svc.flush(oid)
                    dirty.discard(oid)
                    n_dirty -= 1
                    budget -= 1
                    stats["flushes"] += 1
            # arm at >= and drive STRICTLY below: the TIER_FULL health
            # check fires at >= full, so stopping exactly at the
            # watermark would leave it latched forever
            if n_objs / m["target"] >= full:
                hard_full = n_objs >= m["target"]
                for oid in self._heat_order(m["objects"]):
                    if budget <= 0 or n_objs / m["target"] < full:
                        break
                    if self.svc.temperature(oid) > 0 and not hard_full:
                        stats["skipped_hot"] += 1
                        continue
                    if oid in dirty:
                        if budget <= 1:
                            break      # flush+evict is two ops
                        self.svc.flush(oid)
                        dirty.discard(oid)
                        n_dirty -= 1
                        budget -= 1
                        stats["flushes"] += 1
                    self.svc.evict(oid)
                    n_objs -= 1
                    budget -= 1
                    stats["evictions"] += 1
            stats["dirty_ratio"] = n_dirty / m["target"]
            stats["fullness"] = n_objs / m["target"]
            self.backlog_ticks = self.backlog_ticks + 1 \
                if stats["dirty_ratio"] > high else 0
            self.svc.perf.set("objects", n_objs)
            self.svc.perf.set("dirty", n_dirty)
        self.last = stats
        return stats

    def age(self) -> None:
        """Persist the cache PGs' accumulating hit sets (hit_set
        aging): rotation is what makes heat DECAY — an object untouched
        for a full ring of periods ranks cold."""
        for g in self.svc.c.pools[self.svc.cache]["pgs"].values():
            if g.engine.hit_set_params is not None:
                g.engine.hit_set_persist()
                g.bus.deliver_all()

    # -- health-check inputs -------------------------------------------------

    def fullness(self) -> float:
        """Residency over target, WITHOUT xattr probes (cheap enough
        for a health evaluation)."""
        target = max(1, self.conf.get("tier_target_max_objects"))
        return len(self.svc.resident()) / target
