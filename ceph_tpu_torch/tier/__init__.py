"""Cache tiering: a replicated hot tier bound to an EC base pool.

The Ceph cache-tier analog (PrimaryLogPG's promote/proxy paths plus the
tier agent, ``src/osd/TierAgentState.h``): reads serve straight out of
the replicated cache pool when the object is resident (a *hit*), proxy
to the EC base on a miss, and promote when the object's hit-set recency crosses
``tier_promote_min_recency``.  Write-back mode absorbs writes in the
tier — journaled through the hosting OSDs' existing FileStore/BlueStore
WAL, so acked writes survive ``kill -9`` with no new durability
machinery — while :class:`~ceph_tpu_torch.tier.agent.TierAgent` flushes dirty
data and evicts cold objects by heat rank against the dirty-ratio and
fullness watermarks.

This is the first subsystem that *consumes* the observability stack
(per-PG hit sets + ``mgr/heat.py``) rather than feeding it: the agent's
promotion/demotion decisions close the loop from measured skew.

The port's copy of ``ceph_tpu.tier``.
"""
from .agent import TierAgent
from .service import (DIRTY_ATTR, MODES, TierService, live_tier_services)

__all__ = ["DIRTY_ATTR", "MODES", "TierAgent", "TierService",
           "live_tier_services"]
