"""Background repair, copied from ``ceph_tpu.recovery``: the
reservation-gated, prioritized, batch-fused :class:`RecoveryScheduler`
with its :class:`AsyncReserver` pairs, which paces shard repair in waves
through one codec pipeline; chained partial-sum repair (``chain``:
:func:`plan_chains`, the CRUSH-distance source costs) and
regenerating-code repair (``regen``: :func:`plan_regens`)."""
from .chain import (ChainRepair, crush_distance, leg_device, order_hops,
                    plan_chains, source_costs)
from .regen import RegenRepair, plan_regens
from .reserver import AsyncReserver, ReserverStats
from .scheduler import (OSD_BACKFILL_PRIORITY_BASE,
                        OSD_RECOVERY_INACTIVE_PRIORITY_BASE,
                        OSD_RECOVERY_PRIORITY_BASE,
                        OSD_RECOVERY_PRIORITY_FORCED,
                        OSD_RECOVERY_PRIORITY_MAX,
                        JobState, PGRecoveryJob, RecoveryScheduler,
                        live_schedulers)

__all__ = ["AsyncReserver", "ChainRepair", "JobState",
           "OSD_BACKFILL_PRIORITY_BASE",
           "OSD_RECOVERY_INACTIVE_PRIORITY_BASE",
           "OSD_RECOVERY_PRIORITY_BASE", "OSD_RECOVERY_PRIORITY_FORCED",
           "OSD_RECOVERY_PRIORITY_MAX", "PGRecoveryJob", "RecoveryScheduler",
           "RegenRepair", "ReserverStats", "crush_distance", "leg_device",
           "live_schedulers", "order_hops", "plan_chains", "plan_regens",
           "source_costs"]
