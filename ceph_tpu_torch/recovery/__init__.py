"""Repair planning copied from ``ceph_tpu.recovery``: chained
partial-sum repair (``chain``: :func:`plan_chains`, the CRUSH-distance
source costs) and regenerating-code repair (``regen``:
:func:`plan_regens`).  The JAX package's recovery scheduler and
reservers are still to port."""
from .chain import (ChainRepair, crush_distance, leg_device, order_hops,
                    plan_chains, source_costs)
from .regen import RegenRepair, plan_regens

__all__ = ["ChainRepair", "RegenRepair", "crush_distance", "leg_device",
           "order_hops", "plan_chains", "plan_regens", "source_costs"]
