"""OSDMap layer: cluster map model + PG->OSD mapping chain.

Scalar oracle chain (osdmap.py, mirrors src/osd/OSDMap.cc:2359-2653) and
the bulk mapper (bulk.py, the OSDMapMapping analog) over the straw2
kernel."""
from .types import (PG, Pool, POOL_TYPE_ERASURE, POOL_TYPE_REPLICATED,
                    FLAG_HASHPSPOOL, OSD_EXISTS, OSD_UP, OSD_IN_WEIGHT,
                    MAX_PRIMARY_AFFINITY, DEFAULT_PRIMARY_AFFINITY,
                    ceph_stable_mod, pg_mask)
from .osdmap import OSDMap, Incremental, apply_incremental
from .bulk import BulkPGMapper, PoolMapping

__all__ = [
    "PG", "Pool", "POOL_TYPE_ERASURE", "POOL_TYPE_REPLICATED",
    "FLAG_HASHPSPOOL", "OSD_EXISTS", "OSD_UP", "OSD_IN_WEIGHT",
    "MAX_PRIMARY_AFFINITY", "DEFAULT_PRIMARY_AFFINITY",
    "ceph_stable_mod", "pg_mask",
    "OSDMap", "Incremental", "apply_incremental",
    "BulkPGMapper", "PoolMapping",
]
