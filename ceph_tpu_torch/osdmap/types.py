"""OSDMap value types: pg_t, pool model, stable-mod placement seeds.

Python analogs of the reference types driving the PG->OSD mapping chain
(reference: src/osd/osd_types.{h,cc}, src/include/rados.h):

- ``ceph_stable_mod`` (src/include/rados.h:86-92): the split-aware modulus
  that keeps PG placement stable while pg_num grows between powers of two.
- ``pg_pool_t`` (src/osd/osd_types.h): pool type (replicated/erasure), size,
  pg_num/pgp_num and their masks (calc_pg_masks), crush rule, flags; the
  placement seed ``raw_pg_to_pps`` (src/osd/osd_types.cc:1640-1656) hashes
  the stable-mod'd ps with the pool id (FLAG_HASHPSPOOL) so pools don't
  overlap.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..crush.hash import crush_hash32_2

# pool types (src/osd/osd_types.h pg_pool_t::TYPE_*)
POOL_TYPE_REPLICATED = 1
POOL_TYPE_ERASURE = 3

# pg_pool_t flags (subset)
FLAG_HASHPSPOOL = 1 << 0

# osd state flags (src/include/rados.h CEPH_OSD_*)
OSD_EXISTS = 1
OSD_UP = 2
OSD_AUTOOUT = 4
OSD_NEW = 8

OSD_IN_WEIGHT = 0x10000          # CEPH_OSD_IN
MAX_PRIMARY_AFFINITY = 0x10000   # CEPH_OSD_MAX_PRIMARY_AFFINITY
DEFAULT_PRIMARY_AFFINITY = 0x10000


def ceph_stable_mod(x: int, b: int, bmask: int) -> int:
    """Stable modulus (src/include/rados.h:86-92): bins in [0,b) where b need
    not be a power of two; entries above b fold into the lower half-range so
    growing b splits one bin at a time."""
    if (x & bmask) < b:
        return x & bmask
    return x & (bmask >> 1)


def pg_mask(num: int) -> int:
    """calc_pg_masks: containing power-of-two minus 1 (b=12 -> 15)."""
    if num <= 1:
        return 0
    return (1 << (num - 1).bit_length()) - 1


@dataclass(frozen=True)
class PG:
    """pg_t: (pool id, placement seed)."""
    pool: int
    ps: int

    def __str__(self) -> str:
        return f"{self.pool}.{self.ps:x}"


@dataclass
class Pool:
    """pg_pool_t (mapping-relevant subset)."""
    pool_id: int
    type: int = POOL_TYPE_REPLICATED
    size: int = 3
    min_size: int = 2
    pg_num: int = 32
    pgp_num: int = 0                # 0 => same as pg_num
    crush_rule: int = 0
    flags: int = FLAG_HASHPSPOOL
    erasure_code_profile: str = ""
    name: str = ""
    params: dict = field(default_factory=dict)
    # pool snapshots (pg_pool_t::snap_seq / snaps / removed_snaps,
    # src/osd/osd_types.h): snap_seq is the newest issued snap id,
    # snaps maps live snap ids -> names, removed_snaps awaits snaptrim
    snap_seq: int = 0
    snaps: dict = field(default_factory=dict)          # snapid -> name
    removed_snaps: set = field(default_factory=set)

    def __post_init__(self):
        if not self.pgp_num:
            self.pgp_num = self.pg_num

    @property
    def pg_num_mask(self) -> int:
        return pg_mask(self.pg_num)

    @property
    def pgp_num_mask(self) -> int:
        return pg_mask(self.pgp_num)

    def can_shift_osds(self) -> bool:
        """Replicated pools shift over holes; EC pools are positional
        (src/osd/osd_types.h can_shift_osds; ecbackend.rst:100-105)."""
        return self.type == POOL_TYPE_REPLICATED

    def raw_pg_to_pg(self, pg: PG) -> PG:
        """Fold a full-precision ps into [0, pg_num)."""
        return PG(pg.pool, ceph_stable_mod(pg.ps, self.pg_num,
                                           self.pg_num_mask))

    def raw_pg_to_pps(self, pg: PG) -> int:
        """Placement seed (src/osd/osd_types.cc:1640-1656)."""
        if self.flags & FLAG_HASHPSPOOL:
            return crush_hash32_2(
                ceph_stable_mod(pg.ps, self.pgp_num, self.pgp_num_mask),
                pg.pool & 0xFFFFFFFF)
        return ceph_stable_mod(pg.ps, self.pgp_num,
                               self.pgp_num_mask) + pg.pool
