"""OSDMap: cluster map + the PG->OSD mapping chain (scalar oracle).

Mirrors the reference mapping chain exactly (reference: src/osd/OSDMap.cc):
``_pg_to_raw_osds`` (:2359-2377) -> ``_apply_upmap`` (:2389-2433) ->
``_raw_to_up_osds`` (:2436-2459, EC pools keep positional holes) ->
``_apply_primary_affinity`` (:2461-2514) -> pg_temp/primary_temp
(:2516-2546), composed in ``_pg_to_up_acting_osds`` (:2591).  Epochs advance
via ``Incremental`` deltas like the reference's OSDMap::Incremental.

This scalar implementation is the oracle for the vectorized bulk mapper in
``bulk.py`` (the OSDMapMapping analog).
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field

from ..crush.hash import crush_hash32_2
from ..crush.map import CRUSH_ITEM_NONE, CrushMap
from ..crush.mapper import crush_do_rule
from .types import (DEFAULT_PRIMARY_AFFINITY, MAX_PRIMARY_AFFINITY,
                    OSD_EXISTS, OSD_IN_WEIGHT, OSD_UP, PG, Pool)


class OSDMap:
    def __init__(self, max_osd: int = 0, crush: CrushMap | None = None):
        self.epoch = 1
        self.max_osd = 0
        self.osd_state: list[int] = []
        self.osd_weight: list[int] = []          # 16.16 reweight (IN=0x10000)
        self.osd_primary_affinity: list[int] | None = None
        self.crush = crush if crush is not None else CrushMap()
        self.pools: dict[int, Pool] = {}
        self.pool_name: dict[int, str] = {}
        self.pg_upmap: dict[PG, list[int]] = {}
        self.pg_upmap_items: dict[PG, list[tuple[int, int]]] = {}
        self.pg_temp: dict[PG, list[int]] = {}
        self.primary_temp: dict[PG, int] = {}
        if max_osd:
            self.set_max_osd(max_osd)

    # -- osd state ----------------------------------------------------------

    def set_max_osd(self, n: int) -> None:
        while self.max_osd < n:
            self.osd_state.append(0)
            self.osd_weight.append(0)
            if self.osd_primary_affinity is not None:
                self.osd_primary_affinity.append(DEFAULT_PRIMARY_AFFINITY)
            self.max_osd += 1
        del self.osd_state[n:]
        del self.osd_weight[n:]
        if self.osd_primary_affinity is not None:
            del self.osd_primary_affinity[n:]
        self.max_osd = n

    def exists(self, o: int) -> bool:
        return 0 <= o < self.max_osd and bool(self.osd_state[o] & OSD_EXISTS)

    def is_up(self, o: int) -> bool:
        return self.exists(o) and bool(self.osd_state[o] & OSD_UP)

    def is_down(self, o: int) -> bool:
        return not self.is_up(o)

    def is_in(self, o: int) -> bool:
        return self.exists(o) and self.osd_weight[o] > 0

    def is_out(self, o: int) -> bool:
        return not self.is_in(o)

    def create_osd(self, o: int, up: bool = True,
                   weight: int = OSD_IN_WEIGHT) -> None:
        if o >= self.max_osd:
            self.set_max_osd(o + 1)
        self.osd_state[o] = OSD_EXISTS | (OSD_UP if up else 0)
        self.osd_weight[o] = weight

    def set_primary_affinity(self, o: int, aff: int) -> None:
        if self.osd_primary_affinity is None:
            self.osd_primary_affinity = (
                [DEFAULT_PRIMARY_AFFINITY] * self.max_osd)
        self.osd_primary_affinity[o] = aff

    def add_pool(self, pool: Pool, name: str = "") -> None:
        self.pools[pool.pool_id] = pool
        if name:
            pool.name = name
        self.pool_name[pool.pool_id] = pool.name

    def find_rule(self, crush_rule: int, type: int, size: int) -> int:
        """CrushWrapper::find_rule — modern maps have rule id == ruleset, so
        existence is the check."""
        return crush_rule if crush_rule in self.crush.rules else -1

    # -- mapping chain (scalar; OSDMap.cc:2359-2653) ------------------------

    def _pg_to_raw_osds(self, pool: Pool, pg: PG) -> tuple[list[int], int]:
        pps = pool.raw_pg_to_pps(pg)
        size = pool.size
        ruleno = self.find_rule(pool.crush_rule, pool.type, size)
        osds: list[int] = []
        if ruleno >= 0:
            ca = self.crush.choose_args.get(
                pg.pool, self.crush.choose_args.get(-1))
            osds = crush_do_rule(self.crush, ruleno, pps, size,
                                 self.osd_weight, ca)
        self._remove_nonexistent_osds(pool, osds)
        return osds, pps

    def _remove_nonexistent_osds(self, pool: Pool, osds: list[int]) -> None:
        if pool.can_shift_osds():
            # NONE fails exists() too and is dropped (OSDMap.cc:2330-2350)
            osds[:] = [o for o in osds if self.exists(o)]
        else:
            for i, o in enumerate(osds):
                if o != CRUSH_ITEM_NONE and not self.exists(o):
                    osds[i] = CRUSH_ITEM_NONE

    @staticmethod
    def _pick_primary(osds: list[int]) -> int:
        for o in osds:
            if o != CRUSH_ITEM_NONE:
                return o
        return -1

    def _apply_upmap(self, pool: Pool, raw_pg: PG, raw: list[int]) -> None:
        pg = pool.raw_pg_to_pg(raw_pg)
        p = self.pg_upmap.get(pg)
        if p is not None:
            for o in p:
                if (o != CRUSH_ITEM_NONE and 0 <= o < self.max_osd and
                        self.osd_weight[o] == 0):
                    # rejected: the reference returns here, skipping
                    # pg_upmap_items as well (OSDMap.cc:2396-2400)
                    return
            raw[:] = list(p)
        q = self.pg_upmap_items.get(pg)
        if q is not None:
            for frm, to in q:
                exists_ = False
                pos = -1
                for i, o in enumerate(raw):
                    if o == to:
                        exists_ = True
                        break
                    if (o == frm and pos < 0 and
                            not (to != CRUSH_ITEM_NONE and
                                 0 <= to < self.max_osd and
                                 self.osd_weight[to] == 0)):
                        pos = i
                if not exists_ and pos >= 0:
                    raw[pos] = to

    def _raw_to_up_osds(self, pool: Pool, raw: list[int]) -> list[int]:
        if pool.can_shift_osds():
            return [o for o in raw if self.exists(o) and not self.is_down(o)]
        return [CRUSH_ITEM_NONE if (not self.exists(o) or self.is_down(o))
                else o for o in raw]

    def _apply_primary_affinity(self, seed: int, pool: Pool,
                                osds: list[int], primary: int) -> int:
        aff = self.osd_primary_affinity
        if aff is None:
            return primary
        if not any(o != CRUSH_ITEM_NONE and
                   aff[o] != DEFAULT_PRIMARY_AFFINITY for o in osds):
            return primary
        pos = -1
        for i, o in enumerate(osds):
            if o == CRUSH_ITEM_NONE:
                continue
            a = aff[o]
            if (a < MAX_PRIMARY_AFFINITY and
                    (crush_hash32_2(seed & 0xFFFFFFFF, o) >> 16) >= a):
                if pos < 0:
                    pos = i
            else:
                pos = i
                break
        if pos < 0:
            return primary
        primary = osds[pos]
        if pool.can_shift_osds() and pos > 0:
            for i in range(pos, 0, -1):
                osds[i] = osds[i - 1]
            osds[0] = primary
        return primary

    def _get_temp_osds(self, pool: Pool, pg: PG) -> tuple[list[int], int]:
        pg = pool.raw_pg_to_pg(pg)
        temp: list[int] = []
        p = self.pg_temp.get(pg)
        if p is not None:
            for o in p:
                if not self.exists(o) or self.is_down(o):
                    if not pool.can_shift_osds():
                        temp.append(CRUSH_ITEM_NONE)
                else:
                    temp.append(o)
        temp_primary = self.primary_temp.get(pg, -1)
        if temp_primary == -1:
            for o in temp:
                if o != CRUSH_ITEM_NONE:
                    temp_primary = o
                    break
        return temp, temp_primary

    def pg_to_raw_osds(self, pg: PG) -> tuple[list[int], int]:
        pool = self.pools.get(pg.pool)
        if pool is None:
            return [], -1
        raw, _ = self._pg_to_raw_osds(pool, pg)
        return raw, self._pick_primary(raw)

    def pg_to_raw_up(self, pg: PG) -> tuple[list[int], int]:
        pool = self.pools.get(pg.pool)
        if pool is None:
            return [], -1
        raw, pps = self._pg_to_raw_osds(pool, pg)
        self._apply_upmap(pool, pg, raw)
        up = self._raw_to_up_osds(pool, raw)
        primary = self._pick_primary(raw)
        primary = self._apply_primary_affinity(pps, pool, up, primary)
        return up, primary

    def pg_to_up_acting_osds(self, pg: PG):
        """Returns (up, up_primary, acting, acting_primary)
        (OSDMap.cc:2591-2653)."""
        pool = self.pools.get(pg.pool)
        if pool is None or pg.ps >= pool.pg_num:
            return [], -1, [], -1
        acting, acting_primary = self._get_temp_osds(pool, pg)
        raw, pps = self._pg_to_raw_osds(pool, pg)
        self._apply_upmap(pool, pg, raw)
        up = self._raw_to_up_osds(pool, raw)
        up_primary = self._pick_primary(up)
        up_primary = self._apply_primary_affinity(pps, pool, up, up_primary)
        if not acting:
            acting = list(up)
            if acting_primary == -1:
                acting_primary = up_primary
        return up, up_primary, acting, acting_primary

    def clone(self) -> "OSDMap":
        return copy.deepcopy(self)

    # -- (de)serialisation (the reference encodes maps as binary blobs;
    #    this framework uses JSON-able dicts, cf. osdmaptool --dump json) --

    def to_dict(self) -> dict:
        def pgs(d):
            return {f"{pg.pool}.{pg.ps}": v for pg, v in d.items()}
        return {
            "epoch": self.epoch,
            "max_osd": self.max_osd,
            "osd_state": list(self.osd_state),
            "osd_weight": list(self.osd_weight),
            "osd_primary_affinity": (
                None if self.osd_primary_affinity is None
                else list(self.osd_primary_affinity)),
            "crush": self.crush.to_dict(),
            "pools": {str(pid): {
                "pool_id": p.pool_id, "type": p.type, "size": p.size,
                "min_size": p.min_size, "pg_num": p.pg_num,
                "pgp_num": p.pgp_num, "crush_rule": p.crush_rule,
                "flags": p.flags, "name": p.name,
                "erasure_code_profile": p.erasure_code_profile,
            } for pid, p in self.pools.items()},
            "pg_upmap": pgs(self.pg_upmap),
            "pg_upmap_items": pgs(self.pg_upmap_items),
            "pg_temp": pgs(self.pg_temp),
            "primary_temp": pgs(self.primary_temp),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "OSDMap":
        def unpgs(m, conv=lambda v: v):
            out = {}
            for key, v in m.items():
                pool_s, ps_s = key.split(".")
                out[PG(int(pool_s), int(ps_s))] = conv(v)
            return out
        m = cls(crush=CrushMap.from_dict(d["crush"]))
        m.epoch = d.get("epoch", 1)
        m.set_max_osd(d["max_osd"])
        m.osd_state = list(d["osd_state"])
        m.osd_weight = list(d["osd_weight"])
        pa = d.get("osd_primary_affinity")
        m.osd_primary_affinity = None if pa is None else list(pa)
        for pid_s, pd in d.get("pools", {}).items():
            m.add_pool(Pool(**pd))
        m.pg_upmap = unpgs(d.get("pg_upmap", {}), list)
        m.pg_upmap_items = unpgs(
            d.get("pg_upmap_items", {}),
            lambda v: [tuple(x) for x in v])
        m.pg_temp = unpgs(d.get("pg_temp", {}), list)
        m.primary_temp = unpgs(d.get("primary_temp", {}), int)
        return m


@dataclass
class Incremental:
    """OSDMap delta (reference: OSDMap::Incremental, src/osd/OSDMap.h).
    ``new_state`` entries XOR into osd_state (the reference's convention for
    up/down and exists flips)."""
    epoch: int = 0
    new_max_osd: int = -1
    new_pools: dict[int, Pool] = field(default_factory=dict)
    old_pools: list[int] = field(default_factory=list)
    new_state: dict[int, int] = field(default_factory=dict)     # XOR flags
    new_weight: dict[int, int] = field(default_factory=dict)
    new_primary_affinity: dict[int, int] = field(default_factory=dict)
    new_pg_temp: dict[PG, list[int]] = field(default_factory=dict)
    new_primary_temp: dict[PG, int] = field(default_factory=dict)
    new_pg_upmap: dict[PG, list[int]] = field(default_factory=dict)
    old_pg_upmap: list[PG] = field(default_factory=list)
    new_pg_upmap_items: dict[PG, list[tuple[int, int]]] = (
        field(default_factory=dict))
    old_pg_upmap_items: list[PG] = field(default_factory=list)
    new_crush: CrushMap | None = None


def apply_incremental(m: OSDMap, inc: Incremental) -> OSDMap:
    """Apply a delta, producing the next epoch (OSDMap::apply_incremental)."""
    n = m.clone()
    if inc.epoch and inc.epoch != m.epoch + 1:
        raise ValueError(f"incremental epoch {inc.epoch} != {m.epoch + 1}")
    n.epoch = m.epoch + 1
    if inc.new_crush is not None:
        n.crush = inc.new_crush
    if inc.new_max_osd >= 0:
        n.set_max_osd(inc.new_max_osd)
    for pid, pool in inc.new_pools.items():
        n.pools[pid] = pool
        n.pool_name[pid] = pool.name
    for pid in inc.old_pools:
        n.pools.pop(pid, None)
        n.pool_name.pop(pid, None)
    for o, st in inc.new_state.items():
        n.osd_state[o] ^= st
    for o, w in inc.new_weight.items():
        n.osd_weight[o] = w
    for o, a in inc.new_primary_affinity.items():
        n.set_primary_affinity(o, a)
    for pg, osds in inc.new_pg_temp.items():
        if osds:
            n.pg_temp[pg] = list(osds)
        else:
            n.pg_temp.pop(pg, None)
    for pg, o in inc.new_primary_temp.items():
        if o >= 0:
            n.primary_temp[pg] = o
        else:
            n.primary_temp.pop(pg, None)
    for pg, osds in inc.new_pg_upmap.items():
        n.pg_upmap[pg] = list(osds)
    for pg in inc.old_pg_upmap:
        n.pg_upmap.pop(pg, None)
    for pg, items in inc.new_pg_upmap_items.items():
        n.pg_upmap_items[pg] = list(items)
    for pg in inc.old_pg_upmap_items:
        n.pg_upmap_items.pop(pg, None)
    return n
