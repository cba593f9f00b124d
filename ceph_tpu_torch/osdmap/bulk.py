"""Bulk PG->OSD mapping: whole-pool placement as one kernel launch.

The card's analog of the reference's thread-pool full-cluster mapper
(reference: src/osd/OSDMapMapping.{h,cc} — ``ParallelPGMapper`` splits the
PG range over worker threads, ``OSDMapMapping::update()`` iterates every PG
of every pool, OSDMapMapping.cc:45-53).  Here the whole pool maps in one
``BulkMapper.map_rule`` call (one launch of the straw2 kernel over the
placement seeds, or its plain version with ``device="cpu"``) and the
post-CRUSH chain (exists/up filtering, primary affinity) runs vectorized in
numpy; the sparse per-PG overrides (pg_upmap, pg_upmap_items, pg_temp,
primary_temp) are re-resolved through the scalar oracle, exactly because
they are dict-sized, not PG-count-sized.

Output rows are fixed-width ``[pg_num, size]`` int64 with CRUSH_ITEM_NONE
padding (replicated pools shift-left over holes like the reference, then
pad; EC pools keep positional holes).
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from ..crush.hash import crush_hash32_2_np
from ..crush.torch_mapper import BulkMapper
from ..crush.map import CRUSH_ITEM_NONE
from .osdmap import OSDMap
from .types import (DEFAULT_PRIMARY_AFFINITY, FLAG_HASHPSPOOL,
                    MAX_PRIMARY_AFFINITY, PG, Pool)

NONE = CRUSH_ITEM_NONE


def stable_mod_np(x: np.ndarray, b: int, bmask: int) -> np.ndarray:
    lo = x & bmask
    return np.where(lo < b, lo, x & (bmask >> 1))


@dataclass
class PoolMapping:
    pool_id: int
    up: np.ndarray              # [pg_num, width] int64, NONE-padded
    up_primary: np.ndarray      # [pg_num] int64
    acting: np.ndarray
    acting_primary: np.ndarray
    pps: np.ndarray             # [pg_num] uint32 placement seeds


class BulkPGMapper:
    """Maps every PG of a pool (or the whole cluster) in bulk on
    ``device``: ``"cuda"`` (the default) or ``"cpu"`` (the plain version).

    ``times`` sums the seconds of every ``map_pool`` call by stage: ``pps``
    (placement seeds on the host), ``map`` (the bulk map, copies to and
    from the device included) and ``post`` (the filters, primary affinity
    and the sparse overrides)."""

    def __init__(self, osdmap: OSDMap, device: str = "cuda"):
        self.m = osdmap
        self.bulk = BulkMapper(osdmap.crush, device=device)
        self.times = {"pps": 0.0, "map": 0.0, "post": 0.0}
        # device-independent state vectors
        n = osdmap.max_osd
        self._exists = np.zeros(n, dtype=bool)
        self._up = np.zeros(n, dtype=bool)
        for o in range(n):
            self._exists[o] = osdmap.exists(o)
            self._up[o] = osdmap.is_up(o)
        aff = osdmap.osd_primary_affinity
        self._aff = (None if aff is None
                     else np.asarray(aff, dtype=np.int64))

    # -- pps ---------------------------------------------------------------

    def pool_pps(self, pool: Pool) -> np.ndarray:
        ps = np.arange(pool.pg_num, dtype=np.uint32)
        folded = stable_mod_np(ps, pool.pgp_num, pool.pgp_num_mask)
        if pool.flags & FLAG_HASHPSPOOL:
            return crush_hash32_2_np(
                folded, np.uint32(pool.pool_id & 0xFFFFFFFF))
        return (folded + np.uint32(pool.pool_id)).astype(np.uint32)

    # -- vector post-chain --------------------------------------------------

    def _shift_left(self, arr: np.ndarray, valid: np.ndarray) -> np.ndarray:
        """Stable-compact valid entries to the front, NONE-pad the tail."""
        order = np.argsort(~valid, axis=1, kind="stable")
        out = np.take_along_axis(arr, order, axis=1)
        ok = np.take_along_axis(valid, order, axis=1)
        return np.where(ok, out, NONE)

    def _pick_primary(self, arr: np.ndarray) -> np.ndarray:
        valid = arr != NONE
        anyv = valid.any(axis=1)
        pos = valid.argmax(axis=1)
        prim = arr[np.arange(arr.shape[0]), pos]
        return np.where(anyv, prim, -1)

    def _apply_primary_affinity(self, pps: np.ndarray, pool: Pool,
                                up: np.ndarray, primary: np.ndarray):
        """Vectorized OSDMap::_apply_primary_affinity (OSDMap.cc:2461-2514):
        reject osd as primary when (hash(seed, osd) >> 16) >= affinity;
        fall back to the first valid entry when all reject."""
        if self._aff is None:
            return up, primary
        valid = up != NONE
        osd = np.clip(up, 0, self.m.max_osd - 1).astype(np.int64)
        a = np.where(valid, self._aff[osd], DEFAULT_PRIMARY_AFFINITY)
        nondefault = (valid & (a != DEFAULT_PRIMARY_AFFINITY)).any(axis=1)
        h = crush_hash32_2_np(pps[:, None].astype(np.uint32),
                              up.astype(np.uint32))
        reject = valid & (a < MAX_PRIMARY_AFFINITY) & ((h >> 16) >= a)
        accept = valid & ~reject
        n, width = up.shape
        rows = np.arange(n)
        pos_acc = np.where(accept.any(axis=1), accept.argmax(axis=1), -1)
        pos_val = np.where(valid.any(axis=1), valid.argmax(axis=1), -1)
        pos = np.where(pos_acc >= 0, pos_acc, pos_val)
        new_prim = np.where(pos >= 0, up[rows, np.maximum(pos, 0)], primary)
        new_prim = np.where(nondefault, new_prim, primary)
        if pool.can_shift_osds():
            # rotate the accepted primary to the front of rows that changed
            p = np.where(nondefault & (pos > 0), pos, 0)[:, None]
            idx = np.arange(width)[None, :]
            src = np.where(idx == 0, p, np.where(idx <= p, idx - 1, idx))
            up = np.take_along_axis(up, src, axis=1)
        return up, new_prim

    # -- public -------------------------------------------------------------

    def map_pool(self, pool_id: int) -> PoolMapping:
        m = self.m
        pool = m.pools[pool_id]
        size = pool.size
        t0 = time.perf_counter()
        pps = self.pool_pps(pool)
        t1 = time.perf_counter()
        ruleno = m.find_rule(pool.crush_rule, pool.type, size)

        # per-pool choose_args, falling back to the compat set (-1) the
        # way _pg_to_raw_osds does (OSDMap.cc choose_args_index)
        ca = m.crush.choose_args.get(pool_id, m.crush.choose_args.get(-1))
        use_scalar = ruleno < 0
        if not use_scalar:
            try:
                out, placed = self.bulk.map_rule(
                    ruleno, pps, reweights=m.osd_weight, result_max=size,
                    choose_args=ca)
            except ValueError:
                use_scalar = True
        if use_scalar:
            out = np.full((pool.pg_num, size), NONE, dtype=np.int64)
            for i in range(pool.pg_num):
                row, _ = m._pg_to_raw_osds(pool, PG(pool_id, i))
                out[i, :len(row)] = row
            placed = None
        raw = np.asarray(out, dtype=np.int64)
        t2 = time.perf_counter()
        if raw.shape[1] < size:
            pad = np.full((raw.shape[0], size - raw.shape[1]), NONE,
                          dtype=np.int64)
            raw = np.concatenate([raw, pad], axis=1)
        if placed is not None:
            # firstn rows are only valid up to their placed count
            width = raw.shape[1]
            tail = np.arange(width)[None, :] >= np.asarray(placed)[:, None]
            if not pool.can_shift_osds():
                tail = np.zeros_like(tail)          # indep keeps holes
            raw = np.where(tail, NONE, raw)

        # _remove_nonexistent_osds
        inb = (raw >= 0) & (raw < m.max_osd)
        exists = inb & self._exists[np.clip(raw, 0, m.max_osd - 1)]
        if pool.can_shift_osds():
            raw = self._shift_left(raw, exists)
        else:
            raw = np.where((raw != NONE) & ~exists, NONE, raw)

        # _raw_to_up_osds (down -> hole)
        inb = (raw >= 0) & (raw < m.max_osd)
        upok = inb & self._up[np.clip(raw, 0, m.max_osd - 1)]
        if pool.can_shift_osds():
            up = self._shift_left(raw, upok)
        else:
            up = np.where((raw != NONE) & ~upok, NONE, raw)

        up_primary = self._pick_primary(up)
        up, up_primary = self._apply_primary_affinity(
            pps, pool, up, up_primary)

        acting = up.copy()
        acting_primary = up_primary.copy()

        # sparse overrides through the scalar oracle
        override = set()
        for d in (m.pg_upmap, m.pg_upmap_items, m.pg_temp, m.primary_temp):
            for pg in d:
                if pg.pool == pool_id and pg.ps < pool.pg_num:
                    override.add(pg.ps)
        for ps in override:
            u, upr, act, actpr = m.pg_to_up_acting_osds(PG(pool_id, ps))
            row = np.full(size, NONE, dtype=np.int64)
            row[:len(u)] = u
            up[ps] = row
            up_primary[ps] = upr
            row = np.full(size, NONE, dtype=np.int64)
            row[:len(act)] = act
            acting[ps] = row
            acting_primary[ps] = actpr

        t3 = time.perf_counter()
        self.times["pps"] += t1 - t0
        self.times["map"] += t2 - t1
        self.times["post"] += t3 - t2
        return PoolMapping(pool_id=pool_id, up=up, up_primary=up_primary,
                           acting=acting, acting_primary=acting_primary,
                           pps=pps)

    def map_cluster(self) -> dict[int, PoolMapping]:
        return {pid: self.map_pool(pid) for pid in sorted(self.m.pools)}
