"""pg_autoscaler: recommend pg_num per pool.

Mirror of the reference's autoscaler math (reference:
src/pybind/mgr/pg_autoscaler/module.py:270-330): the root's PG allowance is
``osd_count * mon_target_pg_per_osd``; each pool gets the share of that
allowance matching its capacity ratio (actual usage vs target_size take the
max), scaled by ``raw_used_rate`` (replica count / EC (k+m)/k overhead) and
``pg_autoscale_bias``, quantized to the nearest power of two, floored at
``pg_num_min``; an adjustment is recommended only when the target is off by
more than the 3x threshold.

The port's copy of ``ceph_tpu.mgr.pg_autoscaler``, over the port's
``osdmap``.
"""
from __future__ import annotations

from ..osdmap import OSDMap, POOL_TYPE_ERASURE

PG_NUM_MIN = 4
THRESHOLD = 3.0
MON_TARGET_PG_PER_OSD = 100


def nearest_power_of_two(n: float) -> int:
    if n <= 1:
        return 1
    v = int(n)
    next_p = 1 << v.bit_length()
    prev_p = next_p >> 1
    return prev_p if (n - prev_p) < (next_p - n) else next_p


def raw_used_rate(m: OSDMap, pool_id: int, k: int | None = None) -> float:
    """Storage amplification: size for replicated, (k+m)/k for EC
    (OSDMap::pool_raw_used_rate)."""
    pool = m.pools[pool_id]
    if pool.type == POOL_TYPE_ERASURE:
        if k is None and pool.params:
            kv = pool.params.get("k")
            k = int(kv) if kv is not None else None
        if k is None:
            # pools rebuilt from a serialized map only carry the profile
            # string ("k=4 m=2 ..."); parse k from there
            for kv in (pool.erasure_code_profile or "").split():
                key, _, val = kv.partition("=")
                if key == "k" and val.isdigit():
                    k = int(val)
                    break
        if k:
            return pool.size / float(k)
        return float(pool.size)
    return float(pool.size)


def autoscale_recommendations(
        m: OSDMap, pool_bytes_used: dict[int, int],
        capacity_bytes: int,
        target_pg_per_osd: int = MON_TARGET_PG_PER_OSD,
        options: dict[int, dict] | None = None) -> list[dict]:
    """Per-pool recommendation dicts (module.py:310-330 shape)."""
    options = options or {}
    n_osds = sum(1 for o in range(m.max_osd) if m.is_in(o))
    root_pg_target = n_osds * target_pg_per_osd
    out = []
    for pid in sorted(m.pools):
        pool = m.pools[pid]
        opt = options.get(pid, {})
        bias = opt.get("pg_autoscale_bias", 1.0)
        target_bytes = opt.get("target_size_bytes", 0)
        k = opt.get("k")
        rate = raw_used_rate(m, pid, k)
        used = pool_bytes_used.get(pid, 0)
        actual_ratio = (used * rate) / capacity_bytes if capacity_bytes else 0
        capacity_ratio = (max(used, target_bytes) * rate / capacity_bytes
                          if capacity_bytes else 0.0)
        target_ratio = opt.get("target_size_ratio", 0.0)
        final_ratio = max(capacity_ratio, target_ratio)
        pool_pg_target = (final_ratio * root_pg_target) / rate * bias
        final_pg = max(opt.get("pg_num_min", PG_NUM_MIN),
                       nearest_power_of_two(pool_pg_target))
        would_adjust = (0.0 <= final_ratio <= 1.0 and
                        (final_pg > pool.pg_num * THRESHOLD or
                         final_pg <= pool.pg_num / THRESHOLD))
        out.append({
            "pool_id": pid, "pool_name": pool.name,
            "pg_num_target": pool.pg_num,
            "raw_used_rate": rate,
            "actual_capacity_ratio": actual_ratio,
            "capacity_ratio": capacity_ratio,
            "final_ratio": final_ratio,
            "pg_num_ideal": int(pool_pg_target),
            "pg_num_final": final_pg,
            "would_adjust": would_adjust,
            "bias": bias,
        })
    return out
