"""Workload heat maps: rolling per-PG / per-OSD load + tail digest.

The spatial half of the PGMap digest (reference: src/mon/PGMap.cc keeps
per-PG/per-OSD stat deltas; the balancer module and `ceph osd perf`
read them): mgr/stats.py already windows every PG backend's perf
collection, so the per-collection deltas ARE per-PG deltas — this
module projects them onto the placement topology (pg -> primary OSD)
and answers the question ROADMAP item 5's balancer loop needs answered
before and after it engages: *which OSDs are hot, and how bad is the
tail?*

Surfaces:

- :meth:`HeatTracker.pg_heat` — per-PG primary-op and byte rates over
  the stats window;
- :meth:`HeatTracker.osd_heat` — the same rolled onto each PG's primary
  OSD (primary-op heat: the serving cost lands on the primary);
- :meth:`HeatTracker.tail_digest` — max/median/mean OSD load and the
  max/median skew ratio (the tail-utilization number item 5 gates on);
- :func:`hot_shard_check` — the ``HOT_SHARD`` health check: a sustained,
  skewed load concentration fires WARN with the offending OSDs listed;
- ``ceph_tpu_osd_heat{osd=...}`` / ``ceph_tpu_pg_heat{pg=...}``
  prometheus families via :func:`live_heat_trackers`
  (mgr/prometheus.py renders them).

Collections are matched to PGs by the backend naming convention
(``<prefix>.<tag>[e<epoch>].pg<pgid>`` — the epoch suffix appears on
backfilled incarnations); the ``tag`` scopes a tracker to its own
cluster when several share one Context.

A copy of ``ceph_tpu.mgr.heat``.
"""
from __future__ import annotations

import re
import statistics
import weakref

from .stats import PG_PREFIXES

_TRACKERS: "weakref.WeakSet[HeatTracker]" = weakref.WeakSet()

# the windowed counters that make up "load": primary ops and bytes
_OP_KEYS = ("reads", "writes")
_BYTE_KEYS = ("read_bytes", "write_bytes")


def live_heat_trackers() -> list["HeatTracker"]:
    return list(_TRACKERS)


class HeatTracker:
    """Project the stats window's per-collection deltas onto the PG/OSD
    topology.  ``topology`` is a callable returning
    ``{pg: {"primary": osd, "acting": [osds]}}`` (the cluster's live
    placement); ``tag`` scopes collection matching to one cluster."""

    def __init__(self, stats, topology, name: str = "heat",
                 tag: str | None = None):
        self.stats = stats
        self.topology = topology
        self.name = name
        # "<prefix>.<tag>[e<epoch>].pg<pgid>" -> pgid; no tag matches any
        self._pg_re = re.compile(
            (rf"\.{re.escape(tag)}(?:e\d+)?" if tag else r"(?:\.[^.]+?)?")
            + r"\.pg(?P<pg>.+)$")
        _TRACKERS.add(self)

    def _pg_of(self, coll: str) -> str | None:
        if not any(coll.startswith(p) for p in PG_PREFIXES):
            return None
        m = self._pg_re.search(coll)
        return m.group("pg") if m else None

    # -- heat surfaces -----------------------------------------------------

    def pg_heat(self, topo: dict | None = None) -> dict[str, dict]:
        """``{pg: {op_s, bytes_s, primary}}`` over the stats window.
        Every topology PG appears (cold PGs at 0.0), so the heat map's
        SHAPE is the placement, not just the traffic."""
        dt = self.stats.span()
        if topo is None:
            topo = self.topology() or {}
        out = {pg: {"op_s": 0.0, "bytes_s": 0.0,
                    "primary": info.get("primary")}
               for pg, info in topo.items()}
        if dt <= 0:
            return out
        for key, bucket in (list(zip(_OP_KEYS, ["op_s"] * 2))
                            + list(zip(_BYTE_KEYS, ["bytes_s"] * 2))):
            for coll, delta in self.stats.per_collection_delta(
                    key, PG_PREFIXES).items():
                pg = self._pg_of(coll)
                if pg in out:
                    out[pg][bucket] += delta / dt
        for rec in out.values():
            rec["op_s"] = round(rec["op_s"], 3)
            rec["bytes_s"] = round(rec["bytes_s"], 3)
        return out

    def osd_heat(self, topo: dict | None = None,
                 pgs: dict | None = None) -> dict[int, dict]:
        """``{osd: {op_s, bytes_s, primary_pgs}}`` — per-PG heat rolled
        onto each PG's primary.  Every OSD appearing in any acting set
        is present (a spare OSD's 0.0 row IS the imbalance signal)."""
        if topo is None:
            topo = self.topology() or {}
        if pgs is None:
            pgs = self.pg_heat(topo)
        out: dict[int, dict] = {}
        for info in topo.values():
            for osd in info.get("acting", ()):
                out.setdefault(int(osd), {"op_s": 0.0, "bytes_s": 0.0,
                                          "primary_pgs": 0})
        for pg, rec in pgs.items():
            osd = rec.get("primary")
            if osd is None:
                continue
            row = out.setdefault(int(osd), {"op_s": 0.0, "bytes_s": 0.0,
                                            "primary_pgs": 0})
            row["op_s"] = round(row["op_s"] + rec["op_s"], 3)
            row["bytes_s"] = round(row["bytes_s"] + rec["bytes_s"], 3)
            row["primary_pgs"] += 1
        return out

    def tail_digest(self, heat: dict | None = None) -> dict:
        """The tail-utilization digest (ROADMAP item 5's before/after
        instrument): max/median/mean primary-op load across OSDs and the
        max/median skew ratio.  ``ratio`` is 0.0 when nothing moves and
        ``inf``-free: a hot OSD over an otherwise idle cluster reports
        the max against a zero median via ``median == 0``."""
        if heat is None:
            heat = self.osd_heat()
        loads = sorted(r["op_s"] for r in heat.values())
        if not loads:
            return {"osds": 0, "max_op_s": 0.0, "median_op_s": 0.0,
                    "mean_op_s": 0.0, "ratio": 0.0, "hot_osds": []}
        mx = loads[-1]
        med = statistics.median(loads)
        mean = sum(loads) / len(loads)
        ratio = (mx / med) if med > 0 else (0.0 if mx <= 0 else mx)
        hot = sorted((osd for osd, r in heat.items()
                      if med > 0 and r["op_s"] >= med * 2
                      or med <= 0 and r["op_s"] > 0),
                     key=lambda o: -heat[o]["op_s"])
        return {"osds": len(loads), "max_op_s": round(mx, 3),
                "median_op_s": round(med, 3),
                "mean_op_s": round(mean, 3),
                "ratio": round(ratio, 3), "hot_osds": hot[:8]}

    def snapshot(self) -> dict:
        """ONE coherent heat computation — the stats window is walked
        and the topology queried once, and every derived surface (osd
        rollup, tail digest) comes from that same per-PG pass.  The
        multi-surface consumers (time-series tick, flight dump, health
        check, prometheus scrape) read this instead of recomputing
        pg_heat per surface."""
        topo = self.topology() or {}
        pgs = self.pg_heat(topo)
        osds = self.osd_heat(topo, pgs)
        return {"tail": self.tail_digest(osds), "osds": osds,
                "pgs": pgs}

    def flat_series(self) -> dict[str, float]:
        """The time-series-ring source: tail digest + per-OSD op rates
        as flat ``name -> value`` series."""
        snap = self.snapshot()
        d = snap["tail"]
        out = {"tail_max_op_s": d["max_op_s"],
               "tail_median_op_s": d["median_op_s"],
               "tail_ratio": d["ratio"]}
        for osd, rec in sorted(snap["osds"].items()):
            out[f"osd.{osd}.op_s"] = rec["op_s"]
        return out

    def dump(self) -> dict:
        """The flight-recorder source: the full spatial picture."""
        return self.snapshot()

    def close(self) -> None:
        _TRACKERS.discard(self)


def hot_shard_check(tracker: HeatTracker, cct):
    """HOT_SHARD: one OSD's primary-op load is a sustained multiple of
    the median (``mgr_hot_shard_ratio``) while carrying real traffic
    (``mgr_hot_shard_min_ops`` op/s) over a window of at least a second
    — the hot-shard workload ROADMAP item 5's balancer must flatten.
    Sub-second windows and idle clusters never fire (the
    pg_recovery_stalled_check discipline: no paging without evidence)."""
    def check():
        from .health import CheckResult
        if tracker.stats.span() < 1.0:
            return None
        ratio = float(cct.conf.get("mgr_hot_shard_ratio"))
        min_ops = float(cct.conf.get("mgr_hot_shard_min_ops"))
        snap = tracker.snapshot()
        d = snap["tail"]
        if d["max_op_s"] < min_ops:
            return None
        med = d["median_op_s"]
        if med > 0 and d["max_op_s"] / med < ratio:
            return None
        heat = snap["osds"]
        # offenders at the CONFIGURED ratio (tail_digest's hot_osds uses
        # a fixed 2x digest convention — the check must not claim ">= Nx"
        # for OSDs that only cleared 2x)
        hot = sorted((osd for osd, r in heat.items()
                      if (med > 0 and r["op_s"] >= med * ratio)
                      or (med <= 0 and r["op_s"] >= min_ops)),
                     key=lambda o: -heat[o]["op_s"])[:8]
        detail = [f"osd.{osd}: {heat[osd]['op_s']:.0f} op/s over "
                  f"{heat[osd]['primary_pgs']} primary pgs"
                  for osd in hot]
        return CheckResult(
            f"{len(hot)} osd(s) serving >= {ratio:.0f}x the "
            f"median primary-op load (max {d['max_op_s']:.0f} op/s, "
            f"median {med:.0f})",
            detail=detail, count=len(hot))
    return check


def top_objects(cluster, n: int = 20) -> list[dict]:
    """Bounded top-N hot-OBJECT digest folded from the per-PG hit sets
    — object granularity under the PG/OSD heat maps above, and the
    tier agent's promotion-evidence surface (`heat top`).

    Bloom hit sets cannot enumerate their members, so candidates come
    from the cluster's object bookkeeping and each is membership-tested
    against its PG's current + archived sets
    (``object_temperature``).  Only pools with hit sets armed
    contribute; the result is bounded by a heap, never by truncating a
    sort of the whole namespace."""
    import heapq
    from ..osd.hit_set import is_hit_set_oid
    scored = []
    for pid, oids in sorted(cluster.objects.items()):
        engines = {}          # pg ps -> engine (one hit-set probe setup)
        for oid in sorted(oids):
            if is_hit_set_oid(oid):
                continue
            ps = cluster.object_pg(pid, oid)
            eng = engines.get(ps)
            if eng is None:
                eng = engines[ps] = \
                    cluster.pools[pid]["pgs"][ps].engine
            if eng.hit_set_params is None:
                continue
            t = eng.object_temperature(oid)
            if t > 0:
                scored.append((t, f"{pid}/{oid}", pid, oid))
    # nlargest == sorted(..., reverse=True)[:n] and is STABLE: equal
    # temperatures keep the pool/oid iteration order (alphabetical)
    top = heapq.nlargest(int(n), scored, key=lambda rec: rec[0])
    return [{"pool": pid, "oid": oid, "temperature": t}
            for t, _, pid, oid in top]
