"""Health check engine: named, registered checks with severities + mute.

Mirror of the reference's health-check registry (reference:
src/mon/health_check.h — ``health_check_map_t`` keyed by check name, each
carrying a severity, a summary and detail lines; src/mon/Monitor.cc
``handle_command`` 'health mute <code>').  Rather than a few checks
hard-coded inside ``Cluster.health()``, this engine makes the check set
EXTENSIBLE so
any subsystem (optracker slow ops, exec throttles, the launch
ledger's jit registry, scrub) can register a named check without the
cluster layer knowing about it, and so operators can mute a known-noisy key without
losing the rest of the surface.

A check is a callable returning:

- ``None``/falsy — healthy;
- a ``str`` — raised at the registered default severity with that summary;
- a :class:`CheckResult` — summary + detail lines + optional severity
  override (e.g. PG_AVAILABILITY escalating WARN->ERR past ``m`` lost
  shards).

``evaluate()`` runs every check, computes the aggregate status over the
UNMUTED raised checks, and fires ``on_transition(key, info, evaluation)``
for every check that newly raised or escalated — the anomaly
flight-recorder hook (``common/flight_recorder.py``): state is captured
at the moment something goes wrong, not when an operator gets around to
asking.

A copy of ``ceph_tpu.mgr.health``; ``HBM_PRESSURE`` reads the port's
``common/device_telemetry`` (``torch.cuda``).
"""
from __future__ import annotations

import threading
import weakref
from dataclasses import dataclass, field

HEALTH_OK = "HEALTH_OK"
HEALTH_WARN = "HEALTH_WARN"
HEALTH_ERR = "HEALTH_ERR"

SEVERITY_RANK = {HEALTH_OK: 0, HEALTH_WARN: 1, HEALTH_ERR: 2}

# live engines, for the prometheus health-status gauge export (the same
# weakref pattern as osd_daemon.live_daemons / engine.live_engines)
_ENGINES: "weakref.WeakSet[HealthCheckEngine]" = weakref.WeakSet()


def live_health_engines() -> list["HealthCheckEngine"]:
    return list(_ENGINES)


@dataclass
class CheckResult:
    """What a raised check reports (health_check_t analog)."""
    summary: str
    detail: list[str] = field(default_factory=list)
    severity: str | None = None          # None -> the registered default
    count: int = 0                       # affected entities (mon's count)


class HealthCheckEngine:
    """Registry of named health checks; ``Cluster.health()`` is a thin
    view over ``evaluate()``."""

    def __init__(self, name: str = "health", cct=None, on_transition=None,
                 on_clear=None):
        self.name = name
        self.cct = cct
        # key -> (fn, default severity, description of the trigger)
        self._checks: dict[str, tuple] = {}
        self._muted: set[str] = set()
        # key -> severity rank currently raised (transition detection)
        self._raised: dict[str, int] = {}
        self._lock = threading.Lock()
        self.on_transition = on_transition
        # fired (key, evaluation) when a previously-raised check stops
        # reporting — the cluster-log "cleared" line's source
        self.on_clear = on_clear
        # the most recent evaluation: flight-recorder sources read THIS
        # instead of re-evaluating (which would recurse through the
        # transition hook mid-dump)
        self.last_evaluation: dict | None = None
        # bumped at the start of every evaluate(): checks that share an
        # expensive scan (e.g. the cluster's per-PG state walk) key a
        # memo on it so one evaluation pays the scan once
        self.eval_seq = 0
        _ENGINES.add(self)

    # -- registry ----------------------------------------------------------

    def register(self, key: str, fn, severity: str = HEALTH_WARN,
                 description: str = "") -> None:
        if severity not in SEVERITY_RANK or severity == HEALTH_OK:
            raise ValueError(f"check {key!r}: severity must be "
                             f"{HEALTH_WARN} or {HEALTH_ERR}")
        with self._lock:
            self._checks[key] = (fn, severity, description)

    def unregister(self, key: str) -> None:
        with self._lock:
            self._checks.pop(key, None)
            self._raised.pop(key, None)

    def registered(self) -> dict[str, dict]:
        """Check metadata (key -> severity/description), for docs/top."""
        with self._lock:
            return {k: {"severity": sev, "description": desc}
                    for k, (_, sev, desc) in sorted(self._checks.items())}

    # -- mute ('ceph health mute <code>') ----------------------------------

    def mute(self, key: str) -> None:
        """Muting is lenient about unknown keys (a persisted mute must
        survive a check that is registered later in boot)."""
        with self._lock:
            self._muted.add(key)

    def unmute(self, key: str) -> None:
        with self._lock:
            self._muted.discard(key)

    @property
    def muted(self) -> set[str]:
        with self._lock:
            return set(self._muted)

    # -- evaluation --------------------------------------------------------

    def _run_check(self, key: str, fn, default_sev: str) -> dict | None:
        try:
            res = fn()
        except Exception as e:           # a broken check must not crash
            res = CheckResult(           # health itself — it IS a finding
                f"health check {key!r} raised: {e!r}"[:200])
        if not res:
            return None
        if isinstance(res, str):
            res = CheckResult(res)
        sev = res.severity or default_sev
        return {"severity": sev, "summary": res.summary,
                "detail": list(res.detail), "count": res.count,
                "muted": key in self._muted}

    def evaluate(self, fire_transitions: bool = True) -> dict:
        """Run every registered check.  Returns the health_check_map_t
        shape: ``{"status", "checks": {key: {...}}, "muted": [...]}``.
        Aggregate status ignores muted checks; transitions (new raise or
        severity escalation) fire ``on_transition`` AFTER the full
        evaluation is cached, so hooks can snapshot it re-entrantly.
        ``fire_transitions=False`` is a read-only snapshot: no hooks, no
        raised-state bookkeeping — for callers INSIDE a transition hook
        (e.g. a flight-recorder source) where firing again would recurse
        or steal the real transition from the next live evaluation."""
        with self._lock:
            checks = dict(self._checks)
            self.eval_seq += 1
        results: dict[str, dict] = {}
        for key, (fn, sev, _desc) in sorted(checks.items()):
            info = self._run_check(key, fn, sev)
            if info is not None:
                results[key] = info
        worst = max((SEVERITY_RANK[c["severity"]]
                     for k, c in results.items() if not c["muted"]),
                    default=0)
        evaluation = {
            "status": {0: HEALTH_OK, 1: HEALTH_WARN, 2: HEALTH_ERR}[worst],
            "checks": results,
            "muted": sorted(self.muted),
        }
        if not fire_transitions:
            with self._lock:
                self.last_evaluation = evaluation
            return evaluation
        transitions: list[tuple[str, dict]] = []
        with self._lock:
            for key, info in results.items():
                rank = SEVERITY_RANK[info["severity"]]
                # muted checks never fire the transition hook: mute
                # exists for known-noisy keys, and a flapping muted
                # check must not evict real incidents from the
                # flight-recorder ring (raised-state is still tracked,
                # so unmuting mid-raise does not retro-fire either)
                if rank > self._raised.get(key, 0) and not info["muted"]:
                    transitions.append((key, info))
                self._raised[key] = rank
            cleared: list[str] = []
            for key in list(self._raised):
                if key not in results:
                    del self._raised[key]        # cleared: re-raise fires
                    cleared.append(key)
            self.last_evaluation = evaluation
        if self.on_transition is not None:
            for key, info in transitions:
                self.on_transition(key, info, evaluation)
        if self.on_clear is not None:
            for key in cleared:
                self.on_clear(key, evaluation)
        return evaluation

    def severity_gauges(self) -> dict[str, int]:
        """One gauge per REGISTERED check (0=ok/muted, 1=warn, 2=err) —
        the ``ceph_tpu_health_status`` prometheus surface.  Evaluates
        live so a scrape sees current state (and trips the flight
        recorder on a fresh transition, which is the point of scraping).
        MUTED checks export 0: mute must silence alert rules the same
        way it silences the status line, or the two surfaces disagree
        and the pager defeats the mute."""
        ev = self.evaluate()
        with self._lock:
            keys = list(self._checks)
        return {key: SEVERITY_RANK[ev["checks"][key]["severity"]]
                if key in ev["checks"] and not ev["checks"][key]["muted"]
                else 0
                for key in sorted(keys)}

    def close(self) -> None:
        """Drop out of the live-engine registry (a shut-down cluster must
        not keep exporting health gauges — the ServingEngine.stop
        discipline)."""
        _ENGINES.discard(self)
        with self._lock:
            self._checks.clear()
            self._raised.clear()
        self.last_evaluation = None


def thin_view(evaluation: dict) -> dict:
    """The 'ceph health' wire shape from a full evaluation:
    {"status", "checks": {key: summary}} with muted checks split out
    under "muted" only when any exist (so the healthy shape stays
    exactly {"status", "checks"} — pinned by the rados API tests).
    Shared by ``Cluster.health()`` and the CLI so one evaluation serves
    both the status line and the detail listing."""
    out = {"status": evaluation["status"],
           "checks": {k: c["summary"]
                      for k, c in evaluation["checks"].items()
                      if not c["muted"]}}
    if evaluation["muted"]:
        out["muted"] = {k: evaluation["checks"][k]["summary"]
                        if k in evaluation["checks"] else "(not raised)"
                        for k in evaluation["muted"]}
    return out


# -- generic check factories (subsystem-agnostic: they read only the perf
#    and stats surfaces, so any owner — MiniCluster, a standalone serving
#    process — can register them) ------------------------------------------

def slow_ops_check(stats):
    """SLOW_OPS: ops exceeded ``osd_op_complaint_time`` within the stats
    window (reference: the mon's SLOW_OPS from per-OSD complaints).  The
    cumulative ``slow_ops`` counters alone cannot clear; the WINDOW delta
    is what distinguishes 'slow right now' from 'was slow last week'."""
    def check():
        delta = stats.counter_delta("slow_ops")
        if delta > 0:
            total = int(stats.gauge_sum("slow_ops"))
            return CheckResult(
                f"{int(delta)} slow ops in the last "
                f"{stats.span():.0f}s ({total} total)",
                count=int(delta))
        return None
    return check


def iter_throttles(cct):
    """Yield ``(name, val, max)`` for every registered throttle perf
    collection — ONE walk of the schema shared by THROTTLE_SATURATED
    and `ceph_tpu top` (two hand-rolled walks would drift apart the
    first time the val/max keys move)."""
    for name, pc in sorted(cct.perf.snapshot().items()):
        if not name.startswith("throttle."):
            continue
        try:
            yield name, pc.get("val"), pc.get("max")
        except KeyError:
            continue


def throttle_saturated_check(cct, ratio: float | None = None):
    """THROTTLE_SATURATED: an admission throttle is pinned near its limit
    (queue saturation — the arXiv:1709.05365 signal: sustained
    backpressure means demand is outrunning the device)."""
    def check():
        r = ratio if ratio is not None else \
            float(cct.conf.get("mgr_throttle_saturation_ratio"))
        hot: list[str] = []
        for name, val, mx in iter_throttles(cct):
            if mx and val / mx >= r:
                hot.append(f"{name}: {int(val)}/{int(mx)} units in use")
        if hot:
            return CheckResult(
                f"{len(hot)} throttle(s) >= {r:.0%} of limit",
                detail=hot, count=len(hot))
        return None
    return check


def pg_recovery_stalled_check(stats, scheduler_getter):
    """PG_RECOVERY_STALLED: degraded PGs sit in the recovery scheduler
    but NOTHING progresses over the stats window — no reservation is
    active (``osd_max_backfills`` exhausted or zeroed, a wedged grant
    holder), or jobs hold grants yet zero objects recovered/replayed.
    The queue-depth alone cannot distinguish 'busy' from 'stuck'; the
    window delta of actual repair work is what does."""
    def check():
        sched = scheduler_getter()
        if sched is None:
            return None
        queued, active = sched.job_counts()
        if queued + active == 0:
            return None
        if stats.span() < 1.0:
            # a sub-second window (or a single sample) holds no evidence
            # of a stall — back-to-back scrapes must not page anyone
            return None
        from .stats import PG_PREFIXES
        progress = (
            stats.counter_delta("recoveries", PG_PREFIXES) +
            stats.counter_delta("recovery_failures", PG_PREFIXES) +
            stats.counter_delta("log_repairs_clean", PG_PREFIXES) +
            stats.counter_delta("log_repair_objects", PG_PREFIXES) +
            stats.counter_delta("backfill_objects", PG_PREFIXES) +
            stats.counter_delta("wave_objects", ("recovery.",)))
        if progress > 0:
            return None
        return CheckResult(
            f"{queued + active} recovery job(s) "
            f"({queued} queued, {active} active) with no repair "
            f"progress in the last {stats.span():.0f}s",
            detail=[f"job {key}: state={j.state.value} "
                    f"priority={j.priority} targets={list(j.targets)}"
                    for key, j in sorted(sched.jobs.items())],
            count=queued + active)
    return check


def hbm_pressure_check(cct, ratio: float | None = None, sampler=None):
    """HBM_PRESSURE: a device's session high-water memory mark is pinned
    near its capacity (``mgr_hbm_pressure_ratio`` of ``bytes_limit``) —
    the working set is one allocation away from an OOM that would take a
    serving dispatch down with it.  Reads the guarded watermark sampler
    (``device_telemetry.hbm_watermarks``): platforms whose backend lacks
    memory stats (CPU) report nothing and the check stays silent."""
    def check():
        r = ratio if ratio is not None else \
            float(cct.conf.get("mgr_hbm_pressure_ratio"))
        if sampler is not None:
            marks = sampler()
        else:
            from ..common import device_telemetry
            marks = device_telemetry.hbm_watermarks()
        hot: list[str] = []
        for dev, rec in sorted(marks.items()):
            limit = rec.get("bytes_limit", 0)
            hw = rec.get("high_water_bytes", 0)
            if limit and hw / limit >= r:
                hot.append(f"{dev}: high-water {hw}/{limit} bytes "
                           f"({100.0 * hw / limit:.0f}% of capacity)")
        if hot:
            return CheckResult(
                f"{len(hot)} device(s) >= {r:.0%} of memory capacity",
                detail=hot, count=len(hot))
        return None
    return check


def device_degraded_check():
    """DEVICE_DEGRADED: one or more codec pipelines have circuit-broken
    their device path — N consecutive device failures opened the breaker
    and its batches fail fast (``ops/pipeline.py``; the port serves
    nothing on the host instead).  Clears when half-open probes re-close
    every breaker.  Reads the live-breaker registry
    (``failure/breaker.py``), so any pipeline in the process — serving
    engine, recovery scheduler, standalone — reports without wiring."""
    def check():
        from ..failure.breaker import CLOSED, live_breakers
        rows: list[str] = []
        for b in live_breakers():
            d = b.dump()
            if d["state"] == CLOSED:
                continue
            rows.append(
                f"{d['name']}: {d['state']} after "
                f"{d['consecutive_failures']} consecutive device "
                f"failures ({d['opens']} opens, {d['probes']} probes)")
        if rows:
            return CheckResult(
                f"{len(rows)} device codec path(s) failing fast",
                detail=rows, count=len(rows))
        return None
    return check


def osd_flapping_check(limiter_getter):
    """OSD_FLAPPING: the monitor's mark-down limiter has damped one or
    more OSDs — marked down too often inside ``osd_markdown_window``,
    they stay down (boots refused) until the operator clears the record
    (``Monitor.clear_markdown``).  The osd_markdown_log health surface."""
    def check():
        lim = limiter_getter()
        if lim is None:
            return None
        damped = sorted(lim.damped)
        if damped:
            return CheckResult(
                f"{len(damped)} osd(s) flapping: boots damped until "
                f"operator clear",
                detail=[f"osd.{o} marked down >= {lim.count} times in "
                        f"{lim.window:.0f}s; down until cleared"
                        for o in damped],
                count=len(damped))
        return None
    return check


def recompile_storm_check(cct, stats, threshold: float | None = None):
    """RECOMPILE_STORM: the jit registry is compiling at more
    than ``mgr_recompile_storm_compiles`` per MINUTE over the stats
    window — the shape-churn failure mode where every batch recompiles
    instead of hitting the size buckets (each compile is ~ms-to-s of
    stall on the dispatch path).  Time-normalized: the window is bounded
    by sample COUNT, so on a rarely-polled cluster it can span hours —
    an absolute count would flag ordinary warmup as a storm.

    In the port the ``jit`` collection is the launch ledger's
    (``ops/launch_ledger.py``): a "compilation" is a (kernel, launch
    shape) key's first launch — its synchronised, timed first launch,
    with the kernel library's build or load on the library's first key —
    and a cache hit any later launch of the key.  A storm is so a path
    whose launch widths churn (a new shape every op) where they should
    repeat."""
    def check():
        limit = threshold if threshold is not None else \
            float(cct.conf.get("mgr_recompile_storm_compiles"))
        dt = stats.span()
        if dt <= 0:
            return None
        compiles = stats.counter_delta("compilations", coll_prefix=("jit",))
        # a window shorter than a minute still needs `limit` ABSOLUTE
        # compiles to fire: two warmup compiles 100ms apart are a 1200/min
        # instantaneous rate but not a storm
        per_min = compiles / max(dt, 60.0) * 60.0
        if compiles >= limit and per_min >= limit:
            hits = stats.counter_delta("cache_hits", coll_prefix=("jit",))
            return CheckResult(
                f"{int(compiles)} jit compilations in the last "
                f"{dt:.0f}s (~{per_min:.0f}/min, cache hits: "
                f"{int(hits)}) — check shape bucketing",
                count=int(compiles))
        return None
    return check


def tier_full_check(tiers_getter):
    """TIER_FULL: a cache tier's residency is at or past its
    ``tier_full_ratio`` watermark — promotions and absorbed writes are
    about to be paid for with synchronous evictions (or refused), the
    tier-equivalent of a full OSD.  ``tiers_getter`` returns the live
    ``{cache_pool: (service, agent)}`` map; residency is counted from
    object bookkeeping (no I/O on the health path)."""
    def check():
        hot: list[str] = []
        for pid, (svc, agent) in sorted(tiers_getter().items()):
            full = svc.cct.conf.get("tier_full_ratio")
            f = agent.fullness()
            if f >= full:
                hot.append(f"tier pool {pid} ({svc.name}): "
                           f"{len(svc.resident())} objects = "
                           f"{100.0 * f:.0f}% of target "
                           f"(tier_full_ratio {100.0 * full:.0f}%)")
        if hot:
            return CheckResult(
                f"{len(hot)} cache tier(s) at/over the full watermark",
                detail=hot, count=len(hot))
        return None
    return check


def tier_flush_backlog_check(tiers_getter, min_ticks: int = 2):
    """TIER_FLUSH_BACKLOG: an agent finished ``min_ticks`` consecutive
    passes still above ``tier_dirty_ratio_high`` — the EC base pool is
    not absorbing flushes as fast as writeback absorbs writes (base
    inactive, flush budget too small, or genuine overload).  One
    over-watermark pass is normal burst behavior; a STREAK is the
    backlog.  Reads the agent's own tick accounting: no I/O here."""
    def check():
        stuck: list[str] = []
        for pid, (svc, agent) in sorted(tiers_getter().items()):
            if agent.backlog_ticks >= min_ticks:
                stuck.append(
                    f"tier pool {pid} ({svc.name}): dirty ratio "
                    f"{agent.last.get('dirty_ratio', 0.0):.2f} still "
                    f"over tier_dirty_ratio_high after "
                    f"{agent.backlog_ticks} agent passes")
        if stuck:
            return CheckResult(
                f"{len(stuck)} cache tier(s) cannot flush fast enough",
                detail=stuck, count=len(stuck))
        return None
    return check
