"""Prometheus exporter: perf counters + span latencies in the text format.

Analog of the reference mgr's prometheus module (reference:
src/pybind/mgr/prometheus/module.py — walks every daemon's perf counter
schema and renders `ceph_<subsystem>_<counter>` metrics).  Here the
process-wide PerfCounters registry renders to the same text format:
counters as `ceph_tpu_<collection>_<name>`, averages as `_sum`/`_count`
pairs, histograms as cumulative `_bucket{le=...}` series **plus the
`_sum` series real scrapers require for histogram types** — and the span
tracer's per-name latency distributions as
`ceph_tpu_span_latency_seconds` histograms.  `# HELP`/`# TYPE` are
emitted exactly once per metric name (several collections share counter
names, e.g. one `ec_backend.<pg>` per PG) and the `collection` label is
identical across a histogram's `_bucket`/`_count`/`_sum` series.

The port's copy of ``ceph_tpu.mgr.prometheus``, with every family of the
JAX package's exporter under the same ``ceph_tpu`` prefix (the port's
wire accounting, copy ledger and critical-path ledger document their
families under it).  ``ceph_tpu_device_efficiency`` carries the launch
ledger's per-(kernel, launch shape) roofline rows, and the ``device``
collection the card's telemetry over ``torch.cuda``, which a scrape
reads without ever creating a CUDA context.
"""
from __future__ import annotations

import time

from ..common import default_context
from ..common.perf_counters import (
    PERFCOUNTER_AVG, PERFCOUNTER_HISTOGRAM, PERFCOUNTER_TIME_AVG,
)
from ..common.tracer import default_tracer


def _sanitize(name: str) -> str:
    return "".join(ch if ch.isalnum() or ch == "_" else "_"
                   for ch in name)


class _MetricFamily:
    """One exposition block: HELP + TYPE once, then every series."""

    def __init__(self, name: str, kind: str, help_text: str):
        self.name, self.kind = name, kind
        self.help = help_text or name
        self.lines: list[str] = []

    def render(self) -> list[str]:
        return [f"# HELP {self.name} {self.help}",
                f"# TYPE {self.name} {self.kind}"] + self.lines


def _histogram_series(fam: _MetricFamily, label: str, bounds, counts,
                      total_sum: float) -> None:
    """Cumulative buckets + the +Inf bucket + _sum/_count, all under ONE
    label set (the satellite contract: consistent `collection`/`span`
    labels across the three series)."""
    cum = 0
    for bound, n in zip(bounds, counts):
        cum += n
        fam.lines.append(f'{fam.name}_bucket{{{label},le="{bound}"}} {cum}')
    total = cum + (counts[len(bounds)] if len(counts) > len(bounds) else 0)
    fam.lines.append(f'{fam.name}_bucket{{{label},le="+Inf"}} {total}')
    fam.lines.append(f'{fam.name}_sum{{{label}}} {total_sum}')
    fam.lines.append(f'{fam.name}_count{{{label}}} {total}')


def _mclock_depth_gauges(family, prefix: str) -> None:
    """Queue depths of every live mClock queue — the OSD daemons' sharded
    op queues and the serving engines' admission queues — as one gauge
    family (`ceph_tpu_mclock_queue_depth`), labelled by owner.  Lazy
    imports keep the exporter loadable in partial environments."""
    metric = f"{prefix}_mclock_queue_depth"
    fam = None
    try:
        from ..osd.osd_daemon import live_daemons
    except Exception:                       # pragma: no cover
        live_daemons = list
    try:
        from ..exec.engine import live_engines
    except Exception:                       # pragma: no cover
        live_engines = list
    for d in sorted(live_daemons(), key=lambda d: d.whoami):
        for shard, depths in sorted(d.queue_depths().items()):
            for op_class, depth in sorted(depths.items()):
                if fam is None:
                    fam = family(metric, "gauge",
                                 "queued items per mClock class")
                fam.lines.append(
                    f'{metric}{{owner="osd.{d.whoami}",shard="{shard}",'
                    f'op_class="{_sanitize(op_class)}"}} {depth}')
    for e in sorted(live_engines(), key=lambda e: e.name):
        for op_class, depth in sorted(e.depths().items()):
            if op_class.startswith("_"):
                continue                    # the _total/_bytes extras
            if fam is None:
                fam = family(metric, "gauge",
                             "queued items per mClock class")
            fam.lines.append(
                f'{metric}{{owner="serving.{_sanitize(e.name)}",'
                f'shard="0",op_class="{_sanitize(op_class)}"}} {depth}')


def _recovery_reserver_gauges(family, prefix: str) -> None:
    """``ceph_tpu_recovery_reserver_queued`` /
    ``ceph_tpu_recovery_reserver_granted`` — per-OSD local/remote
    reservation queue depth and in-flight grants of every live
    RecoveryScheduler (the AsyncReserver occupancy an operator watches
    to tell 'repair is pacing' from 'repair is wedged')."""
    try:
        from ..recovery.scheduler import live_schedulers
    except Exception:                       # pragma: no cover
        return
    fams = {}
    for sched in sorted(live_schedulers(), key=lambda s: s.name):
        for kind, osd, depth, granted in sched.reserver_gauges():
            for suffix, v, help_text in (
                    ("queued", depth,
                     "recovery reservations waiting per OSD reserver"),
                    ("granted", granted,
                     "recovery reservations in flight per OSD reserver")):
                metric = f"{prefix}_recovery_reserver_{suffix}"
                fam = fams.get(metric)
                if fam is None:
                    fam = fams[metric] = family(metric, "gauge",
                                                help_text)
                fam.lines.append(
                    f'{metric}{{owner="{_sanitize(sched.name)}",'
                    f'kind="{kind}",osd="{osd}"}} {v}')


def _health_gauges(family, prefix: str) -> None:
    """``ceph_tpu_health_status{owner=...,check=...}`` — one gauge per
    REGISTERED check per live engine (0=ok, 1=warn, 2=err).  Evaluated
    live at scrape time, so a scrape that catches a fresh WARN/ERR also
    trips the owner's flight recorder — by design."""
    try:
        from .health import live_health_engines
    except Exception:                       # pragma: no cover
        return
    metric = f"{prefix}_health_status"
    fam = None
    for e in sorted(live_health_engines(), key=lambda e: e.name):
        for key, rank in sorted(e.severity_gauges().items()):
            if fam is None:
                fam = family(metric, "gauge",
                             "health check severity "
                             "(0=ok/muted 1=warn 2=err)")
            fam.lines.append(
                f'{metric}{{owner="{_sanitize(e.name)}",'
                f'check="{_sanitize(key)}"}} {rank}')


def _device_time_gauges(family, prefix: str) -> None:
    """``ceph_tpu_device_time_seconds{class=...}`` — cumulative device
    occupancy by owner class from the attribution ledger
    (common/device_attribution), plus the busy-time total as
    ``class="_busy"`` so dashboards can plot shares without summing."""
    try:
        from ..common import device_attribution
        snap = device_attribution.snapshot()
    except Exception:                       # pragma: no cover
        return
    if not snap["classes"] and not snap["busy_s"]:
        return
    metric = f"{prefix}_device_time_seconds"
    fam = family(metric, "counter",
                 "device busy seconds attributed per owner class "
                 "(common/device_attribution)")
    for cls, rec in sorted(snap["classes"].items()):
        fam.lines.append(
            f'{metric}{{class="{_sanitize(cls)}"}} '
            f'{round(rec["device_s"], 6)}')
    fam.lines.append(
        f'{metric}{{class="_busy"}} {round(snap["busy_s"], 6)}')


def _device_efficiency_gauges(family, prefix: str, snap: dict | None
                              ) -> None:
    """``ceph_tpu_device_efficiency{executable,stat}`` — the roofline
    ledger's per-executable achieved rates, arithmetic intensity and
    %-of-peak (common/roofline.py).  ``stat="memory_bound"`` encodes the
    classification (1 = under the ridge point).  The aggregate view
    exports through the ordinary ``device_efficiency`` collection walk;
    this family adds the per-executable breakdown the perf schema cannot
    hold (open-ended executable set).  ``snap`` is the ONE snapshot
    ``render()`` took via ``roofline.refresh(cct)`` — sharing it keeps
    the per-executable rows on the same (config-overridable) peaks as
    the aggregate gauges in the same scrape."""
    if not snap or not snap["executables"]:
        return
    metric = f"{prefix}_device_efficiency"
    fam = family(metric, "gauge",
                 "per-executable roofline efficiency "
                 "(common/roofline.py)")
    for eid, rec in sorted(snap["executables"].items()):
        stats = (("calls", rec["calls"]),
                 ("seconds", rec["seconds"]),
                 ("achieved_flops_s", rec["achieved_flops_s"]),
                 ("achieved_bytes_s", rec["achieved_bytes_s"]),
                 ("arithmetic_intensity", rec["arithmetic_intensity"]),
                 ("pct_of_peak", rec["pct_of_peak"]),
                 ("memory_bound",
                  1 if rec["bound"] == "memory" else 0))
        for stat, v in stats:
            fam.lines.append(
                f'{metric}{{executable="{_sanitize(eid)}",'
                f'stat="{stat}"}} {round(float(v), 6)}')


def _wire_gauges(family, prefix: str) -> None:
    """``ceph_tpu_wire_bytes`` / ``ceph_tpu_wire_msgs``
    ``{owner,msg_type,dir}`` — per-message-type wire traffic of every
    live WireAccounting (bus + TCP messenger).  The totals and per-class
    rollups already export through the ordinary ``wire.<name>``
    collection walk; this family adds the per-TYPE breakdown the perf
    schema cannot hold (open-ended type set)."""
    try:
        from ..common.wire_accounting import live_wire_accountants
    except Exception:                       # pragma: no cover
        return
    fams = {}
    for acct in sorted(live_wire_accountants(), key=lambda a: a.name):
        for mtype, rec in acct.per_type().items():
            for direction in ("tx", "rx"):
                for unit, help_text in (
                        ("bytes", "wire bytes per message type"),
                        ("msgs", "wire messages per message type")):
                    v = rec[f"{direction}_{unit}"]
                    if not v:
                        continue
                    metric = f"{prefix}_wire_{unit}"
                    fam = fams.get(metric)
                    if fam is None:
                        fam = fams[metric] = family(metric, "counter",
                                                    help_text)
                    fam.lines.append(
                        f'{metric}{{owner="{_sanitize(acct.name)}",'
                        f'msg_type="{_sanitize(mtype)}",'
                        f'dir="{direction}"}} {v}')


def _heat_gauges(family, prefix: str) -> None:
    """``ceph_tpu_osd_heat{owner,osd,stat}`` /
    ``ceph_tpu_pg_heat{owner,pg,stat}`` — the workload heat maps of
    every live HeatTracker (mgr/heat.py): primary-op and byte rates over
    the stats window, rolled per PG and per primary OSD.  The
    before/after instrument for the balancer loop (ROADMAP item 5)."""
    try:
        from .heat import live_heat_trackers
    except Exception:                       # pragma: no cover
        return
    fams = {}
    for tracker in sorted(live_heat_trackers(), key=lambda t: t.name):
        owner = _sanitize(tracker.name)
        snap = tracker.snapshot()
        for metric_key, label, rows, help_text in (
                ("osd_heat", "osd", snap["osds"],
                 "per-OSD primary-op load over the stats window"),
                ("pg_heat", "pg", snap["pgs"],
                 "per-PG primary-op load over the stats window")):
            metric = f"{prefix}_{metric_key}"
            for key, rec in sorted(rows.items(), key=lambda kv:
                                   str(kv[0])):
                for stat in ("op_s", "bytes_s"):
                    fam = fams.get(metric)
                    if fam is None:
                        fam = fams[metric] = family(metric, "gauge",
                                                    help_text)
                    # pg ids ("1.0") and osd ids are clean label VALUES
                    # as-is; only metric names need sanitizing
                    fam.lines.append(
                        f'{metric}{{owner="{owner}",'
                        f'{label}="{key}",'
                        f'stat="{stat}"}} {rec[stat]}')


def _tier_gauges(family, prefix: str) -> None:
    """``ceph_tpu_tier_ops{owner,op}`` /
    ``ceph_tpu_tier_state{owner,stat}`` — every live cache tier's
    promotion/flush/evict counters plus residency, dirtiness, and hit
    rate (tier/service.py): the before/after instrument for the
    hot-tier loop (ROADMAP item 7)."""
    try:
        from ..tier import live_tier_services
    except Exception:                       # pragma: no cover
        return
    ops_fam = state_fam = None
    for svc in sorted(live_tier_services(), key=lambda s: s.name):
        owner = _sanitize(svc.name)
        for op in ("hit", "miss", "proxy_read", "proxy_write", "promote",
                   "promote_skip", "writeback", "flush", "evict",
                   "invalidate"):
            if ops_fam is None:
                ops_fam = family(f"{prefix}_tier_ops", "counter",
                                 "cache-tier operations by kind "
                                 "(tier/service.py)")
            ops_fam.lines.append(
                f'{prefix}_tier_ops{{owner="{owner}",op="{op}"}} '
                f'{int(svc.perf.get(op))}')
        st = svc.stats()
        for stat, v in (("objects", st["objects"]),
                        ("dirty", svc.perf.get("dirty")),
                        ("hit_rate", round(st["hit_rate"], 6))):
            if state_fam is None:
                state_fam = family(f"{prefix}_tier_state", "gauge",
                                   "cache-tier residency, dirtiness, "
                                   "and hit rate")
            state_fam.lines.append(
                f'{prefix}_tier_state{{owner="{owner}",'
                f'stat="{stat}"}} {v}')


def _copy_gauges(family, prefix: str) -> None:
    """``ceph_tpu_copy_bytes{source}`` / ``ceph_tpu_copy_state{stat}``
    — the payload copy ledger (common/copy_ledger.py): bytes copied per
    surviving host-copy source, bytes served to consumers, and the
    ``copies_per_byte`` quotient the zero-copy data path is gated on
    (ROADMAP item 2)."""
    try:
        from ..common.copy_ledger import ledger
    except Exception:                       # pragma: no cover
        return
    snap = ledger().snapshot()
    copied_fam = family(f"{prefix}_copy_bytes", "counter",
                        "payload bytes copied, by copy source "
                        "(common/copy_ledger.py)")
    for source, v in sorted(snap["copied"].items()):
        copied_fam.lines.append(
            f'{prefix}_copy_bytes{{source="{_sanitize(source)}"}} {v}')
    state_fam = family(f"{prefix}_copy_state", "gauge",
                       "payload bytes served and copies per served byte")
    for stat, v in (("served_bytes", snap["served"]),
                    ("copied_total", snap["copied_total"]),
                    ("copies_per_byte",
                     round(snap["copies_per_byte"], 6))):
        state_fam.lines.append(
            f'{prefix}_copy_state{{stat="{stat}"}} {v}')


def _slo_gauges(family, prefix: str) -> None:
    """``ceph_tpu_slo_budget{owner,class,stat}`` — every live
    SLOTracker's per-class objective state: the configured p99 bound,
    both windows' burn rates, and the remaining error budget (mgr/slo.py
    multi-window burn engine)."""
    try:
        from .slo import live_slo_trackers
    except Exception:                       # pragma: no cover
        return
    metric = f"{prefix}_slo_budget"
    fam = None
    for tracker in sorted(live_slo_trackers(), key=lambda t: t.name):
        # objectives only: the full status() would also compute the
        # per-class attribution summaries this family never renders
        for cls, s in sorted(tracker.objectives_status().items()):
            stats = (("objective_p99_ms", s["objective_p99_ms"]),
                     ("target", s["target"]),
                     ("burn_fast", s["fast"]["burn"]),
                     ("burn_slow", s["slow"]["burn"]),
                     ("budget_remaining", s["budget_remaining"]),
                     ("ops_slow_window", s["slow"]["ops"]),
                     ("bad_slow_window", s["slow"]["bad"]))
            for stat, v in stats:
                if fam is None:
                    fam = family(metric, "gauge",
                                 "per-class latency SLO state "
                                 "(mgr/slo.py burn-rate engine)")
                fam.lines.append(
                    f'{metric}{{owner="{_sanitize(tracker.name)}",'
                    f'class="{_sanitize(cls)}",stat="{stat}"}} '
                    f'{round(float(v), 6)}')


def _latency_phase_gauges(family, prefix: str) -> None:
    """``ceph_tpu_latency_phase_seconds{owner,class,phase}`` — the
    critical-path ledgers' cumulative per-(class, phase) seconds
    (common/critpath.py).  Each scrape folds newly-completed traces
    first, the StatsAggregator idiom: scrape cadence IS fold cadence."""
    try:
        from ..common.critpath import live_ledgers
    except Exception:                       # pragma: no cover
        return
    metric = f"{prefix}_latency_phase_seconds"
    fam = None
    for ledger in sorted(live_ledgers(), key=lambda led: led.name):
        try:
            ledger.refresh()
        except Exception:                   # pragma: no cover
            pass
        for cls, acc in ledger.phase_seconds().items():
            for phase, secs in sorted(acc.items()):
                if not secs:
                    continue
                if fam is None:
                    fam = family(metric, "counter",
                                 "critical-path latency attributed per "
                                 "op class and phase "
                                 "(common/critpath.py)")
                fam.lines.append(
                    f'{metric}{{owner="{_sanitize(ledger.name)}",'
                    f'class="{_sanitize(cls)}",'
                    f'phase="{_sanitize(phase)}"}} {round(secs, 6)}')


def _stats_rate_gauges(family, prefix: str) -> None:
    """``ceph_tpu_stats_rate{owner=...,stat=...}`` — the PGMap-style
    digest (client IO B/s and op/s, recovery B/s, serving batch
    throughput, jit churn) of every live StatsAggregator.  Each scrape
    ticks the aggregator, so scrape cadence IS the rate window cadence
    (how the reference mgr's prometheus module drives PGMap deltas)."""
    try:
        from .stats import live_aggregators
    except Exception:                       # pragma: no cover
        return
    metric = f"{prefix}_stats_rate"
    fam = None
    for agg in sorted(live_aggregators(), key=lambda a: a.name):
        agg.sample()
        for stat, v in sorted(agg.digest_flat().items()):
            if fam is None:
                fam = family(metric, "gauge",
                             "rolling-window rate digest "
                             "(mgr/stats.py StatsAggregator)")
            fam.lines.append(
                f'{metric}{{owner="{_sanitize(agg.name)}",'
                f'stat="{stat}"}} {round(v, 3)}')


def _device_refresh_due(cct, now: float) -> bool:
    """TTL gate on the per-scrape device-telemetry refresh
    (``mgr_device_refresh_ttl``): a tight scrape loop re-renders the
    LAST snapshot's gauges instead of re-reading the card's memory state
    every render.  ``ttl=0`` restores refresh-every-scrape.  The stamp
    lives ON the context — a fresh context's first scrape must refresh
    its own gauges regardless of when another context last scraped."""
    try:
        ttl = float(cct.conf.get("mgr_device_refresh_ttl"))
    except Exception:
        ttl = 0.0
    last = getattr(cct, "_prom_device_refresh", float("-inf"))
    if ttl > 0.0 and now - last < ttl:
        return False
    cct._prom_device_refresh = now
    return True


def render(cct=None, prefix: str = "ceph_tpu") -> str:
    """The /metrics payload: every registered collection's metrics plus
    the tracer's span-latency histograms."""
    cct = cct if cct is not None else default_context()
    # refresh the device gauges BEFORE the collection walk renders them
    # (never creates a CUDA context: a scrape thread reads the card only
    # where CUDA is already initialised), at most once per
    # mgr_device_refresh_ttl
    try:
        if _device_refresh_due(cct, time.monotonic()):
            from ..common import device_telemetry
            device_telemetry.refresh(cct)
    except Exception:                       # pragma: no cover
        pass
    # same for the roofline ledger's aggregate device_efficiency gauges
    # (its snapshot first reads the launch ledger's finished CUDA-event
    # pairs, never waiting); the returned snapshot also feeds the
    # per-executable family below (one ledger join per scrape, same
    # peaks for both surfaces)
    eff_snap = None
    try:
        from ..common import roofline
        eff_snap = roofline.refresh(cct)
    except Exception:                       # pragma: no cover
        pass
    families: dict[str, _MetricFamily] = {}

    def family(metric: str, kind: str, help_text: str) -> _MetricFamily:
        fam = families.get(metric)
        if fam is None:
            fam = families[metric] = _MetricFamily(metric, kind, help_text)
        return fam

    for coll_name, pc in sorted(cct.perf.snapshot().items()):
        label = f'collection="{coll_name}"'
        # fold the per-thread counter cells: hot-path inc/tinc/hinc land
        # in thread-local shards, and a scrape must see them
        with pc._lock:
            folded = {key: pc._folded_locked(m, key)
                      for key, m in pc._metrics.items()}
        for key, m in sorted(pc._metrics.items()):
            metric = f"{prefix}_{_sanitize(key)}"
            value, total, count, bc = folded[key]
            if m.kind in (PERFCOUNTER_AVG, PERFCOUNTER_TIME_AVG):
                fam = family(metric, "summary", m.description)
                fam.lines.append(f"{metric}_sum{{{label}}} {total}")
                fam.lines.append(f"{metric}_count{{{label}}} {count}")
            elif m.kind == PERFCOUNTER_HISTOGRAM:
                fam = family(metric, "histogram", m.description)
                _histogram_series(fam, label, m.buckets, bc, total)
            else:
                fam = family(metric, "counter", m.description)
                fam.lines.append(f"{metric}{{{label}}} {value}")

    _mclock_depth_gauges(family, prefix)
    _recovery_reserver_gauges(family, prefix)
    _health_gauges(family, prefix)
    _stats_rate_gauges(family, prefix)
    # latency-phase first: it FOLDS every live ledger, so the slo
    # budget gauges in the same scrape judge the freshly-folded records
    # instead of lagging one scrape behind the attribution data
    _latency_phase_gauges(family, prefix)
    _slo_gauges(family, prefix)
    _device_time_gauges(family, prefix)
    _device_efficiency_gauges(family, prefix, eff_snap)
    _wire_gauges(family, prefix)
    _heat_gauges(family, prefix)
    _tier_gauges(family, prefix)
    _copy_gauges(family, prefix)

    span_metric = f"{prefix}_span_latency_seconds"
    hists = default_tracer().histograms()
    if hists:
        fam = family(span_metric, "histogram",
                     "span wall time by span name (common/tracer.py)")
        for name in sorted(hists):
            h = hists[name]
            _histogram_series(fam, f'span="{name}"', h["buckets"],
                              h["counts"], h["sum"])

    lines: list[str] = []
    for metric in sorted(families):
        lines.extend(families[metric].render())
    return "\n".join(lines) + "\n"
