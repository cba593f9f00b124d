"""MiniCluster: an in-process cluster harness (the vstart.sh analog).

Mirror of the reference's dev-cluster workflow (reference: src/vstart.sh +
qa/standalone/ceph-helpers.sh run_osd/wait_for_clean;
qa/standalone/erasure-code/test-erasure-code.sh:21-66 creates an EC pool
over 11 OSDs and does put/get): builds a CRUSH tree + OSDMap, creates EC
pools from profiles (plugin factory + create_rule, the mon's pool-creation
path), places every PG via the OSDMap mapping chain, and instantiates one
EC group (primary ECBackend + shard OSDs on a message bus) per PG with the
acting set CRUSH chose.  Objects route to PGs with the librados placement
(ceph_str_hash_rjenkins + ceph_stable_mod).

Every OSD runs one daemon (sharded mClock op queue + superblock) over
ONE ObjectStore that holds each hosted PG shard as a collection (a
MemStore, or in durable mode a FileStore or BlueStoreLite under
``data_dir``), and every PG talks over one cluster-wide MessageBus
through its own channel.

The port's copy of ``ceph_tpu.cluster``.  An EC pool defaults to the
``torch_rs`` plugin; a profile with no ``device`` key runs its encode
(``gf_apply``), HashInfo crcs (``crc32c_rows``) and reconstructing reads
and recovery waves (``gf_apply`` decode) on the card, and without a card
such a write raises and stores nothing.  The telemetry spine carries the
roofline ledger (``efficiency`` time-series and flight sources) and
``torch.profiler`` capture windows under ``<data_dir>/profiles``, with a
one-shot auto-capture on any WARN/ERR health transition.
"""
from __future__ import annotations

from .backend import (ECBackend, MessageBus, PGTransaction, ReplicatedBackend,
                      StripeInfo)
from .backend.ec_backend import OSDShard
from .common import Context, default_context
from .crush import (CRUSH_BUCKET_STRAW2, CRUSH_RULE_CHOOSELEAF_FIRSTN,
                    CRUSH_RULE_CHOOSELEAF_INDEP,
                    CRUSH_RULE_EMIT, CRUSH_RULE_TAKE, CrushMap)
from .osdmap import (OSDMap, PG, Pool, POOL_TYPE_ERASURE,
                     POOL_TYPE_REPLICATED, ceph_stable_mod)
from .osdmap.str_hash import ceph_str_hash_rjenkins
from .plugins.registry import ErasureCodePluginRegistry


import itertools

NONE_ID = 0x7FFFFFFF          # CRUSH_ITEM_NONE

_cluster_ids = itertools.count(1)


class BlockedWriteError(IOError):
    """A write parked on an inactive PG (< min_size current shards): it is
    queued — neither acked nor lost — and commits when shards return."""


class PGGroup:
    """One placement group: primary backend + shard OSDs.

    With ``bus`` (a cluster-wide MessageBus), the PG talks through a
    :class:`~ceph_tpu_torch.backend.messages.PGChannel` — one endpoint per OSD
    on ONE shared bus, the reference's messenger topology.  Without it
    (standalone/unit use) the PG gets a private bus as before."""

    def __init__(self, pgid: PG, acting: list[int], ec_impl,
                 chunk_size: int, cct, name_prefix: str,
                 min_size: int = 0, store_factory=None, epoch: int = 0,
                 bus: MessageBus | None = None):
        self.pgid = pgid
        self.acting = acting
        # map epoch this acting set was established at: ops stamped with
        # an older epoch by a stale client get rejected (the OSD's
        # require_same_or_newer_map check, src/osd/OSD.cc)
        self.epoch = epoch
        if bus is None:
            self.bus = MessageBus()
        else:
            from .backend.messages import PGChannel
            self.bus = PGChannel(bus, f"{name_prefix}.{pgid}")
        primary = acting[0]
        mk = store_factory if store_factory is not None else lambda osd: None
        # name is unique across PGs sharing a primary AND across clusters
        # sharing a Context (salted with the cluster id)
        if ec_impl is None:       # replicated pool: full copies, no codec
            self.backend = ReplicatedBackend(
                len(acting), self.bus, acting=list(acting), whoami=primary,
                cct=cct, name=f"{name_prefix}.pg{pgid}", min_size=min_size,
                store=mk(primary))
        else:
            k = ec_impl.get_data_chunk_count()
            self.backend = ECBackend(
                ec_impl, StripeInfo(k, chunk_size), self.bus,
                acting=list(acting), whoami=primary, cct=cct,
                name=f"{name_prefix}.pg{pgid}", min_size=min_size,
                store=mk(primary))
        for osd in acting:
            if osd != primary:
                OSDShard(osd, self.bus, store=mk(osd))
        # the primary's object-op engine (PrimaryLogPG analog): executes
        # client op vectors atomically on top of the backend pipeline
        from .osd.primary_log_pg import PrimaryLogPG
        self.engine = PrimaryLogPG(
            self.backend, pool_type="replicated" if ec_impl is None else "ec")
        # the peering statechart (acting-set negotiation on map changes)
        from .osd.peering import PeeringCoordinator
        self.peering = PeeringCoordinator(self.backend)
        # admin-socket observability for the PG-level subsystems
        # (the reference's 'dump_watchers' and pg-state query commands)
        name = self.backend.instance_name
        for cmd, fn in (
                (f"dump_watchers.{name}",
                 lambda **kw: {oid: sorted(ws) for oid, ws in
                               self.engine.watchers.items() if ws}),
                (f"peering_history.{name}",
                 lambda **kw: {"state": self.peering.state.value,
                               "last_epoch_started":
                                   self.peering.last_epoch_started,
                               "history": list(self.peering.history)})):
            # names are unique (cluster-id + epoch salted), so a duplicate
            # registration is a LIFECYCLE BUG — let the guard raise
            cct.admin_socket.register(cmd, fn)

    def shutdown(self, discard_stores: bool = False) -> None:
        # closes the primary's store too; discard skips the final
        # checkpoint when the directories are about to be deleted.
        # (Collections over a shared per-OSD store close as no-ops — the
        # daemon owns that store's lifecycle.)
        name = self.backend.instance_name
        for cmd in (f"dump_watchers.{name}", f"peering_history.{name}"):
            self.backend.cct.admin_socket.unregister(cmd)
        self.backend.shutdown(checkpoint_store=not discard_stores)
        for h in self.bus.handlers.values():
            if isinstance(h, OSDShard) and h is not self.backend.local_shard \
                    and hasattr(h.store, "close"):
                h.store.close(checkpoint=not discard_stores)
        if hasattr(self.bus, "unregister_all"):
            self.bus.unregister_all()


class MiniCluster:
    def __init__(self, n_osds: int = 12, osds_per_host: int = 3,
                 chunk_size: int = 4096, cct: Context | None = None,
                 data_dir=None, store_backend: str = "file"):
        self.cct = cct if cct is not None else default_context()
        # a daemon's start (global_init.cc:577): load the plugins that
        # osd_erasure_code_plugins names, failing on any that will not load
        ErasureCodePluginRegistry.instance().preload(
            self.cct.conf.get("osd_erasure_code_plugins").split())
        self.chunk_size = chunk_size
        self.n_osds = n_osds
        self.osds_per_host = osds_per_host
        self.cluster_id = next(_cluster_ids)
        # durable-store flavour: "file" (FileStore WAL+snapshot) or
        # "bluestore" (extent allocator, checksums at rest, compression)
        if store_backend not in ("file", "bluestore"):
            raise ValueError(f"unknown store_backend {store_backend!r} "
                             f"(choose 'file' or 'bluestore')")
        self.store_backend = store_backend
        # durable mode: every OSD's store lives under
        # data_dir/osd.<id>/store and cluster metadata persists to
        # cluster_meta.pkl — MiniCluster.load() reopens the whole thing
        from pathlib import Path
        self.data_dir = Path(data_dir) if data_dir is not None else None
        cmap = CrushMap()
        cmap.set_type_name(1, "host")
        cmap.set_type_name(2, "root")
        hosts = []
        for h0 in range(0, n_osds, osds_per_host):
            items = list(range(h0, min(h0 + osds_per_host, n_osds)))
            hb = cmap.add_bucket(
                CRUSH_BUCKET_STRAW2, 1, items, [0x10000] * len(items))
            cmap.set_item_name(hb, f"host{len(hosts)}")
            hosts.append(hb)
        root = cmap.add_bucket(
            CRUSH_BUCKET_STRAW2, 2, hosts,
            [sum(cmap.buckets[h].item_weights) for h in hosts])
        cmap.set_item_name(root, "default")
        cmap.finalize()
        self.osdmap = OSDMap(crush=cmap)
        for o in range(n_osds):
            self.osdmap.create_osd(o)
        self._next_pool = 1
        self.pools: dict[int, dict] = {}       # pool_id -> {pgs, pool, ec}
        self.pool_ids: dict[str, int] = {}
        self.objects: dict[int, set[str]] = {}  # pool_id -> written oids
        # (oid, result, msg) from batched (deliver=False) op replies that
        # completed with an error AFTER their submit call returned — the
        # next deliver_all() surfaces them (raising from inside the
        # daemon drain would strand the rest of the queue)
        self._deferred_errors: list[tuple[str, int, str]] = []
        # ONE cluster-wide message bus: each OSD registers a single
        # endpoint that demuxes PG-enveloped traffic to its hosted PGs —
        # the reference's one-messenger-per-OSD topology
        self.bus = MessageBus()
        self.bus.pre_deliver_hooks.append(self._drain_live_daemons)
        # wire accounting (common/wire_accounting.py): every bus send
        # charges byte/op counters per message type and owner op class —
        # the source of recovery.wire_bytes_per_byte_repaired and
        # serving.wire_bytes_per_op in the stats digest
        from .common.wire_accounting import WireAccounting
        self.wire = WireAccounting(cct=self.cct,
                                   name=f"c{self.cluster_id}")
        self.bus.wire_stats = self.wire
        # one daemon shell per OSD: sharded mClock op queue + superblock,
        # and ONE ObjectStore hosting every PG shard on that OSD as
        # collections (OSD.cc:3971 load_pgs iterates one store)
        from .osd.osd_daemon import OSDDaemon
        self.osds = {}
        # osd_queue_throttle_ops > 0 bounds every daemon's op queue: past
        # it, ms_dispatch answers ('throttled', epoch) instead of queueing
        qcap = self.cct.conf.get("osd_queue_throttle_ops")
        for o in range(n_osds):
            st = self._osd_store(o)
            throttle = None
            if qcap:
                from .exec import Throttle
                throttle = Throttle(f"osd.{o}.q", qcap, cct=self.cct)
            d = OSDDaemon(o, meta_store=st, op_throttle=throttle)
            d.store = st
            self.osds[o] = d
        # optional serving engine (enable_serving): cross-PG encode/decode
        # coalescing + admission throttles for every EC backend
        self.serving = None
        # optional recovery scheduler (enable_recovery_scheduler):
        # reservation-gated, prioritized, batch-fused background repair
        self.recovery = None
        # optional fault injection campaign (inject_faults): one seeded
        # FaultInjector spanning the bus, store and device planes
        self.fault_injector = None
        # cache tiers (create_tier): cache pool id -> (TierService,
        # TierAgent); the TIER_* health checks register lazily with the
        # first tier (the enable_recovery_scheduler discipline)
        self.tiers: dict[int, tuple] = {}
        # telemetry spine (mgr/stats + mgr/health + flight recorder):
        # status() renders the stats digest, health() is a thin view over
        # the check engine, and any check entering WARN/ERR snapshots a
        # flight bundle (to data_dir/flight in durable mode)
        self._init_telemetry()

    def _init_telemetry(self) -> None:
        from .common.clusterlog import ClusterLog
        from .common.flight_recorder import FlightRecorder
        from .mgr.health import HealthCheckEngine
        from .mgr.heat import HeatTracker
        from .mgr.stats import StatsAggregator
        from .mgr.timeseries import TimeSeriesRing
        self.stats = StatsAggregator(cct=self.cct,
                                     name=f"c{self.cluster_id}")
        self.flight = FlightRecorder(
            cct=self.cct,
            out_dir=(self.data_dir / "flight")
            if self.data_dir is not None else None,
            capacity=self.cct.conf.get("mgr_flight_capacity"))
        self.health_engine = HealthCheckEngine(
            name=f"c{self.cluster_id}", cct=self.cct,
            on_transition=self._on_health_transition,
            on_clear=self._on_health_clear)
        # the cluster log (clog analog): the dozen human-readable lines
        # an incident reads first, persisted under <data_dir>/clusterlog
        # so `ceph -w` can follow from another process
        self.clusterlog = ClusterLog(
            cct=self.cct,
            path=(self.data_dir / "clusterlog")
            if self.data_dir is not None else None)
        # workload heat maps over the stats window, scoped to this
        # cluster's PG collections by the c<id> tag
        self.heat = HeatTracker(self.stats, self._heat_topology,
                                name=f"c{self.cluster_id}",
                                tag=f"c{self.cluster_id}")
        # the embedded time-series ring: status() ticks it; flight
        # bundles carry it; ts_report reads it post-hoc
        self.ts = TimeSeriesRing(cct=self.cct)
        self.ts.add_source("stats", self.stats.digest_flat)
        self.ts.add_source("heat", self.heat.flat_series)
        from .common import roofline
        self.ts.add_source("efficiency", roofline.flat_series)
        # critical-path latency decomposition + SLO burn engine
        # (common/critpath.py + mgr/slo.py): status() folds completed
        # traces into per-class phase attribution; the SLO tracker
        # judges them against slo_<class>_p99_ms objectives
        from .common.critpath import CritPathLedger
        from .mgr.slo import SLOTracker
        self.critpath = CritPathLedger(cct=self.cct,
                                       name=f"c{self.cluster_id}")
        self.slo = SLOTracker(self.critpath, cct=self.cct,
                              name=f"c{self.cluster_id}")
        self.ts.add_source("slo", self.slo.flat_series)
        # torch.profiler capture windows (common/profiler_capture.py):
        # `device profile start|stop|status` plus a rate-limited one-shot
        # auto-capture on any WARN/ERR health transition.  Durable mode
        # only (captures need a disk home under <data_dir>/profiles).
        from .common.profiler_capture import ProfilerCapture
        self.profiler = ProfilerCapture(
            cct=self.cct,
            out_dir=(self.data_dir / "profiles")
            if self.data_dir is not None else None)
        self.profiler.register_admin()
        self._register_health_checks()
        # OSD up/down land in the cluster log the moment the bus flips
        # (the mon's "osd.3 down" clog lines)
        self.bus.down_listeners.append(
            lambda osd: self.clusterlog.warn(f"osd.{osd} down",
                                             channel="osd"))
        self.bus.up_listeners.append(
            lambda osd: self.clusterlog.info(f"osd.{osd} up",
                                             channel="osd"))
        # transition-triggered dumps see the evaluation already cached;
        # MANUAL dumps (admin/CLI) on a process that never ran health()
        # fall back to a read-only evaluation (no hooks — evaluating
        # inside a dump must not recurse into another dump)
        self.flight.add_source(
            "health", lambda: self.health_engine.last_evaluation
            or self.health_engine.evaluate(fire_transitions=False))
        self.flight.add_source("stats", lambda: self.stats.digest())
        self.flight.add_source("wire", self.wire.dump)
        self.flight.add_source("heat", self.heat.dump)
        self.flight.add_source("clusterlog", self.clusterlog.dump)
        self.flight.add_source("timeseries", self.ts.dump)
        self.flight.add_source("efficiency", roofline.snapshot)
        # a WARN/ERR bundle must answer "which phase blew the budget"
        # from the artifact alone: both the SLO state and the raw
        # per-class attribution ride every capture (the fold runs first
        # so the bundle carries traces completed right up to the dump)
        self.flight.add_source("slo", self._slo_flight_source)
        self.flight.register_admin()
        # slo status/dump admin commands (takeover-register, the flight
        # recorder's idiom: newest owner of the shared name wins)
        def _slo_status(**kw):
            self.critpath.refresh()
            return self.slo.status()

        def _slo_dump(**kw):
            return self._slo_flight_source()
        self._slo_admin_fns = {"slo status": _slo_status,
                               "slo dump": _slo_dump}
        for cmd, desc in (
                ("slo status",
                 "per-class latency objectives, burn rates, and "
                 "critical-path phase attribution"),
                ("slo dump",
                 "full SLO + critical-path ledger snapshot (JSON)")):
            self.cct.admin_socket.unregister(cmd)
            self.cct.admin_socket.register(cmd, self._slo_admin_fns[cmd],
                                           desc)

        # object-granularity heat (the tier agent's promotion surface):
        # `heat top [n]` folds the per-PG hit sets into a bounded top-N
        # hot-object digest (mgr/heat.py:top_objects)
        def _heat_top(n=20, **kw):
            from .mgr.heat import top_objects
            return {"top": top_objects(self, int(n))}
        self._slo_admin_fns["heat top"] = _heat_top
        self.cct.admin_socket.unregister("heat top")
        self.cct.admin_socket.register(
            "heat top", _heat_top,
            "top-N hottest objects by hit-set membership "
            "(object-granularity heat under the PG/OSD maps)")

    def _slo_flight_source(self) -> dict:
        self.critpath.refresh()
        return self.slo.dump()

    def _heat_topology(self) -> dict:
        """The heat tracker's placement view: pg -> primary + acting."""
        return {str(g.pgid): {"primary": g.backend.whoami,
                              "acting": list(g.acting)}
                for p in self.pools.values()
                for g in p["pgs"].values()}

    def _on_health_transition(self, key, info, evaluation) -> None:
        """A check newly raised or escalated: capture the run-up NOW
        (tracer ring + perf + health + stats), while the state that
        tripped it is still live — and log the transition where a human
        will read it."""
        msg = f"health check {key} raised: {info['summary']}"
        sev = "ERR" if info["severity"] == "HEALTH_ERR" else "WRN"
        # a fresh process's engine re-fires STANDING checks as new
        # transitions (its prior state is empty), and the clusterlog ring
        # persists across reopens: only log when this key's latest
        # persisted line differs (message OR severity — an escalation
        # with an unchanged summary still logs), so `ceph -s` in a loop
        # against an unhealthy cluster doesn't bury the history in
        # duplicates.  Genuine raise/clear/raise cycles log every time:
        # the "cleared" line (on_clear below) breaks the dedup chain.
        prior = self._last_health_line(key)
        if prior is None or prior["message"] != msg \
                or prior.get("severity") != sev:
            self.clusterlog.log(sev, msg, channel="health")
        self.flight.dump(reason=f"health-{key}-{info['severity']}")
        # one bounded profiler capture per anomaly (cooldown-gated inside:
        # a flapping check must not churn the process-global profiler)
        self.profiler.auto_capture(reason=f"{key}-{info['severity']}")

    def _last_health_line(self, key: str) -> dict | None:
        return next((e for e in reversed(self.clusterlog.dump())
                     if e.get("channel") == "health"
                     and e["message"].startswith(f"health check {key} ")),
                    None)

    def _on_health_clear(self, key, evaluation) -> None:
        """A raised check stopped reporting: one INF line — but only if
        the raise itself was logged (muted checks never were), and only
        once (the dedup mirror of _on_health_transition)."""
        msg = f"health check {key} cleared"
        prior = self._last_health_line(key)
        if prior is not None and prior["message"] != msg:
            self.clusterlog.info(msg, channel="health")

    def _register_health_checks(self) -> None:
        """The named check set (mon/health_check.h keys where the concept
        matches).  Cluster-shape checks close over self; the generic
        perf-surface checks come from mgr.health factories."""
        from .mgr.health import (CheckResult, HEALTH_ERR,
                                 recompile_storm_check, slow_ops_check,
                                 throttle_saturated_check)
        eng = self.health_engine

        def osd_down():
            down = [o for o in range(self.osdmap.max_osd)
                    if not self.osdmap.is_up(o)]
            if down:
                return CheckResult(
                    f"{len(down)} osds down",
                    detail=[f"osd.{o} is down" for o in down],
                    count=len(down))
            return None

        # ONE per-PG state walk per evaluation, shared by the two state
        # checks (keyed on the engine's eval_seq — without the memo every
        # health()/scrape would re-classify every PG once per check)
        walk = {"seq": -1, "states": {}}

        def _pgs_in_state(state: str) -> list[str]:
            if walk["seq"] != eng.eval_seq:
                states: dict[str, list[str]] = {}
                for p in self.pools.values():
                    for g in p["pgs"].values():
                        states.setdefault(self.pg_state(g),
                                          []).append(repr(g.pgid))
                walk["seq"] = eng.eval_seq
                walk["states"] = states
            return walk["states"].get(state, [])

        def pg_degraded():
            pgs = _pgs_in_state("active+degraded")
            if pgs:
                return CheckResult(
                    f"{len(pgs)} pgs degraded",
                    detail=[f"pg {pgid} is active+degraded"
                            for pgid in pgs], count=len(pgs))
            return None

        def pg_availability():
            pgs = _pgs_in_state("inactive")
            if pgs:
                return CheckResult(
                    f"{len(pgs)} pgs inactive",
                    detail=[f"pg {pgid} is inactive (< min_size current "
                            f"shards)" for pgid in pgs], count=len(pgs))
            return None

        def object_damaged():
            oids = [f"{pid}/{oid}" for pid, p in self.pools.items()
                    for g in p["pgs"].values()
                    for oid in sorted(getattr(g.backend,
                                              "inconsistent_objects", ()))]
            if oids:
                return CheckResult(
                    f"{len(oids)} objects with unlocatable inconsistency",
                    detail=oids, count=len(oids))
            return None

        eng.register("OSD_DOWN", osd_down,
                     description="one or more OSDs are marked down")
        eng.register("PG_DEGRADED", pg_degraded,
                     description="PGs serving with fewer than size "
                                 "current shards")
        eng.register("PG_AVAILABILITY", pg_availability,
                     severity=HEALTH_ERR,
                     description="PGs below min_size: writes blocked")
        eng.register("OBJECT_DAMAGED", object_damaged,
                     description="objects flagged inconsistent with no "
                                 "locatable bad shard")
        eng.register("SLOW_OPS", slow_ops_check(self.stats),
                     description="ops exceeded osd_op_complaint_time "
                                 "within the stats window")
        eng.register("THROTTLE_SATURATED",
                     throttle_saturated_check(self.cct),
                     description="an admission throttle is pinned near "
                                 "its limit (sustained backpressure)")
        eng.register("RECOMPILE_STORM",
                     recompile_storm_check(self.cct, self.stats),
                     description="jit compilations within the stats "
                                 "window exceeded the storm threshold")
        from .mgr.heat import hot_shard_check
        eng.register("HOT_SHARD", hot_shard_check(self.heat, self.cct),
                     description="one OSD's primary-op load is a "
                                 "sustained multiple of the median "
                                 "(hot-shard workload skew)")
        from .mgr.health import hbm_pressure_check
        eng.register("HBM_PRESSURE",
                     hbm_pressure_check(self.cct),
                     description="a device's high-water memory mark is "
                                 "pinned near its capacity (guarded "
                                 "watermark sampler: silent on backends "
                                 "without memory stats)")
        from .mgr.health import device_degraded_check, osd_flapping_check
        eng.register("DEVICE_DEGRADED", device_degraded_check(),
                     description="a codec pipeline circuit-broke its "
                                 "device path: batches fail fast until "
                                 "half-open probes re-close the breaker")
        eng.register("OSD_FLAPPING",
                     osd_flapping_check(
                         lambda: getattr(getattr(self, "monitor", None),
                                         "markdown", None)),
                     description="an OSD was marked down too often "
                                 "within osd_markdown_window: boots are "
                                 "damped until the operator clears the "
                                 "markdown record")
        from .mgr.slo import slo_burn_check, slo_exhausted_check
        eng.register("SLO_BURN", slo_burn_check(self.slo),
                     description="a class's latency error budget is "
                                 "burning past slo_burn_rate_threshold "
                                 "in BOTH burn windows (fast+slow "
                                 "agreement: a blip does not page, a "
                                 "sustained burn does)")
        eng.register("SLO_EXHAUSTED", slo_exhausted_check(self.slo),
                     severity=HEALTH_ERR,
                     description="a class's slow-window burn rate says "
                                 "the latency error budget is gone "
                                 "(slo_exhausted_burn_rate)")

    def enable_serving(self, start: bool = False, **kw):
        """Attach a :class:`~ceph_tpu_torch.exec.ServingEngine` (its CUDA
        codec pipeline) to every EC
        backend (current and future pools): their encode/decode
        dispatches then flow through throttled admission and the op
        coalescer.  ``start=True`` runs it threaded (deadline batching
        across concurrent submitters); the default single-thread mode
        keeps the cluster deterministic — ops coalesce when submitted in
        bursts and flush inline otherwise."""
        from .exec import ServingEngine
        kw.setdefault("name", f"serving.c{self.cluster_id}")
        self.serving = ServingEngine(cct=self.cct, **kw)
        if start:
            self.serving.start()
        for pool in self.pools.values():
            if pool["ec"] is not None:
                for g in pool["pgs"].values():
                    g.backend.attach_serving(self.serving)
        return self.serving

    def enable_recovery_scheduler(self, **kw):
        """Attach a :class:`~ceph_tpu_torch.recovery.RecoveryScheduler` to
        every PG backend (current and future pools): shard revival,
        peering activation, and stalled-recovery re-drives then route
        through per-OSD local+remote reservations (``osd_max_backfills``),
        Ceph-style priorities, and byte-rate-capped waves whose degraded
        objects reconstruct through one batched decode dispatch."""
        from .recovery import RecoveryScheduler
        if self.recovery is None:
            kw.setdefault("name", f"c{self.cluster_id}")
            self.recovery = RecoveryScheduler(cct=self.cct, **kw)
            # recovery start/finish lines land in the cluster log
            self.recovery.clog = self.clusterlog
            from .mgr.health import pg_recovery_stalled_check
            self.health_engine.register(
                "PG_RECOVERY_STALLED",
                pg_recovery_stalled_check(self.stats,
                                          lambda: self.recovery),
                description="degraded PGs queued for recovery but no "
                            "reservation is progressing")
        for pool in self.pools.values():
            for g in pool["pgs"].values():
                self._attach_recovery(g, pool["pool"])
        return self.recovery

    def _attach_recovery(self, g: PGGroup, pool: Pool) -> None:
        # chain planning is topology-aware: osd -> host bucket, the same
        # layout the crush map above was built with
        g.backend.osd_locations = {o: o // self.osds_per_host
                                   for o in range(self.n_osds)}
        self.recovery.attach_backend(
            g.backend, pgid=g.pgid, daemon=self.osds[g.backend.whoami],
            pool_params=pool.params)

    # -- cache tiering (tier/) ---------------------------------------------

    def create_tier(self, cache_pool: int, base_pool: int, *,
                    mode: str = "writeback", frontend=None):
        """Bind a replicated cache pool over an EC base pool (the mon's
        ``osd tier add`` + ``cache-mode``): returns the
        :class:`~ceph_tpu_torch.tier.TierService` with its flush/evict
        agent attached as ``.agent``.  The ``TIER_FULL`` /
        ``TIER_FLUSH_BACKLOG`` health checks and the ``tier status``
        admin command register with the FIRST tier (lazily, the
        enable_recovery_scheduler discipline: clusters without tiering
        never evaluate them).  ``frontend`` (a
        :class:`~ceph_tpu_torch.msg.frontend.ShardedFrontend`) admits the
        tier's hits through its shed ladder."""
        from .tier import TierAgent, TierService
        if cache_pool in self.tiers:
            raise ValueError(f"pool {cache_pool} is already a cache tier")
        svc = TierService(self, cache_pool, base_pool, mode=mode,
                          frontend=frontend,
                          name=f"c{self.cluster_id}.p{cache_pool}")
        svc.agent = TierAgent(svc)
        first = not self.tiers
        self.tiers[cache_pool] = (svc, svc.agent)
        if first:
            from .mgr.health import (tier_flush_backlog_check,
                                     tier_full_check)
            self.health_engine.register(
                "TIER_FULL", tier_full_check(lambda: self.tiers),
                description="a cache tier's residency is at/over its "
                            "tier_full_ratio watermark")
            self.health_engine.register(
                "TIER_FLUSH_BACKLOG",
                tier_flush_backlog_check(lambda: self.tiers),
                description="a tier agent keeps ending its passes over "
                            "tier_dirty_ratio_high: the base pool is "
                            "not absorbing flushes fast enough")

            def _tier_status(**kw):
                return {str(pid): s.stats()
                        for pid, (s, _a) in sorted(self.tiers.items())}
            self._slo_admin_fns["tier status"] = _tier_status
            self.cct.admin_socket.unregister("tier status")
            self.cct.admin_socket.register(
                "tier status", _tier_status,
                "per-tier cache mode, residency, hit rate, and "
                "promotion/flush/evict counters")
        self.clusterlog.info(
            f"pool {cache_pool} is now a {mode} cache tier over pool "
            f"{base_pool}", channel="mon")
        return svc

    # -- pool parameter updates (the mon's 'osd pool set') ------------------

    def pool_set(self, pool_id: int, key: str, value) -> None:
        """``ceph osd pool set <pool> <key> <value>``: update one pool
        param LIVE and persist it.  The ``hit_set_*`` family re-arms
        per-PG hit-set accumulation in place (the observer hook pool
        params get in lieu of ConfigProxy observers): the accumulating
        set restarts under the new geometry, the persisted archive ring
        is resumed, and ``hit_set_count 0`` disarms tracking."""
        if pool_id not in self.pools:
            raise KeyError(f"no pool {pool_id}")
        pool = self.pools[pool_id]["pool"]
        pool.params[key] = str(value)
        if key in ("hit_set_count", "hit_set_period",
                   "hit_set_target_size", "hit_set_fpp"):
            for g in self.pools[pool_id]["pgs"].values():
                if int(pool.params.get("hit_set_count", 0)) > 0:
                    self._arm_hit_sets(g, pool)
                else:
                    g.engine.hit_set = None
                    g.engine.hit_set_params = None
        self.clusterlog.info(
            f"pool '{pool.name}' set {key} = {value}", channel="mon")
        self._save_meta()

    # -- fault injection (failure/) ----------------------------------------

    def inject_faults(self, plan=None):
        """Arm (or, with ``None``, disarm) cluster-wide fault injection
        from ONE seeded :class:`~ceph_tpu_torch.failure.config.FaultPlan`:

        - the bus plane drives the shared MessageBus (reorder/dup/drop,
          stamping its events into the campaign log);
        - the store plane wraps every PG shard store in a
          :class:`~ceph_tpu_torch.failure.store.FaultyStore` (EIO / torn
          writes / slow reads);
        - the device plane rides the serving/recovery pipelines when
          those subsystems are enabled.

        The TRANSPORT plane lives on the :class:`~ceph_tpu_torch.net.
        ClusterServer` (``server.inject_faults(cluster.fault_injector)``)
        — the sockets are its, not ours.  Returns the :class:`~ceph_tpu_torch.failure.injector.FaultInjector`
        (or None)."""
        from .failure import FaultInjector
        from .failure.store import FaultyStore, unwrap
        if plan is None:
            self.bus.inject_faults(None)
            self.bus.fault_log = None
            for g in (g for p in self.pools.values()
                      for g in p["pgs"].values()):
                for h in g.bus.handlers.values():
                    st = getattr(h, "store", None)
                    if isinstance(st, FaultyStore):
                        h.store = unwrap(st)
            if self.serving is not None:
                self.serving.inject_device_faults(None)
            if self.recovery is not None:
                self.recovery.inject_device_faults(None)
            old, self.fault_injector = self.fault_injector, None
            if old is not None:
                old.close()
            return None
        if self.fault_injector is not None:
            # re-arming with a new plan: disarm first, so store wrappers
            # rebind to the NEW injector (stale wrappers would keep
            # rolling the old plan's faults into the old event log) and
            # the old perf collection is released before its replacement
            # registers under the same name
            self.inject_faults(None)
        inj = FaultInjector(plan, clusterlog=self.clusterlog,
                            cct=self.cct, name=f"c{self.cluster_id}")
        self.fault_injector = inj
        self.bus.inject_faults(plan)
        self.bus.fault_log = inj.record
        for g in (g for p in self.pools.values()
                  for g in p["pgs"].values()):
            self._wrap_stores(g, inj)
        if self.serving is not None:
            self.serving.inject_device_faults(inj)
        if self.recovery is not None:
            self.recovery.inject_device_faults(inj)
        self.clusterlog.info(
            f"fault injection armed (seed {plan.seed})", channel="faults")
        return inj

    @staticmethod
    def _wrap_stores(g: PGGroup, injector) -> None:
        """Every shard store of one PG behind a FaultyStore (idempotent:
        an already-wrapped store is left alone)."""
        from .failure.store import FaultyStore
        for shard, h in g.bus.handlers.items():
            st = getattr(h, "store", None)
            if st is not None and not isinstance(st, FaultyStore):
                h.store = FaultyStore(st, injector,
                                      target=f"osd.{shard}/{g.pgid}")

    # -- pool creation (the mon's osd pool create path) --------------------

    def create_ec_pool(self, name: str, profile: dict | None = None,
                      pg_num: int = 8) -> int:
        profile = dict(profile or {})
        profile.setdefault("plugin", "torch_rs")
        profile.setdefault("k", "4")
        profile.setdefault("m", "2")
        plugin = profile["plugin"]
        ec = ErasureCodePluginRegistry.instance().factory(
            plugin, "", dict(profile))
        n = ec.get_chunk_count()
        # ErasureCode::create_rule semantics: chooseleaf indep over hosts
        # when enough hosts exist, else osds (ErasureCode.cc:64-83); a
        # crush-device-class profile key routes the take through the
        # per-class shadow tree (ErasureCode.cc:44-62 parses it)
        root = self.osdmap.crush.take_with_class(
            "default", profile.get("crush-device-class", ""))
        n_hosts = sum(1 for bid, b in self.osdmap.crush.buckets.items()
                      if b.type == 1 and not self.osdmap.crush.is_shadow(bid))
        ftype = 1 if n_hosts >= n else 0
        ruleno = self.osdmap.crush.add_rule(
            [(CRUSH_RULE_TAKE, root, 0),
             (CRUSH_RULE_CHOOSELEAF_INDEP, n, ftype),
             (CRUSH_RULE_EMIT, 0, 0)])
        pool_id = self._next_pool
        self._next_pool += 1
        pool = Pool(pool_id=pool_id, type=POOL_TYPE_ERASURE, size=n,
                    min_size=ec.get_data_chunk_count() + 1, pg_num=pg_num,
                    crush_rule=ruleno, name=name,
                    erasure_code_profile=" ".join(
                        f"{k}={v}" for k, v in sorted(profile.items())),
                    params=dict(profile))
        return self._instantiate_pool(pool, name, ec)

    def create_replicated_pool(self, name: str, size: int = 3,
                               pg_num: int = 8,
                               params: dict | None = None) -> int:
        """Replicated pool: ``size`` full copies, min_size = size//2 + 1
        (the mon's defaults for ``osd pool create ... replicated``);
        CRUSH chooses hosts firstn the way replicated rules do.
        ``params`` carries pool options (hit_set_count/hit_set_period
        arm cache-tier hit sets)."""
        root = self.osdmap.crush.item_id("default")
        n_hosts = sum(1 for bid, b in self.osdmap.crush.buckets.items()
                      if b.type == 1 and not self.osdmap.crush.is_shadow(bid))
        ftype = 1 if n_hosts >= size else 0
        ruleno = self.osdmap.crush.add_rule(
            [(CRUSH_RULE_TAKE, root, 0),
             (CRUSH_RULE_CHOOSELEAF_FIRSTN, size, ftype),
             (CRUSH_RULE_EMIT, 0, 0)])
        pool_id = self._next_pool
        self._next_pool += 1
        pool = Pool(pool_id=pool_id, type=POOL_TYPE_REPLICATED, size=size,
                    min_size=size // 2 + 1, pg_num=pg_num,
                    crush_rule=ruleno, name=name,
                    params={"size": str(size), **(params or {})})
        return self._instantiate_pool(pool, name, None)

    def _instantiate_pool(self, pool: Pool, name: str, ec) -> int:
        self.osdmap.add_pool(pool)
        pgs = {}
        for ps in range(pool.pg_num):
            pgid = PG(pool.pool_id, ps)
            up, up_primary, acting, _ = self.osdmap.pg_to_up_acting_osds(pgid)
            if not acting or any(a == 0x7FFFFFFF for a in acting):
                raise RuntimeError(
                    f"pg {pgid} not fully mapped (acting={acting}); "
                    f"add OSDs or shrink the pool size")
            pgs[ps] = PGGroup(pgid, acting, ec, self.chunk_size, self.cct,
                              name_prefix=f"c{self.cluster_id}",
                              min_size=pool.min_size,
                              store_factory=self._store_factory(
                                  pool.pool_id, ps),
                              epoch=self.osdmap.epoch,
                              bus=self.bus)
            self.osds[acting[0]].register_pg(pgid, pgs[ps])
            self._arm_hit_sets(pgs[ps], pool)
            if self.serving is not None and ec is not None:
                pgs[ps].backend.attach_serving(self.serving)
            if self.recovery is not None:
                self._attach_recovery(pgs[ps], pool)
            if self.fault_injector is not None:
                # the store plane covers pools created mid-campaign too
                self._wrap_stores(pgs[ps], self.fault_injector)
        self.pools[pool.pool_id] = {"pool": pool, "pgs": pgs, "ec": ec}
        self.pool_ids[name] = pool.pool_id
        if not getattr(self, "_restoring", False):
            # reopens restore pools through this same path: only a
            # GENUINELY new pool is a cluster-log event (a "created"
            # line per reopen would bury the real history)
            self.clusterlog.info(
                f"pool '{name}' created (id {pool.pool_id}, "
                f"{'ec' if ec is not None else 'replicated'}, "
                f"{pool.pg_num} pgs)", channel="mon")
        self._save_meta()
        return pool.pool_id

    @staticmethod
    def _arm_hit_sets(g: PGGroup, pool: Pool) -> None:
        """hit_set_count/hit_set_period pool params arm per-PG hit-set
        accumulation (PrimaryLogPG::hit_set_setup; the tiering agent's
        temperature source).  Called at pool creation AND after a remap
        rebuilds the PGGroup — the new engine would otherwise silently
        stop tracking and the agent would evict its whole working set."""
        hs_count = int(pool.params.get("hit_set_count", 0))
        if hs_count > 0:
            g.engine.configure_hit_sets(
                hs_count, int(pool.params.get("hit_set_period", 100)),
                int(pool.params.get("hit_set_target_size", 1000)),
                float(pool.params.get("hit_set_fpp", 0.05)))

    # -- daemons, stores and durability (data_dir mode) ------------------

    def _drain_live_daemons(self) -> None:
        """Run every live OSD's queued client ops (dead OSDs stay
        parked); hooked into the shared bus's deliver_all so 'deliver
        everything' includes daemon queues."""
        for osd, daemon in self.osds.items():
            if osd not in self.bus.down:
                daemon.drain()

    def _store_factory(self, pool_id: int, ps: int):
        """Every (PG, shard) store is a Collection inside the hosting
        OSD's ONE shared store — shared WAL ordering, one checkpoint, one
        restart recovering every hosted PG (reference: OSD.cc:3971
        load_pgs over a single ObjectStore)."""
        from .backend.collection import Collection

        def factory(osd, _pid=pool_id, _ps=ps):
            return Collection(self.osds[osd].store, f"pg.{_pid}.{_ps}")
        return factory

    def _osd_store(self, osd: int):
        """The OSD's single ObjectStore: superblock at the root namespace,
        PG shards as collections (FileStore or BlueStore-lite in durable
        mode, per ``store_backend``)."""
        if self.data_dir is None:
            from .backend.memstore import MemStore
            return MemStore()
        if self.store_backend == "bluestore":
            from .backend.bluestore import BlueStoreLite
            return BlueStoreLite(self.data_dir / f"osd.{osd}" / "store")
        from .backend.filestore import FileStore
        return FileStore(self.data_dir / f"osd.{osd}" / "store")

    def _save_meta(self) -> None:
        """Persist what cannot be rebuilt from the shard stores: the pool
        definitions (the mon's role; object bookkeeping is rediscovered
        from the primaries' stores at load)."""
        if self.data_dir is None:
            return
        import os
        import pickle
        self.data_dir.mkdir(parents=True, exist_ok=True)
        meta = {
            "n_osds": self.n_osds,
            "osds_per_host": self.osds_per_host,
            "chunk_size": self.chunk_size,
            "store_backend": self.store_backend,
            # operator state the data path cannot rebuild: muted health
            # checks survive a reopen (the mon persists mutes the same way)
            "health_mutes": sorted(self.health_engine.muted),
            "pools": [{"name": p["pool"].name,
                       "type": p["pool"].type,
                       "size": p["pool"].size,
                       "params": dict(p["pool"].params),
                       "pg_num": p["pool"].pg_num,
                       "snap_seq": p["pool"].snap_seq,
                       "snaps": dict(p["pool"].snaps),
                       "removed_snaps": set(p["pool"].removed_snaps)}
                      for _, p in sorted(self.pools.items())],
        }
        tmp = self.data_dir / "cluster_meta.pkl.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(meta, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, self.data_dir / "cluster_meta.pkl")

    @classmethod
    def load(cls, data_dir, cct: Context | None = None) -> "MiniCluster":
        """Reopen a durable cluster: rebuild the maps from the persisted
        pool definitions (deterministic CRUSH -> identical placements),
        reopen every shard's FileStore, replay PG logs (OSDShard boot),
        and run a boot-time repair pass so any shard that restarted stale
        catches up through the ordinary log path before serving."""
        import pickle
        from pathlib import Path
        with open(Path(data_dir) / "cluster_meta.pkl", "rb") as f:
            meta = pickle.load(f)
        c = cls(n_osds=meta["n_osds"], osds_per_host=meta["osds_per_host"],
                chunk_size=meta["chunk_size"], cct=cct, data_dir=data_dir,
                store_backend=meta.get("store_backend", "file"))
        for key in meta.get("health_mutes", ()):
            c.health_engine.mute(key)
        c._restoring = True
        try:
            for p in meta["pools"]:
                if p["type"] == POOL_TYPE_REPLICATED:
                    pid = c.create_replicated_pool(p["name"], p["size"],
                                                   p["pg_num"],
                                                   params=p.get("params"))
                else:
                    pid = c.create_ec_pool(p["name"], p["params"],
                                           p["pg_num"])
                pool = c.pools[pid]["pool"]
                pool.snap_seq = p.get("snap_seq", 0)
                pool.snaps = dict(p.get("snaps", {}))
                pool.removed_snaps = set(p.get("removed_snaps", ()))
        finally:
            c._restoring = False
        # re-persist: pool creation above rewrote the meta file BEFORE the
        # snap fields were restored; without this, the next process would
        # load a cluster whose pool snaps were silently wiped
        c._save_meta()
        for pid, pool in c.pools.items():
            for g in pool["pgs"].values():
                # crash recovery first: elect the authoritative log and
                # roll back any write persisted on < min_size shards (it
                # was never acked); only then repair stale shards
                g.backend.start_boot_peering()
                g.bus.deliver_all()
                from .osd.hit_set import is_hit_set_oid
                from .osd.primary_log_pg import is_clone_oid
                c.objects.setdefault(pid, set()).update(
                    o for o in g.backend._local_oids()
                    if not is_clone_oid(o) and not is_hit_set_oid(o))
                for osd in g.acting:
                    if osd != g.backend.whoami:
                        g.backend.start_shard_repair(osd)
                # the primary itself may have restarted stale (peering
                # adopted a peer's log): repair its own shard too
                if g.backend.local_shard.pg_log.head < g.backend.pg_log.head:
                    g.backend.start_shard_repair(g.backend.whoami)
                g.bus.deliver_all()
        return c

    # -- object placement (librados object_locator -> pg) ------------------

    def object_pg(self, pool_id: int, oid: str) -> int:
        pool = self.pools[pool_id]["pool"]
        ps = ceph_str_hash_rjenkins(oid)
        return ceph_stable_mod(ps, pool.pg_num, pool.pg_num_mask)

    def pg_group(self, pool_id: int, oid: str) -> PGGroup:
        return self.pools[pool_id]["pgs"][self.object_pg(pool_id, oid)]

    # -- client I/O --------------------------------------------------------

    def put(self, pool_id: int, oid: str, data: bytes,
            deliver: bool = True, wait: bool = True,
            on_commit=None) -> PGGroup:
        """Write ``oid``.  With ``wait`` (default), raises BlockedWriteError
        if the PG is inactive (< min_size current shards) — the op stays
        queued and commits when shards return, exactly like a blocked
        client op on an inactive reference PG.  ``on_commit`` fires when
        (possibly much later) the write is durable on min_size shards."""
        g = self.pg_group(pool_id, oid)
        sinfo = getattr(g.backend, "sinfo", None)
        pad = (-len(data)) % sinfo.stripe_width if sinfo is not None else 0
        done: list[int] = []

        def _committed(tid):
            done.append(tid)
            if on_commit:
                on_commit(tid)
        if self.pools[pool_id]["pool"].snap_seq:
            # pool snapshots exist: the write MUST run through the op
            # engine so make_writable clones the head at snap boundaries
            # (bypassing it would silently break snapshot isolation)
            from .osd.osd_ops import ObjectOperation
            failed: list[int] = []
            sync_phase = [True]      # until put() has checked `failed`

            def _snap_done(reply):
                # an error reply is NOT a committed write: surface it like
                # operate() does instead of silently acking the put
                if reply.result < 0:
                    if sync_phase[0] and deliver:
                        failed.append(reply.result)
                    else:
                        # the reply arrived AFTER put() returned (batched
                        # deliver=False op, or a blocked write completing
                        # once shards came back).  Raising here would
                        # unwind through the op engine's _finish and
                        # strand the daemon queue, so park the error for
                        # deliver_all() to surface instead.
                        self._deferred_errors.append(
                            (oid, reply.result,
                             f"put of {oid} failed: result {reply.result}"))
                else:
                    _committed(reply.version)
            res = self._dispatch_op_vector(
                g, pool_id, oid,
                ObjectOperation().write(0, bytes(data) + b"\0" * pad).ops,
                self.osdmap.epoch, _snap_done, drain=deliver)
            sync_phase[0] = False
            if res is not None:
                raise IOError(f"put of {oid} rejected ({res[0]}): {res}")
            if failed:
                err = IOError(f"put of {oid} failed: result {failed[0]}")
                err.errno = failed[0]
                raise err
            if deliver and wait and not done:
                raise BlockedWriteError(
                    f"write of {oid} blocked: PG {g.pgid} inactive")
            return g
        # the fast-path put is still a CLIENT op: root a trace here (the
        # MOSDOp dispatch edge does the same) so the sub-writes it fans
        # out attribute their wire bytes to the client class
        from .common.tracer import root_or_ambient
        with root_or_ambient("client"):
            g.backend.submit_transaction(
                PGTransaction().write(oid, 0, bytes(data) + b"\0" * pad),
                on_commit=_committed)
        self.objects.setdefault(pool_id, set()).add(oid)
        if deliver:
            g.bus.deliver_all()
            if wait and not done:
                raise BlockedWriteError(
                    f"write of {oid} blocked: PG {g.pgid} inactive "
                    f"({len(g.backend.current_shards())} current shards < "
                    f"min_size {g.backend.min_size})")
        return g

    def put_many(self, pool_id: int, objects: dict[str, bytes],
                 wait: bool = True) -> None:
        """Write a batch of objects with ONE device encode dispatch for
        the whole batch, across PGs (ecutil.encode_many — the cross-op
        coalescing SURVEY §3.2 calls the main device restructuring; the
        reference encodes per stripe per op, ECUtil.cc:136-148).
        Replicated pools have nothing to encode and just loop."""
        if not objects:
            return
        pool = self.pools[pool_id]
        if pool["ec"] is None or pool["pool"].snap_seq:
            # replicated: nothing to batch-encode.  Snapped pools: every
            # write must run the op engine's COW (put handles both).
            for oid, data in objects.items():
                self.put(pool_id, oid, data, wait=wait)
            return
        from .backend import ecutil
        order = sorted(objects)
        groups = {oid: self.pg_group(pool_id, oid) for oid in order}
        sinfo = groups[order[0]].backend.sinfo
        padded = {}
        for oid in order:
            data = bytes(objects[oid])
            padded[oid] = data + b"\0" * ((-len(data)) % sinfo.stripe_width)
        encoded = ecutil.encode_many(sinfo, pool["ec"],
                                     [padded[oid] for oid in order])
        done: list[str] = []
        from .common.tracer import root_or_ambient
        with root_or_ambient("client"):
            for oid, enc in zip(order, encoded):
                t = PGTransaction().write(oid, 0, padded[oid])
                objop = t.ops[oid]
                objop.precomputed_chunks = enc
                objop.precomputed_for = padded[oid]
                groups[oid].backend.submit_transaction(
                    t, on_commit=lambda tid, _oid=oid: done.append(_oid))
                self.objects.setdefault(pool_id, set()).add(oid)
        for g in {id(g): g for g in groups.values()}.values():
            g.bus.deliver_all()
        if wait and len(done) != len(order):
            missing = sorted(set(order) - set(done))
            raise BlockedWriteError(
                f"batch writes blocked on inactive PGs: {missing}")

    def _snap_context(self, pool_id: int):
        """The pool's live SnapContext (what librados attaches to every
        write once pool snaps exist)."""
        from .osd.osd_ops import SnapContext
        pool = self.pools[pool_id]["pool"]
        if not pool.snap_seq:
            return None
        return SnapContext(pool.snap_seq,
                           tuple(sorted(pool.snaps, reverse=True)))

    def _dispatch_op_vector(self, g, pool_id: int, oid: str, ops,
                            epoch: int, on_done, drain: bool = True,
                            snapid: int | None = None,
                            internal: bool = False):
        """ONE copy of the MOSDOp dispatch path (used by operate() and
        the Objecter-facing osd_submit): daemon queue -> op engine, with
        object bookkeeping in the COMPLETION callback — a write parked on
        an inactive PG has not hit the store yet, so bookkeeping at
        dispatch time would let a later backfill drop the acked object.
        Returns None when accepted, or ("stale", current_map)."""
        from .backend.memstore import GObject
        from .osd.osd_ops import MOSDOp, MOSDOpReply
        if snapid is not None and \
                snapid not in self.pools[pool_id]["pool"].snaps:
            # reads at a removed (or never-issued) pool snap are ENOENT
            # even while a shared clone still covers the id for an older
            # live snap (the reference validates against the pool first)
            if on_done:
                on_done(MOSDOpReply(-2, list(ops)))
            return None
        daemon = self.osds[g.backend.whoami]
        primary_dead = g.backend.whoami in g.bus.down
        # every client op gets a trace context here, the MOSDOp dispatch
        # edge: an ambient one (Objecter / net.py RPC / an operate() call
        # inside a traced scope) is adopted, otherwise a fresh client
        # root — so the daemon's spans and every sub-op fanned out below
        # stitch into one cross-daemon trace
        from .common.tracer import default_tracer
        tr = default_tracer()
        trace_ctx = tr.current_ctx() or tr.new_trace("client")

        def _done(reply):
            if g.backend.local_shard.store.exists(
                    GObject(oid, g.backend.whoami)):
                self.objects.setdefault(pool_id, set()).add(oid)
            else:
                self.objects.get(pool_id, set()).discard(oid)
            if on_done:
                on_done(reply)
        m = MOSDOp(oid=oid, ops=ops, epoch=epoch, snapid=snapid,
                   snapc=self._snap_context(pool_id), internal=internal,
                   trace=trace_ctx)
        res = daemon.ms_dispatch(g.pgid, m, _done)
        if res is not None and res[0] == "throttled" and not primary_dead:
            # bounded daemon queue hit (osd_queue_throttle_ops): the
            # cooperative analog of client backoff-and-resend is draining
            # the queue — running the backlog releases its throttle units
            # — then resending once.  Only a DEAD primary's parked queue
            # can stay full past a drain.  Deliberate trade-off: with
            # deliver=False batching, this runs the parked ops early and
            # fragments the batch — when demand overruns the bound,
            # bounded memory wins over maximal coalescing.
            import time as _time
            t0 = _time.monotonic()
            daemon.drain()
            backoff = _time.monotonic() - t0
            # the bounce + drain is this op's backoff-and-resend time:
            # stamped as `retry` phase in its trace
            tr.complete("client.backoff_resend", _time.time() - backoff,
                        backoff, ctx=trace_ctx, oid=oid)
            res = daemon.ms_dispatch(g.pgid, m, _done)
        if res is not None:
            return res
        if drain:
            if primary_dead:
                # a dead OSD executes nothing: the op stays queued on the
                # daemon (BlockedWriteError surface) and runs at the next
                # deliver_all() after revival.  Draining now would let the
                # engine fan out an op whose replies a bus-down primary
                # can never receive — leaking its per-object write slot.
                return None
            daemon.drain()
            g.bus.deliver_all()
        return None

    def operate(self, pool_id: int, oid: str, op,
                deliver: bool = True, snapid: int | None = None,
                internal: bool = False):
        """Execute a librados-style op vector atomically on ``oid``
        through the primary's op engine (IoCtx::operate →
        PrimaryLogPG::do_osd_ops).  Returns the MOSDOpReply; raises
        IOError on a negative overall result.  With ``deliver=False`` the
        op is only queued on the primary's daemon (returns None); the
        caller drains the daemon and delivers the bus itself — batch
        submission, like put(deliver=False)."""
        g = self.pg_group(pool_id, oid)
        out: list = []
        abandoned = [False]

        def _cb(reply):
            if abandoned[0]:
                # the caller got BlockedWriteError and stopped listening:
                # a LATE error reply must not vanish (mirror put()'s
                # _snap_done) — deliver_all() surfaces it
                if reply.result < 0:
                    self._deferred_errors.append(
                        (oid, reply.result,
                         f"op on {oid} failed after revival: "
                         f"result {reply.result}"))
                return
            out.append(reply)
        res = self._dispatch_op_vector(g, pool_id, oid, op.ops,
                                       self.osdmap.epoch, _cb,
                                       drain=deliver, snapid=snapid,
                                       internal=internal)
        if res is not None:
            raise IOError(f"op on {oid} rejected ({res[0]}): {res}")
        if not deliver:
            return None
        if not out:
            abandoned[0] = True
            raise BlockedWriteError(
                f"op on {oid} blocked: PG {g.pgid} inactive")
        reply = out[0]
        if reply.result < 0:
            err = IOError(f"op on {oid} failed: result {reply.result}")
            err.errno = reply.result
            err.reply = reply
            raise err
        return reply

    def get(self, pool_id: int, oid: str, length: int) -> bytes:
        g = self.pg_group(pool_id, oid)
        out = {}
        from .common.tracer import root_or_ambient
        # client-class root (see put): degraded-read sub-reads account
        # their wire bytes to the client that asked for them
        with root_or_ambient("client"):
            g.backend.objects_read_and_reconstruct(
                {oid: [(0, length)]},
                lambda result, errors: out.update(result=result,
                                                  errors=errors))
        g.bus.deliver_all()
        if out.get("errors"):
            raise IOError(out["errors"])
        return out["result"][oid][0][2][:length]

    def deliver_all(self) -> None:
        """Run everything queued: daemon op queues FIRST (batched
        deliver=False ops park there — bus delivery alone would never
        execute them), then every PG bus.  Errors parked by batched op
        replies surface here, where the caller expects completion.
        Daemons of bus-down OSDs stay parked: a dead OSD executes
        nothing until revived."""
        # every PG channel shares ONE cluster bus whose pre-deliver hook
        # drains the live daemons: one call quiesces everything (a per-PG
        # loop would redo the full drain once per PG)
        self.bus.deliver_all()
        if self._deferred_errors:
            oid, result, msg = self._deferred_errors[0]
            rest = len(self._deferred_errors) - 1
            self._deferred_errors.clear()
            err = IOError(msg + (f" (+{rest} more batched errors)"
                                 if rest else ""))
            err.errno = result
            raise err

    @staticmethod
    def pg_state(g: PGGroup) -> str:
        """ONE classification of a PG's serving state, shared by
        status(), health(), and 'ceph pg dump'."""
        current = len(g.backend.current_shards())
        if current < g.backend.min_size:
            return "inactive"
        if current < len(g.acting):
            return "active+degraded"
        return "active+clean"

    def health(self) -> dict:
        """'ceph health' shape: a THIN view over the HealthCheckEngine —
        {"status", "checks": {key: summary}}, muted checks split out
        under "muted" (only when any exist, so the healthy shape stays
        exactly {"status", "checks"})."""
        from .mgr.health import thin_view
        return thin_view(self.health_engine.evaluate())

    def health_detail(self) -> dict:
        """The full engine evaluation (per-check severity + detail lines
        + mute state) — 'ceph health detail' / the flight-recorder
        source."""
        return self.health_engine.evaluate()

    def mute_health(self, key: str) -> None:
        """'ceph health mute <KEY>': mute AND persist in one step — any
        surface that mutes through the engine alone would lose the mute
        at the next reopen."""
        self.health_engine.mute(key)
        self._save_meta()

    def unmute_health(self, key: str) -> None:
        self.health_engine.unmute(key)
        self._save_meta()

    # -- scrub (PG::scrub scheduling through the daemons' op queues) --------

    def scrub_pool(self, pool_id: int, repair: bool = True) -> dict:
        """Deep-scrub every PG of the pool as BG_SCRUB work on the
        primaries' mClock queues (scrubs cannot starve clients), compare
        every shard against the authority, and (with ``repair``) queue
        shard repairs for inconsistencies — the reference's
        'ceph pg deep-scrub' + repair flow.  Returns
        {pgid: {oid: [bad shards]}} with only the inconsistencies."""
        from .osd.mclock import BG_SCRUB
        report: dict = {}
        for g in self.pools[pool_id]["pgs"].values():
            daemon = self.osds[g.backend.whoami]

            def scrub(g=g):
                from .backend.memstore import GObject
                from .backend.pg_backend import PG_META, shard_store
                # the scrub object list is the UNION over every up
                # shard's store: an object whose primary copy is missing
                # must still be scrubbed (the reference compares scrub
                # maps from all shards)
                oids: set[str] = set()
                for shard in g.acting:
                    if shard in g.bus.down:
                        continue
                    store = shard_store(g.bus, shard)
                    oids.update(gobj.oid for gobj in store.list_objects()
                                if gobj.shard == shard
                                and gobj.oid != PG_META)
                bad: dict[str, list[int]] = {}
                scanned: dict[str, int] = {}
                # damaged objects (inconsistent recovery sources) stay in
                # the report until an operator-grade overwrite clears
                # them — a laundered object can scrub "clean" wrongly
                for oid in sorted(getattr(g.backend,
                                          "inconsistent_objects", ())):
                    bad[oid] = sorted(
                        ci for ci, s in enumerate(g.acting)
                        if s not in g.bus.down)
                    scanned[oid] = len(bad[oid])
                for oid in sorted(oids):
                    try:
                        per_shard = g.backend.be_deep_scrub(oid)
                    except (KeyError, FileNotFoundError):
                        # authority state unreadable (e.g. the primary's
                        # copy is gone): fall back to per-shard existence
                        # so recovery still has its healthy sources
                        per_shard = {}
                        for ci, s in enumerate(g.acting):
                            if s in g.bus.down:
                                continue
                            per_shard[ci] = shard_store(g.bus, s).exists(
                                GObject(oid, s))
                    bads = sorted(s for s, ok in per_shard.items() if not ok)
                    if bads and oid not in bad:
                        bad[oid] = bads
                        scanned[oid] = len(per_shard)
                if bad:
                    report[repr(g.pgid)] = bad
                    if repair:
                        # object-level recovery, not log repair: scrub
                        # finds BITROT, which the logs cannot see — the
                        # bad chunks reconstruct from healthy shards and
                        # re-push (be_deep_scrub keys by chunk index).
                        # An UNRECOVERABLE set (every scanned chunk
                        # flagged: ambiguous/multi-chunk rot) stays in
                        # the report — recovery with zero healthy
                        # sources would just park a dead op forever.
                        for oid, chunks in sorted(bad.items()):
                            if len(chunks) >= scanned[oid]:
                                continue
                            g.backend.recover_object(oid, set(chunks))
                        g.bus.deliver_all()
            daemon.queue_background(g.pgid, scrub, op_class=BG_SCRUB)
            daemon.drain()
            g.bus.deliver_all()
        if report:
            self.clusterlog.warn(
                f"deep scrub of pool {pool_id} found inconsistencies in "
                f"{len(report)} pg(s): "
                f"{sum(len(b) for b in report.values())} object(s)",
                channel="scrub")
        return report

    # -- pool snapshots (the mon's 'osd pool mksnap/rmsnap') ----------------

    def create_pool_snap(self, pool_id: int, name: str) -> int:
        """Issue a pool snapshot: bumps snap_seq; subsequent writes carry
        the new SnapContext and COW-clone heads at first touch
        (pg_pool_t::add_snap)."""
        pool = self.pools[pool_id]["pool"]
        if name in pool.snaps.values():
            raise ValueError(f"pool snap {name!r} already exists")
        pool.snap_seq += 1
        pool.snaps[pool.snap_seq] = name
        self._save_meta()
        return pool.snap_seq

    def remove_pool_snap(self, pool_id: int, name: str) -> None:
        """Delete a pool snapshot and queue snaptrim: clone objects of the
        removed snap are deleted by BACKGROUND work riding the daemons'
        mClock queues under BG_SNAPTRIM — trimming cannot starve client
        ops (pg_pool_t::remove_snap + the SnapTrimmer)."""
        from .osd.mclock import BG_SNAPTRIM
        from .osd.primary_log_pg import (SNAP_SEP, SS_ATTR, empty_snapset,
                                         split_clone_oid)
        from .backend.memstore import GObject
        pool = self.pools[pool_id]["pool"]
        snapid = next((s for s, n in pool.snaps.items() if n == name), None)
        if snapid is None:
            raise ValueError(f"no pool snap named {name!r}")
        del pool.snaps[snapid]
        pool.removed_snaps.add(snapid)
        self._save_meta()
        live = set(pool.snaps)
        for g in self.pools[pool_id]["pgs"].values():
            daemon = self.osds[g.backend.whoami]

            def trim(g=g, live=live):
                # A clone with id c covers the snaps in (previous clone,
                # c]; it is removable only when NO live snap remains in
                # that interval (the reference deletes a clone when its
                # per-clone snaps list empties, SnapTrimmer).
                store = g.backend.local_shard.store
                whoami = g.backend.whoami
                t = PGTransaction()
                clones_by_head: dict[str, list[int]] = {}
                for gobj in store.list_objects():
                    if gobj.shard != whoami:
                        continue
                    parsed = split_clone_oid(gobj.oid)
                    if parsed is None:
                        continue
                    head, cid = parsed
                    clones_by_head.setdefault(head, []).append(cid)
                for head, clones in sorted(clones_by_head.items()):
                    clones.sort()
                    keep = []
                    for i, c in enumerate(clones):
                        prev = clones[i - 1] if i else 0
                        if any(prev < s <= c for s in live):
                            keep.append(c)
                            continue
                        t.delete(f"{head}{SNAP_SEP}{c}")
                        # (the delete's wholesale exoneration in the
                        # backend drops any damage flag with the clone)
                    if keep != clones:
                        hobj = GObject(head, whoami)
                        if store.exists(hobj):
                            try:
                                ss = dict(store.getattr(hobj, SS_ATTR))
                            except KeyError:
                                ss = empty_snapset()
                            ss["clones"] = keep
                            ss["sizes"] = {k: v
                                           for k, v in ss["sizes"].items()
                                           if int(k) in keep}
                            t.touch(head).setattr(SS_ATTR, ss)
                if t.ops:
                    g.backend.submit_transaction(t)
                    g.bus.deliver_all()
            daemon.queue_background(g.pgid, trim, op_class=BG_SNAPTRIM)
            daemon.drain()
            g.bus.deliver_all()

    # -- RADOS protocol surface (what an Objecter talks to) ----------------

    def osd_submit(self, pool_id: int, ps: int, target_osd: int,
                   client_epoch: int, oid: str, data: bytes | None,
                   read_len: int = 0, on_done=None, ops=None,
                   snapid: int | None = None, drain: bool = True):
        """One client op arriving at an OSD.  Returns None when accepted
        (completion via ``on_done``), or ``("stale", current_map)`` when
        the client's map is too old for this PG — wrong primary, or an
        epoch predating the PG's current acting set — mirroring the OSD's
        require_same_or_newer_map + "client has old map" resend dance.
        ``ops`` carries an op VECTOR through the daemon queue into the
        primary's op engine (the MOSDOp path); data/read_len are the
        legacy whole-object put/get shape."""
        g = self.pools[pool_id]["pgs"][ps]
        if target_osd != g.backend.whoami or client_epoch < g.epoch:
            return ("stale", self.osdmap)
        if ops is not None:
            res = self._dispatch_op_vector(g, pool_id, oid, ops,
                                           client_epoch, on_done,
                                           snapid=snapid, drain=drain)
            if res is not None:
                return ("stale", self.osdmap)
            return None
        if data is not None:
            # wait=False: an inactive PG parks the op, which stays in the
            # objecter's inflight list until it commits — the reference's
            # blocked-op behavior, not an error
            self.put(pool_id, oid, data, wait=False,
                     on_commit=lambda tid: on_done(len(data))
                     if on_done else None)
        else:
            try:
                on_done(self.get(pool_id, oid, read_len))
            except (IOError, KeyError) as e:
                on_done(e if isinstance(e, IOError) else IOError(str(e)))
        return None

    def shutdown(self) -> None:
        """Unhook every PG backend from the (possibly shared) Context so a
        discarded cluster is collectable and does not shadow later ones;
        durable stores checkpoint and close."""
        if self.serving is not None:
            self.serving.stop()
        if self.recovery is not None:
            self.recovery.close()
        if self.fault_injector is not None:
            self.fault_injector.close()
            self.fault_injector = None
        for svc, _agent in self.tiers.values():
            svc.close()
        self.tiers.clear()
        # telemetry spine down FIRST: a prometheus scrape racing the
        # teardown must not evaluate checks over half-closed PGs
        self.stats.close()
        self.health_engine.close()
        self.heat.close()
        self.clusterlog.close()
        self.flight.close()
        self.profiler.close()
        self.wire.close()
        self.slo.close()
        self.critpath.close()
        for cmd, fn in self._slo_admin_fns.items():
            if self.cct.admin_socket.get(cmd) is fn:
                self.cct.admin_socket.unregister(cmd)
        for p in self.pools.values():
            for g in p["pgs"].values():
                g.shutdown()
        for d in self.osds.values():
            if hasattr(d.store, "close"):
                d.store.close()     # meta_store IS the same store

    # -- control plane -----------------------------------------------------

    def _pg_objects(self, pool_id: int, g: PGGroup) -> list[str]:
        return [oid for oid in sorted(self.objects.get(pool_id, ()))
                if self.pools[pool_id]["pgs"][self.object_pg(pool_id, oid)]
                is g]

    def _repair_after_boot(self, pool_id: int, g: PGGroup,
                           shard: int) -> None:
        """Bring a rebooted shard current BEFORE it serves reads, via the
        PG log: equality is free, missed writes replay in O(missed
        entries), and only a shard past the log horizon pays a full
        backfill (PGLog.cc semantics — replaces the old O(all objects)
        deep scrub on every boot).  A revived primary repairs its own
        store the same way: its local shard log lags the authority log
        by exactly the writes that committed without it."""
        from .backend.ec_backend import RepairState
        rop = g.backend.start_shard_repair(shard)
        g.bus.deliver_all()
        if rop.state != RepairState.COMPLETE:
            raise IOError(
                f"repair of shard {shard} after boot failed: {rop.state}")

    def _backfill_pg(self, pool_id: int, ps: int, new_acting: list[int],
                     ec) -> None:
        """Acting set changed (auto-out remapping): move the PG's data to
        the new layout — read every object through the old group (degraded
        reads reconstruct), re-encode into a fresh group (the reference's
        backfill)."""
        from .common.tracer import default_tracer
        tr = default_tracer()
        self.clusterlog.info(
            f"backfill of pg {pool_id}.{ps:x} -> {new_acting}",
            channel="osd")
        with tr.activate(tr.new_trace("rebalance")), \
                tr.span("backfill.pg", owner="rebalance",
                        pg=f"{pool_id}.{ps}"):
            self._backfill_pg_traced(pool_id, ps, new_acting, ec)

    def _backfill_pg_traced(self, pool_id: int, ps: int,
                            new_acting: list[int], ec) -> None:
        old = self.pools[pool_id]["pgs"][ps]
        damaged = set(getattr(old.backend, "inconsistent_objects", ()))
        # read everything out of the old layout FIRST: in durable mode the
        # new group reopens the same per-(osd, pg) collections, so the old
        # stores must be drained and closed before the new ones open
        from .backend.ecutil import HINFO_KEY
        from .backend.memstore import GObject
        from .backend.replicated import VERSION_KEY
        contents: dict[str, bytes] = {}
        metadata: dict[str, tuple] = {}       # oid -> (attrs, omap, header)
        store = old.backend.local_shard.store
        # ground truth from the primary's own store, not just client
        # bookkeeping: snapshot CLONES are real objects the engine
        # created internally and must move with their heads
        moving = sorted(set(self._pg_objects(pool_id, old)) |
                        set(old.backend._local_oids()))
        for oid in moving:
            size = old.backend.object_size(oid)
            out = {}
            old.backend.objects_read_and_reconstruct(
                {oid: [(0, size)]},
                lambda result, errors: out.update(result=result,
                                                  errors=errors))
            old.bus.deliver_all()
            if out.get("errors"):
                raise IOError(f"backfill read of {oid}: {out['errors']}")
            contents[oid] = out["result"][oid][0][2]
            # object metadata moves with the data: attrs (minus per-layout
            # internals — hinfo is chunk-layout-specific, @version is
            # re-stamped by the new group's log) plus omap on replicated
            gobj = GObject(oid, old.backend.whoami)
            attrs = {k: v for k, v in store.getattrs(gobj).items()
                     if k not in (HINFO_KEY, VERSION_KEY)} \
                if store.exists(gobj) else {}
            omap = store.get_omap(gobj) if ec is None and \
                store.exists(gobj) else {}
            header = store.get_omap_header(gobj) if ec is None and \
                store.exists(gobj) else b""
            metadata[oid] = (attrs, omap, header)
        old.shutdown(discard_stores=self.data_dir is not None)
        # destroy the outgoing incarnation's collections: the new group
        # reuses the same collection name, and OSDs present in BOTH
        # acting sets (or rejoining later) would otherwise boot their
        # shard from the stale incarnation's persisted pg log
        from .backend.collection import Collection
        for osd in old.acting:
            if osd != NONE_ID:
                Collection(self.osds[osd].store,
                           f"pg.{pool_id}.{ps}").destroy()
        new = PGGroup(PG(pool_id, ps), new_acting, ec, self.chunk_size,
                      self.cct, name_prefix=f"c{self.cluster_id}e"
                                            f"{self.osdmap.epoch}",
                      min_size=self.pools[pool_id]["pool"].min_size,
                      store_factory=self._store_factory(pool_id, ps),
                      epoch=self.osdmap.epoch,
                      bus=self.bus)
        for oid, data in contents.items():
            t = PGTransaction().write(oid, 0, data)
            attrs, omap, header = metadata[oid]
            objop = t.ops[oid]
            objop.attr_updates.update(attrs)
            if omap:
                objop.omap_ops.append(("set", omap))
            if header:
                objop.omap_ops.append(("header", header))
            new.backend.submit_transaction(t)
            new.bus.deliver_all()
        # damaged-object state survives the move: the copied bytes may
        # BE the laundered rot, and dropping the flag would let it scrub
        # clean forever without an operator restore
        new.backend.inconsistent_objects |= damaged
        if self.serving is not None and ec is not None:
            new.backend.attach_serving(self.serving)
        if self.recovery is not None:
            self.recovery.cancel_pg(old.backend, reason="backfill remap")
            self._attach_recovery(new, self.pools[pool_id]["pool"])
        self._arm_hit_sets(new, self.pools[pool_id]["pool"])
        self.pools[pool_id]["pgs"][ps] = new
        # re-home the PG on its (possibly new) primary's daemon
        if old.backend.whoami != new.backend.whoami:
            self.osds[old.backend.whoami].pgs.pop(new.pgid, None)
            self.osds[old.backend.whoami].write_superblock()
        self.osds[new.backend.whoami].register_pg(new.pgid, new)

    def attach_monitor(self, n_mons: int = 1):
        """Wire the control plane over this cluster's OSDMap: committed
        epochs propagate to the data path the way daemons react to osdmap
        epoch bumps in the reference — down-marks route around the shard,
        boot-marks repair it before it serves, and weight changes
        (auto-out) backfill PGs onto their new acting sets.

        ``n_mons > 1`` runs a real Paxos quorum (MonCluster): map commits
        then require a monitor majority and survive monitor deaths."""
        from .mon import MonCluster, Monitor
        from .osdmap import OSD_UP
        if n_mons > 1:
            mon = MonCluster(self.osdmap, n_mons=n_mons, cct=self.cct)
        else:
            mon = Monitor(self.osdmap, cct=self.cct)

        def on_map(new_map, inc):
            self.osdmap = new_map
            affected: dict[int, PGGroup] = {}
            for o, st in inc.new_state.items():
                if not (st & OSD_UP):
                    continue
                down_now = new_map.is_down(o)
                for pid, pool in self.pools.items():
                    for g in pool["pgs"].values():
                        if o not in g.acting:
                            continue
                        if down_now:
                            g.bus.mark_down(o)
                        else:
                            g.bus.mark_up(o)
                        if new_map.is_down(g.backend.whoami):
                            # the PRIMARY is dead (this flip or an earlier
                            # one): its coordinator cannot peer and its
                            # repairs cannot complete (replies to a down
                            # shard drop) — the group is moribund until
                            # the weight/backfill path re-homes it or the
                            # primary itself boots back
                            continue
                        if not down_now:
                            self._repair_after_boot(pid, g, o)
                        affected[id(g)] = g
            # AdvMap: ONE statechart round per affected PG per committed
            # incremental, however many OSDs it flipped (GetInfo -> ... ->
            # Active); explicit repairs above just join the repair queues
            for g in affected.values():
                g.peering.advance_map(new_map.epoch)
                g.bus.deliver_all()
            if inc.new_weight:
                # CRUSH remapping: re-place every PG, backfill the changed
                for pid, pool in self.pools.items():
                    ec = pool["ec"]
                    for ps, g in list(pool["pgs"].items()):
                        _, _, acting, _ = new_map.pg_to_up_acting_osds(
                            PG(pid, ps))
                        if (acting and NONE_ID not in acting and
                                list(acting) != list(g.acting)):
                            self._backfill_pg(pid, ps, list(acting), ec)
        mon.subscribers.append(on_map)
        # monitor transitions (up/down/flap damping) land in the cluster
        # log next to the bus-level lines.  In a quorum, apply_committed
        # runs on EVERY replica: the clog_gate keeps only the current
        # leader speaking, so one commit logs once, not n_mons times.
        if hasattr(mon, "mons"):
            for pm in mon.mons:
                pm.service.clog = self.clusterlog
                pm.service.clog_gate = \
                    (lambda _pm=pm, _mc=mon: _mc.leader() is _pm)
        else:
            mon.clog = self.clusterlog
        self.monitor = mon
        return mon

    # -- cluster-wide status (ceph -s shape) -------------------------------

    def status(self) -> dict:
        """ceph -s shape: osdmap summary + pgmap with per-state counts
        (the PGMap the mon's stats service aggregates — active+clean /
        active+degraded / inactive from each PG's shard availability)
        plus the rate digest (client IO B/s and op/s, recovery B/s,
        serving batch throughput).  Each call ticks the StatsAggregator,
        so consecutive status calls bracket the rate window the way the
        mgr's periodic reports do."""
        n_pgs = 0
        states = {"active+clean": 0, "active+degraded": 0, "inactive": 0}
        for p in self.pools.values():
            for g in p["pgs"].values():
                n_pgs += 1
                states[self.pg_state(g)] += 1
        self.stats.sample()
        # status IS the mgr tick: the time-series ring records a point
        # (interval-gated, so a tight status loop stays bounded), and
        # every objecter attached to this cluster sweeps its op
        # timeouts — a parked/black-holed client op ages onto slow_ops
        # and the SLOW_OPS window delta without anyone polling by hand
        from .client.objecter import live_objecters
        for ob in live_objecters():
            if ob.cluster is self:
                ob.check_op_timeouts()
        # fold completed traces into the critical-path ledger BEFORE the
        # ts point records: the `slo` series reads the ledger
        self.critpath.refresh()
        self.ts.record()
        st = {
            "osdmap": {"epoch": self.osdmap.epoch,
                       "num_osds": self.osdmap.max_osd,
                       "num_up_osds": sum(
                           1 for o in range(self.osdmap.max_osd)
                           if self.osdmap.is_up(o))},
            "pgmap": {"num_pgs": n_pgs,
                      "num_pools": len(self.pools),
                      "pgs_by_state": {k: v for k, v in states.items()
                                       if v},
                      "io_rates": self.stats.digest()},
        }
        if self.recovery is not None:
            # recovering/queued PG counts + reservation occupancy (the
            # 'recovery:' block ceph -s renders next to the IO rates)
            st["pgmap"]["recovery"] = self.recovery.summary()
        return st
