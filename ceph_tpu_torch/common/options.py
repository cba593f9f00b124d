"""Typed option schema + runtime config store with live observers.

A copy of ``ceph_tpu.common.options``: every option, under the JAX
package's names, types, levels and defaults, so one config serves both
packages (reference: src/common/options.cc's typed Option table and
src/common/config.cc's ``md_config_t`` with its observers).  The
``jax_rs_*`` names are kept for that reason; in the port they set the
CUDA codec pipeline.  The two defaults that name a plugin
(``osd_erasure_code_plugins``, ``osd_pool_default_erasure_code_profile``)
name ``torch_rs`` where the JAX package names ``jax_rs``.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable

# Option levels (options.h Option::LEVEL_*)
LEVEL_BASIC = "basic"
LEVEL_ADVANCED = "advanced"
LEVEL_DEV = "dev"

# Option types (options.h Option::TYPE_*)
TYPE_STR = "str"
TYPE_INT = "int"
TYPE_UINT = "uint"
TYPE_FLOAT = "float"
TYPE_BOOL = "bool"
TYPE_SIZE = "size"          # accepts 4K/1M/2G suffixes

_SIZE_SUFFIX = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40}


def parse_size(v) -> int:
    if isinstance(v, (int, float)):
        return int(v)
    s = str(v).strip().lower()
    if s and s[-1] in _SIZE_SUFFIX:
        return int(float(s[:-1]) * _SIZE_SUFFIX[s[-1]])
    return int(s, 0)


_CASTS: dict[str, Callable[[Any], Any]] = {
    TYPE_STR: str,
    TYPE_INT: lambda v: int(str(v), 0) if isinstance(v, str) else int(v),
    TYPE_UINT: lambda v: int(str(v), 0) if isinstance(v, str) else int(v),
    TYPE_FLOAT: float,
    TYPE_BOOL: lambda v: (v if isinstance(v, bool)
                          else str(v).lower() in ("1", "true", "yes", "on")),
    TYPE_SIZE: parse_size,
}


@dataclass
class Option:
    name: str
    type: str = TYPE_STR
    level: str = LEVEL_ADVANCED
    default: Any = None
    description: str = ""
    long_description: str = ""
    see_also: list[str] = field(default_factory=list)
    min: Any = None
    max: Any = None
    enum_allowed: list[str] = field(default_factory=list)
    startup: bool = False       # FLAG_STARTUP: no runtime updates

    def cast(self, value):
        v = _CASTS[self.type](value)
        if self.type in (TYPE_UINT, TYPE_SIZE) and v < 0:
            raise ValueError(f"{self.name}: negative value {v}")
        if self.min is not None and v < self.min:
            raise ValueError(f"{self.name}: {v} < min {self.min}")
        if self.max is not None and v > self.max:
            raise ValueError(f"{self.name}: {v} > max {self.max}")
        if self.enum_allowed and v not in self.enum_allowed:
            raise ValueError(
                f"{self.name}: {v!r} not in {self.enum_allowed}")
        return v


# The framework's option table (the subset of the reference's ~2000 options
# this codebase consumes; same names where the concept matches).
OPTIONS: list[Option] = [
    Option("erasure_code_dir", TYPE_STR, LEVEL_ADVANCED, default="",
           description="directory where erasure-code plugins can be found",
           startup=True),
    Option("osd_erasure_code_plugins", TYPE_STR, LEVEL_ADVANCED,
           default="torch_rs cpp_rs",
           description="erasure code plugins to preload", startup=True),
    Option("osd_pool_default_erasure_code_profile", TYPE_STR, LEVEL_ADVANCED,
           default="plugin=torch_rs technique=reed_sol_van k=2 m=2",
           description="default erasure code profile"),
    Option("osd_pool_default_size", TYPE_UINT, LEVEL_BASIC, default=3,
           description="number of replicas for replicated pools",
           min=0, max=10),
    Option("osd_pool_default_pg_num", TYPE_UINT, LEVEL_BASIC, default=32,
           description="number of PGs for new pools"),
    Option("osd_recovery_max_chunk", TYPE_SIZE, LEVEL_ADVANCED,
           default=8 << 20,
           description="max recovery read size (rounded to stripe width)"),
    Option("ec_batch_max_stripes", TYPE_UINT, LEVEL_ADVANCED, default=256,
           description="stripes coalesced per device dispatch"),
    Option("ec_device_threshold_bytes", TYPE_SIZE, LEVEL_ADVANCED,
           default=8 * 1024 * 1024,
           description="under device=auto, single calls below this encode "
                       "on the SIMD host codec and larger ones on the "
                       "card; ceph_tpu_torch.tools.baseline_matrix config "
                       "2 measures the crossover"),
    Option("pipeline_breaker_threshold", TYPE_UINT, LEVEL_ADVANCED,
           default=3,
           description="consecutive device-side codec failures before "
                       "the pipeline's circuit breaker opens and its "
                       "submits fail fast without touching the card "
                       "(0 disables the breaker)",
           see_also=["pipeline_breaker_cooldown"]),
    Option("pipeline_breaker_cooldown", TYPE_FLOAT, LEVEL_ADVANCED,
           default=5.0, min=0.0,
           description="seconds an open pipeline breaker waits before "
                       "admitting one half-open probe dispatch back to "
                       "the device (success re-closes, failure re-opens)",
           see_also=["pipeline_breaker_threshold"]),
    Option("jax_rs_pipeline_depth", TYPE_UINT, LEVEL_ADVANCED,
           default=4,
           description="max dispatched device batches in flight before "
                       "the codec pipeline forces completion of the "
                       "oldest; batch N+1's host pack overlaps batch N's "
                       "device compute (0 = synchronous dispatch)",
           see_also=["jax_rs_mesh_devices"]),
    Option("jax_rs_mesh_devices", TYPE_UINT, LEVEL_ADVANCED,
           default=0,
           description="split coalesced codec batches across the dp axis "
                       "of a device mesh over this many devices "
                       "(parallel/mesh sharded encode/decode steps); "
                       "0 or 1 = single-chip dispatch, and the option is "
                       "ignored when fewer devices are present",
           see_also=["jax_rs_pipeline_depth"]),
    Option("osd_serving_throttle_bytes", TYPE_SIZE, LEVEL_ADVANCED,
           default=64 << 20,
           description="serving admission throttle: max payload bytes "
                       "queued or in flight (backpressure past this)",
           see_also=["osd_serving_throttle_ops", "osd_serving_fail_fast"]),
    Option("osd_serving_throttle_ops", TYPE_UINT, LEVEL_ADVANCED,
           default=1024, min=1,
           description="serving admission throttle: max ops queued or in "
                       "flight",
           see_also=["osd_serving_throttle_bytes"]),
    Option("osd_serving_fail_fast", TYPE_BOOL, LEVEL_ADVANCED,
           default=False,
           description="when a serving throttle is full, refuse the op "
                       "(ThrottleFull) instead of blocking the submitter"),
    Option("osd_batch_max_delay_ms", TYPE_FLOAT, LEVEL_ADVANCED,
           default=2.0, min=0.0,
           description="op coalescer deadline: max milliseconds an op "
                       "waits for batch companions before dispatch",
           see_also=["osd_batch_max_ops"]),
    Option("osd_batch_max_ops", TYPE_UINT, LEVEL_ADVANCED,
           default=64, min=1,
           description="op coalescer: max ops fused into one device "
                       "dispatch",
           see_also=["osd_batch_max_delay_ms"]),
    Option("osd_op_complaint_time", TYPE_FLOAT, LEVEL_ADVANCED, default=30.0,
           description="ops slower than this many seconds are slow ops "
                       "(flagged in dumps, counted on slow_ops)",
           min=0.0),
    # -- observability fast path (common/instruments.py, tracer sampling) --
    Option("instruments_enabled", TYPE_BOOL, LEVEL_ADVANCED, default=True,
           description="master kill-switch for the hot-path instruments "
                       "(tracer spans/instants/completes, wire "
                       "accounting, rpc latency observation): off turns "
                       "them into cheap no-op guards; health checks and "
                       "perf-counter math keep working either way",
           see_also=["tracer_sample_rate"]),
    Option("tracer_sample_rate", TYPE_FLOAT, LEVEL_ADVANCED, default=1.0,
           min=0.0, max=1.0,
           description="head-based per-trace sampling rate: the decision "
                       "is made ONCE when the root TraceContext is "
                       "created and rides the context so a whole trace "
                       "samples atomically; unsampled ops keep a "
                       "micro-record and are promoted into the ring when "
                       "they cross osd_op_complaint_time",
           see_also=["instruments_enabled", "osd_op_complaint_time"]),
    Option("osd_recovery_chain_enable", TYPE_BOOL, LEVEL_ADVANCED,
           default=True,
           description="chained streaming repair: recovery waves plan a "
                       "partial-sum chain over survivor OSDs (each hop "
                       "GF-scales its local shard and forwards the "
                       "running sum) instead of pulling k full shards "
                       "to the primary; falls back to centralized "
                       "verified repair per object on any mid-chain "
                       "failure and for sub-chunked codes",
           see_also=["osd_recovery_chain_max_len"]),
    Option("osd_recovery_chain_max_len", TYPE_UINT, LEVEL_ADVANCED,
           default=12, min=2,
           description="longest partial-sum chain (hop count = decode "
                       "sources); repairs needing more sources than "
                       "this stay centralized",
           see_also=["osd_recovery_chain_enable"]),
    Option("osd_recovery_regen_enable", TYPE_BOOL, LEVEL_ADVANCED,
           default=True,
           description="regenerating-code repair: single-erasure repairs "
                       "on a regenerating pool (pm_regen MSR/MBR) gather "
                       "d helper inner products (beta bytes each) at the "
                       "newcomer instead of decoding k full chunks; "
                       "falls back to centralized verified repair on any "
                       "abort (helper death, version skew, sub-chunk or "
                       "hash mismatch) and for multi-chunk losses",
           see_also=["osd_recovery_chain_enable"]),
    Option("osd_recovery_max_active", TYPE_UINT, LEVEL_ADVANCED, default=3,
           description="concurrent recoveries per OSD (the recovery "
                       "scheduler's wave size: objects fused into one "
                       "batched reconstruct dispatch)",
           see_also=["osd_max_backfills",
                     "osd_recovery_max_bytes_per_sec"]),
    Option("osd_max_backfills", TYPE_UINT, LEVEL_ADVANCED, default=1,
           min=0,
           description="max concurrent recovery/backfill reservations "
                       "per OSD (local and remote AsyncReserver "
                       "max_allowed; 0 parks every job — useful to "
                       "pause background repair)",
           see_also=["osd_recovery_max_active"]),
    Option("osd_recovery_max_bytes_per_sec", TYPE_SIZE, LEVEL_ADVANCED,
           default=0,
           description="token-bucket byte-rate cap on recovery waves "
                       "per OSD (0 = uncapped); waves run post-paid and "
                       "the next wave waits out the debt in virtual time",
           see_also=["osd_recovery_sleep"]),
    Option("osd_recovery_sleep", TYPE_FLOAT, LEVEL_ADVANCED, default=0.0,
           min=0.0,
           description="virtual-time pause between recovery waves "
                       "(throttles background repair like the "
                       "reference's recovery sleep)",
           see_also=["osd_recovery_max_bytes_per_sec"]),
    Option("osd_queue_throttle_ops", TYPE_UINT, LEVEL_ADVANCED,
           default=0,
           description="OSD daemon op-queue admission bound (0 = "
                       "unlimited); past it ms_dispatch answers "
                       "('throttled', epoch) and the client backs off"),
    Option("mgr_stats_period", TYPE_FLOAT, LEVEL_ADVANCED, default=1.0,
           min=0.01,
           description="seconds between background StatsAggregator "
                       "samples (the mgr's tick interval)",
           see_also=["mgr_stats_window"]),
    Option("mgr_stats_window", TYPE_UINT, LEVEL_ADVANCED, default=120,
           min=2,
           description="perf-counter samples retained in the rolling "
                       "rate window (rates span first..last sample)",
           see_also=["mgr_stats_period"]),
    Option("mgr_throttle_saturation_ratio", TYPE_FLOAT, LEVEL_ADVANCED,
           default=0.9, min=0.0, max=1.0,
           description="THROTTLE_SATURATED health check fires when a "
                       "throttle's in-use/limit ratio reaches this"),
    Option("mgr_recompile_storm_compiles", TYPE_UINT, LEVEL_ADVANCED,
           default=8, min=1,
           description="RECOMPILE_STORM health check fires when jit "
                       "compilations within the stats window reach this "
                       "many AND this rate per minute (shape churn "
                       "defeating the size buckets)"),
    # -- device efficiency & profiling (roofline / profiler_capture) -------
    Option("device_peak_flops", TYPE_FLOAT, LEVEL_ADVANCED, default=0.0,
           min=0.0,
           description="roofline peak FLOP/s override for this card "
                       "(0 = resolve from the device-kind registry in "
                       "common/roofline.py)",
           see_also=["device_peak_hbm_bytes_per_sec"]),
    Option("device_peak_hbm_bytes_per_sec", TYPE_SIZE, LEVEL_ADVANCED,
           default=0,
           description="roofline peak device-memory bandwidth override in "
                       "bytes/s (0 = resolve from the device-kind "
                       "registry)",
           see_also=["device_peak_flops"]),
    Option("mgr_device_refresh_ttl", TYPE_FLOAT, LEVEL_ADVANCED,
           default=5.0, min=0.0,
           description="seconds a prometheus scrape reuses the last "
                       "device-telemetry snapshot before re-reading the "
                       "card's memory state (0 = refresh every render)"),
    Option("mgr_hbm_pressure_ratio", TYPE_FLOAT, LEVEL_ADVANCED,
           default=0.85, min=0.0, max=1.0,
           description="HBM_PRESSURE health check fires when a device's "
                       "high-water memory mark reaches this fraction of "
                       "its reported capacity"),
    Option("mgr_profiler_max_captures", TYPE_UINT, LEVEL_ADVANCED,
           default=8, min=1,
           description="torch.profiler capture directories kept on disk "
                       "(oldest removed past the bound)"),
    Option("mgr_profiler_cooldown", TYPE_FLOAT, LEVEL_ADVANCED,
           default=300.0, min=0.0,
           description="seconds between health-transition profiler "
                       "auto-captures (a flapping check must not churn "
                       "the profiler)",
           see_also=["mgr_profiler_auto_window"]),
    Option("mgr_profiler_auto_window", TYPE_FLOAT, LEVEL_ADVANCED,
           default=0.0, min=0.0,
           description="seconds a health-transition auto-capture stays "
                       "open before the profiler stops (0 = stop "
                       "immediately: a marker artifact with zero "
                       "steady-state risk; operators open real windows "
                       "with 'device profile start')",
           see_also=["mgr_profiler_cooldown"]),
    Option("mgr_flight_capacity", TYPE_UINT, LEVEL_ADVANCED, default=8,
           min=1,
           description="flight-recorder bundles kept in the in-memory "
                       "ring (disk dumps are additionally bounded by "
                       "the operator's data dir)"),
    Option("mgr_hot_shard_ratio", TYPE_FLOAT, LEVEL_ADVANCED, default=4.0,
           min=1.0,
           description="HOT_SHARD health check fires when one OSD's "
                       "primary-op rate reaches this multiple of the "
                       "median OSD load over the stats window",
           see_also=["mgr_hot_shard_min_ops"]),
    Option("mgr_hot_shard_min_ops", TYPE_FLOAT, LEVEL_ADVANCED,
           default=16.0, min=0.0,
           description="HOT_SHARD requires the hottest OSD to sustain at "
                       "least this many primary op/s before skew alone "
                       "can fire the check (idle clusters never page)",
           see_also=["mgr_hot_shard_ratio"]),
    Option("mgr_cluster_log_max", TYPE_UINT, LEVEL_ADVANCED, default=500,
           min=1,
           description="cluster log (clog) entries kept in the bounded "
                       "ring; the on-disk clusterlog file compacts back "
                       "to this bound"),
    Option("mgr_ts_interval", TYPE_FLOAT, LEVEL_ADVANCED, default=1.0,
           min=0.0,
           description="minimum seconds between embedded time-series "
                       "points (status ticks closer together are "
                       "coalesced)",
           see_also=["mgr_ts_capacity", "mgr_ts_coarse_every"]),
    Option("mgr_ts_capacity", TYPE_UINT, LEVEL_ADVANCED, default=360,
           min=2,
           description="points per time-series ring (fine and coarse "
                       "archives each hold this many; round-robin "
                       "eviction past it)",
           see_also=["mgr_ts_interval"]),
    Option("mgr_ts_coarse_every", TYPE_UINT, LEVEL_ADVANCED, default=12,
           min=1,
           description="fine time-series points folded (mean+max) into "
                       "one coarse archive point",
           see_also=["mgr_ts_capacity"]),
    Option("slo_fast_window", TYPE_FLOAT, LEVEL_ADVANCED, default=60.0,
           min=0.05,
           description="seconds of the FAST burn-rate window: SLO_BURN "
                       "needs both the fast and slow windows past "
                       "slo_burn_rate_threshold (multi-window agreement "
                       "— a blip trips the fast window alone and stays "
                       "silent)",
           see_also=["slo_slow_window", "slo_burn_rate_threshold"]),
    Option("slo_slow_window", TYPE_FLOAT, LEVEL_ADVANCED, default=600.0,
           min=0.1,
           description="seconds of the SLOW burn-rate window (budget "
                       "remaining and SLO_EXHAUSTED are judged over it)",
           see_also=["slo_fast_window"]),
    Option("slo_burn_rate_threshold", TYPE_FLOAT, LEVEL_ADVANCED,
           default=2.0, min=1.0,
           description="error-budget burn multiple past which SLO_BURN "
                       "raises when BOTH windows agree (1.0 = spending "
                       "exactly the sustainable rate)",
           see_also=["slo_exhausted_burn_rate"]),
    Option("slo_exhausted_burn_rate", TYPE_FLOAT, LEVEL_ADVANCED,
           default=10.0, min=1.0,
           description="slow-window burn multiple past which "
                       "SLO_EXHAUSTED (HEALTH_ERR) raises: the budget "
                       "is gone at any plausible compliance period",
           see_also=["slo_burn_rate_threshold"]),
    Option("slo_min_ops", TYPE_UINT, LEVEL_ADVANCED, default=8, min=1,
           description="minimum ops in BOTH burn windows before the SLO "
                       "checks can page (an idle class holds no "
                       "evidence either way)"),
    # -- the log (common/log.py; the monitor's dout) ----------------------
    Option("log_file", TYPE_STR, LEVEL_BASIC, default="",
           description="path to log file"),
    Option("log_max_recent", TYPE_UINT, LEVEL_ADVANCED, default=500,
           description="recent log entries kept for crash dump"),
    Option("debug_osd", TYPE_INT, LEVEL_DEV, default=1,
           description="osd subsystem log gather level", min=0, max=20),
    Option("debug_ec", TYPE_INT, LEVEL_DEV, default=1,
           description="erasure-code subsystem log level", min=0, max=20),
    Option("debug_crush", TYPE_INT, LEVEL_DEV, default=1,
           description="crush subsystem log level", min=0, max=20),
    # -- monitor, heartbeats and flap damping (mon/, failure/markdown.py) --
    Option("osd_heartbeat_interval", TYPE_INT, LEVEL_ADVANCED, default=6,
           description="seconds between peer heartbeats", min=1, max=60),
    Option("osd_heartbeat_grace", TYPE_INT, LEVEL_ADVANCED, default=20,
           description="seconds without heartbeat before reporting down"),
    Option("mon_osd_min_down_reporters", TYPE_UINT, LEVEL_ADVANCED,
           default=2, description="failure reports needed to mark down"),
    Option("mon_osd_min_up_ratio", TYPE_FLOAT, LEVEL_ADVANCED, default=0.3,
           description="refuse down-marks below this up fraction"),
    Option("mon_osd_down_out_interval", TYPE_INT, LEVEL_ADVANCED,
           default=600, description="seconds down before auto-out"),
    Option("mon_osd_reporter_subtree_level", TYPE_STR, LEVEL_ADVANCED,
           default="host",
           description="crush level for counting distinct failure reporters"),
    Option("osd_markdown_count", TYPE_UINT, LEVEL_ADVANCED, default=5,
           min=1,
           description="mark-downs within osd_markdown_window before an "
                       "OSD is declared flapping: further boots are "
                       "refused (OSD_FLAPPING) until the operator clears "
                       "the markdown record (osd_markdown_log analog)",
           see_also=["osd_markdown_window"]),
    Option("osd_markdown_window", TYPE_FLOAT, LEVEL_ADVANCED,
           default=600.0, min=1.0,
           description="sliding window in seconds over which "
                       "osd_markdown_count mark-downs count as flapping",
           see_also=["osd_markdown_count"]),
    # -- cache tiering (tier/) ---------------------------------------------
    Option("ms_inject_socket_failures", TYPE_UINT, LEVEL_ADVANCED,
           default=0,
           description="inject a connection reset roughly every N "
                       "post-auth messages on the TCP transport (0 "
                       "disables) — the reference's 'ms inject socket "
                       "failures'; the ClusterServer auto-arms its "
                       "fault hooks when nonzero",
           see_also=["ms_inject_delay_prob", "ms_inject_delay_ms"]),
    Option("ms_inject_delay_prob", TYPE_FLOAT, LEVEL_ADVANCED,
           default=0.0, min=0.0, max=1.0,
           description="probability a post-auth TCP message is delayed "
                       "by ms_inject_delay_ms before hitting the wire "
                       "('ms inject delay' analog)",
           see_also=["ms_inject_delay_ms"]),
    Option("ms_inject_delay_ms", TYPE_FLOAT, LEVEL_ADVANCED,
           default=0.0, min=0.0,
           description="milliseconds an ms_inject_delay_prob hit stalls "
                       "the send"),
    Option("ms_rpc_timeout", TYPE_FLOAT, LEVEL_ADVANCED, default=30.0,
           min=0.1,
           description="overall per-RPC deadline on the TCP client: a "
                       "call not answered (across resends) within this "
                       "many seconds raises TimeoutError instead of "
                       "hanging on a black-holed request"),
    Option("ms_rpc_retry_attempts", TYPE_UINT, LEVEL_ADVANCED, default=4,
           min=1,
           description="send attempts per RPC within ms_rpc_timeout: "
                       "resends after a connection reset or a silent "
                       "per-attempt timeout (the server dedups resends "
                       "by (session, rid), so retries never re-apply)",
           see_also=["ms_rpc_timeout"]),
    Option("ms_reconnect_max_attempts", TYPE_UINT, LEVEL_ADVANCED,
           default=8, min=1,
           description="bounded reconnect attempts after the TCP link "
                       "drops before the client gives up "
                       "(full-jitter exponential backoff between tries)",
           see_also=["ms_reconnect_backoff_base",
                     "ms_reconnect_backoff_cap"]),
    Option("ms_reconnect_backoff_base", TYPE_FLOAT, LEVEL_ADVANCED,
           default=0.05, min=0.0,
           description="base seconds of the reconnect backoff schedule: "
                       "attempt n sleeps uniform[0, min(cap, "
                       "base * 2^n)] (full jitter)"),
    Option("ms_reconnect_backoff_cap", TYPE_FLOAT, LEVEL_ADVANCED,
           default=2.0, min=0.0,
           description="ceiling seconds any single reconnect backoff "
                       "sleep can reach"),
    # -- async messenger (msg/) --------------------------------------------
    Option("ms_async_op_threads", TYPE_UINT, LEVEL_ADVANCED, default=3,
           min=1,
           description="dispatch worker threads per async server "
                       "transport (the reference's ms_async_op_threads): "
                       "the FIXED pool that executes RPCs off the "
                       "dmClock dispatch queue — never grows with "
                       "connection count"),
    Option("ms_async_dispatch_queue_max", TYPE_UINT, LEVEL_ADVANCED,
           default=1024, min=1,
           description="dispatch-queue depth limit the overload-shedding "
                       "ladder measures against: each dmClock class may "
                       "occupy only its fraction of this before its "
                       "arrivals bounce with EBUSY (client ops shed only "
                       "at the full limit)"),
    Option("ms_async_write_queue_bytes", TYPE_SIZE, LEVEL_ADVANCED,
           default=4 * 1024 * 1024,
           description="per-connection write-queue byte budget "
                       "(exec/throttle.py): senders block (bounded) when "
                       "a peer stops draining, and the connection closes "
                       "when the budget stays exhausted a full send "
                       "timeout — backpressure instead of unbounded "
                       "buffering"),
    Option("ms_async_batch_max", TYPE_UINT, LEVEL_ADVANCED, default=64,
           min=1,
           description="max RpcCalls the mux client coalesces into one "
                       "RpcBatch frame (one pickle, one MAC, one "
                       "syscall per admission window)"),
    Option("ms_async_batch_delay_ms", TYPE_FLOAT, LEVEL_ADVANCED,
           default=0.5, min=0.0,
           description="how long the mux client's sender waits for more "
                       "calls to coalesce once one is queued (0 sends "
                       "immediately)",
           see_also=["ms_async_batch_max"]),
    Option("ms_zero_copy", TYPE_BOOL, LEVEL_ADVANCED, default=True,
           description="serialize batch-frame payloads through the "
                       "raw sideband segment (length-prefixed bulk data "
                       "after the pickled control header) so a payload "
                       "byte is copied ~once between socket and device "
                       "staging; off forces the legacy all-pickle frame "
                       "(the bench's 'legacy' arm). Both formats decode "
                       "regardless of the setting — this only gates the "
                       "ENCODE side, so mixed-version peers interoperate",
           see_also=["ms_async_batch_max"]),
    Option("tier_promote_min_recency", TYPE_UINT, LEVEL_ADVANCED,
           default=2, min=0,
           description="consecutive most-recent hit sets a missed "
                       "object must appear in before the proxy read "
                       "also promotes it into the cache pool "
                       "(min_read_recency_for_promote; 0 promotes on "
                       "first touch, higher values stop one-shot scans "
                       "from thrashing the tier)"),
    Option("tier_dirty_ratio_high", TYPE_FLOAT, LEVEL_ADVANCED,
           default=0.6, min=0.0, max=1.0,
           description="dirty objects over tier_target_max_objects "
                       "past which the agent arms flush mode "
                       "(cache_target_dirty_high_ratio)",
           see_also=["tier_dirty_ratio_low", "tier_target_max_objects"]),
    Option("tier_dirty_ratio_low", TYPE_FLOAT, LEVEL_ADVANCED,
           default=0.4, min=0.0, max=1.0,
           description="flush mode disarms once the dirty fraction "
                       "drops under this (hysteresis below "
                       "tier_dirty_ratio_high: the next absorbed write "
                       "does not immediately re-arm the agent)",
           see_also=["tier_dirty_ratio_high"]),
    Option("tier_full_ratio", TYPE_FLOAT, LEVEL_ADVANCED,
           default=0.8, min=0.0, max=1.0,
           description="resident objects over tier_target_max_objects "
                       "past which the agent evicts cold clean objects "
                       "(cache_target_full_ratio) and TIER_FULL raises",
           see_also=["tier_target_max_objects"]),
    Option("tier_target_max_objects", TYPE_UINT, LEVEL_ADVANCED,
           default=256, min=1,
           description="capacity target of the RAM-resident cache pool "
                       "in objects: the denominator of every tier "
                       "watermark (target_max_objects)",
           see_also=["tier_full_ratio", "tier_dirty_ratio_high"]),
    Option("tier_agent_max_ops", TYPE_UINT, LEVEL_ADVANCED,
           default=16, min=1,
           description="flush/evict operations one agent pass may "
                       "issue (osd_agent_max_ops): the agent shares "
                       "the cluster with clients and must not convoy "
                       "them"),
]

# per-owner-class latency objectives (mgr/slo.py): slo_<class>_p99_ms is
# the bound (0 = no objective), slo_<class>_target the fraction of ops
# that must meet it — the error budget is 1 - target.  Generated for the
# canonical owner classes (common/device_attribution.OWNER_CLASSES,
# inlined here so the schema stays import-light).
for _cls in ("client", "serving", "recovery", "scrub", "rebalance"):
    OPTIONS.append(Option(
        f"slo_{_cls}_p99_ms", TYPE_FLOAT, LEVEL_ADVANCED, default=0.0,
        min=0.0,
        description=f"latency objective for {_cls}-class ops in "
                    f"milliseconds (0 disables the objective; "
                    f"slo_{_cls}_target sets the compliance fraction)",
        see_also=[f"slo_{_cls}_target"]))
    OPTIONS.append(Option(
        f"slo_{_cls}_target", TYPE_FLOAT, LEVEL_ADVANCED, default=0.999,
        min=0.0, max=1.0,
        description=f"fraction of {_cls}-class ops that must complete "
                    f"within slo_{_cls}_p99_ms (error budget = "
                    f"1 - target)",
        see_also=[f"slo_{_cls}_p99_ms"]))

SCHEMA: dict[str, Option] = {o.name: o for o in OPTIONS}


class ConfigProxy:
    """md_config_t analog: typed values + observers (config.cc)."""

    def __init__(self, overrides: dict | None = None,
                 schema: dict[str, Option] | None = None):
        self.schema = dict(schema or SCHEMA)
        self._values: dict[str, Any] = {}
        self._observers: dict[str, list[Callable[[str, Any], None]]] = {}
        self._lock = threading.Lock()
        if overrides:
            for k, v in overrides.items():
                self.set(k, v, _startup=True)

    def get(self, name: str):
        opt = self.schema[name]
        with self._lock:
            if name in self._values:
                return self._values[name]
        return opt.cast(opt.default) if opt.default is not None else None

    def __getitem__(self, name: str):
        return self.get(name)

    def set(self, name: str, value, _startup: bool = False) -> None:
        opt = self.schema.get(name)
        if opt is None:
            raise KeyError(f"unknown option {name!r}")
        if opt.startup and not _startup:
            raise ValueError(f"option {name} can only be set at startup")
        v = opt.cast(value)
        with self._lock:
            self._values[name] = v
            observers = list(self._observers.get(name, ()))
        for fn in observers:        # outside the lock, like the reference
            fn(name, v)

    def add_observer(self, name: str, fn: Callable[[str, Any], None]) -> None:
        """Live-update hook (md_config_obs_t analog)."""
        if name not in self.schema:
            raise KeyError(f"unknown option {name!r}")
        with self._lock:
            self._observers.setdefault(name, []).append(fn)

    def show_config(self) -> dict[str, Any]:
        return {name: self.get(name) for name in sorted(self.schema)}

    def diff(self) -> dict[str, Any]:
        """Only non-default values (`ceph config diff`)."""
        with self._lock:
            return dict(self._values)
