"""RecoveryScheduler: reservation-gated, prioritized, batch-fused repair.

The orchestration layer between damage DETECTION (peering, shard
revival, scrub) and the repair machinery in ``backend/pg_backend.py``.
Analog of the reference's background-recovery admission stack
(reference: src/common/AsyncReserver.h instantiated as the OSD's
``local_reserver``/``remote_reserver``, OSDService::queue_for_recovery +
the ``osd_max_backfills`` / ``osd_recovery_max_active`` /
``osd_recovery_sleep`` option family), with one change for the device
codec: each wave's missing objects are reconstructed through ONE
batched device dispatch (``ecutil.decode_shards_many``) instead of one
``decode`` per object.

Flow per degraded PG (a :class:`PGRecoveryJob`):

1. **local reservation** on the primary OSD's
   :class:`~ceph_tpu_torch.recovery.reserver.AsyncReserver` at a Ceph-style
   priority (table below);
2. per target shard, a **remote reservation** on the target OSD's
   remote reserver (sequential, like the reference's
   RemoteBackfillReserved chain);
3. the shard repair starts with the job as its *driver*: the repair
   planner hands the missing-object list back instead of recovering
   inline, and the job paces it in **waves** — at most
   ``osd_recovery_max_active`` objects each, queued on the primary
   daemon's dmClock queue in the ``background_recovery`` class (client
   ops win under load), byte-budgeted by a token bucket
   (``osd_recovery_max_bytes_per_sec``) with ``osd_recovery_sleep``
   of virtual time between waves;
4. completion releases the reservations; preemption by a
   higher-priority PG (or a map change via the peering statechart)
   aborts the current repair cleanly and requeues the job.

Priority table (reference: PeeringState::get_recovery_priority):

======================================  =====
``OSD_RECOVERY_PRIORITY_FORCED``          255
``OSD_RECOVERY_PRIORITY_MAX``             253
``OSD_RECOVERY_INACTIVE_PRIORITY_BASE``   220   (+ degraded depth)
``OSD_RECOVERY_PRIORITY_BASE``            180   (+ pool prio + depth)
``OSD_BACKFILL_PRIORITY_BASE``            140   (+ pool prio + depth)
======================================  =====

Pool ``recovery_priority`` (a pool param) is clamped to [-10, 10] like
the reference; degraded depth is the number of stale/down shards in the
acting set, so deeper damage sorts first within a band.

A copy of ``ceph_tpu.recovery.scheduler``.  Its one ``CodecPipeline``
(``jax_rs_pipeline_depth``, the option's reference name) dispatches each
wave's decodes on the device the pool's plugin routes them to: the
card's stream for a profile with no ``device`` key, the plain versions
for ``device=cpu``.  A failure on the card fails the wave; nothing is
rebuilt on the host instead.
"""
from __future__ import annotations

import contextlib
import time
import weakref
from dataclasses import dataclass, field
from enum import Enum

from .reserver import AsyncReserver
from ..common.tracer import default_tracer, trace_span
from ..osd.mclock import BG_RECOVERY
from ..osd.pg_log import OP_DELETE

OSD_RECOVERY_PRIORITY_FORCED = 255
OSD_RECOVERY_PRIORITY_MAX = 253
OSD_RECOVERY_INACTIVE_PRIORITY_BASE = 220
OSD_RECOVERY_PRIORITY_BASE = 180
OSD_BACKFILL_PRIORITY_BASE = 140

# live schedulers, for the prometheus reserver-gauge export and the
# stats digest (the osd_daemon.live_daemons weakref pattern)
_SCHEDULERS: "weakref.WeakSet[RecoveryScheduler]" = weakref.WeakSet()


def live_schedulers() -> list["RecoveryScheduler"]:
    return list(_SCHEDULERS)


class JobState(Enum):
    QUEUED = "queued"            # waiting for the local reservation
    RUNNING = "running"          # local held; repairing target by target
    COMPLETE = "complete"
    CANCELLED = "cancelled"


class _TokenBucket:
    """Post-paid byte budget: a wave always runs, the NEXT wave waits out
    whatever debt it left (guaranteed progress under any cap — the
    pacing role ``osd_recovery_sleep`` + the recovery throttles play in
    the reference).  Burst capacity is one second of rate."""

    def __init__(self, rate: float):
        self.rate = float(rate)
        self.tokens = 0.0
        self.last: float | None = None

    def consume(self, amount: float, now: float) -> float:
        """Spend ``amount`` at ``now``; returns seconds until the debt
        clears (0.0 when within budget or uncapped)."""
        if self.rate <= 0:
            return 0.0
        if self.last is None:
            self.last = now
            self.tokens = self.rate          # full burst on first use
        self.tokens = min(self.rate,
                          self.tokens + (now - self.last) * self.rate)
        self.last = now
        self.tokens -= amount
        return max(0.0, -self.tokens / self.rate)


@dataclass
class PGRecoveryJob:
    """One degraded PG's trip through the scheduler.

    A job repairs its targets in BATCHES: all remote reservations for
    the batch acquire in ascending-OSD order (globally ordered
    hold-and-wait — two jobs can never deadlock on each other's remote
    slots), then every shard repair of the batch runs CONCURRENTLY.
    Concurrency within the batch is load-bearing, not an optimization:
    one shard's missing objects may only become recoverable once the
    OTHER stale shards of the same PG catch up (current_shards() must
    grow past k), exactly like the inline path's parallel repairs."""
    key: str                     # backend.instance_name (unique per PG)
    backend: object
    pgid: object
    daemon: object
    pool_params: dict
    targets: list[int]           # shards waiting for the NEXT batch
    priority: int
    backfill: frozenset = frozenset()   # targets known to need backfill
    state: JobState = JobState.QUEUED
    batch: list = field(default_factory=list)    # shards repairing now
    remote_pending: list = field(default_factory=list)  # ascending OSDs
    remote_waiting: int | None = None   # request queued, not yet granted
    remote_held: set = field(default_factory=set)
    repairs_open: int = 0        # batch repairs not yet complete
    rops: dict = field(default_factory=dict)     # shard -> ShardRepairOp
    stalled: list = field(default_factory=list)  # parked RecoveryOps
    open_ops: int = 0            # re-driven stalled ops still in flight
    not_before: float = 0.0      # wave pacing horizon (daemon clock)
    # bumped on preemption/cancel AND batch restarts so every wave /
    # repair / remote-reservation callback of the old incarnation turns
    # inert (the role osdmap epochs play for sub-ops)
    gen: int = 0
    # the LOCAL reservation's own generation: its grant/preempt closures
    # are registered once per request, so this bumps ONLY when the local
    # reservation is re-requested (preempt/cancel) — a batch restart
    # bumping `gen` must not stale the still-live local callbacks, or a
    # later preemption of the slot would be silently ignored
    local_gen: int = 0
    cancelled: bool = False
    # when schedule_backend queued the job (perf_counter), and whether
    # the job has yet held its local reservation and every remote one
    t_sched: float = field(default_factory=time.perf_counter)
    reserved: bool = False

    # -- driver interface (ShardRepairOp.driver) ---------------------------

    def offer_work(self, backend, rop, items) -> None:
        """The repair planner computed the missing set: pace it in waves
        instead of recovering inline (pg_backend.handle_pg_log_info /
        handle_pg_scan_reply hand off here when a driver is attached)."""
        self.rops[rop.shard] = rop
        rop.deferred = list(items)
        self.scheduler._queue_wave(self, rop)

    scheduler: object = None     # backref, set at creation


class RecoveryScheduler:
    """Per-OSD local/remote reservers + the PG job state machine."""

    def __init__(self, cct=None, name: str = "recovery"):
        from ..common import PerfCountersBuilder, default_context
        from ..ops.pipeline import CodecPipeline
        self.cct = cct if cct is not None else default_context()
        self.name = name
        self._local: dict[int, AsyncReserver] = {}
        self._remote: dict[int, AsyncReserver] = {}
        self._buckets: dict[int, _TokenBucket] = {}
        self.jobs: dict[str, PGRecoveryJob] = {}
        # one device pipeline shared by every attached PG backend: wave
        # reconstructs dispatch async through it, so a wave's later
        # signature groups pack on the host while earlier groups' device
        # decodes are still in flight (depth 0 turns it off)
        depth = int(self.cct.conf.get("jax_rs_pipeline_depth"))
        self.pipeline = CodecPipeline(depth=depth, cct=self.cct,
                                      name=f"recovery.{name}.pipeline") \
            if depth > 0 else None
        self.perf = (
            PerfCountersBuilder(f"recovery.{name}")
            .add_u64_counter("jobs_scheduled",
                             "PG recovery jobs entering the scheduler")
            .add_u64_counter("jobs_completed",
                             "PG recovery jobs run to completion")
            .add_u64_counter("preemptions",
                             "jobs preempted by higher-priority PGs")
            .add_u64_counter("map_cancels",
                             "jobs cancelled by map changes (re-peering)")
            .add_u64_counter("waves", "recovery waves dispatched")
            .add_u64_counter("wave_objects",
                             "objects dispatched inside waves")
            .add_u64_counter("stalled_requeued",
                             "parked recoveries re-entered via the "
                             "scheduler instead of bypassing it")
            .add_time_avg("reserve_wait_time",
                          "a PG job, from schedule_backend to holding its "
                          "local reservation and every remote one")
            .add_u64("jobs_queued", "jobs waiting for a local reservation")
            .add_u64("jobs_active", "jobs holding a local reservation")
            .create_perf_counters())
        self.cct.perf.add(self.perf)
        # osd_max_backfills is live-tunable (0 pauses background repair):
        # existing reservers must re-bound on a conf set, not just ones
        # created later.  Weakref so a discarded scheduler's observer
        # (the ConfigProxy keeps observers forever) goes inert.
        ref = weakref.ref(self)

        def _on_max_backfills(_name, value, _ref=ref):
            sched = _ref()
            if sched is None:
                return
            for table in (sched._local, sched._remote):
                for r in table.values():
                    r.set_max(int(value))
        self.cct.conf.add_observer("osd_max_backfills", _on_max_backfills)
        # optional cluster log (common/clusterlog.py): job start/finish
        # lines land where an operator reads them (`ceph -w`)
        self.clog = None
        # jobs queued inside held(): their local reservation is requested
        # when the outermost held() block ends
        self._holds = 0
        self._held_jobs: list[PGRecoveryJob] = []
        _SCHEDULERS.add(self)

    def close(self) -> None:
        """Unhook from the Context and the live registry (a shut-down
        cluster must stop exporting reserver gauges)."""
        self.cct.perf.remove(self.perf.name)
        if self.pipeline is not None:
            self.pipeline.close()
        _SCHEDULERS.discard(self)
        self.jobs.clear()

    def inject_device_faults(self, injector) -> None:
        """Route the device-plane fault injection (failure/) through the
        scheduler's shared wave pipeline — the chaos harness hook."""
        if self.pipeline is not None:
            self.pipeline.inject_faults(injector)

    # -- conf --------------------------------------------------------------

    def _conf(self, key: str):
        return self.cct.conf.get(key)

    # -- reservers (the OSD's local_reserver / remote_reserver pair) -------

    def local_reserver(self, osd: int) -> AsyncReserver:
        r = self._local.get(osd)
        if r is None:
            r = self._local[osd] = AsyncReserver(
                f"{self.name}.local.osd.{osd}",
                max_allowed=int(self._conf("osd_max_backfills")))
        return r

    def remote_reserver(self, osd: int) -> AsyncReserver:
        r = self._remote.get(osd)
        if r is None:
            r = self._remote[osd] = AsyncReserver(
                f"{self.name}.remote.osd.{osd}",
                max_allowed=int(self._conf("osd_max_backfills")))
        return r

    def _bucket(self, osd: int) -> _TokenBucket:
        b = self._buckets.get(osd)
        rate = float(self._conf("osd_recovery_max_bytes_per_sec"))
        if b is None:
            b = self._buckets[osd] = _TokenBucket(rate)
        b.rate = rate                       # live-tunable
        return b

    # -- attachment (MiniCluster.enable_recovery_scheduler) ----------------

    def attach_backend(self, backend, pgid, daemon,
                       pool_params: dict | None = None) -> None:
        """Wire a PG backend: revival/stall/peering repair paths then
        route through this scheduler instead of firing inline, and wave
        reconstructs ride the scheduler's shared device pipeline."""
        backend.recovery_scheduler = self
        backend.recovery_pipeline = self.pipeline
        backend._recovery_ctx = {"pgid": pgid, "daemon": daemon,
                                 "pool_params": dict(pool_params or {})}
        # chained streaming repair runs its scale-accumulate on SURVIVOR
        # shards, not the primary: hand every shard handler the same
        # shared pipeline so hop dispatches get the breaker / host
        # fallback / device attribution the wave decodes already have
        for handler in backend.bus.handlers.values():
            getattr(handler, "local_shard",
                    handler).recovery_pipeline = self.pipeline

    # -- priorities --------------------------------------------------------

    def pg_priority(self, backend, pool_params: dict | None = None,
                    backfill: frozenset = frozenset(),
                    forced: bool = False) -> int:
        if forced:
            return OSD_RECOVERY_PRIORITY_FORCED
        params = pool_params or {}
        pool_prio = max(-10, min(10, int(params.get("recovery_priority",
                                                    0) or 0)))
        acting = set(backend.acting)
        depth = len(acting & (backend.stale | backend.bus.down))
        if not backend.is_active():
            # inactive PG: writes are blocked — escalate past every
            # ordinary recovery (the reference's inactive base)
            base = OSD_RECOVERY_INACTIVE_PRIORITY_BASE + depth
        elif backfill:
            base = OSD_BACKFILL_PRIORITY_BASE + pool_prio + depth
        else:
            base = OSD_RECOVERY_PRIORITY_BASE + pool_prio + depth
        return max(1, min(OSD_RECOVERY_PRIORITY_MAX, base))

    # -- entry points ------------------------------------------------------

    @contextlib.contextmanager
    def held(self):
        """Jobs that :meth:`schedule_backend` queues inside this block
        request their local reservation only when the outermost block
        ends.  The map callback runs under it: peering takes the PG to
        Active and hands it its targets, and the rebuild is background
        work for later deliveries (the reference queues a PG's
        reservation request as an event after activation, not inside
        the map handling)."""
        self._holds += 1
        try:
            yield
        finally:
            self._holds -= 1
            if not self._holds:
                jobs, self._held_jobs = self._held_jobs, []
                for job in jobs:
                    if not job.cancelled:
                        self._request_local(job)

    def schedule_backend(self, backend, targets=None,
                         backfill=frozenset(),
                         forced: bool = False,
                         stalled=None) -> PGRecoveryJob:
        """Queue (or merge into) the PG's recovery job.  ``targets``
        defaults to the backend's stale-but-up shards; an existing live
        job absorbs new targets instead of double-reserving."""
        ctx = getattr(backend, "_recovery_ctx", None)
        if ctx is None:
            raise ValueError(f"backend {backend.instance_name} is not "
                             f"attached to scheduler {self.name}")
        key = backend.instance_name
        want = list(targets) if targets is not None else \
            sorted(backend.stale & backend.up_shards())
        job = self.jobs.get(key)
        if job is not None and not job.cancelled and \
                job.state in (JobState.QUEUED, JobState.RUNNING):
            added = False
            for s in want:
                if s not in job.batch and s not in job.targets:
                    job.targets.append(s)
                    added = True
            # merged targets carry their backfill classification along,
            # or later priority recomputations band them wrongly
            job.backfill = frozenset(job.backfill | set(backfill))
            prio = self.pg_priority(backend, job.pool_params,
                                    job.backfill, forced)
            if prio > job.priority:
                job.priority = prio
                if job.state is JobState.QUEUED:
                    self.local_reserver(backend.whoami).update_priority(
                        job.key, prio)
                elif job.remote_waiting is not None:
                    # escalation must reach the queued REMOTE request
                    # too, or a forced job keeps waiting at its old rank
                    self.remote_reserver(
                        job.remote_waiting).update_priority(
                        (job.key, job.remote_waiting), prio)
            if added and job.state is JobState.RUNNING:
                if not job.batch and not job.remote_pending:
                    self._start_batch(job)
                else:
                    # a batch is in flight but the NEW target may be the
                    # very shard whose catch-up the batch's recoveries
                    # are waiting on (current_shards() below k): restart
                    # with the union — all of a PG's stale shards must
                    # repair together or none can finish
                    self._restart_batch(job)
            return job
        job = PGRecoveryJob(
            key=key, backend=backend, pgid=ctx["pgid"],
            daemon=ctx["daemon"], pool_params=ctx["pool_params"],
            targets=list(want), backfill=frozenset(backfill),
            priority=self.pg_priority(backend, ctx["pool_params"],
                                      frozenset(backfill), forced))
        job.scheduler = self
        # stalled ops must board BEFORE the reservation request: the
        # grant can fire synchronously and run the job to completion —
        # ops attached to an already-completed (popped) job are stranded
        job.stalled = list(stalled or [])
        self.jobs[key] = job
        self.perf.inc("jobs_scheduled")
        if self.clog is not None:
            self.clog.info(
                f"recovery queued for pg {job.pgid} "
                f"(targets {sorted(job.targets)}, prio {job.priority})",
                channel="recovery")
        self._update_gauges()
        if self._holds:
            self._held_jobs.append(job)
        else:
            self._request_local(job)
        return job

    def _request_local(self, job: PGRecoveryJob) -> None:
        lgen = job.local_gen
        self.local_reserver(job.backend.whoami).request_reservation(
            job.key,
            on_grant=lambda: self._local_granted(job, lgen),
            prio=job.priority,
            on_preempt=lambda: self._preempted_local(job, lgen))

    def requeue_stalled(self, backend, rops) -> PGRecoveryJob | None:
        """Parked RecoveryOps re-enter reservation-gated: they ride the
        PG's job (merged with any pending shard repairs) instead of
        bypassing the scheduler on shard revival."""
        rops = [r for r in rops if r is not None]
        if not rops:
            return None
        self.perf.inc("stalled_requeued", len(rops))
        job = self.jobs.get(backend.instance_name)
        if job is not None and not job.cancelled and \
                job.state in (JobState.QUEUED, JobState.RUNNING):
            # board before the merge: _start_batch may run _maybe_complete
            # and an empty stalled list would let the job finish under us
            job.stalled.extend(rops)
            self.schedule_backend(backend)
            if job.state is JobState.RUNNING:
                self._drive_stalled(job)
                self._maybe_complete(job)
            return job
        return self.schedule_backend(backend, stalled=rops)

    def cancel_pg(self, backend, reason: str = "map change") -> bool:
        """Map change / re-peering: abort the PG's job cleanly.  The
        current shard repair fails (the shard stays stale), reservations
        release, still-parked ops go back to the backend's stall list —
        the re-activation that follows schedules a fresh job."""
        job = self.jobs.pop(backend.instance_name, None)
        if job is None or job.state in (JobState.COMPLETE,
                                        JobState.CANCELLED):
            return False
        job.cancelled = True
        job.gen += 1
        job.local_gen += 1
        job.state = JobState.CANCELLED
        self.perf.inc("map_cancels")
        self._release_all(job)
        self._abort_batch(job)
        backend._stalled_recoveries.extend(job.stalled)
        job.stalled = []
        self._update_gauges()
        return True

    # -- job state machine -------------------------------------------------

    def _local_granted(self, job: PGRecoveryJob, lgen: int) -> None:
        if job.local_gen != lgen or job.cancelled:
            return
        job.state = JobState.RUNNING
        self._update_gauges()
        self._drive_stalled(job)
        self._start_batch(job)

    def _start_batch(self, job: PGRecoveryJob) -> None:
        """Take every queued target as ONE batch and acquire its remote
        reservations in ascending-OSD order before any repair starts
        ('local+remote reservations before any push')."""
        if job.cancelled or job.batch or job.remote_pending:
            return
        seen: set[int] = set()
        batch: list[int] = []
        for shard in job.targets:
            if shard not in seen and shard not in job.backend.bus.down:
                seen.add(shard)
                batch.append(shard)
        job.targets = []
        if not batch:
            self._maybe_complete(job)
            return
        job.batch = batch
        job.remote_pending = sorted(s for s in batch
                                    if s != job.backend.whoami)
        self._acquire_next_remote(job)

    def _acquire_next_remote(self, job: PGRecoveryJob) -> None:
        if job.cancelled:
            return
        if not job.remote_pending:
            if not job.reserved:
                self._reserved(job)
            self._run_batch(job)
            return
        shard = job.remote_pending.pop(0)
        job.remote_waiting = shard
        gen = job.gen
        self.remote_reserver(shard).request_reservation(
            (job.key, shard),
            on_grant=lambda: self._remote_granted(job, shard, gen),
            prio=job.priority,
            on_preempt=lambda: self._preempted(job, gen))

    def _remote_granted(self, job: PGRecoveryJob, shard: int,
                        gen: int) -> None:
        if job.gen != gen or job.cancelled:
            # grant raced a preemption/cancel of this incarnation: give
            # the slot straight back, or it would be held forever
            self.remote_reserver(shard).cancel_reservation((job.key,
                                                            shard))
            return
        job.remote_waiting = None
        job.remote_held.add(shard)
        self._acquire_next_remote(job)

    def _reserved(self, job: PGRecoveryJob) -> None:
        """The job holds its local reservation and every remote one of
        its batch for the first time: book the wait since it was
        scheduled (span ``recovery.reserve_wait``, counter
        ``reserve_wait_time``)."""
        job.reserved = True
        default_tracer().observe("recovery.reserve_wait", job.t_sched)
        self.perf.tinc("reserve_wait_time", time.perf_counter() - job.t_sched)

    def _run_batch(self, job: PGRecoveryJob) -> None:
        """Every reservation held: start ALL the batch's shard repairs
        (concurrently — one shard's objects may only be recoverable once
        the others catch up; see the class docstring)."""
        gen = job.gen
        b = job.backend
        job.repairs_open = 0
        for shard in list(job.batch):
            if shard in b.bus.down:
                job.batch.remove(shard)
                continue
            job.repairs_open += 1
            # the backend dedupes repairs by shard (an existing one just
            # chains our on_complete), so every increment above has a
            # matching completion callback
            job.rops[shard] = b.start_shard_repair(
                shard,
                on_complete=lambda rop, _s=shard:
                    self._on_repair_done(job, _s, gen),
                driver=job)
        if job.repairs_open == 0:
            self._finish_batch(job)

    def _on_repair_done(self, job: PGRecoveryJob, shard: int,
                        gen: int) -> None:
        if job.gen != gen or job.cancelled:
            return
        if shard in job.batch:
            job.batch.remove(shard)
        job.rops.pop(shard, None)
        job.repairs_open = max(0, job.repairs_open - 1)
        if job.repairs_open == 0:
            self._finish_batch(job)

    def _restart_batch(self, job: PGRecoveryJob) -> None:
        """Fold the in-flight batch back into the target queue and start
        over with the union.  Remote slots release and re-acquire in
        ascending order, preserving the deadlock-freedom invariant;
        aborted repairs fail cleanly (their shards stay stale and rejoin
        the new batch), completed pushes are kept by the stores."""
        job.gen += 1                # in-flight wave/repair callbacks go inert
        self._abort_batch(job)
        self._release_remotes(job)
        job.targets = job.batch + job.targets
        job.batch, job.remote_pending = [], []
        job.repairs_open = 0
        job.open_ops = 0            # ungated in-flight ops drain on their own
        self._start_batch(job)

    def _finish_batch(self, job: PGRecoveryJob) -> None:
        job.batch = []
        self._release_remotes(job)
        self._drive_stalled(job)
        if job.targets:                 # revivals that arrived mid-batch
            self._start_batch(job)
        else:
            self._maybe_complete(job)

    def _maybe_complete(self, job: PGRecoveryJob) -> None:
        if job.cancelled or job.targets or job.batch or \
                job.remote_pending or job.stalled or job.open_ops:
            return
        job.state = JobState.COMPLETE
        self.jobs.pop(job.key, None)
        self.local_reserver(job.backend.whoami).cancel_reservation(job.key)
        self.perf.inc("jobs_completed")
        if self.clog is not None:
            self.clog.info(f"recovery of pg {job.pgid} complete",
                           channel="recovery")
        self._update_gauges()

    def _preempted(self, job: PGRecoveryJob, gen: int) -> None:
        """A REMOTE reservation we hold (or wait on) was preempted."""
        if job.gen != gen or job.cancelled:
            return
        self._do_preempt(job)

    def _preempted_local(self, job: PGRecoveryJob, lgen: int) -> None:
        """The LOCAL reservation was preempted (guarded by its own
        generation: batch restarts bump `gen` but leave the local
        grant's closures live)."""
        if job.local_gen != lgen or job.cancelled:
            return
        self._do_preempt(job)

    def _do_preempt(self, job: PGRecoveryJob) -> None:
        """A higher-priority PG took a reservation: stop cleanly — the
        batch's shard repairs fail (their shards stay stale, nothing
        half-applied), in-flight object pushes drain harmlessly — and
        requeue at a freshly computed priority."""
        job.gen += 1
        job.local_gen += 1
        self.perf.inc("preemptions")
        self._release_all(job)
        self._abort_batch(job)
        job.targets = job.batch + job.targets   # remote_pending ⊆ batch
        job.batch, job.remote_pending = [], []
        job.repairs_open = 0
        job.open_ops = 0            # ungated in-flight ops drain on their own
        job.state = JobState.QUEUED
        job.priority = self.pg_priority(job.backend, job.pool_params,
                                        job.backfill)
        self._update_gauges()
        self._request_local(job)

    def _release_all(self, job: PGRecoveryJob) -> None:
        self.local_reserver(job.backend.whoami).cancel_reservation(job.key)
        self._release_remotes(job)

    def _release_remotes(self, job: PGRecoveryJob) -> None:
        """ONE copy of remote-slot release, shared by batch finish,
        batch restart, preemption, and cancel."""
        for shard in sorted(job.remote_held):
            self.remote_reserver(shard).cancel_reservation((job.key,
                                                            shard))
        job.remote_held.clear()
        if job.remote_waiting is not None:
            # a request still queued (no grant yet) must be withdrawn too
            self.remote_reserver(job.remote_waiting).cancel_reservation(
                (job.key, job.remote_waiting))
            job.remote_waiting = None

    def _abort_batch(self, job: PGRecoveryJob) -> None:
        """Fail the batch's shard repairs NOW and deregister them: a
        restarted (or freshly granted) batch must start FRESH repairs —
        leaving a doomed op in ``shard_repairs`` would make the restart
        silently join it and complete with the shard still stale.
        Callbacks of in-flight recover/delete sub-ops go inert once the
        op leaves RECOVERING (the on_shard_down discipline)."""
        b = job.backend
        for shard, rop in sorted(job.rops.items()):
            rop.deferred = []
            rop.failed = True
            if b.shard_repairs.get(shard) is rop:
                b._repair_write_tids = {
                    tid: v for tid, v in b._repair_write_tids.items()
                    if v[0] is not rop}
                rop.pending.clear()
                b._finish_shard_repair(rop)
        job.rops.clear()

    # -- stalled-op re-drive (reservation-gated) ---------------------------

    def _drive_stalled(self, job: PGRecoveryJob) -> None:
        rops, job.stalled = job.stalled, []
        b = job.backend
        for rop in rops:
            gen = job.gen
            prev = rop.on_complete

            def chained(rec, _prev=prev, _job=job, _gen=gen):
                if _prev:
                    _prev(rec)
                self._stalled_op_done(_job, _gen)
            rop.on_complete = chained
            job.open_ops += 1
            try:
                b.continue_recovery_op(rop)
            except IOError:
                # still too few survivors: back to the parked list,
                # reservation budget released for this op
                rop.on_complete = prev
                job.open_ops -= 1
                b._stalled_recoveries.append(rop)

    def _stalled_op_done(self, job: PGRecoveryJob, gen: int) -> None:
        if job.gen != gen or job.cancelled:
            return
        job.open_ops = max(0, job.open_ops - 1)
        self._maybe_complete(job)

    # -- wave pacing (the jobs' engine) -----------------------------------

    def _queue_wave(self, job: PGRecoveryJob, rop) -> None:
        """The next wave rides the primary daemon's dmClock queue in the
        background_recovery class: client ops win under load."""
        gen = job.gen
        job.daemon.queue_background(
            job.pgid, lambda: self._run_wave(job, rop, gen),
            op_class=BG_RECOVERY)

    def _run_wave(self, job: PGRecoveryJob, rop, gen: int) -> None:
        if job.gen != gen or job.cancelled or not rop.deferred:
            return
        daemon, b = job.daemon, job.backend
        now = daemon._now()
        if job.not_before > now:
            # 'sleeping' in the cooperative model is consuming virtual
            # time: the byte-budget debt + osd_recovery_sleep
            daemon.advance_clock(job.not_before - now)
        n = max(1, int(self._conf("osd_recovery_max_active")))
        items = rop.deferred[:n]
        del rop.deferred[:n]
        est = 0
        for oid, op in items:
            if op != OP_DELETE:
                try:
                    est += b.object_size(oid)
                except (KeyError, OSError):   # gone or unreadable here:
                    pass                      # the wave finds out
        wait = self._bucket(daemon.whoami).consume(est, daemon._now())
        job.not_before = daemon._now() + wait + \
            float(self._conf("osd_recovery_sleep"))
        self.perf.inc("waves")
        self.perf.inc("wave_objects", len(items))
        # phase="dispatch": the wave span's SELF time is host-side wave
        # orchestration (the sub-reads and fused decode under it carry
        # their own wire/device phases) — explicit so the critical-path
        # registry guard sees a declaration at the call site too
        with trace_span("recovery.wave", owner="recovery",
                        phase="dispatch",
                        pg=repr(job.pgid), objects=len(items)):
            b.repair_wave(rop, items,
                          on_done=lambda: self._wave_done(job, rop, gen))

    def _wave_done(self, job: PGRecoveryJob, rop, gen: int) -> None:
        if job.gen != gen or job.cancelled:
            return
        if rop.deferred:
            self._queue_wave(job, rop)
        # else: the repair's own completion path (catch-up delta +
        # _finish_shard_repair) fires on_complete -> _on_repair_done

    # -- observability -----------------------------------------------------

    def _update_gauges(self) -> None:
        queued, active = self.job_counts()
        self.perf.set("jobs_queued", queued)
        self.perf.set("jobs_active", active)

    def job_counts(self) -> tuple[int, int]:
        """(queued, active) — the PG_RECOVERY_STALLED check's input."""
        return (sum(1 for j in self.jobs.values()
                    if j.state is JobState.QUEUED),
                sum(1 for j in self.jobs.values()
                    if j.state is JobState.RUNNING))

    def reserver_gauges(self) -> list[tuple[str, int, int, int]]:
        """(kind, osd, queue_depth, in_flight) rows — the prometheus
        ``ceph_tpu_recovery_reserver_*`` surface."""
        rows = []
        for kind, table in (("local", self._local),
                            ("remote", self._remote)):
            for osd, r in sorted(table.items()):
                rows.append((kind, osd, r.queue_depth(), r.in_flight()))
        return rows

    def summary(self) -> dict:
        """The ``ceph -s`` recovery block: queued/active PG jobs +
        reservation occupancy."""
        queued, active = self.job_counts()
        res = {"queued": 0, "granted": 0}
        for _kind, _osd, depth, granted in self.reserver_gauges():
            res["queued"] += depth
            res["granted"] += granted
        return {"queued_pgs": queued, "active_pgs": active,
                "reservations": res}

    def dump(self) -> dict:
        return {
            "jobs": {k: {"state": j.state.value, "priority": j.priority,
                         "targets": list(j.targets),
                         "batch": list(j.batch),
                         "remote_held": sorted(j.remote_held),
                         "stalled": len(j.stalled),
                         "open_ops": j.open_ops}
                     for k, j in sorted(self.jobs.items())},
            "local": {o: r.dump() for o, r in sorted(self._local.items())},
            "remote": {o: r.dump()
                       for o, r in sorted(self._remote.items())},
        }
