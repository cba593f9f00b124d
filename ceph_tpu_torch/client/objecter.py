"""Objecter: client-side op lifecycle with epoch tracking and resend.

Analog of the reference's Objecter (reference: src/osdc/Objecter.cc —
``op_submit`` :2257, ``_calc_target`` re-running the OSDMap mapping chain
client-side :2786, ``_send_op`` :3239, and the resend-on-map-change scan
``_scan_requests``):

- the client holds ITS OWN OSDMap copy, which can be epochs behind the
  cluster's; every op's target (pg, primary, acting) is computed from that
  map and the op is stamped with the client's epoch;
- the OSD side (:meth:`~ceph_tpu_torch.cluster.MiniCluster.osd_submit`) rejects
  ops that arrive with a stale epoch at a PG whose acting set has since
  changed, or that address an OSD that is no longer the primary — the
  reject carries the current map (the mon-subscription refresh the
  reference drives via ``CEPH_MSG_OSD_MAP``);
- on a reject, and proactively on :meth:`handle_osd_map`, the Objecter
  recomputes every in-flight op's target and RESENDS the ones whose
  target moved — so a write issued against a pre-remap map lands on the
  new acting set without the caller doing anything;
- a PG's mapping depends only on the map, so the Objecter runs the
  mapping chain once per PG and map (one object at one epoch) and
  answers the PG's later ops from a memo that empties when the map
  changes (the per-epoch PG table the reference's OSD and mon keep).

The port's copy of ``ceph_tpu.client.objecter``.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field

from ..common.tracer import default_tracer
from ..osdmap import PG, OSDMap, ceph_stable_mod
from ..osdmap.str_hash import ceph_str_hash_rjenkins

MAX_ATTEMPTS = 8      # maps only move forward; a resend loop means a bug

_objecter_ids = itertools.count(1)

# live objecters (the live_daemons/live_engines pattern): the cluster's
# status() tick sweeps op timeouts on every objecter attached to it, so
# parked ops age into SLOW_OPS without anyone polling by hand
import weakref

_OBJECTERS: "weakref.WeakSet[Objecter]" = weakref.WeakSet()


def live_objecters() -> list["Objecter"]:
    return list(_OBJECTERS)


@dataclass
class _Op:
    """Objecter::Op (the in-flight bookkeeping, Objecter.h)."""
    tid: int
    pool_id: int
    oid: str
    data: bytes | None                    # None => read
    read_len: int = 0
    ops: list | None = None               # op VECTOR (IoCtx::operate path)
    snapid: int | None = None             # read AT this snap
    drain: bool = True                    # False = aio: queue, don't pump
    on_complete: object = None
    target: tuple | None = None           # (ps, primary, acting) last sent
    attempts: int = 0
    done: bool = False
    result: object = None
    # op-timeout accounting: parked ops (inactive PG, a shard
    # that never answers) older than osd_op_complaint_time get flagged
    # once by check_op_timeouts and counted on slow_ops -> SLOW_OPS
    submitted_at: float = 0.0
    slow: bool = False
    # the op's root TraceContext: every send/resend (and the whole
    # cross-daemon fan-out below it) stitches under ONE trace id
    trace: object = None


class Objecter:
    """Client op dispatcher over a MiniCluster's RADOS surface."""

    def __init__(self, cluster):
        self.cluster = cluster
        # the client's own map: starts current, goes stale as the cluster
        # moves on (unless wired to a monitor via handle_osd_map)
        self.osdmap: OSDMap = cluster.osdmap
        self.next_tid = 0
        self.inflight: dict[int, _Op] = {}
        self.resends = 0
        self.stale_rejects = 0
        # per-objecter perf collection: in-flight gauge + the slow_ops
        # counter the SLOW_OPS health check's window delta picks up (the
        # Objecter::op_timeout -> mon complaint path of the reference)
        from ..common.perf_counters import PerfCountersBuilder
        self.perf = (
            PerfCountersBuilder(f"objecter.{next(_objecter_ids)}")
            .add_u64("inflight", "client ops submitted and not yet "
                                 "completed (parked ops included)")
            .add_u64_counter("ops", "client ops submitted through this "
                                    "objecter")
            .add_u64_counter("slow_ops", "in-flight ops older than "
                                         "osd_op_complaint_time when "
                                         "check_op_timeouts ran")
            .add_u64_counter("target_hits", "op targets answered from the "
                                            "per-PG memo of the map")
            .add_u64_counter("target_misses", "op targets that ran the "
                                              "mapping chain (first op of "
                                              "a PG under a map)")
            .create_perf_counters())
        # (pool, ps) -> (primary, acting) under the map it was filled
        # from: that map object at that epoch; emptied when either moves
        self._targets: dict[tuple[int, int], tuple[int, tuple]] = {}
        self._targets_map: OSDMap | None = None
        self._targets_epoch = 0
        cluster.cct.perf.add(self.perf)
        _OBJECTERS.add(self)

    def close(self) -> None:
        """Unhook the perf collection (a discarded objecter must not
        leave a frozen inflight gauge behind)."""
        self.cluster.cct.perf.remove(self.perf.name)
        _OBJECTERS.discard(self)

    def check_op_timeouts(self, now: float | None = None) -> list[int]:
        """Flag every in-flight op older than ``osd_op_complaint_time``
        (once per op) and count it on ``slow_ops`` — the client edge of
        SLOW_OPS: a black-holed or parked op becomes a health signal
        instead of a silent hang.  Returns the tids flagged."""
        now = time.monotonic() if now is None else now
        complaint = self.cluster.cct.conf.get("osd_op_complaint_time")
        flagged = []
        for op in list(self.inflight.values()):
            if not op.done and not op.slow and \
                    now - op.submitted_at >= complaint:
                op.slow = True
                self.perf.inc("slow_ops")
                flagged.append(op.tid)
        self.perf.set("inflight", len(self.inflight))
        return flagged

    # -- target computation (Objecter.cc:2786) -----------------------------

    def _calc_target(self, pool_id: int, oid: str) -> tuple[int, int, tuple]:
        with default_tracer().span("objecter.calc_target", cat="client"):
            m = self.osdmap
            pool = m.pools[pool_id]
            ps = ceph_stable_mod(ceph_str_hash_rjenkins(oid), pool.pg_num,
                                 pool.pg_num_mask)
            if self._targets_map is not m or self._targets_epoch != m.epoch:
                self._targets = {}
                self._targets_map, self._targets_epoch = m, m.epoch
            hit = self._targets.get((pool_id, ps))
            if hit is not None:
                self.perf.inc("target_hits")
                return ps, *hit
            self.perf.inc("target_misses")
            _, _, acting, _ = m.pg_to_up_acting_osds(PG(pool_id, ps))
            hit = (acting[0] if acting else -1, tuple(acting))
            self._targets[(pool_id, ps)] = hit
            return ps, *hit

    # -- op lifecycle (Objecter.cc:2257 op_submit) -------------------------

    def write(self, pool_id: int, oid: str, data: bytes,
              on_complete=None) -> int:
        self.next_tid += 1
        op = _Op(self.next_tid, pool_id, oid, bytes(data),
                 on_complete=on_complete)
        self._track(op)
        self._send_op(op)
        return op.tid

    def _track(self, op: _Op) -> None:
        op.submitted_at = time.monotonic()
        self.inflight[op.tid] = op
        self.perf.inc("ops")
        self.perf.set("inflight", len(self.inflight))

    def operate(self, pool_id: int, oid: str, op,
                on_complete=None, snapid: int | None = None,
                drain: bool = True) -> int:
        """Submit a librados-style op VECTOR (ObjectOperation) through the
        full client lifecycle — epoch-stamped target, stale reject +
        resend on map change — landing in the primary's op engine
        (IoCtx::operate -> op_submit -> PrimaryLogPG::do_osd_ops).
        ``on_complete`` receives the MOSDOpReply."""
        self.next_tid += 1
        o = _Op(self.next_tid, pool_id, oid, None, ops=list(op.ops),
                snapid=snapid, drain=drain, on_complete=on_complete)
        self._track(o)
        self._send_op(o)
        return o.tid

    def read(self, pool_id: int, oid: str, length: int) -> bytes:
        """Synchronous read convenience (librados rados_read shape)."""
        self.next_tid += 1
        op = _Op(self.next_tid, pool_id, oid, None, read_len=length)
        self._track(op)
        self._send_op(op)
        if not op.done:
            self.inflight.pop(op.tid, None)    # no ghost resends later
            raise IOError(f"read of {oid} did not complete")
        if isinstance(op.result, Exception):
            raise op.result
        return op.result

    def _send_op(self, op: _Op) -> None:
        if op.attempts >= MAX_ATTEMPTS:
            op.done = True
            op.result = IOError(f"op {op.tid} exceeded {MAX_ATTEMPTS} sends")
            self.inflight.pop(op.tid, None)
            if op.on_complete:
                op.on_complete(op.result)
            return
        op.attempts += 1
        ps, primary, acting = self._calc_target(op.pool_id, op.oid)
        op.target = (ps, primary, acting)
        # the client edge of the distributed trace: one root context per
        # op (resends reuse it — they are the same logical op), activated
        # around the dispatch so the whole server-side fan-out chains
        # under the client.op span on the 'client' track
        tr = default_tracer()
        if op.trace is None:
            op.trace = tr.new_trace("client")
        # a RESEND is retry overhead by definition: its span is named
        # apart so the critical-path ledger charges the whole re-sent
        # attempt to the `retry` phase (the first attempt stays
        # client.op — the op itself, not its retries)
        span_name = "client.op" if op.attempts == 1 else "client.op_retry"
        with tr.activate(op.trace, track="client"), \
                tr.span(span_name, cat="client", oid=op.oid,
                        tid=op.tid, attempt=op.attempts):
            reply = self.cluster.osd_submit(
                op.pool_id, ps, primary, self.osdmap.epoch,
                oid=op.oid, data=op.data, read_len=op.read_len, ops=op.ops,
                snapid=op.snapid, drain=op.drain,
                on_done=lambda result, _op=op: self._op_done(_op, result))
        if reply is not None:             # ("stale", current_map)
            _, newer = reply
            self.stale_rejects += 1
            attempts_before = op.attempts
            self.handle_osd_map(newer)    # refresh + resend moved ops
            if (not op.done and op.tid in self.inflight and
                    op.attempts == attempts_before):
                # handle_osd_map did not resend us (target unchanged —
                # a pure epoch bump at the PG): resend explicitly
                self.resends += 1
                self._send_op(op)

    def _op_done(self, op: _Op, result) -> None:
        if op.done:
            return
        op.done = True
        op.result = result
        self.inflight.pop(op.tid, None)
        self.perf.set("inflight", len(self.inflight))
        if op.on_complete:
            op.on_complete(result)

    # -- map updates (the CEPH_MSG_OSD_MAP path + _scan_requests) ----------

    def handle_osd_map(self, new_map: OSDMap) -> None:
        """Adopt a newer map and resend every in-flight op whose target
        changed under it (Objecter.cc _scan_requests -> _send_op)."""
        if new_map.epoch <= self.osdmap.epoch:
            return
        self.osdmap = new_map
        for op in list(self.inflight.values()):
            if op.done:
                continue
            ps, primary, acting = self._calc_target(op.pool_id, op.oid)
            if (ps, primary, acting) != op.target:
                self.resends += 1
                self._send_op(op)

    def attach(self, mon) -> None:
        """Subscribe to a monitor's committed maps (mon session)."""
        mon.subscribers.append(lambda new_map, inc:
                               self.handle_osd_map(new_map))
