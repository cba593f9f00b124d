"""The PG peering statechart: acting-set negotiation over the bus.

Analog of the reference's boost::statechart peering machine (reference:
src/osd/PeeringState.{h,cc} — states at PeeringState.h:604-774,
GetInfo/GetLog/GetMissing/Activating flow in PeeringState.cc).  The
reference encodes ~6600 LoC of statechart; what survives the redesign is
the OBSERVABLE protocol:

    AdvMap ──▶ GetInfo ──(all infos)──▶ GetLog ──(authority adopted)──▶
    GetMissing ──(missing computed)──▶ Activating ──(all acks)──▶ Active

- **GetInfo**: the primary queries every up member of the acting set for
  its pg_info (log head/tail + entries) — `PGLogQuery` fan-out.
- **choose_acting / find_best_info**: the authority is the info with the
  max last_update, ties broken by the longer log (lower tail) then the
  lower shard id (PeeringState::find_best_info semantics).  Peers whose
  logs can catch up by replay join the acting set; peers past the log
  horizon are marked backfill targets (PeeringState::choose_acting's
  "needs backfill" split).
- **GetLog**: if the authority is a peer, its log is merged and entries
  witnessed by < min_size shards roll back (never acked — the shared
  election in PGBackend.elect_and_adopt_authority).
- **GetMissing**: per-peer catch-up plans derived from log divergence;
  stale peers get shard-repair ops queued (log replay or backfill).
- **Activating**: `PGActivate` fans to every up peer; each replica moves
  Stray→ReplicaActive, stamps the epoch, and acks.  When every ack is in,
  the PG is **Active**: parked writes re-drive and last_epoch_started
  advances.

A peer dying mid-peering (bus down event) just shrinks the expectation
set — peering completes with the survivors, exactly like the reference
restarting GetInfo on prior-set changes.

The machine records every transition in ``history`` (epoch, state) — the
`pg_state` the reference exposes via `ceph pg dump`.

A copy of ``ceph_tpu.osd.peering``.
"""
from __future__ import annotations

from dataclasses import dataclass
from enum import Enum

from ..backend.messages import PGActivate, PGActivateAck, PGLogInfo, \
    PGLogQuery


class PState(Enum):
    """State names mirror PeeringState.h:604-774's nesting."""
    INITIAL = "Initial"
    GET_INFO = "Started/Primary/Peering/GetInfo"
    GET_LOG = "Started/Primary/Peering/GetLog"
    GET_MISSING = "Started/Primary/Peering/GetMissing"
    ACTIVATING = "Started/Primary/Active/Activating"
    ACTIVE = "Started/Primary/Active"


@dataclass
class PeerInfo:
    """pg_info_t subset the negotiation runs on."""
    shard: int
    last_update: int
    tail: int


class PeeringCoordinator:
    """The primary-side peering machine bound to one PG backend."""

    def __init__(self, backend):
        self.backend = backend
        backend.peering = self
        self.state = PState.INITIAL
        self.epoch = 0
        self.last_epoch_started = 0
        self.history: list[tuple[int, str]] = [(0, PState.INITIAL.value)]
        self._expect_infos: set[int] = set()
        self._infos: dict[int, PGLogInfo] = {}
        self._expect_acks: set[int] = set()
        self.acting_set: list[int] = list(backend.acting)
        self.backfill_targets: set[int] = set()
        self.repair_targets: set[int] = set()
        backend.bus.down_listeners.append(self._on_peer_down)

    # -- bookkeeping -------------------------------------------------------

    def _enter(self, state: PState) -> None:
        self.state = state
        self.history.append((self.epoch, state.value))

    # -- events ------------------------------------------------------------

    def advance_map(self, epoch: int) -> None:
        """AdvMap: the map changed (shard died/revived, acting set
        touched) — restart peering from GetInfo.  Reference: the Peering
        super-state's AdvMap reaction."""
        self.epoch = max(self.epoch, epoch)
        b = self.backend
        sched = getattr(b, "recovery_scheduler", None)
        if sched is not None:
            # map change preempts background repair cleanly: the job's
            # reservations release and the re-activation below queues a
            # fresh one against the new acting-set reality
            sched.cancel_pg(b)
        peers = {s for s in b.acting if s != b.whoami and s not in b.bus.down}
        self._infos = {}
        self._expect_infos = set(peers)
        self._expect_acks = set()
        self._enter(PState.GET_INFO)
        if not peers:
            self._got_all_infos()
            return
        for shard in sorted(peers):
            # entries below our tail are trimmed cluster-wide, so the
            # reply only ships the segment election/repair can use (the
            # same bound start_shard_repair queries with)
            b.bus.send(shard, PGLogQuery(b.whoami, since=b.pg_log.tail))

    def offer_pg_log_info(self, info: PGLogInfo) -> bool:
        """MNotifyRec: a peer's info arrived.  Returns False when this
        machine is not collecting (the reply belongs to a repair op)."""
        if self.state != PState.GET_INFO or \
                info.from_shard not in self._expect_infos:
            return False
        self._infos[info.from_shard] = info
        if set(self._infos) >= self._expect_infos:
            self._got_all_infos()
        return True

    def on_activate_ack(self, ack: PGActivateAck) -> None:
        if self.state != PState.ACTIVATING or ack.epoch != self.epoch:
            return
        self._expect_acks.discard(ack.from_shard)
        if not self._expect_acks:
            self._activate_done()

    def _on_peer_down(self, shard: int) -> None:
        """A peer died mid-peering: shrink the expectation set (the
        reference restarts GetInfo when the prior set changes; with a
        fixed acting set, dropping the dead peer is equivalent)."""
        if self.state == PState.GET_INFO and shard in self._expect_infos:
            self._expect_infos.discard(shard)
            self._infos.pop(shard, None)
            if set(self._infos) >= self._expect_infos:
                self._got_all_infos()
        elif self.state == PState.ACTIVATING and shard in self._expect_acks:
            self._expect_acks.discard(shard)
            if not self._expect_acks:
                self._activate_done()

    # -- the flow ----------------------------------------------------------

    def _got_all_infos(self) -> None:
        b = self.backend
        infos = {b.whoami: PeerInfo(b.whoami, b.pg_log.head, b.pg_log.tail)}
        for shard, info in self._infos.items():
            infos[shard] = PeerInfo(shard, info.last_update, info.tail)
        # find_best_info: max last_update, then longer log, then low shard
        best = max(infos.values(),
                   key=lambda i: (i.last_update, -i.tail, -i.shard))
        self._enter(PState.GET_LOG)
        if best.shard != b.whoami and self._infos:
            # adopt the authority peer's log (+ witness-count rollback)
            b.elect_and_adopt_authority(dict(self._infos))
        self._enter(PState.GET_MISSING)
        # choose_acting: who serves, who repairs, who backfills
        self.acting_set = [b.whoami]
        self.backfill_targets = set()
        self.repair_targets = set()
        head = b.pg_log.head
        for shard, info in sorted(self._infos.items()):
            if info.last_update == head:
                self.acting_set.append(shard)
            elif info.last_update >= b.pg_log.tail:
                self.repair_targets.add(shard)      # log replay suffices
            else:
                self.backfill_targets.add(shard)    # past the log horizon
        self._enter(PState.ACTIVATING)
        up_peers = sorted(set(self._infos))
        self._expect_acks = set(up_peers)
        for shard in up_peers:
            b.bus.send(shard, PGActivate(b.whoami, self.epoch, head))
        if not up_peers:
            self._activate_done()

    def _activate_done(self) -> None:
        b = self.backend
        self._enter(PState.ACTIVE)
        self.last_epoch_started = self.epoch
        # queue recovery for stale/backfill peers: through the recovery
        # scheduler's reservation gate when one is attached (priorities,
        # osd_max_backfills, wave pacing), else inline through the repair
        # machinery (GetMissing's product; the repair op itself picks
        # log-replay vs backfill from the peer's reply)
        targets = [shard
                   for shard in sorted(self.repair_targets |
                                       self.backfill_targets)
                   if shard not in b.bus.down]
        sched = getattr(b, "recovery_scheduler", None)
        if sched is not None and targets:
            sched.schedule_backend(
                b, targets=targets,
                backfill=frozenset(self.backfill_targets))
        else:
            for shard in targets:
                b.start_shard_repair(shard)
        # an Active PG serves: re-drive writes parked while peering
        b._redrive_parked()
