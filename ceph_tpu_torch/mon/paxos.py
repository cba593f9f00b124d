"""Multi-monitor Paxos: rank election, collect/begin/accept/commit.

Analog of the reference's monitor consensus (reference: src/mon/Paxos.cc,
1585 LoC — phases ``collect`` (recovery after election), ``begin`` (leader
proposes), ``handle_accept``, ``commit``; elections in src/mon/Elector.cc —
lowest rank among reachable monitors wins).  The single-``Monitor``
shortcut ("a commit IS quorum") becomes real consensus here:

- a value (an OSDMap ``Incremental``) commits only after EVERY member of
  the quorum accepts it, and a quorum is a strict majority of the monmap —
  so any committed map change survives the death of any minority of
  monitors, including the leader;
- after every election the new leader runs the COLLECT phase: peons report
  their ``last_committed``/``accepted_pn`` and any uncommitted value;
  the leader catches up laggards, adopts the highest-pn uncommitted value
  and re-proposes it — the "leader died between begin and commit" recovery
  (Paxos.cc handle_last -> begin of previously-accepted value);
- proposal numbers are ``round*100 + rank`` so they are unique and
  monotonic across leaders (Paxos.cc get_new_proposal_number).

Monitors talk over the same deterministic
:class:`~ceph_tpu_torch.backend.messages.MessageBus` the OSDs use (mark_down =
monitor death), so elections/proposals interleave with the existing fault
injection.  Each monitor embeds a :class:`~ceph_tpu_torch.mon.monitor.Monitor`
service (the OSDMonitor analog) whose ``propose_pending`` routes through
Paxos when quorum mode is on.

The port's copy of ``ceph_tpu.mon.paxos``.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

from .monitor import Monitor
from ..backend.messages import MessageBus
from ..common import Context, default_context
from ..osdmap import Incremental, OSDMap


# -- wire payloads (MMonElection / MMonPaxos analogs) -------------------------

@dataclass
class ElectionPropose:
    from_shard: int
    epoch: int


@dataclass
class ElectionAck:
    from_shard: int
    epoch: int


@dataclass
class ElectionVictory:
    from_shard: int
    epoch: int
    quorum: tuple


@dataclass
class Collect:
    from_shard: int
    pn: int
    last_committed: int


@dataclass
class CollectReply:
    from_shard: int
    pn: int
    accepted_pn: int
    last_committed: int
    # committed versions the leader is missing: {version: (now, inc)}
    commits: dict = field(default_factory=dict)
    # (pn, version, (now, inc)) accepted but never committed, or None
    uncommitted: tuple | None = None


@dataclass
class Begin:
    from_shard: int
    pn: int
    version: int
    value: tuple            # (now, Incremental)


@dataclass
class Forward:
    """Peon -> leader: a client value (MForward).  ``seq`` is the per-peon
    reqid the leader dedups on — a duplicated forward must not commit (and,
    with XOR incremental semantics, un-commit) the value twice."""
    from_shard: int
    seq: int
    value: tuple


@dataclass
class Accept:
    from_shard: int
    pn: int
    version: int


@dataclass
class Commit:
    from_shard: int
    version: int
    value: tuple


class PaxosMonitor:
    """One monitor: elector + paxos + embedded OSDMonitor service."""

    def __init__(self, rank: int, bus: MessageBus, n_mons: int,
                 osdmap: OSDMap, cct: Context | None = None):
        self.rank = rank
        self.bus = bus
        self.n_mons = n_mons
        self.cct = cct if cct is not None else default_context()
        self.service = Monitor(osdmap, cct=self.cct)
        self.service.submit_fn = self.submit
        # paxos state (the store: committed transaction log)
        self.committed: dict[int, tuple] = {}
        self.last_committed = 0
        self.accepted_pn = 0
        self.uncommitted: tuple | None = None    # (pn, version, value)
        # election state
        self.epoch = 0
        self.leader: int | None = None
        self.quorum: set[int] = set()
        self._electing = False
        self._election_acks: set[int] = set()
        # leader proposal state
        self._collecting: set[int] | None = None
        self._collect_pn = 0
        self._collect_uncommitted: list[tuple] = []
        self._proposing: tuple | None = None     # (version, value)
        self._accepts: set[int] = set()
        self.pending_values: deque = deque()
        self._forward_seq = 0
        self._forward_seen: dict[int, int] = {}  # peon rank -> last seq
        self.on_commit: list = []                # fn(version, value)
        bus.register(rank, self)

    # -- helpers -------------------------------------------------------------

    def up_peers(self) -> list[int]:
        return [r for r in range(self.n_mons)
                if r != self.rank and r not in self.bus.down]

    def is_leader(self) -> bool:
        return (self.leader == self.rank and
                len(self.quorum) > self.n_mons // 2 and
                self._collecting is None)

    def in_quorum(self) -> bool:
        return self.leader is not None and self.rank in self.quorum

    # -- election (Elector.cc: lowest reachable rank wins) --------------------

    def start_election(self) -> None:
        self.epoch += 1
        self.leader = None
        self.quorum = set()
        # queued-but-not-begun client values die with the reign: the
        # services that produced them re-propose from their own state
        # (the PaxosService::restart semantics; clients resend)
        self.pending_values.clear()
        self._electing = True
        self._election_acks = {self.rank}
        # the deterministic analog of the elector's timeout window: wait
        # for every currently-up peer's deferral, not just a bare
        # majority, so up monitors are never left out of the quorum
        self._election_expect = {self.rank} | set(self.up_peers())
        self._proposing = None
        self._collecting = None
        for peer in self.up_peers():
            self.bus.send(peer, ElectionPropose(self.rank, self.epoch))
        self._maybe_win()

    def _maybe_win(self) -> None:
        if not self._electing or \
                len(self._election_acks) <= self.n_mons // 2 or \
                not self._election_acks >= self._election_expect:
            return
        self._electing = False
        self.leader = self.rank
        self.quorum = set(self._election_acks)
        for peer in sorted(self.quorum - {self.rank}):
            self.bus.send(peer, ElectionVictory(self.rank, self.epoch,
                                                tuple(sorted(self.quorum))))
        self._leader_init()

    def handle_message(self, msg) -> None:
        if isinstance(msg, ElectionPropose):
            if msg.from_shard > self.rank:
                # I out-rank the proposer: contest (Elector defers only to
                # lower ranks)
                if not self._electing or msg.epoch > self.epoch:
                    self.epoch = max(self.epoch, msg.epoch)
                    self.start_election()
            else:
                self.epoch = max(self.epoch, msg.epoch)
                self._electing = True
                self.leader = None
                self.bus.send(msg.from_shard,
                              ElectionAck(self.rank, msg.epoch))
        elif isinstance(msg, ElectionAck):
            if self._electing and msg.epoch == self.epoch:
                self._election_acks.add(msg.from_shard)
                self._maybe_win()
        elif isinstance(msg, ElectionVictory):
            if msg.epoch >= self.epoch:
                self.epoch = msg.epoch
                self.leader = msg.from_shard
                self.quorum = set(msg.quorum)
                self._electing = False
                self._proposing = None
                self.pending_values.clear()
        elif isinstance(msg, Forward):
            self._handle_forward(msg)
        elif isinstance(msg, Collect):
            self._handle_collect(msg)
        elif isinstance(msg, CollectReply):
            self._handle_collect_reply(msg)
        elif isinstance(msg, Begin):
            self._handle_begin(msg)
        elif isinstance(msg, Accept):
            self._handle_accept(msg)
        elif isinstance(msg, Commit):
            self._handle_commit(msg)
        else:
            raise TypeError(f"mon.{self.rank}: unexpected {msg!r}")

    # -- collect: post-election recovery (Paxos.cc collect/handle_last) -------

    def _leader_init(self) -> None:
        round_ = max(self.accepted_pn, self._collect_pn) // 100 + 1
        self._collect_pn = round_ * 100 + self.rank
        self.accepted_pn = self._collect_pn
        self._collecting = set(self.quorum) - {self.rank}
        self._collect_uncommitted = []
        if self.uncommitted is not None:
            pn, version, value = self.uncommitted
            self._collect_uncommitted.append((pn, version, value))
        if not self._collecting:
            self._finish_collect()
            return
        for peer in sorted(self._collecting):
            self.bus.send(peer, Collect(self.rank, self._collect_pn,
                                        self.last_committed))

    def _handle_collect(self, msg: Collect) -> None:
        if msg.pn >= self.accepted_pn:
            self.accepted_pn = msg.pn
            self.leader = msg.from_shard
        # ALWAYS reply (Paxos.cc handle_collect): a reply carrying a
        # higher accepted_pn is the nack that makes the collector retry
        # with a larger pn (handle_last's uncommitted_pn bump)
        reply = CollectReply(self.rank, msg.pn, self.accepted_pn,
                             self.last_committed)
        for v in range(msg.last_committed + 1, self.last_committed + 1):
            reply.commits[v] = self.committed[v]
        if self.uncommitted is not None and \
                self.uncommitted[1] > max(self.last_committed,
                                          msg.last_committed):
            reply.uncommitted = self.uncommitted
        self.bus.send(msg.from_shard, reply)

    def _handle_collect_reply(self, msg: CollectReply) -> None:
        if self._collecting is None:
            return
        if msg.accepted_pn > self._collect_pn:
            # a peon promised a higher pn under a previous reign: pick a
            # pn above it and re-run the whole collect
            self.accepted_pn = max(self.accepted_pn, msg.accepted_pn)
            self._leader_init()
            return
        if msg.pn != self._collect_pn:
            return
        # learn commits we missed while down/behind
        for v in sorted(msg.commits):
            if v == self.last_committed + 1:
                self._apply_commit(v, msg.commits[v])
        if msg.uncommitted is not None:
            self._collect_uncommitted.append(msg.uncommitted)
        self._collecting.discard(msg.from_shard)
        self._peon_last_committed = getattr(self, "_peon_last_committed", {})
        self._peon_last_committed[msg.from_shard] = msg.last_committed
        if not self._collecting:
            self._finish_collect()

    def _finish_collect(self) -> None:
        self._collecting = None
        # catch laggard peons up: ship every commit they are missing (the
        # share_state half of Paxos.cc handle_last) so future commits
        # apply in order on every quorum member
        peon_lc = getattr(self, "_peon_last_committed", {})
        for peer in sorted(self.quorum - {self.rank}):
            for v in range(peon_lc.get(peer, self.last_committed) + 1,
                           self.last_committed + 1):
                self.bus.send(peer, Commit(self.rank, v, self.committed[v]))
        # re-propose the highest-pn uncommitted value (the begin-without-
        # commit recovery: a previous leader died between begin and commit)
        redo = [u for u in self._collect_uncommitted
                if u[1] == self.last_committed + 1]
        if redo:
            pn, version, value = max(redo, key=lambda u: u[0])
            self._begin(value)
            return
        self._maybe_begin()

    # -- begin/accept/commit (Paxos.cc:1585 phases) ---------------------------

    def submit(self, now: float, inc: Incremental) -> bool:
        """PaxosService hands a pending map change to consensus.  Returns
        False when there is no quorum to accept it — the service keeps its
        pending state and re-proposes later (nothing is parked here: a
        stale Incremental replayed under a later reign would XOR-undo
        newer state)."""
        value = (now, inc)
        if self.leader is None or not self.in_quorum():
            return False
        if self.leader == self.rank:
            self.pending_values.append(value)
            self._maybe_begin()
        else:
            # forward to the leader (MForward), deduped by (rank, seq)
            self._forward_seq += 1
            self.bus.send(self.leader,
                          Forward(self.rank, self._forward_seq, value))
        return True

    def _handle_forward(self, msg: Forward) -> None:
        if msg.seq <= self._forward_seen.get(msg.from_shard, 0):
            return                       # duplicate forward (resend)
        self._forward_seen[msg.from_shard] = msg.seq
        if self.is_leader() or (self.leader == self.rank and
                                self._collecting is not None):
            self.pending_values.append(msg.value)
            self._maybe_begin()
        # not the leader (election raced the forward): drop — the origin
        # service re-proposes under the new reign

    def _maybe_begin(self) -> None:
        if (self._proposing is None and self._collecting is None and
                self.is_leader() and self.pending_values):
            self._begin(self.pending_values.popleft())

    def _begin(self, value: tuple) -> None:
        version = self.last_committed + 1
        self._proposing = (version, value)
        self._accepts = {self.rank}
        self.uncommitted = (self.accepted_pn, version, value)
        for peer in sorted(self.quorum - {self.rank}):
            self.bus.send(peer, Begin(self.rank, self.accepted_pn,
                                      version, value))
        self._maybe_commit()

    def _handle_begin(self, msg: Begin) -> None:
        if msg.pn < self.accepted_pn:
            return                       # stale proposer
        self.accepted_pn = msg.pn
        self.uncommitted = (msg.pn, msg.version, msg.value)
        self.bus.send(msg.from_shard, Accept(self.rank, msg.pn,
                                             msg.version))

    def _handle_accept(self, msg: Accept) -> None:
        if (self._proposing is None or msg.pn != self.accepted_pn or
                msg.version != self._proposing[0]):
            return
        self._accepts.add(msg.from_shard)
        self._maybe_commit()

    def _maybe_commit(self) -> None:
        """Commit once EVERY quorum member accepted (Paxos.cc commits when
        accepted == quorum; the quorum itself is a monmap majority, so the
        value is durable on a majority)."""
        if self._proposing is None or not self._accepts >= self.quorum:
            return
        version, value = self._proposing
        self._proposing = None
        self._apply_commit(version, value)
        for peer in sorted(self.quorum - {self.rank}):
            self.bus.send(peer, Commit(self.rank, version, value))
        self._maybe_begin()

    def _handle_commit(self, msg: Commit) -> None:
        if msg.version == self.last_committed + 1:
            self._apply_commit(msg.version, msg.value)

    def _apply_commit(self, version: int, value: tuple) -> None:
        self.committed[version] = value
        self.last_committed = version
        if self.uncommitted is not None and self.uncommitted[1] <= version:
            self.uncommitted = None
        now, inc = value
        self.service.apply_committed(now, inc)
        for fn in self.on_commit:
            fn(version, value)


class MonCluster:
    """N monitors on one bus with a Monitor-compatible facade: failure
    reports and ticks address the current leader's service; committed maps
    fan out to ``subscribers`` exactly once per epoch (whichever quorum
    member applies first)."""

    def __init__(self, osdmap: OSDMap, n_mons: int = 3,
                 cct: Context | None = None):
        self.cct = cct if cct is not None else default_context()
        self.bus = MessageBus()
        self.n_mons = n_mons
        self.mons = [PaxosMonitor(r, self.bus, n_mons, osdmap, cct=self.cct)
                     for r in range(n_mons)]
        self.subscribers: list = []
        self._notified = 0
        for m in self.mons:
            m.on_commit.append(self._on_commit)
        self.elect()

    def _on_commit(self, version: int, value: tuple) -> None:
        if version <= self._notified:
            return
        self._notified = version
        now, inc = value
        leader = self.leader()
        newmap = (leader or self.mons[0]).service.osdmap
        for fn in self.subscribers:
            fn(newmap, inc)

    # -- membership ----------------------------------------------------------

    def elect(self) -> "PaxosMonitor | None":
        """Run an election among up monitors and drain the bus."""
        for m in self.mons:
            if m.rank not in self.bus.down:
                m.start_election()
                break                    # lowest up rank proposes first
        self.bus.deliver_all()
        return self.leader()

    def kill(self, rank: int) -> None:
        """A monitor dies: re-elect immediately (the reference's elector
        reacts to the lost connection) so the facade keeps working when a
        majority survives."""
        self.bus.mark_down(rank)
        self.elect()

    def revive(self, rank: int) -> None:
        self.bus.mark_up(rank)
        self.elect()                     # re-peer; collect catches it up

    def leader(self) -> PaxosMonitor | None:
        for m in self.mons:
            if m.rank not in self.bus.down and m.is_leader():
                return m
        return None

    def quorum_ranks(self) -> set[int]:
        ld = self.leader()
        return set(ld.quorum) if ld else set()

    # -- Monitor facade --------------------------------------------------

    @property
    def osdmap(self) -> OSDMap:
        ld = self.leader()
        return (ld or self.mons[0]).service.osdmap

    def prepare_failure(self, target: int, reporter: int,
                        failed_since: float, now: float) -> bool:
        ld = self.leader()
        if ld is None:
            return False
        out = ld.service.prepare_failure(target, reporter, failed_since, now)
        return out

    def cancel_failure(self, target: int, reporter: int) -> None:
        ld = self.leader()
        if ld is not None:
            ld.service.cancel_failure(target, reporter)

    def mark_osd_down(self, osd: int) -> bool:
        ld = self.leader()
        if ld is not None:
            return ld.service.mark_osd_down(osd)
        return False

    def osd_boot(self, osd: int, now: float | None = None) -> bool:
        ld = self.leader()
        if ld is not None:
            return ld.service.osd_boot(osd, now=now)
        return False

    @property
    def markdown(self):
        """The leader's flap-damping limiter (OSD_FLAPPING reads it)."""
        ld = self.leader()
        return (ld or self.mons[0]).service.markdown

    def clear_markdown(self, osd: int) -> bool:
        """Operator clear on EVERY replica: mark-downs are recorded by
        each quorum member's apply_committed, so a leader-only clear
        would resurrect the damping on the next failover."""
        was = False
        for m in self.mons:
            was = m.service.clear_markdown(osd) or was
        return was

    @property
    def nodown(self) -> set[int]:
        ld = self.leader()
        return (ld or self.mons[0]).service.nodown

    def propose_pending(self, now: float) -> OSDMap | None:
        ld = self.leader()
        if ld is None:
            return None
        before = ld.last_committed
        ld.service.propose_pending(now)
        self.bus.deliver_all()
        return self.osdmap if ld.last_committed > before else None

    def tick(self, now: float) -> OSDMap | None:
        ld = self.leader()
        if ld is None:
            return None
        before = ld.last_committed
        ld.service.tick(now)
        self.bus.deliver_all()
        return self.osdmap if ld.last_committed > before else None
