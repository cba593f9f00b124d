"""OSD peer heartbeats over a virtual clock.

Mirror of the reference's heartbeat machinery (reference: src/osd/OSD.cc —
``handle_osd_ping`` :4547, ``heartbeat_check`` :4746 comparing each peer's
last reply against ``osd_heartbeat_grace``, failures queued in
``failure_queue`` :4539,:4678-4692 and reported to the mon).  Time is a
``VirtualClock`` so tests drive deterministic failure timelines (the
Thrasher's clock-stepping pattern, qa/tasks/ceph_manager.py).

The port's copy of ``ceph_tpu.mon.heartbeat``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .monitor import Monitor


class VirtualClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def now(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t


@dataclass
class HeartbeatAgent:
    """One OSD's heartbeat state: pings peers, checks replies, reports."""
    osd: int
    mon: Monitor
    clock: VirtualClock
    peers: list[int] = field(default_factory=list)
    last_rx: dict[int, float] = field(default_factory=dict)
    # the deterministic "network": agent registry, None entry = dead OSD
    network: dict[int, "HeartbeatAgent | None"] = field(default_factory=dict)
    failure_pending: set[int] = field(default_factory=set)

    def ping_peers(self) -> None:
        """Send pings; live peers reply immediately (OSD.cc:4547 ping/reply
        is request-response on the heartbeat messenger)."""
        now = self.clock.now()
        for p in self.peers:
            peer = self.network.get(p)
            if peer is not None:
                # peer processes the ping and we get the reply this tick
                peer.last_rx[self.osd] = now
                self.last_rx[p] = now

    def heartbeat_check(self) -> list[int]:
        """(OSD.cc:4746): peers silent past the grace go on the failure
        queue; recovered peers get their reports canceled, and a peer
        the map says is DOWN gets boot-reported the moment it replies
        again (the preprocess_boot path heartbeats drive).  The boot is
        NOT unconditional: the monitor's mark-down limiter refuses it
        while the peer is flap-damped — without that gate this very
        first-post-grace-reply re-mark-up is the flapping hole (down,
        up 6s later, down again, forever)."""
        now = self.clock.now()
        grace = self.mon.cct.conf.get("osd_heartbeat_grace")
        newly_failed = []
        for p in self.peers:
            last = self.last_rx.get(p)
            if last is None:
                continue                # never heard: not yet accountable
            if now - last >= grace:
                if p not in self.failure_pending:
                    self.failure_pending.add(p)
                    newly_failed.append(p)
                self.mon.prepare_failure(p, self.osd,
                                         failed_since=last, now=now)
            else:
                if p in self.failure_pending:
                    self.failure_pending.discard(p)
                    self.mon.cancel_failure(p, self.osd)
                if last >= now and self.mon.osdmap.is_down(p):
                    # fresh reply from a down-marked peer: report the
                    # boot (flap damping inside osd_boot may refuse)
                    self.mon.osd_boot(p, now=now)
        return newly_failed

    def tick(self) -> list[int]:
        self.ping_peers()
        return self.heartbeat_check()


def build_heartbeat_mesh(mon: Monitor, clock: VirtualClock,
                         n_osds: int) -> dict[int, HeartbeatAgent]:
    """All-to-all peer mesh (the reference picks subsets of up OSDs via
    maybe_update_heartbeat_peers; all-to-all is exact for small clusters)."""
    network: dict[int, HeartbeatAgent | None] = {}
    agents = {}
    for o in range(n_osds):
        agents[o] = HeartbeatAgent(
            osd=o, mon=mon, clock=clock,
            peers=[p for p in range(n_osds) if p != o],
            network=network)
        network[o] = agents[o]
    return agents
