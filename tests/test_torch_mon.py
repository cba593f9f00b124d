"""The port's monitor, heartbeats, Paxos quorum and flap damping against
the JAX package's, on the CPU.

Each scenario runs twice, once over ``ceph_tpu.mon`` and once over
``ceph_tpu_torch.mon``, on the same OSDMap (the reference's built by
``test_osdmap.build_cluster``, the port's converted from it) and the same
seeded sequence of failure reports, heartbeat ticks, boots and monitor
deaths.  What the two record is held equal exactly: every committed
epoch with its incremental (state flips and weights), each OSD's up/in
state, the failure reports pending, the mark-down limiter, every
monitor's Paxos state and the bus's message counts.  The cluster cases
drive ``MiniCluster.attach_monitor`` on both packages and compare the
whole cluster state (``test_torch_cluster.run_both``).
"""
from __future__ import annotations

import importlib

import pytest

from ceph_tpu_torch import convert
from test_osdmap import build_cluster
from test_torch_cluster import (_read_all, _victim, _write,
                                fixed_clock, payload,  # noqa: F401
                                run_both)
from test_torch_ec_backend import norm

GRACE = 20          # osd_heartbeat_grace default


class MonSide:
    def __init__(self, pkg: str):
        self.pkg = pkg
        imp = importlib.import_module
        self.mon = imp(f"{pkg}.mon")
        self.hb = imp(f"{pkg}.mon.heartbeat")
        self.osdmap = imp(f"{pkg}.osdmap")
        self.Context = imp(f"{pkg}.common").Context

    def map(self, **kw):
        m = build_cluster(**kw)
        return m if self.pkg == "ceph_tpu" else \
            convert.osdmap_from_reference(m.to_dict())

    def monitor(self, n_mons: int = 1, **conf):
        cct = self.Context(overrides=conf or None)
        if n_mons > 1:
            return self.mon.MonCluster(self.map(), n_mons=n_mons, cct=cct)
        return self.mon.Monitor(self.map(), cct=cct)


SIDES = (MonSide("ceph_tpu"), MonSide("ceph_tpu_torch"))


def map_state(m) -> tuple:
    return (m.epoch, tuple((m.is_up(o), m.osd_weight[o])
                           for o in range(m.max_osd)))


def inc_state(inc) -> tuple:
    return (inc.epoch, sorted(inc.new_state.items()),
            sorted(inc.new_weight.items()))


def mon_state(mon) -> dict:
    out = {"map": map_state(mon.osdmap),
           "markdown": mon.markdown.dump(),
           "damped": sorted(mon.markdown.damped),
           "nodown": sorted(mon.nodown)}
    if not hasattr(mon, "mons"):
        out["failures"] = {t: sorted(f.reporters.items())
                           for t, f in sorted(mon.failure_info.items())}
    else:
        out["paxos"] = [(m.rank, m.last_committed, m.leader,
                         sorted(m.quorum), m.epoch,
                         map_state(m.service.osdmap)) for m in mon.mons]
        out["delivered"] = mon.bus.delivered
    return out


def run_mon(scenario, **kw):
    """Run ``scenario(side, mon, trace)`` on both packages; every commit
    seen by a subscriber lands in the trace; hold the traces and final
    states equal."""
    seen = {}
    for side in SIDES:
        mon = side.monitor(**kw)
        trace: list = []
        mon.subscribers.append(
            lambda new, inc, _t=trace: _t.append(("commit", map_state(new),
                                                  inc_state(inc))))
        scenario(side, mon, trace)
        seen[side.pkg] = (norm(trace), norm(mon_state(mon)))
    assert seen["ceph_tpu_torch"] == seen["ceph_tpu"]
    return seen["ceph_tpu"]


# -- the failure path ----------------------------------------------------------

def scn_reports(side, mon, trace):
    t0 = 100.0
    trace.append(mon.prepare_failure(0, 3, failed_since=t0, now=t0 + 1))
    trace.append(mon.prepare_failure(0, 1, failed_since=t0, now=t0 + 1))
    trace.append(mon.propose_pending(t0 + 1) is None)       # within grace
    trace.append(mon.prepare_failure(0, 6, failed_since=t0,
                                     now=t0 + GRACE))
    trace.append(map_state(mon.propose_pending(t0 + GRACE)))
    # same-host reporters are not enough
    mon.prepare_failure(9, 10, failed_since=t0, now=t0 + GRACE + 1)
    trace.append(mon.prepare_failure(9, 11, failed_since=t0,
                                     now=t0 + GRACE + 1))
    mon.cancel_failure(9, 10)
    trace.append(sorted(mon.failure_info))
    mon.tick(t0 + GRACE + 5)


def scn_min_up_ratio(side, mon, trace):
    n = mon.osdmap.max_osd
    for target in range(n):
        mon.prepare_failure(target, (target + 3) % n, 0.0, GRACE + 1)
        mon.prepare_failure(target, (target + 9) % n, 0.0, GRACE + 1)
        mon.propose_pending(GRACE + 1)
    trace.append(sum(1 for o in range(n) if mon.osdmap.is_up(o)))


def scn_nodown_out_boot(side, mon, trace):
    mon.nodown.add(0)
    mon.prepare_failure(0, 3, 0.0, GRACE + 1)
    mon.prepare_failure(0, 6, 0.0, GRACE + 1)
    mon.tick(GRACE + 2)
    for victim in (4, 13):
        for r in (victim + 3, victim + 6, victim + 9):
            mon.prepare_failure(victim, r % 27, 0.0, GRACE + 1)
    mon.propose_pending(GRACE + 1)
    mon.tick(GRACE + 1 + 599)
    mon.osd_boot(13)
    mon.propose_pending(GRACE + 1 + 599)
    mon.tick(GRACE + 1 + 601)          # osd.4 auto-out: weight 0
    trace.append([mon.osdmap.is_out(o) for o in (0, 4, 13)])
    pg = side.osdmap.PG(2, 0)
    trace.append(list(mon.osdmap.pg_to_up_acting_osds(pg)[2]))


@pytest.mark.parametrize("scenario,conf", [
    (scn_reports, {}),
    (scn_min_up_ratio, {"mon_osd_min_up_ratio": 0.75}),
    (scn_nodown_out_boot, {"mon_osd_down_out_interval": 600}),
])
def test_failure_path(scenario, conf):
    run_mon(scenario, **conf)


# -- heartbeats ------------------------------------------------------------------

def scn_heartbeats(side, mon, trace):
    clock = side.mon.VirtualClock()
    agents = side.hb.build_heartbeat_mesh(mon, clock, mon.osdmap.max_osd)
    net = agents[0].network
    for step in range(14):
        if step == 3:
            net[5] = None                      # osd.5 goes silent
        if step == 6:
            net[8] = None                      # a second one, briefly
        if step == 8:
            net[8] = agents[8]                 # recovers inside grace
        if step == 11:
            net[5] = agents[5]                 # osd.5 replies again
        clock.advance(6)
        for o, a in sorted(agents.items()):
            if net.get(o) is not None:
                trace.append((step, o, a.tick()))
        mon.tick(clock.now())
        trace.append((step, sorted(mon.failure_info), mon.osdmap.epoch))


def test_heartbeats_mark_down_and_boot():
    trace, state = run_mon(scn_heartbeats)
    commits = [t for t in trace if t[0] == "commit"]
    assert len(commits) == 2                   # osd.5 down, then up


# -- flap damping ----------------------------------------------------------------

def scn_flapping(side, mon, trace):
    now = 0.0
    for cycle in range(4):
        now += GRACE + 1
        mon.prepare_failure(7, 1, now - GRACE - 1, now)
        mon.prepare_failure(7, 12, now - GRACE - 1, now)
        mon.propose_pending(now)
        now += 1
        trace.append(("boot", mon.osd_boot(7, now=now)))
        mon.propose_pending(now)
    trace.append(("damped", sorted(mon.markdown.damped)))
    trace.append(("clear", mon.clear_markdown(7)))
    trace.append(("boot", mon.osd_boot(7, now=now + 1)))
    mon.propose_pending(now + 1)


@pytest.mark.parametrize("n_mons", [1, 3])
def test_flap_damping(n_mons):
    trace, state = run_mon(scn_flapping, n_mons=n_mons, osd_markdown_count=3)
    boots = [t[1] for t in trace if t[0] == "boot"]
    assert boots == [True, True, False, False, True]
    assert ("damped", (7,)) in trace


def test_osd_flapping_health_check():
    """OSD_FLAPPING reads the monitor's limiter on both clusters: raised
    while osd.7 is damped, cleared by the operator's clear."""
    def scenario(env):
        c = env.cluster({"osd_markdown_count": 2})
        pid = env.ec_pool(c)
        c.put(pid, "x", payload(1000))
        mon = c.attach_monitor()
        prim = {g.backend.whoami for g in c.pools[pid]["pgs"].values()}
        v = min(o for o in range(12) if o not in prim)
        out = []
        now = 0.0
        for _ in range(2):
            now += GRACE + 1
            mon.prepare_failure(v, (v + 3) % 12, now - GRACE - 1, now)
            mon.prepare_failure(v, (v + 6) % 12, now - GRACE - 1, now)
            mon.propose_pending(now)
            out.append(mon.osd_boot(v, now=now + 1))
            mon.propose_pending(now + 1)
        h = c.health()
        out.append(h["checks"].get("OSD_FLAPPING"))
        mon.clear_markdown(v)
        mon.osd_boot(v)
        mon.propose_pending(now + 2)
        c.deliver_all()
        out.append("OSD_FLAPPING" in c.health()["checks"])
        out.append([e["message"] for e in c.clusterlog.last(50)
                    if e["channel"] == "mon"])
        out.append(c.get(pid, "x", 1000) == payload(1000))
        return out
    obs, _ = run_both(scenario)
    assert obs[1] is False and obs[2] is not None and obs[3] is False


# -- the Paxos quorum ------------------------------------------------------------

def _down_inc(side, osd):
    inc = side.osdmap.Incremental()
    inc.new_state[osd] = side.osdmap.OSD_UP
    return inc


def scn_quorum(side, mc, trace):
    ld = mc.leader()
    trace.append(("leader", ld.rank, sorted(mc.quorum_ranks())))
    ld.submit(0.0, _down_inc(side, 3))
    mc.bus.deliver_all()
    # begin reaches the peons, the leader dies with the accepts in flight:
    # the new leader's collect re-proposes the uncommitted value
    mc.leader().submit(0.0, _down_inc(side, 7))
    while mc.bus.deliver_one(1) or mc.bus.deliver_one(2):
        pass
    trace.append(("uncommitted", [m.uncommitted is not None
                                  for m in mc.mons]))
    mc.kill(0)
    trace.append(("leader", mc.leader().rank, sorted(mc.quorum_ranks())))
    # the failure path through the surviving quorum
    mc.prepare_failure(2, 4, failed_since=0.0, now=GRACE + 1)
    mc.prepare_failure(2, 9, failed_since=0.0, now=GRACE + 1)
    trace.append(("propose", map_state(mc.propose_pending(GRACE + 1))))
    # a peon forwards; the dead leader comes back and catches up
    mc.mons[2].submit(0.0, _down_inc(side, 6))
    mc.bus.deliver_all()
    mc.revive(0)
    trace.append(("leader", mc.leader().rank, sorted(mc.quorum_ranks())))
    mc.kill(1)
    mc.kill(2)
    trace.append(("no quorum", mc.elect() is None))


def test_three_monitor_quorum_through_a_leader_death():
    trace, state = run_mon(scn_quorum, n_mons=3)
    assert [m[1] for m in state["paxos"]] == [4, 4, 4]


# -- the monitor driving the cluster ---------------------------------------------

@pytest.mark.parametrize("n_mons", [1, 3])
def test_attach_monitor_drives_repair(n_mons):
    """Heartbeats report a silent OSD; the (quorum) monitor commits it
    down, the PGs route around it through degraded writes; its boot
    commits it up and the recovery scheduler repairs it."""
    def scenario(env):
        S = env.S
        hb = importlib.import_module(f"{S.pkg}.mon.heartbeat")
        c = env.cluster(recovery=True)
        pid = env.ec_pool(c)
        data = _write(env, c, pid, n=8)
        v = _victim(c, pid)
        mon = c.attach_monitor(n_mons=n_mons)
        clock = hb.VirtualClock()
        agents = hb.build_heartbeat_mesh(mon, clock, 12)
        net = agents[0].network
        out = []
        for step in range(12):
            if step == 2:
                net[v] = None
            if step == 7:
                for i in range(4):
                    data[f"obj{i}"] = payload(700 + i, 300 + i)
                    c.put(pid, f"obj{i}", data[f"obj{i}"])
            if step == 8:
                net[v] = agents[v]
            clock.advance(6)
            for o, a in sorted(agents.items()):
                if net.get(o) is not None:
                    a.tick()
            mon.tick(clock.now())
            c.deliver_all()
            out.append((step, mon.osdmap.epoch, mon.osdmap.is_up(v),
                        sorted(c.bus.down)))
        out.append(_read_all(c, pid, data))
        out.append([e["message"] for e in c.clusterlog.last(100)
                    if e["channel"] == "mon"])
        return out
    obs, _ = run_both(scenario)
    assert any(not s[2] for s in obs[:12]) and obs[11][2]


def test_auto_out_backfills():
    def scenario(env):
        c = env.cluster({"mon_osd_down_out_interval": 60})
        pid = env.ec_pool(c)
        data = _write(env, c, pid, n=10)
        v = _victim(c, pid)
        mon = c.attach_monitor()
        for r in [o for o in range(12) if o != v][:4]:
            mon.prepare_failure(v, r, 0.0, GRACE + 1)
        mon.propose_pending(GRACE + 1)
        mon.tick(GRACE + 1000)
        acting = {ps: list(g.acting)
                  for ps, g in sorted(c.pools[pid]["pgs"].items())}
        assert all(v not in a for a in acting.values())
        return [acting, _read_all(c, pid, data), mon.osdmap.epoch]
    run_both(scenario)
