"""The port's store fault plane (``failure/store.py``, ``StoreFaults``,
the injector's event log and digest, ``MiniCluster.inject_faults``)
against the JAX package's, on the CPU.

One seed drives both packages: the injector's per-(plane, kind)
decision streams, its event log and its order-sensitive digest must
come out the same, and a cluster campaign (degraded gets under injected
read EIOs, writes under injected write EIOs and torn writes) must make
the same decisions, fail the same ops with the same errors and leave
the same cluster state (``test_torch_cluster.run_both``, bitwise).
"""
from __future__ import annotations

import errno
import importlib

import pytest

from test_torch_cluster import (JAX, PORT, STRIPE, _write,
                                fixed_clock, payload,  # noqa: F401
                                run_both)


def fmod(side, name):
    return importlib.import_module(f"{side.pkg}.failure{name}")


def plan(side, seed, **store):
    cfg = fmod(side, ".config")
    return cfg.FaultPlan(seed=seed, store=cfg.StoreFaults(**store))


# -- the injector ---------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_same_seed_same_decisions_and_digest(seed):
    runs = {}
    for side in (JAX, PORT):
        inj = fmod(side, "").FaultInjector(plan(side, seed))
        decisions = []
        for i in range(300):
            decisions.append((
                inj.roll("store", "eio_read", 0.3, target=f"osd.{i % 5}"),
                inj.roll("store", "torn_write", 0.1, target="t", ops=i),
                inj.roll("store", "slow_read", 0.0),
                inj.roll("device", "oom", 0.05)))
        runs[side.pkg] = (decisions, inj.event_digest(), inj.summary(),
                          inj.events[:20])
    assert runs["ceph_tpu_torch"] == runs["ceph_tpu"]
    assert runs["ceph_tpu"][2]["total"] > 0


def test_perf_and_clusterlog_stamping():
    out = {}
    for side in (JAX, PORT):
        Context = importlib.import_module(f"{side.pkg}.common").Context
        ClusterLog = importlib.import_module(
            f"{side.pkg}.common.clusterlog").ClusterLog
        cct = Context()
        clog = ClusterLog(cct=cct)
        inj = fmod(side, "").FaultInjector(plan(side, 1), clusterlog=clog,
                                          cct=cct, name="t1")
        inj.roll("store", "eio_read", 1.0, target="osd.0")
        inj.record("bus", "drop", target=3)
        snap = cct.perf.snapshot()["faults.t1"]
        out[side.pkg] = (snap.get("injected"), snap.get("store_events"),
                         snap.get("bus_events"),
                         [e["message"] for e in clog.last(10)])
        inj.close()
        assert "faults.t1" not in cct.perf.snapshot()
        clog.close()
    assert out["ceph_tpu_torch"] == out["ceph_tpu"]


# -- FaultyStore ----------------------------------------------------------------

def _store_case(side, kind):
    ms = importlib.import_module(f"{side.pkg}.backend.memstore")
    store_mod = fmod(side, ".store")
    faults = {"eio_read": {"eio_read_prob": 1.0},
              "eio_write": {"eio_write_prob": 1.0},
              "torn_write": {"torn_write_prob": 1.0},
              "slow_read": {"slow_read_prob": 1.0, "slow_read_ms": 1.0},
              "none": {}}[kind]
    inj = fmod(side, "").FaultInjector(plan(side, 2, **faults))
    inner = ms.MemStore()
    st = store_mod.FaultyStore(inner, inj, target="osd.0")
    a, b = ms.GObject("a", 0), ms.GObject("b", 0)
    out = []
    try:
        st.queue_transaction(ms.Transaction().write(a, 0, b"AA")
                             .write(b, 0, b"BB"))
        out.append("applied")
    except IOError as e:
        out.append(("write", e.errno, str(e)))
    out.append((inner.exists(a), inner.exists(b)))
    try:
        out.append(st.read(a))
    except IOError as e:
        out.append(("read", e.errno, str(e)))
    out.append(([(g.oid, g.shard) for g in st.list_objects()],
                store_mod.unwrap(st) is inner,
                repr(st).startswith("FaultyStore(")))
    out.append([(e["plane"], e["kind"], e["target"]) for e in inj.events])
    return out


@pytest.mark.parametrize("kind", ["eio_read", "eio_write", "torn_write",
                                  "slow_read", "none"])
def test_faulty_store(kind):
    got = {side.pkg: _store_case(side, kind) for side in (JAX, PORT)}
    assert got["ceph_tpu_torch"] == got["ceph_tpu"]
    if kind == "torn_write":
        assert got["ceph_tpu"][1] == (True, False)
    if kind in ("eio_read", "eio_write"):
        assert errno.EIO in [x[1] for x in got["ceph_tpu"]
                             if isinstance(x, tuple) and len(x) == 3
                             and isinstance(x[1], int)]


# -- the cluster campaign ---------------------------------------------------------

def _outcome(fn):
    try:
        return ("ok", fn())
    except IOError as e:
        return ("err", type(e).__name__, getattr(e, "errno", None))


def scn_read_eio_campaign(env):
    """Degraded gets under a seeded read-EIO rate: the same gets fail on
    both packages, nothing acked is lost, and disarming restores every
    read."""
    c = env.cluster()
    pid = env.ec_pool(c)
    data = _write(env, c, pid, n=8)
    inj = c.inject_faults(plan(env.S, 21, eio_read_prob=0.15))
    out = []
    for oid, d in sorted(data.items()):
        g = c.pg_group(pid, oid)
        c.bus.mark_down(g.acting[1])
        out.append((oid, _outcome(lambda: c.get(pid, oid, len(d)) == d)))
        c.bus.mark_up(g.acting[1])
        c.deliver_all()
    out.append(([(e["plane"], e["kind"], e["target"]) for e in inj.events],
                inj.event_digest(), inj.summary()))
    c.inject_faults(None)
    out.append(c.fault_injector is None)
    for g in c.pools[pid]["pgs"].values():
        assert not any(type(getattr(h, "store", None)).__name__ ==
                       "FaultyStore" for h in g.bus.handlers.values())
    out.append({oid: c.get(pid, oid, len(d)) == d
                for oid, d in data.items()})
    return out


def scn_write_faults_campaign(env):
    """Writes under injected write EIOs and torn writes: the same writes
    fail; what was acked reads back after the plan is disarmed and the
    PGs repaired."""
    c = env.cluster()
    pid = env.ec_pool(c)
    rep = c.create_replicated_pool("rep", 3, 4)
    inj = c.inject_faults(plan(env.S, 5, eio_write_prob=0.05,
                               torn_write_prob=0.05))
    acked = {}
    out = []
    for i in range(10):
        for p in (pid, rep):
            oid, d = f"w{p}.{i}", payload(STRIPE + 9 * i, 300 + i)
            r = _outcome(lambda: c.put(p, oid, d) and None)
            out.append((oid, r))
            if r[0] == "ok":
                acked[(p, oid)] = d
    out.append(([(e["plane"], e["kind"], e["target"]) for e in inj.events],
                inj.event_digest()))
    c.inject_faults(None)
    c.deliver_all()
    out.append(sorted(acked))
    reads = {}
    for (p, oid), d in sorted(acked.items()):
        reads[oid] = _outcome(lambda: c.get(p, oid, len(d)) == d)
    out.append(reads)
    return out


@pytest.mark.parametrize("scenario", [scn_read_eio_campaign,
                                      scn_write_faults_campaign])
def test_cluster_store_campaign(scenario):
    obs, _ = run_both(scenario)
    events = obs[-4 if scenario is scn_read_eio_campaign else -3][0]
    assert events, "the campaign injected nothing"


def test_rearm_rebinds_the_wrappers():
    """inject_faults(plan B) while plan A is armed swaps every store
    wrapper onto B's injector and closes A's; pools created mid-campaign
    are wrapped too."""
    def scenario(env):
        c = env.cluster()
        pid = env.ec_pool(c, pg_num=2)
        inj_a = c.inject_faults(plan(env.S, 1, eio_read_prob=1.0))
        inj_b = c.inject_faults(plan(env.S, 2))
        c.put(pid, "o", payload(1024))
        rep = c.create_replicated_pool("rep", 3, 2)
        c.put(rep, "r", payload(100))
        wrapped = []
        for p in (pid, rep):
            for g in c.pools[p]["pgs"].values():
                for h in g.bus.handlers.values():
                    st = getattr(h, "store", None)
                    if st is not None:
                        wrapped.append((type(st).__name__,
                                        st._inj is inj_b))
        out = [c.fault_injector is inj_b, inj_a.perf is None,
               c.get(pid, "o", 1024) == payload(1024),
               inj_b.summary()["planes"].get("store"), sorted(set(wrapped)),
               [e["message"] for e in c.clusterlog.last(20)
                if e["channel"] == "faults"]]
        c.inject_faults(None)
        return out
    obs, _ = run_both(scenario)
    assert obs[4] == (("FaultyStore", True),)


def test_durable_cluster_under_store_faults(tmp_path):
    """A durable BlueStore cluster under read EIOs: the same degraded gets
    fail on both packages, and after disarm and a reopen every acked
    object reads back."""
    seen = {}
    for side in (JAX, PORT):
        d = tmp_path / side.pkg
        c = side.MiniCluster(n_osds=12, osds_per_host=3, chunk_size=128,
                             cct=side.Context(), data_dir=d,
                             store_backend="bluestore")
        prof = {"plugin": side.rs, "k": "4", "m": "2",
                "device": "numpy" if side is JAX else "cpu"}
        pid = c.create_ec_pool("ec", prof, pg_num=8)
        data = {f"o{i}": payload(3 * STRIPE + i, i) for i in range(8)}
        for oid, v in data.items():
            c.put(pid, oid, v)
        inj = c.inject_faults(plan(side, 9, eio_read_prob=0.2))
        res = []
        for oid, v in sorted(data.items()):
            g = c.pg_group(pid, oid)
            c.bus.mark_down(g.acting[2])
            res.append(_outcome(lambda: c.get(pid, oid, len(v)) == v))
            c.bus.mark_up(g.acting[2])
            # an injected EIO on a shard's sub-read escapes the bus's
            # delivery (as in the reference); the rest of the queue
            # drains on the next call
            for _ in range(8):
                r = _outcome(c.deliver_all)
                res.append(r)
                if r[0] == "ok":
                    break
        res.append(inj.event_digest())
        c.inject_faults(None)
        c.shutdown()
        c2 = side.MiniCluster.load(d, cct=side.Context())
        res.append({oid: c2.get(pid, oid, len(v)) == v
                    for oid, v in data.items()})
        c2.shutdown()
        seen[side.pkg] = res
    assert seen["ceph_tpu_torch"] == seen["ceph_tpu"]
    assert all(seen["ceph_tpu"][-1].values())
