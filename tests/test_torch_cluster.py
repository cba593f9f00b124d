"""The port's MiniCluster against the JAX package's, on the CPU.

Every case runs one scenario twice: on ``ceph_tpu.cluster.MiniCluster``
(``jax_rs`` with ``device=numpy``, the reference's own cluster-test
setup, or its default JAX-CPU device path) and on
``ceph_tpu_torch.cluster.MiniCluster`` (``torch_rs`` with
``device=cpu``: the plain PyTorch versions of the kernels).  The
clusters are small (12 OSDs on 4 hosts, ``chunk_size`` 128, ``pg_num``
8, k=4 m=2); the same seeded payloads and the same op sequence go
through both, and the harness holds the two runs equal, bitwise
(tolerance 0):

- what the scenario observed: read results, op-vector replies, scrub
  reports, repair states, scheduler state;
- every pool (rule, size, min_size, pg_num, snapshots) and every PG's
  acting set, primary, authority and shard PG logs, stale set, perf
  counters and damaged objects;
- every OSD's one store: each collection's objects (bytes, attributes
  with ``HINFO_KEY`` among them, the pgmeta omap with its pickled PG
  log decoded field by field) and the daemon superblock;
- object -> PG routing (the cluster's object lists) and the wire
  accounting's byte and message totals.

``PrimaryLogPG`` stamps ``time.time()`` into each object's info
attribute; both packages read one fixed clock here so the attributes
compare.
"""
from __future__ import annotations

import importlib
import time as _time
import types

import numpy as np
import pytest
import torch

from test_torch_ec_backend import _omap, norm

K, M = 4, 2
CHUNK = 128
STRIPE = K * CHUNK
PG_NUM = 8

PERF_KEYS = ("writes", "write_rollbacks", "reads", "read_errors",
             "write_bytes", "stripe_bytes_encoded", "read_bytes",
             "recoveries", "recovery_bytes", "recovery_failures",
             "chain_repairs", "chain_objects", "chain_fallbacks",
             "regen_repairs", "regen_objects", "regen_fallbacks",
             "log_repairs_clean", "log_repairs", "log_repair_objects",
             "shard_backfills", "backfill_objects")
SCHED_KEYS = ("jobs_scheduled", "jobs_completed", "preemptions",
              "map_cancels", "waves", "wave_objects", "stalled_requeued",
              "jobs_queued", "jobs_active")


class Side:
    """One package's cluster surface."""

    def __init__(self, pkg: str):
        self.pkg = pkg
        imp = importlib.import_module
        self.MiniCluster = imp(f"{pkg}.cluster").MiniCluster
        self.Context = imp(f"{pkg}.common").Context
        self.ops = imp(f"{pkg}.osd.osd_ops")
        self.plog = imp(f"{pkg}.osd.primary_log_pg")
        self.GObject = imp(f"{pkg}.backend.memstore").GObject
        self.shard_store = imp(f"{pkg}.backend.pg_backend").shard_store
        self.rs = "jax_rs" if pkg == "ceph_tpu" else "torch_rs"


JAX = Side("ceph_tpu")
PORT = Side("ceph_tpu_torch")


@pytest.fixture(autouse=True)
def fixed_clock(monkeypatch):
    clock = types.SimpleNamespace(time=lambda: 1.7e9,
                                  monotonic=_time.monotonic,
                                  perf_counter=_time.perf_counter)
    for side in (JAX, PORT):
        monkeypatch.setattr(side.plog, "time", clock)


def payload(n, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, size=n, dtype=np.uint8).tobytes()


class Env:
    """One side's run of a scenario: builds clusters on fresh Contexts,
    makes pools, and snapshots every cluster it built."""

    def __init__(self, side: Side, jax_device: str = "numpy"):
        self.S = side
        self.jax_device = jax_device
        self.clusters: list = []

    def cluster(self, conf: dict | None = None, chunk: int = CHUNK,
                recovery: bool = False):
        c = self.S.MiniCluster(n_osds=12, osds_per_host=3, chunk_size=chunk,
                               cct=self.S.Context(dict(conf or {})))
        if recovery:
            c.enable_recovery_scheduler()
        self.clusters.append(c)
        return c

    def profile(self, kind: str = "rs", k: int = K, m: int = M, **extra):
        dev = self.jax_device if self.S is JAX else "cpu"
        prof = {"k": str(k), "m": str(m), "device": dev}
        if kind == "rs":
            return prof | {"plugin": self.S.rs, "technique": "reed_sol_van"}
        return prof | {"plugin": "pm_regen"} | {
            key: str(v) for key, v in extra.items()}

    def ec_pool(self, c, name: str = "ec", pg_num: int = PG_NUM, **kw):
        return c.create_ec_pool(name, self.profile(**kw), pg_num=pg_num)

    def op(self):
        return self.S.ops.ObjectOperation()

    def snapshot(self) -> list:
        return [cluster_state(c) for c in self.clusters]


def _perf(perf, keys) -> dict:
    out = {}
    for key in keys:
        try:
            out[key] = perf.get(key)
        except KeyError:
            continue
    return out


def _log(log) -> tuple:
    return (log.head, log.tail, norm(list(log.entries)))


def pg_state(c, g) -> dict:
    be = g.backend
    return {"acting": list(g.acting), "primary": be.whoami,
            "epoch": g.epoch, "state": c.pg_state(g),
            "authority_log": _log(be.pg_log),
            "shard_logs": {s: _log(h.pg_log)
                           for s, h in sorted(g.bus.handlers.items())},
            "stale": sorted(be.stale),
            "damaged": sorted(getattr(be, "inconsistent_objects", ())),
            "perf": _perf(be.perf, PERF_KEYS)}


def cluster_state(c) -> dict:
    pools = {}
    for pid, p in sorted(c.pools.items()):
        pool = p["pool"]
        params = {k: v for k, v in pool.params.items()
                  if k not in ("plugin", "device")}
        pools[pid] = {
            "pool": (pool.name, pool.type, pool.size, pool.min_size,
                     pool.pg_num, pool.crush_rule, params, pool.snap_seq,
                     dict(pool.snaps), sorted(pool.removed_snaps)),
            "rule": norm(c.osdmap.crush.rules[pool.crush_rule].steps),
            "pgs": {ps: pg_state(c, g)
                    for ps, g in sorted(p["pgs"].items())}}
    stores = {o: {(g.oid, g.shard): (bytes(ob.data), norm(ob.xattrs),
                                     _omap(ob.omap), bytes(ob.omap_header))
                  for g, ob in d.store.objects.items()}
              for o, d in sorted(c.osds.items())}
    out = {"pools": pools, "stores": stores,
           "objects": {pid: sorted(v) for pid, v in c.objects.items()},
           "wire": c.wire.totals(), "delivered": c.bus.delivered,
           "down": sorted(c.bus.down)}
    if c.recovery is not None:
        out["recovery"] = (sorted(c.recovery.jobs),
                           _perf(c.recovery.perf, SCHED_KEYS),
                           c.recovery.summary())
    return out


def run_both(scenario, jax_device: str = "numpy", perf: bool = True):
    """Run ``scenario(env)`` on the JAX package and on the port and hold
    their observations and final states equal; returns the port's."""
    seen = {}
    for side in (JAX, PORT):
        env = Env(side, jax_device)
        try:
            observed = norm(scenario(env))
            seen[side.pkg] = (observed, env.snapshot())
        finally:
            for c in env.clusters:
                c.shutdown()
    (jobs, jstate), (pobs, pstate) = seen["ceph_tpu"], seen["ceph_tpu_torch"]
    assert pobs == jobs
    assert len(pstate) == len(jstate)
    for got, want in zip(pstate, jstate):
        if not perf:
            for st in (got, want):
                for p in st["pools"].values():
                    for g in p["pgs"].values():
                        g.pop("perf")
        assert got.keys() == want.keys()
        for key in want:
            if key == "stores":
                assert got[key].keys() == want[key].keys()
                for o in want[key]:
                    assert got[key][o] == want[key][o], f"osd.{o} store"
            else:
                assert got[key] == want[key], key
    return pobs, pstate


def _write(env, c, pid, n=10, seed=0, sizes=None):
    data = {}
    for i in range(n):
        size = sizes[i] if sizes else 3 * STRIPE + 37 * i
        data[f"obj{i}"] = payload(size, seed + i)
        c.put(pid, f"obj{i}", data[f"obj{i}"])
    return data


def _read_all(c, pid, data):
    got = {oid: c.get(pid, oid, len(d)) for oid, d in data.items()}
    assert got == data
    return got


# -- pools --------------------------------------------------------------------

def scn_pool_creation(env):
    c = env.cluster()
    ec = env.ec_pool(c, "ecpool")
    rep = c.create_replicated_pool("rep", size=3, pg_num=4)
    wide = env.ec_pool(c, "wide", pg_num=4, k=8, m=4)   # chooseleaf type 0
    return [ec, rep, wide, c.status()["pgmap"]["pgs_by_state"],
            c.health(), sorted(c.pool_ids.items())]


def test_pool_creation():
    run_both(scn_pool_creation)


def test_wide_pool_acting_sets_cover_every_osd():
    """k=8 m=4 over 4 hosts: chooseleaf_indep 12 type 0, every OSD holds
    one shard of every PG."""
    _, state = run_both(scn_pool_creation)
    wide = state[0]["pools"][3]
    from ceph_tpu_torch.crush import CRUSH_RULE_CHOOSELEAF_INDEP
    assert wide["rule"][1] == (CRUSH_RULE_CHOOSELEAF_INDEP, 12, 0)
    for g in wide["pgs"].values():
        assert sorted(g["acting"]) == list(range(12))


# -- client I/O ---------------------------------------------------------------

def scn_put_get_degraded(env):
    c = env.cluster()
    pid = env.ec_pool(c)
    data = _write(env, c, pid)
    out = {"reads": _read_all(c, pid, data), "degraded": {}}
    # every object read with the OSDs of its chunks 1 and 5 down (one
    # data chunk, one parity: a decode)
    for oid, d in sorted(data.items()):
        g = c.pg_group(pid, oid)
        down = [g.acting[1], g.acting[5]]
        for o in down:
            c.bus.mark_down(o)
        out["degraded"][oid] = c.get(pid, oid, len(d))
        assert out["degraded"][oid] == d
        for o in down:
            c.bus.mark_up(o)
        c.deliver_all()
    out["health"] = c.health()
    return out


@pytest.mark.parametrize("jax_device", ["numpy", "jax"])
def test_put_get_degraded(jax_device):
    run_both(scn_put_get_degraded, jax_device=jax_device)


def scn_put_many_and_routing(env):
    c = env.cluster()
    pid = env.ec_pool(c)
    objs = {f"b{i}": payload(STRIPE * (1 + i % 3) + 5 * i, 50 + i)
            for i in range(12)}
    c.put_many(pid, objs)
    routes = {oid: c.object_pg(pid, oid) for oid in objs}
    return {"routes": routes, "reads": _read_all(c, pid, objs),
            "status": c.status()["pgmap"]["pgs_by_state"]}


def test_put_many_and_routing():
    run_both(scn_put_many_and_routing)


# -- op vectors ---------------------------------------------------------------

def _reply(r):
    return (r.result, r.version, [(o.op, o.rval, o.outdata) for o in r.ops])


def scn_op_vectors(env):
    c = env.cluster()
    ec = env.ec_pool(c)
    rep = c.create_replicated_pool("rep", size=3, pg_num=4)
    ops = env.S.ops
    out = []
    for pid in (ec, rep):
        op = env.op
        out.append(_reply(c.operate(pid, "a", op().write_full(
            payload(1500, 1)).setxattr("gen", b"1").omap_set(
            {"k1": b"v1", "k2": b"v2"}) if pid == rep else op().write_full(
            payload(1500, 1)).setxattr("gen", b"1"))))
        out.append(_reply(c.operate(pid, "a", op().append(b"tail"))))
        out.append(_reply(c.operate(pid, "a", op().stat().getxattr("gen")
                                    .read(0, 0))))
        out.append(_reply(c.operate(pid, "a", op().cmpxattr(
            "gen", ops.CMPXATTR_EQ, b"1").setxattr("gen", b"2"))))
        with pytest.raises(IOError) as e:
            c.operate(pid, "a", op().cmpxattr("gen", ops.CMPXATTR_EQ, b"1")
                      .setxattr("gen", b"3"))
        out.append(getattr(e.value, "errno", None))
        out.append(_reply(c.operate(pid, "a", op().zero(10, 20)
                                    .truncate(1200))))
        out.append(_reply(c.operate(pid, "a", op().read(0, 0)
                                    .getxattrs())))
        if pid == rep:
            out.append(_reply(c.operate(pid, "a", op().omap_get_vals()
                                        .omap_rm_keys(["k1"]))))
            out.append(_reply(c.operate(pid, "a", op().omap_get_vals())))
        with pytest.raises(IOError) as e:
            c.operate(pid, "missing", op().read(0, 0))
        out.append(getattr(e.value, "errno", None))
        # watch / notify: acks are the watchers' replies
        heard = []

        def on_notify(notify_id, cookie, data, _heard=heard):
            _heard.append((cookie, data))
            return b"ack-%d" % cookie
        c.operate(pid, "w", op().write_full(b"watched"))
        c.operate(pid, "w", op().watch(1, on_notify))
        c.operate(pid, "w", op().watch(2, on_notify))
        out.append(_reply(c.operate(pid, "w", op().notify(b"hello"))))
        c.operate(pid, "w", op().unwatch(1))
        out.append(_reply(c.operate(pid, "w", op().notify(b"again"))))
        out.append(_reply(c.operate(pid, "w", op().list_watchers())))
        out.append(heard)
        out.append(_reply(c.operate(pid, "a", op().remove())))
    return out


def test_op_vectors():
    run_both(scn_op_vectors)


# -- pool snapshots -----------------------------------------------------------

def scn_pool_snapshots(env):
    c = env.cluster()
    out = []
    for pid in (env.ec_pool(c), c.create_replicated_pool("rep", 3, 4)):
        op = env.op
        c.operate(pid, "s", op().write_full(payload(1000, 7))
                  .setxattr("gen", b"1"))
        s1 = c.create_pool_snap(pid, f"a{pid}")
        c.operate(pid, "s", op().write_full(payload(700, 8))
                  .setxattr("gen", b"2"))
        c.put(pid, "t", payload(600, 9))
        s2 = c.create_pool_snap(pid, f"b{pid}")
        c.operate(pid, "s", op().append(b"more"))
        for snapid in (s1, s2, None):
            out.append(_reply(c.operate(pid, "s", op().read(0, 0)
                                        .getxattr("gen"), snapid=snapid)))
        out.append(_reply(c.operate(pid, "s", op().list_snaps())))
        c.operate(pid, "s", op().rollback(s1))
        out.append(_reply(c.operate(pid, "s", op().read(0, 0))))
        c.remove_pool_snap(pid, f"a{pid}")
        out.append(_reply(c.operate(pid, "s", op().list_snaps())))
        with pytest.raises(IOError) as e:
            c.operate(pid, "s", op().read(0, 0), snapid=s1)
        out.append(getattr(e.value, "errno", None))
    return out


def test_pool_snapshots():
    run_both(scn_pool_snapshots)


# -- scrub ----------------------------------------------------------------------

def scn_scrub(env):
    c = env.cluster()
    pid = env.ec_pool(c)
    rep = c.create_replicated_pool("rep", 3, 4)
    data = _write(env, c, pid, n=6)
    rdata = _write(env, c, rep, n=4, seed=20)
    out = [c.scrub_pool(pid), c.scrub_pool(rep)]
    # bit rot on one shard of an EC object and one replica
    for p, oid in ((pid, "obj2"), (rep, "obj1")):
        g = c.pg_group(p, oid)
        s = g.acting[2]
        st = env.S.shard_store(g.bus, s)
        ob = st.objects[env.S.GObject(oid, s)]
        ob.data[3] ^= 0xFF
    out.append(c.scrub_pool(pid, repair=True))
    out.append(c.scrub_pool(rep, repair=True))
    assert out[0] == out[1] == {} and out[2] and out[3]
    out.append(c.scrub_pool(pid))
    out.append(c.scrub_pool(rep))
    assert out[4] == out[5] == {}
    out.append(_read_all(c, pid, data))
    out.append(_read_all(c, rep, rdata))
    return out


def test_scrub_pool():
    run_both(scn_scrub)


# -- replicated pool ----------------------------------------------------------

def scn_replicated(env):
    c = env.cluster()
    rep = c.create_replicated_pool("rep", size=3, pg_num=PG_NUM)
    data = _write(env, c, rep, n=8, sizes=[100 * i + 1 for i in range(8)])
    out = {"reads": _read_all(c, rep, data), "degraded": {}}
    for oid, d in sorted(data.items()):
        g = c.pg_group(rep, oid)
        c.bus.mark_down(g.acting[1])
        out["degraded"][oid] = c.get(rep, oid, len(d))
        c.bus.mark_up(g.acting[1])
        c.deliver_all()
    # a replica misses overwrites and catches up from the PG log
    g = c.pg_group(rep, "obj0")
    v = g.acting[2]
    c.bus.mark_down(v)
    for oid in sorted(data):
        if c.pg_group(rep, oid) is g:
            data[oid] = payload(333, hash(oid) & 0xFF)
            c.put(rep, oid, data[oid])
    c.bus.mark_up(v)
    c._repair_after_boot(rep, g, v)
    out["after"] = _read_all(c, rep, data)
    return out


def test_replicated_pool():
    run_both(scn_replicated)


# -- repair through the recovery scheduler ---------------------------------

def _victim(c, pid):
    """The OSD that is primary of none of the pool's PGs and holds shards
    of the most of its objects (the lowest id on a tie)."""
    pgs = c.pools[pid]["pgs"]
    prim = {g.backend.whoami for g in pgs.values()}
    load: dict[int, int] = {}
    for oid in c.objects.get(pid, ()):
        for o in pgs[c.object_pg(pid, oid)].acting:
            if o not in prim:
                load[o] = load.get(o, 0) + 1
    return min(load, key=lambda o: (-load[o], o))


def repair_scenario(path: str):
    """Down one non-primary OSD, overwrite every object (degraded writes),
    bring it back: the scheduler's waves repair it by ``path``: "wave"
    (chains off), "chain" or "regen" (a pm_regen MBR pool)."""
    def scenario(env):
        conf = {"osd_recovery_chain_enable": path == "chain",
                "osd_recovery_regen_enable": path == "regen"}
        if path == "regen":
            c = env.cluster(conf, chunk=384, recovery=True)
            pid = env.ec_pool(c, kind="regen", k=3, m=2, d=4, mode="mbr")
            obj = 3 * 3 * 384
        else:
            c = env.cluster(conf, recovery=True)
            pid = env.ec_pool(c)
            obj = 3 * STRIPE
        data = {f"o{i}": payload(obj, i) for i in range(8)}
        for oid, d in data.items():
            c.put(pid, oid, d)
        v = _victim(c, pid)
        c.bus.mark_down(v)
        for i, oid in enumerate(sorted(data)):
            data[oid] = payload(obj, 100 + i)
            c.put(pid, oid, data[oid])
        degraded = c.status()["pgmap"]["pgs_by_state"]
        c.bus.mark_up(v)
        c.deliver_all()
        assert c.recovery.jobs == {}
        assert c.recovery.summary()["reservations"]["granted"] == 0
        perf = {}
        for g in c.pools[pid]["pgs"].values():
            for key in ("recoveries", "chain_objects", "regen_objects"):
                perf[key] = perf.get(key, 0) + g.backend.perf.get(key)
        got = _read_all(c, pid, data)
        scrub = {oid: c.pg_group(pid, oid).backend.be_deep_scrub(oid)
                 for oid in sorted(data)}
        assert all(all(v.values()) for v in scrub.values())
        return {"victim": v, "degraded": degraded, "perf": perf,
                "reads": got, "scrub": scrub,
                "recovery_wire": c.wire.class_bytes().get("recovery")}
    return scenario


@pytest.mark.parametrize("path,counter", [("wave", "recoveries"),
                                          ("chain", "chain_objects"),
                                          ("regen", "regen_objects")])
def test_scheduler_repair(path, counter):
    obs, _ = run_both(repair_scenario(path))
    assert obs["perf"][counter] > 0


# -- state carried across -----------------------------------------------------

def _dump_store(store) -> list[dict]:
    """A plain dump of one OSD's store through its public read surface;
    the superblock's PG list as (pool, ps) pairs."""
    out = []
    for g in store.list_objects():
        xattrs = dict(store.getattrs(g))
        if "sb" in xattrs:
            sb = dict(xattrs["sb"])
            sb["pgids"] = [(p.pool, p.ps) for p in sb["pgids"]]
            xattrs["sb"] = sb
        out.append({"oid": g.oid, "shard": g.shard, "data": store.read(g),
                    "xattrs": xattrs, "omap": store.get_omap(g),
                    "omap_header": store.get_omap_header(g)})
    return out


def _meta(c) -> dict:
    return {"n_osds": c.n_osds, "osds_per_host": c.osds_per_host,
            "chunk_size": c.chunk_size,
            "pools": [{"name": p["pool"].name, "type": p["pool"].type,
                       "size": p["pool"].size, "pg_num": p["pool"].pg_num,
                       "params": dict(p["pool"].params),
                       "snap_seq": p["pool"].snap_seq,
                       "snaps": dict(p["pool"].snaps),
                       "removed_snaps": set(p["pool"].removed_snaps)}
                      for _, p in sorted(c.pools.items())]}


def test_cluster_state_carries_across():
    """Write through the reference cluster (one OSD down for the last
    writes, so its PG logs lag), carry every OSD's store across with
    ``convert.cluster_from_reference``, then read, read degraded and
    repair on the port; the reference does the same from where it stood,
    and the two agree bitwise."""
    from ceph_tpu_torch import convert

    def write(env):
        c = env.cluster()
        pid = env.ec_pool(c)
        rep = c.create_replicated_pool("rep", size=3, pg_num=4)
        data = _write(env, c, pid, n=8)
        rdata = _write(env, c, rep, n=4, seed=30)
        c.operate(rep, "obj0", env.op().omap_set({"x": b"1"}))
        v = _victim(c, pid)
        c.bus.mark_down(v)
        for i in range(3):
            data[f"obj{i}"] = payload(2 * STRIPE, 200 + i)
            c.put(pid, f"obj{i}", data[f"obj{i}"])
        return c, pid, rep, v, data, rdata

    def follow(c, pid, rep, v, data, rdata):
        c.bus.mark_down(v)
        out = {"reads": _read_all(c, pid, data)}
        g = c.pg_group(pid, "obj0")
        down = [o for o in g.acting[1:3] if o != v][:1]
        for o in down:
            c.bus.mark_down(o)
        out["degraded"] = c.get(pid, "obj0", len(data["obj0"]))
        for o in down:
            c.bus.mark_up(o)
        c.bus.mark_up(v)
        for p in (pid, rep):
            for g in c.pools[p]["pgs"].values():
                if v in g.acting:
                    c._repair_after_boot(p, g, v)
        out["after"] = _read_all(c, pid, data)
        out["rreads"] = _read_all(c, rep, rdata)
        return out

    jenv = Env(JAX)
    jc, pid, rep, v, data, rdata = write(jenv)
    meta = _meta(jc)
    dump = {o: _dump_store(d.store) for o, d in jc.osds.items()}
    pc = convert.cluster_from_reference(meta, dump, cct=PORT.Context(),
                                        device="cpu")
    penv = Env(PORT)
    penv.clusters.append(pc)
    try:
        # loaded state equals the reference's, store by store and log by log
        before_j, before_p = cluster_state(jc), cluster_state(pc)
        assert before_p["stores"] == before_j["stores"]
        assert before_p["objects"] == before_j["objects"]
        for p in before_j["pools"]:
            for ps, g in before_j["pools"][p]["pgs"].items():
                pg = before_p["pools"][p]["pgs"][ps]
                for key in ("acting", "primary", "authority_log",
                            "shard_logs"):
                    assert pg[key] == g[key], (p, ps, key)
        want = norm(follow(jc, pid, rep, v, dict(data), dict(rdata)))
        got = norm(follow(pc, pid, rep, v, dict(data), dict(rdata)))
        assert got == want
        after_j, after_p = cluster_state(jc), cluster_state(pc)
        assert after_p["stores"] == after_j["stores"]
        for p in after_j["pools"]:
            for ps, g in after_j["pools"][p]["pgs"].items():
                pg = after_p["pools"][p]["pgs"][ps]
                for key in ("acting", "authority_log", "shard_logs",
                            "stale", "state"):
                    assert pg[key] == g[key], (p, ps, key)
    finally:
        jc.shutdown()
        pc.shutdown()


# -- the port's own guarantees --------------------------------------------------

def test_put_without_a_card_raises_and_stores_nothing(monkeypatch):
    """A pool whose profile has no device key runs on the card; without
    one, a put raises, stores nothing and counts no launch."""
    from ceph_tpu_torch.ops import rs_kernels
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rs_kernels.reset_launches()
    c = PORT.MiniCluster(n_osds=12, osds_per_host=3, chunk_size=CHUNK,
                         cct=PORT.Context())
    try:
        pid = c.create_ec_pool("card", {"k": "4", "m": "2"}, pg_num=4)
        with pytest.raises(RuntimeError, match="cuda"):
            c.put(pid, "x", payload(STRIPE))
        with pytest.raises(RuntimeError, match="cuda"):
            c.put_many(pid, {"y": payload(STRIPE)})
        for d in c.osds.values():
            assert not any(g.oid.endswith("\x00x") or g.oid.endswith("\x00y")
                           for g in d.store.list_objects())
        assert rs_kernels.launches == {"gf_apply": 0, "gf_apply_stripes": 0,
                                       "xor_apply": 0, "crc32c_rows": 0}
    finally:
        c.shutdown()


def test_default_plugin_is_torch_rs(tmp_path):
    c = PORT.MiniCluster(n_osds=6, osds_per_host=2, chunk_size=CHUNK,
                         cct=PORT.Context())
    try:
        pid = c.create_ec_pool("d", {"device": "cpu"}, pg_num=2)
        assert c.pools[pid]["pool"].params["plugin"] == "torch_rs"
        for name in ("load", "attach_monitor", "inject_faults",
                     "create_tier"):
            assert callable(getattr(c, name)), name
    finally:
        c.shutdown()
    from ceph_tpu_torch.backend.bluestore import BlueStoreLite
    from ceph_tpu_torch.backend.filestore import FileStore
    for backend, cls in (("file", FileStore), ("bluestore", BlueStoreLite)):
        d = tmp_path / backend
        c = PORT.MiniCluster(n_osds=6, osds_per_host=2, chunk_size=CHUNK,
                             cct=PORT.Context(), data_dir=d,
                             store_backend=backend)
        try:
            assert all(isinstance(o.store, cls) for o in c.osds.values())
            assert (d / "osd.0" / "store").is_dir()
        finally:
            c.shutdown()
    with pytest.raises(ValueError, match="store_backend"):
        PORT.MiniCluster(n_osds=6, osds_per_host=2, data_dir=tmp_path / "x",
                         store_backend="rocksdb")


def test_device_telemetry_without_a_card():
    from ceph_tpu_torch.common import device_telemetry
    cct = PORT.Context()
    snap = device_telemetry.refresh(cct)
    if not torch.cuda.is_available():
        assert snap["inventory"]["platform"] == "cpu"
        assert snap["memory"] == {} and snap["watermarks"] == {}
        assert snap["live_buffer_bytes"] == 0
    assert cct.perf.get("device").get("num_devices") == \
        snap["inventory"]["num_devices"]


def test_health_status_and_flight_bundle():
    """An inactive PG raises PG_AVAILABILITY on both packages and the
    port's flight recorder captures a bundle with the device source."""
    def scenario(env):
        c = env.cluster()
        pid = env.ec_pool(c, pg_num=2)
        c.put(pid, "h", payload(STRIPE))
        g = c.pg_group(pid, "h")
        for o in g.acting[1:4]:
            c.bus.mark_down(o)
        h = c.health()
        st = c.status()["pgmap"]["pgs_by_state"]
        bundles = [b["reason"] for b in c.flight.bundles]
        dev = c.flight.bundles[-1]["device"]
        for o in g.acting[1:4]:
            c.bus.mark_up(o)
        c.deliver_all()
        return {"health": h, "status": st, "bundles": bundles,
                "device_platform": dev["inventory"]["platform"]
                if env.S is PORT else "cpu"}
    obs, _ = run_both(scenario)
    assert obs["health"]["status"] == "HEALTH_ERR"


# -- the shapes phase ``shapes`` times for the cluster path ------------------

def _degraded_gets(c, pid, data: dict) -> None:
    """chip_smoke.py's degraded gets: PG by PG, the OSDs of chunks 1 and 9
    down, every object of the PG read."""
    by_pg: dict = {}
    for oid in data:
        by_pg.setdefault(c.object_pg(pid, oid), []).append(oid)
    for ps, oids in sorted(by_pg.items()):
        down = [c.pools[pid]["pgs"][ps].acting[i] for i in (1, 9)]
        for o in down:
            c.bus.mark_down(o)
        for oid in oids:
            assert c.get(pid, oid, len(data[oid])) == data[oid]
        for o in down:
            c.bus.mark_up(o)
        c.deliver_all()


def _down_overwrite_up(c, pid, victim, data: dict, new: dict) -> None:
    c.bus.mark_down(victim)
    for oid, d in new.items():
        c.put(pid, oid, d)
    data.update(new)
    c.bus.mark_up(victim)
    c.deliver_all()
    assert not c.recovery.jobs


def test_path_shapes_name_the_clusters_launches():
    """``path_shapes.cluster_shapes`` names every ``gf_apply`` and
    ``crc32c_rows`` launch of ``chip_smoke.py``'s phase ``cluster`` with
    its count: the phase's cluster (12 OSDs on 4 hosts, pg_num 32, a 4 KiB
    stripe unit, torch_rs k=8 m=4, the same object names and payload
    seed) and op sequence, here at 64 KiB objects on the CPU (the widths
    follow the object size; the counts do not)."""
    from ceph_tpu_torch.ops import rs_kernels
    from ceph_tpu_torch.plugins.registry import ErasureCodePluginRegistry
    from ceph_tpu_torch.tools import path_shapes as PS
    obj, objects, small = 64 << 10, 64, PS.CLUSTER_SMALL
    rng = np.random.default_rng(12)
    bufs = [rng.integers(0, 256, obj, dtype=np.uint8).tobytes()
            for _ in range(objects)]
    oids = [f"rbd_data.{i:04x}" for i in range(objects)]
    profile = {"k": "8", "m": "4", "technique": "reed_sol_van",
               "device": "cpu"}
    with PS.recorded_launches(rs_kernels) as seen:
        c = PORT.MiniCluster(n_osds=12, osds_per_host=3,
                             chunk_size=PS.CLUSTER_UNIT, cct=PORT.Context())
        c.enable_recovery_scheduler()
        pid = c.create_ec_pool("rbd", dict(profile), pg_num=32)
        data = dict(zip(oids, bufs))
        for oid, d in data.items():                            # (a)
            c.put(pid, oid, d)
        assert all(c.get(pid, oid, obj) == d for oid, d in data.items())
        _degraded_gets(c, pid, data)                           # (b)
        for s, chain in ((1, False), (2, True)):               # (c), (d)
            c.cct.conf.set("osd_recovery_chain_enable", chain)
            _down_overwrite_up(c, pid, 3, data, {
                oid: bufs[(i + s) % objects] for i, oid in enumerate(oids)})
        rep = c.create_replicated_pool("rep", size=3, pg_num=32)   # (f)
        for i in range(small):
            c.put(rep, f"rep.{i}", bufs[i])
            assert c.get(rep, f"rep.{i}", obj) == bufs[i]
        eng = c.enable_serving()
        served = {f"srv.{i}": bufs[-1 - i] for i in range(small)}
        for oid, d in served.items():
            c.put(pid, oid, d)
        _degraded_gets(c, pid, served)
        eng.flush()
        c.shutdown()
        prof = {"plugin": "pm_regen", "k": "3", "m": "2", "d": "4",
                "mode": "mbr", "device": "cpu"}                 # (e)
        pm = ErasureCodePluginRegistry.instance().factory(
            "pm_regen", "", dict(prof))
        rc = PORT.MiniCluster(n_osds=12, osds_per_host=3, cct=PORT.Context(),
                              chunk_size=pm.get_chunk_size(3 * PS.CLUSTER_UNIT))
        rc.enable_recovery_scheduler()
        rpid = rc.create_ec_pool("regen", dict(prof), pg_num=32)
        roids = [f"regen.{i}" for i in range(small)]
        rdata = dict(zip(roids, bufs))
        for oid, d in rdata.items():
            rc.put(rpid, oid, d)
        prim = {g.backend.whoami for g in rc.pools[rpid]["pgs"].values()}
        load: dict = {}
        for oid in roids:
            for o in rc.pg_group(rpid, oid).acting[1:]:
                if o not in prim:
                    load[o] = load.get(o, 0) + 1
        victim = min(load, key=lambda o: (-load[o], o))
        assert load[victim] == PS.REGEN_VICTIM_OBJECTS
        _down_overwrite_up(rc, rpid, victim, rdata, {
            oid: bufs[i + 1] for i, oid in enumerate(roids)})
        assert all(rc.get(rpid, oid, obj) == d for oid, d in rdata.items())
        rc.shutdown()
    want = PS.cluster_shapes(ErasureCodePluginRegistry.instance(),
                             obj_bytes=obj)
    assert dict(seen) == dict(PS.shape_counts(want))
