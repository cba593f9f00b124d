"""The port's cache tiering (``tier/``: ``TierService``, ``TierAgent``;
``osd/tiering.py``: ``CacheTier``, ``TieringAgent``;
``MiniCluster.create_tier`` with ``TIER_FULL``, ``TIER_FLUSH_BACKLOG``
and ``tier status``) against the JAX package's, on the CPU.

Every scenario binds a replicated cache pool (size 3, hit sets armed)
over an EC base pool (k=4 m=2: ``jax_rs`` with ``device=numpy`` against
``torch_rs`` with ``device=cpu``) on both packages' ``MiniCluster`` and
runs the same reads, writes, flushes, evictions and agent passes;
``test_torch_cluster.run_both`` holds what each observed (tier
counters, residency, dirty marks, agent stats, health) and the whole
cluster state equal bitwise.
"""
from __future__ import annotations

import importlib

import pytest

from test_torch_cluster import (JAX, PORT, fixed_clock,  # noqa: F401
                                payload, run_both)


def tiered(env, conf=None, mode="writeback", recency=1):
    c = env.cluster({"tier_promote_min_recency": recency, **(conf or {})})
    base = env.ec_pool(c, "base", pg_num=4)
    cache = c.create_replicated_pool(
        "cache", size=3, pg_num=4,
        params={"hit_set_count": "2", "hit_set_period": "8"})
    svc = c.create_tier(cache, base, mode=mode)
    return c, svc, cache, base


def _stat(c, pid, oid):
    try:
        return c.operate(pid, oid, c_op(c).stat()).result
    except IOError as e:
        return ("err", getattr(e, "errno", None))


def c_op(c):
    pkg = type(c).__module__.rsplit(".", 1)[0]
    return importlib.import_module(f"{pkg}.osd.osd_ops").ObjectOperation()


def _base_bytes(c, base, oid, n):
    r = c.operate(base, oid, c_op(c).read(0, 0))
    return bytes(r.ops[0].outdata)[:n]


# -- read and write paths ---------------------------------------------------------

def scn_writeback(env):
    c, svc, cache, base = tiered(env)
    out = []
    p = payload(3000, 1)
    c.operate(base, "obj", env.op().write_full(p))
    out += [svc.read("obj") == p, svc.stats(), svc.resident()]
    out += [svc.read("obj") == p, svc.stats()["counters"]]
    svc.evict("obj")
    out += [_stat(c, cache, "obj"), svc.read("obj") == p,
            svc.stats()["counters"]]
    with pytest.raises(IOError):
        svc.read("never-written")
    w = payload(2500, 7)
    svc.write("w", w)
    out += [svc.is_dirty("w"), _stat(c, base, "w")]
    svc.flush("w")
    out += [svc.is_dirty("w"), _base_bytes(c, base, "w", len(w)) == w]
    svc.flush("w")                                  # idempotent
    out += [_base_bytes(c, base, "w", len(w)) == w, svc.stats()]
    return out


def scn_recency_two(env):
    c, svc, cache, base = tiered(env, recency=2)
    c.operate(base, "o", env.op().write_full(b"x" * 64))
    svc.read("o")
    out = [svc.stats()["counters"], svc.resident()]
    svc.agent.age()
    svc.read("o")
    out += [svc.stats()["counters"], svc.resident()]
    return out


def scn_proxy(env):
    c, svc, cache, base = tiered(env, mode="proxy")
    c.operate(base, "p", env.op().write_full(b"v1" * 32))
    out = [svc.read("p")]
    svc.write("p", b"v2" * 32)
    r = c.operate(base, "p", env.op().read(0, 0), internal=True)
    out += [bytes(r.ops[0].outdata)[:64], svc.stats()["counters"],
            svc.read("p")]
    return out


def scn_readonly(env):
    c, svc, cache, base = tiered(env, mode="readonly")
    with pytest.raises(IOError) as e:
        svc.write("x", b"nope")
    c.operate(base, "x", env.op().write_full(b"ro"))
    return [e.value.errno, svc.read("x")[:2], svc.stats()]


@pytest.mark.parametrize("scenario", [scn_writeback, scn_recency_two,
                                      scn_proxy, scn_readonly])
def test_tier_modes(scenario):
    run_both(scenario)


# -- the agent ------------------------------------------------------------------------

def scn_agent(env):
    c, svc, cache, base = tiered(env)
    conf = c.cct.conf
    conf.set("tier_target_max_objects", 5)
    conf.set("tier_dirty_ratio_high", 0.5)
    conf.set("tier_dirty_ratio_low", 0.25)
    for i in range(4):
        svc.write(f"d{i}", payload(300 + i, i))
    out = [svc.agent.tick(), svc.agent.backlog_ticks]
    conf.set("tier_full_ratio", 0.1)
    for _ in range(4):
        assert svc.read("d0") == payload(300, 0)
        out.append(svc.agent.tick(age=True))
    out += [svc.resident(), svc.read("d2") == payload(302, 2),
            svc.stats()]
    conf.set("tier_target_max_objects", 1)
    conf.set("tier_full_ratio", 0.5)
    svc.write("h0", b"a" * 64)
    svc.write("h1", b"b" * 64)
    svc.read("h0"), svc.read("h1")
    out += [svc.agent.tick(max_ops=16), svc.resident(),
            svc.agent.fullness()]
    return out


def test_agent_flush_evict_promote():
    obs, _ = run_both(scn_agent)
    assert obs[0]["flushes"] == 3
    assert obs[6] == ("d0",)


def scn_seed_tiering(env):
    """The seed agent of ``osd/tiering.py``: writeback, flush, evict,
    promote, and a cold set aged out while a hot object stays."""
    tiering = importlib.import_module(f"{env.S.pkg}.osd.tiering")
    c = env.cluster()
    base = env.ec_pool(c, "base", pg_num=4)
    cache = c.create_replicated_pool(
        "cache", size=3, pg_num=4,
        params={"hit_set_count": "2", "hit_set_period": "8"})
    tier = tiering.CacheTier(c, cache, base)
    agent = tiering.TieringAgent(c, cache, base)
    p = payload(3000, 1)
    tier.write("obj", p)
    out = [agent.is_dirty("obj"), _stat(c, base, "obj")]
    agent.flush("obj")
    out += [agent.is_dirty("obj"), _base_bytes(c, base, "obj", 3000) == p]
    agent.evict("obj")
    out += [_stat(c, cache, "obj"), tier.read("obj") == p,
            _stat(c, cache, "obj")]
    for i in range(4):
        tier.write(f"cold{i}", payload(500 + i, i))
    tier.write("hot", payload(200, 99))
    for _ in range(4):
        assert tier.read("hot") == payload(200, 99)
        out.append(agent.agent_work(age=True))
    out += [[_stat(c, cache, f"cold{i}") for i in range(4)],
            _stat(c, cache, "hot"), tier.read("cold2") == payload(502, 2)]
    return out


def test_seed_tiering_agent():
    run_both(scn_seed_tiering)


# -- health and admin ---------------------------------------------------------------

def scn_tier_health(env):
    c, svc, cache, base = tiered(env)
    conf = c.cct.conf
    out = [sorted(c.health()["checks"])]
    conf.set("tier_target_max_objects", 2)
    conf.set("tier_full_ratio", 0.5)
    svc.write("f0", b"x" * 64)
    svc.write("f1", b"y" * 64)
    h = c.health()
    out += [h["status"], h["checks"].get("TIER_FULL")]
    svc.agent.tick(max_ops=16)
    out.append("TIER_FULL" in c.health()["checks"])
    conf.set("tier_target_max_objects", 4)
    conf.set("tier_full_ratio", 0.99)
    conf.set("tier_dirty_ratio_high", 0.25)
    for i in range(3):
        svc.write(f"b{i}", b"z" * 32)
    svc.agent.tick(max_ops=0)
    out.append("TIER_FLUSH_BACKLOG" in c.health()["checks"])
    svc.agent.tick(max_ops=0)
    out.append(c.health()["checks"].get("TIER_FLUSH_BACKLOG"))
    svc.agent.tick(max_ops=16)
    out += [svc.agent.backlog_ticks,
            "TIER_FLUSH_BACKLOG" in c.health()["checks"],
            c.cct.admin_socket.call("tier status")]
    with pytest.raises(ValueError):
        c.create_tier(cache, base)
    out.append([e["message"] for e in c.clusterlog.last(50)
                if e["channel"] == "mon"])
    return out


def test_tier_full_and_flush_backlog():
    obs, _ = run_both(scn_tier_health)
    assert obs[2] is not None and obs[3] is False
    assert obs[4] is False and obs[5] is not None and obs[7] is False


def test_writeback_survives_a_crash(tmp_path):
    """Acked writeback writes survive abandoning the process image (no
    shutdown, no checkpoint) on both packages: the reopened cluster reads
    them back, still dirty, and flushes them through the EC base."""
    seen = {}
    for side in (JAX, PORT):
        d = tmp_path / side.pkg
        c = side.MiniCluster(n_osds=12, osds_per_host=3, chunk_size=128,
                             cct=side.Context(), data_dir=d,
                             store_backend="file")
        prof = {"plugin": side.rs, "k": "4", "m": "2",
                "device": "numpy" if side is JAX else "cpu"}
        base = c.create_ec_pool("base", prof, pg_num=4)
        cache = c.create_replicated_pool(
            "cache", size=3, pg_num=4,
            params={"hit_set_count": "2", "hit_set_period": "8"})
        svc = c.create_tier(cache, base)
        data = {f"k{i}": payload(1200 + i, 40 + i) for i in range(6)}
        for oid, p in data.items():
            svc.write(oid, p)
        for o in c.osds.values():                # kill -9
            o.store.close(checkpoint=False)
        c2 = side.MiniCluster.load(d, cct=side.Context())
        svc2 = c2.create_tier(c2.pool_ids["cache"], c2.pool_ids["base"])
        out = [[svc2.read(oid) == p for oid, p in data.items()],
               [svc2.is_dirty(oid) for oid in data]]
        for oid in data:
            svc2.flush(oid)
        out.append([_base_bytes(c2, base, oid, len(p)) == p
                    for oid, p in data.items()])
        out.append(svc2.stats())
        c2.shutdown()
        seen[side.pkg] = out
    assert seen["ceph_tpu_torch"] == seen["ceph_tpu"]
    assert all(all(x) for x in seen["ceph_tpu"][:3])


# -- admission through the sharded front end ---------------------------------

class _Engine:
    """ServingEngine's depth surface with a scripted queue depth."""

    def __init__(self, depth: int):
        self.depth = depth

    def depths(self):
        return {"_total": self.depth}

    def pressure(self):
        return self.depth / 4


def scn_frontend_admission(env):
    """A tier over a ShardedFrontend (the reference's
    ``tests/test_tier.py`` TestFrontendAdmission): hits are admitted
    through the owning shard's shed ladder and served; a saturated shard
    sheds the hit with FrontendBusy (EBUSY) instead of letting the free
    path bypass overload control; writes skip admission."""
    frontend = importlib.import_module(f"{env.S.pkg}.msg.frontend")
    c = env.cluster({"tier_promote_min_recency": 1})
    base = env.ec_pool(c, "base", pg_num=4)
    cache = c.create_replicated_pool(
        "cache", size=3, pg_num=4,
        params={"hit_set_count": "2", "hit_set_period": "8"})
    engines = {0: _Engine(0), 1: _Engine(0)}
    fe = frontend.ShardedFrontend(
        engines, locate=lambda name: c.object_pg(cache, name) % 2,
        queue_limit=4)
    svc = c.create_tier(cache, base, frontend=fe)
    out = []
    for i in range(6):
        svc.write(f"s{i}", payload(800, i))
    out.append([svc.read(f"s{i}") == payload(800, i) for i in range(6)])
    out.append(fe.stats()["routed"])
    engines[0].depth = engines[1].depth = 10_000
    with pytest.raises(frontend.FrontendBusy) as ei:
        svc.read("s0")
    out.append((ei.value.errno, ei.value.op_class, ei.value.shard))
    out.append({sid: p.snapshot() for sid, p in fe.shed.items()})
    out.append(svc.stats()["counters"])
    return out


def test_frontend_admission():
    run_both(scn_frontend_admission)
