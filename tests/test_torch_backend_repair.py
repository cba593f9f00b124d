"""Shard repair through the port's ECBackend against the JAX package's.

``start_shard_repair`` with a wave driver (the recovery scheduler's
pacing, without reservations) runs the three repair paths of
``_recover_many``: centralized recovery waves (``decode_shards_many``),
chained partial sums (``recovery/chain.py``, ``osd_recovery_chain_enable``)
and regenerating repair (``recovery/regen.py``,
``osd_recovery_regen_enable``, pm_regen MBR and MSR).  Each case runs on
``ceph_tpu.backend`` and on ``ceph_tpu_torch.backend`` and holds the two
bitwise equal (the harness of ``test_torch_ec_backend.py``).

Then: state carried across (``convert.shard_stores_from_reference``:
written on the JAX package, read, degraded-read and repaired on the
port), and the port's refusal to answer on the host for a card it does
not have (a ``torch_rs`` or ``pm_regen`` pool with no ``device`` key).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from ceph_tpu_torch import convert
from ceph_tpu_torch.ops import rs_kernels
from ceph_tpu_torch.tools.wave_driver import WaveScheduler, replace_disk
from test_torch_ec_backend import (CHUNK, JAX, PORT, STRIPE, Env, norm,
                                   payload, run_both)


def cluster_from_stores(ec, stores, chunk_size, cct):
    """make_cluster's layout (chunk i on shard i, the primary on shard 0)
    over existing shard stores; each shard boots its PG log from its
    pgmeta omap."""
    bus = PORT.MessageBus()
    n = ec.get_chunk_count()
    be = PORT.ECBackend(ec, PORT.StripeInfo(ec.get_data_chunk_count(),
                                            chunk_size), bus,
                        acting=list(range(n)), whoami=0, cct=cct,
                        store=stores[0])
    for shard in range(1, n):
        PORT.OSDShard(shard, bus, store=stores[shard])
    return be, bus


def _repair_env(env, chunk, chain, regen, n_objects, obj_bytes, seed):
    be, bus = env.cluster(chunk=chunk, conf={
        "osd_recovery_chain_enable": chain,
        "osd_recovery_regen_enable": regen})
    sched = be.recovery_scheduler = WaveScheduler()
    rng = np.random.default_rng(seed)
    data = {f"o{i}": rng.integers(0, 256, obj_bytes, np.uint8).tobytes()
            for i in range(n_objects)}
    for oid, d in data.items():
        env.write(be, bus, oid, 0, d)
    return be, bus, sched, data


def _states(env, be, bus, data):
    out = {}
    for oid, d in data.items():
        res = env.read(be, bus, oid, 0, len(d))
        assert not res["errors"] and res["result"][oid][0][2] == d
        out[oid] = be.be_deep_scrub(oid)
        assert all(out[oid].values()), (oid, out[oid])
    return out


def repair_scenario(path: str, victims=(3,), n_objects: int = 6,
                    chunk: int = CHUNK, mode: str = ""):
    """Replace the disks of ``victims`` one at a time; each comes back
    stale and its repair runs through ``path``: "wave" (chains off),
    "chain", or "regen"; then every object reads back and deep-scrubs
    clean."""
    def scenario(env):
        k = env.ec.get_data_chunk_count()
        be, bus, sched, data = _repair_env(
            env, chunk, chain=path == "chain", regen=path == "regen",
            n_objects=n_objects, obj_bytes=3 * chunk * k, seed=3)
        done = []
        for v in victims:
            replace_disk(bus, v, env.S.OSDShard)
            rop = be.shard_repairs[v]
            assert rop.driver is sched
            bus.deliver_all()
            assert rop.state == env.S.RepairState.COMPLETE, rop.state
            done.append((v, rop.state, rop.plan, rop.objects_repaired))
        assert not be.stale
        perf = {key: be.perf.get(key) for key in (
            "recoveries", "chain_objects", "regen_objects")}
        if path == "chain":
            assert perf["chain_objects"] == n_objects * len(victims)
        elif path == "regen":
            assert perf["regen_objects"] == n_objects * len(victims)
        else:
            assert perf["chain_objects"] == perf["regen_objects"] == 0
            assert perf["recoveries"] == n_objects * len(victims)
        return {"repairs": done, "waves": sched.waves,
                "reads": _states(env, be, bus, data)}
    return scenario


REPAIRS = {
    "wave": (repair_scenario("wave"), {}),
    "wave_two_victims": (repair_scenario("wave", victims=(2, 5)), {}),
    "wave_parity": (repair_scenario("wave", victims=(5,), n_objects=9),
                    {}),
    "chain": (repair_scenario("chain"), {}),
    "chain_two_victims": (repair_scenario("chain", victims=(1, 4)), {}),
    "wave_k8m4_4k": (repair_scenario("wave", victims=(3,), n_objects=4,
                                     chunk=4096), {"k": 8, "m": 4}),
    "chain_k8m4_4k": (repair_scenario("chain", victims=(3,), n_objects=4,
                                      chunk=4096), {"k": 8, "m": 4}),
}


@pytest.mark.parametrize("case", sorted(REPAIRS))
def test_shard_repair_matches_reference(case):
    scenario, codec = REPAIRS[case]
    run_both(scenario, **codec)


# pm_regen geometries (mode, k, m, d, chunk) of tests/test_regen_repair.py
REGEN = [("mbr", 3, 2, 4, 384), ("msr", 3, 2, 4, 128), ("msr", 2, 2, 2, 128)]


@pytest.mark.parametrize("mode,k,m,d,chunk", REGEN)
@pytest.mark.parametrize("path", ["regen", "wave"])
def test_regen_shard_repair_matches_reference(path, mode, k, m, d, chunk):
    run_both(repair_scenario(path, victims=(1,), chunk=chunk),
             kind="regen", k=k, m=m, d=d, mode=mode)


def test_chain_hop_death_falls_back_like_reference():
    """A chain hop dies with the partial sum in flight: the chain aborts
    to the centralized path on both packages, with the same result."""
    def scenario(env):
        be, bus, sched, data = _repair_env(env, CHUNK, chain=True,
                                           regen=False, n_objects=4,
                                           obj_bytes=3 * STRIPE, seed=5)
        replace_disk(bus, 3, env.S.OSDShard)
        chain = next(iter(be._recovery_chains.values()), None)
        while chain is None:
            assert bus.deliver_one(0) or bus.deliver_one(3)
            chain = next(iter(be._recovery_chains.values()), None)
        bus.mark_down(chain.hop_shards[-1])
        bus.deliver_all()
        return {"hops": chain.hop_shards,
                "fallbacks": be.perf.get("chain_fallbacks"),
                "recoveries": be.perf.get("recoveries")}
    obs, _ = run_both(scenario)
    assert obs["fallbacks"] == 1


def test_repair_legs_carry_the_plugins_device():
    """The plan's device is the plugin's own: torch_rs device=cpu runs
    its chain hops on the plain versions (cpu); device=numpy on the host
    GF math; pm_regen likewise for its regen legs."""
    seen = {}
    for kind, codec in (("rs", {}),
                        ("regen", {"k": 3, "m": 2, "d": 4, "mode": "msr"})):
        for dev in ("cpu", "numpy"):
            env = Env(PORT, kind, **codec)
            env.ec = PORT.registry.factory(
                "torch_rs" if kind == "rs" else "pm_regen", "",
                {"k": str(codec.get("k", 4)), "m": str(codec.get("m", 2)),
                 "device": dev} | ({} if kind == "rs" else
                                   {"d": "4", "mode": "msr"}))
            be, bus, _s, _d = _repair_env(
                env, CHUNK, chain=kind == "rs", regen=kind == "regen",
                n_objects=2, obj_bytes=3 * CHUNK * codec.get("k", 4),
                seed=7)
            sent = []
            send = bus.send
            bus.send = lambda to, msg: (sent.append(msg), send(to, msg))
            replace_disk(bus, 1, env.S.OSDShard)
            bus.deliver_all()
            seen[kind, dev] = {getattr(m, "device", None) for m in sent
                               if type(m).__name__ in ("ECPartialSum",
                                                       "ECRegenRead")}
    assert seen == {("rs", "cpu"): {"cpu"}, ("rs", "numpy"): {"numpy"},
                    ("regen", "cpu"): {"cpu"},
                    ("regen", "numpy"): {"numpy"}}


# -- state carried across --------------------------------------------------------

def _dump(store) -> list[dict]:
    """A plain-dict dump of a store, through its public read surface."""
    return [{"oid": g.oid, "shard": g.shard, "data": store.read(g),
             "xattrs": store.getattrs(g), "omap": store.get_omap(g),
             "omap_header": store.get_omap_header(g)}
            for g in store.list_objects()]


def test_shard_stores_carry_across_from_reference():
    """Write on the JAX package (a shard down for the last writes, so
    its PG log lags), carry every shard's store across, then read,
    degraded-read and repair on the port; the JAX cluster does the same
    and the two agree bitwise."""
    def write(env):
        be, bus = env.cluster()
        for i in range(4):
            env.write(be, bus, f"o{i}", 0, payload(2 * STRIPE + 100 * i, i))
        bus.mark_down(4)
        for i in range(4, 6):
            env.write(be, bus, f"o{i}", 0, payload(STRIPE, i))
        return be, bus

    def follow(env, be, bus):
        bus.mark_down(4)      # the lagging shard: down until repaired
        out = {"reads": {}, "degraded": {}}
        sizes = [2 * STRIPE + 100 * i if i < 4 else STRIPE
                 for i in range(6)]
        for i, n in enumerate(sizes):
            out["reads"][i] = env.read(be, bus, f"o{i}", 0, n)
        bus.mark_down(1)
        for i, n in enumerate(sizes):
            out["degraded"][i] = env.read(be, bus, f"o{i}", 0, n)
            assert out["degraded"][i]["result"][f"o{i}"][0][2] == \
                payload(n, i)
        bus.mark_up(1)
        bus.mark_up(4)        # revival: stale, repaired from the log
        bus.deliver_all()
        assert not be.stale
        out["repaired"] = be.perf.get("log_repair_objects")
        assert out["repaired"] == 2
        out["scrub"] = {i: be.be_deep_scrub(f"o{i}") for i in range(6)}
        assert all(all(r.values()) for r in out["scrub"].values())
        return out

    jenv = Env(JAX)
    jbe, jbus = write(jenv)
    dump = {s: _dump(jenv.store(jbus, s)) for s in jbe.acting}
    stores = convert.shard_stores_from_reference(dump)
    penv = Env(PORT)
    pbe, pbus = cluster_from_stores(penv.ec, stores, CHUNK, PORT.Context())
    penv.clusters.append((pbe, pbus))
    assert norm(list(pbe.pg_log.entries)) == norm(list(jbe.pg_log.entries))
    assert pbus.handlers[4].pg_log.head == 4 < pbe.pg_log.head == 6
    want = follow(jenv, jbe, jbus)
    got = follow(penv, pbe, pbus)
    assert norm(got) == norm(want)
    jstate, pstate = jenv.snapshot()[0], penv.snapshot()[0]
    assert pstate["shards"] == jstate["shards"]
    assert pstate["authority_log"] == jstate["authority_log"]
    assert pstate["local_log"] == jstate["local_log"]


def test_carry_across_refuses_foreign_pickles():
    import pickle
    evil = pickle.dumps(print)
    with pytest.raises(pickle.UnpicklingError):
        convert.shard_stores_from_reference({0: [{
            "oid": "_pgmeta_", "shard": 0, "data": b"", "xattrs": {},
            "omap": {"log.0000000000000001": evil}, "omap_header": b""}]})


# -- no card, no answer on the host ------------------------------------------------

@pytest.fixture
def no_card(monkeypatch):
    """A machine without a card, and the launch counts at zero."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rs_kernels.reset_launches()


@pytest.mark.parametrize("plugin,profile", [
    ("torch_rs", {"k": "4", "m": "2"}),
    ("pm_regen", {"k": "3", "m": "2", "d": "4", "mode": "mbr"})])
def test_no_card_write_fails_and_stores_nothing(no_card, plugin, profile):
    ec = PORT.registry.factory(plugin, "", dict(profile))
    be, bus = PORT.make_cluster(ec, chunk_size=384, cct=PORT.Context())
    with pytest.raises(RuntimeError, match="cuda"):
        be.submit_transaction(PORT.PGTransaction().write(
            "obj", 0, payload(3 * 384 * int(profile["k"]))))
        bus.deliver_all()
    for s in be.acting:
        assert not PORT.shard_store(bus, s).objects
    assert not any(rs_kernels.launches.values())


def _stores_written_on_cpu(plugin, profile, chunk, overwrite=False):
    """Three objects written by a device=cpu pool; ``overwrite`` patches
    each in place afterwards, which clears its chunk hashes."""
    ec = PORT.registry.factory(plugin, "", dict(profile) | {"device": "cpu"})
    env = Env(PORT)
    be, bus = env.cluster(chunk=chunk, ec=ec)
    for i in range(3):
        env.write(be, bus, f"o{i}", 0,
                  payload(3 * chunk * int(profile["k"]), i))
        if overwrite:
            env.write(be, bus, f"o{i}", 10, payload(20, 10 + i))
            assert not be._hinfo(f"o{i}").has_chunk_hash()
    return {s: PORT.shard_store(bus, s) for s in be.acting}


@pytest.mark.parametrize("plugin,profile,path", [
    ("torch_rs", {"k": "4", "m": "2"}, "chain"),
    ("torch_rs", {"k": "4", "m": "2"}, "wave"),
    ("pm_regen", {"k": "3", "m": "2", "d": "4", "mode": "mbr"}, "regen")])
def test_no_card_repair_legs_fail(monkeypatch, plugin, profile, path):
    """Objects written by a device=cpu pool, then served by the same
    stores under a profile with no device key: the repair's legs fail
    with the cuda error, and nothing is rebuilt on the host."""
    chunk = 384
    stores = _stores_written_on_cpu(plugin, profile, chunk)
    ec = PORT.registry.factory(plugin, "", dict(profile))
    cct = PORT.Context()
    cct.conf.set("osd_recovery_chain_enable", path == "chain")
    cct.conf.set("osd_recovery_regen_enable", path == "regen")
    be, bus = cluster_from_stores(ec, stores, chunk, cct)
    be.recovery_scheduler = WaveScheduler()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rs_kernels.reset_launches()
    env = Env(PORT)
    with pytest.raises(RuntimeError, match="cuda"):
        replace_disk(bus, 1, env.S.OSDShard)
        bus.deliver_all()
    assert not any(g.oid.startswith("o")
                   for g in PORT.shard_store(bus, 1).objects)
    assert not any(rs_kernels.launches.values())


@pytest.mark.parametrize("op", ["deep_scrub", "wave"])
def test_no_card_hashless_verify_fails_not_rot(monkeypatch, op):
    """Objects whose overwrites cleared their chunk hashes are verified
    by the code's spare equations, a decode.  With no card that decode
    fails with the cuda error: deep scrub and the recovery wave raise it,
    and no object is recorded as damaged or rebuilt."""
    chunk, profile = 384, {"k": "4", "m": "2"}
    stores = _stores_written_on_cpu("torch_rs", profile, chunk,
                                    overwrite=True)
    ec = PORT.registry.factory("torch_rs", "", dict(profile))
    cct = PORT.Context()
    cct.conf.set("osd_recovery_chain_enable", False)
    be, bus = cluster_from_stores(ec, stores, chunk, cct)
    be.recovery_scheduler = WaveScheduler()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rs_kernels.reset_launches()
    with pytest.raises(RuntimeError, match="cuda"):
        if op == "deep_scrub":
            be.be_deep_scrub("o0")
        else:
            replace_disk(bus, 1, PORT.OSDShard)
            bus.deliver_all()
    assert not be.inconsistent_objects
    if op == "wave":                  # shard 1's new disk stays empty
        assert not any(g.oid.startswith("o")
                       for g in PORT.shard_store(bus, 1).objects)
    assert not any(rs_kernels.launches.values())


# -- the shapes phase ``shapes`` times for the backend path ------------------------

def test_path_shapes_name_the_backends_launches(monkeypatch):
    """``path_shapes.backend_shapes`` times the matrices and widths the
    backend hands ``gf_apply`` and ``crc32c_rows``: an op's encode and
    crc, a degraded read with shards 1 and 9 down and a wave rebuilding
    shard 3; here at 64 KiB objects, scaled to the phase's 4 MiB."""
    from ceph_tpu_torch.tools import path_shapes as PS
    obj, objects = 64 << 10, 2
    ec = PORT.registry.factory("torch_rs", "", {
        "k": "8", "m": "4", "technique": "reed_sol_van", "device": "cpu"})
    be, bus = PORT.make_cluster(ec, chunk_size=4096, cct=PORT.Context(
        {"osd_recovery_chain_enable": False}))
    be.recovery_scheduler = WaveScheduler(size=objects)
    seen = []
    apply, crc = rs_kernels.gf_apply, rs_kernels.crc32c_rows
    monkeypatch.setattr(rs_kernels, "gf_apply", lambda mat, data: (
        seen.append(("gf_apply", np.asarray(mat), tuple(data.shape))),
        apply(mat, data))[1])
    monkeypatch.setattr(rs_kernels, "crc32c_rows", lambda rows: (
        seen.append(("crc32c_rows", None, tuple(rows.shape))),
        crc(rows))[1])
    Env(PORT).write(be, bus, "o0", 0, payload(obj, 0))
    launched = seen[:]
    Env(PORT).write(be, bus, "o1", 0, payload(obj, 1))
    for s in (1, 9):
        bus.mark_down(s)
    seen.clear()
    assert Env(PORT).read(be, bus, "o0", 0, obj)["result"]["o0"][0][2] \
        == payload(obj, 0)
    launched += seen
    for s in (1, 9):
        bus.mark_up(s)
    bus.deliver_all()
    seen.clear()
    replace_disk(bus, 3, PORT.OSDShard)
    bus.deliver_all()
    launched += [x for x in seen if x[0] == "gf_apply"]
    scale = {"op": PS.OBJ_BYTES // obj,
             "wave": PS.OBJECTS * PS.OBJ_BYTES // (objects * obj)}
    want = PS.backend_shapes(PORT.registry)
    assert len(launched) == len(want)
    for (kernel, mat, shape), row in zip(
            sorted(launched, key=lambda x: x[0] == "crc32c_rows"), want):
        assert kernel == row["kernel"], row["label"]
        if mat is not None:
            assert np.array_equal(mat, row["mat"]), row["label"]
        unit = scale["wave" if "wave" in row["label"] else "op"]
        assert (shape[0], shape[1] * unit) == (row["rows"], row["cols"]), \
            row["label"]
