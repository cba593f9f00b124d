"""The port's cluster under ``rados bench write``, on the CPU at a small
size: 12 hosts of one OSD each, an EC pool of ``torch_rs reed_sol_van
k=8 m=4`` (``device=cpu``) with ``pg_num`` 4, a 4 KiB stripe unit and
256 KiB objects, written through librados ``aio_operate(write_full)``.

- every chunk, HashInfo chunk hash and read-back equals the benchmark's
  plain reference (``benchmark/reference/rados_ec.py``) on seeded
  payloads, and every acting set holds one OSD a host;
- ECBackend's encode stage: with a serving engine attached (run without
  its threads), a burst of writes over the PGs goes to the card in
  fewer engine batches than writes, two writes to one object leave the
  second's bytes, writes to one PG commit in submit order, and a shard
  lost while writes wait on their encode is routed around;
- with no engine the write path and its results are as before;
- a pool without ``allow_ec_overwrites`` (Ceph's default for an EC pool)
  takes whole-object writes and aligned appends only, and a
  ``write_full`` over an object restarts its hash chain;
- the spans and counters of the stages, and the cluster log's line for
  a failure domain that falls back from host to osd.
"""
from __future__ import annotations

import numpy as np
import pytest

from benchmark.reference import rados_ec
from ceph_tpu_torch.backend.ecutil import HINFO_KEY
from ceph_tpu_torch.backend.memstore import GObject
from ceph_tpu_torch.backend.pg_backend import shard_store
from ceph_tpu_torch.client.rados import Rados
from ceph_tpu_torch.cluster import MiniCluster
from ceph_tpu_torch.common import Context
from ceph_tpu_torch.common.tracer import default_tracer
from ceph_tpu_torch.osd.osd_ops import ObjectOperation

K, M, UNIT = 8, 4, 4096
OBJ = 256 << 10
PROFILE = {"plugin": "torch_rs", "technique": "reed_sol_van", "k": str(K),
           "m": str(M), "crush-failure-domain": "host", "device": "cpu"}
EOPNOTSUPP = -95


def payloads(n: int, seed: int = 7) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, OBJ, dtype=np.uint8).tobytes()
            for _ in range(n)]


def make(engine: bool = True, overwrites: bool = False, **serving):
    c = MiniCluster(n_osds=12, osds_per_host=1, chunk_size=UNIT,
                    cct=Context())
    pid = c.create_ec_pool("bench", dict(PROFILE), pg_num=4,
                           allow_ec_overwrites=overwrites)
    if engine:
        c.enable_serving(**serving)
    return c, pid, Rados(c).open_ioctx("bench")


def burst(c, io, writes: list[tuple[str, bytes]]) -> list:
    """Issue every write as an aio write_full, then deliver; returns the
    writes' indices in the order they completed."""
    order: list[int] = []
    comps = []
    for i, (oid, data) in enumerate(writes):
        comp = io.aio_operate(oid, ObjectOperation().write_full(data))
        comp.set_complete_callback(lambda _c, i=i: order.append(i))
        comps.append(comp)
    c.deliver_all()
    assert all(comp.is_complete and comp.result == 0 for comp in comps)
    return order


def shards(c, pid, oid):
    """[(chunk, bytes, hinfo)] from the OSDs of the object's acting set."""
    g = c.pg_group(pid, oid)
    out = []
    for chunk, osd in enumerate(g.acting):
        store = shard_store(g.bus, osd)
        obj = GObject(oid, osd)
        out.append((chunk, np.frombuffer(store.read(obj, 0, None),
                                         dtype=np.uint8),
                    store.getattr(obj, HINFO_KEY)))
    return out


def names(n: int) -> list[str]:
    return [f"benchmark_data_cpu_4242_object{i}" for i in range(n)]


def test_every_chunk_crc_and_read_back_equals_the_reference():
    c, pid, io = make()
    data = payloads(20)
    oids = names(16)
    burst(c, io, list(zip(oids, data[:16])))
    last = {oid: data[(i + 4) % 20] for i, oid in enumerate(oids)}
    burst(c, io, list(last.items()))              # whole-object rewrites
    for oid, want in last.items():
        assert io.read(oid, OBJ) == want
        ref = rados_ec.chunks(np.frombuffer(want, np.uint8), K, M, UNIT)
        crcs = rados_ec.crc32c(rados_ec.HINFO_SEED, np.stack(ref))
        got = shards(c, pid, oid)
        assert len(got) == K + M
        for chunk, mine, hinfo in got:
            assert np.array_equal(mine, ref[chunk])
            assert hinfo["total_chunk_size"] == OBJ // K
            assert hinfo["cumulative_shard_hashes"][chunk] == crcs[chunk]
        assert rados_ec.distinct_hosts(c.pg_group(pid, oid).acting,
                                       lambda osd: osd)
    c.shutdown()


def test_a_burst_over_the_pgs_is_fewer_batches_than_writes():
    c, pid, io = make()
    oids = names(16)
    assert len({c.object_pg(pid, oid) for oid in oids}) > 1
    eng = c.serving
    b0, n0 = eng.perf.get("batches"), eng.perf.get("ops_coalesced")
    burst(c, io, list(zip(oids, payloads(16))))
    batches = eng.perf.get("batches") - b0
    assert eng.perf.get("ops_coalesced") - n0 == 16
    assert 1 <= batches < 16
    c.shutdown()


def test_two_writes_to_one_object_in_a_burst_leave_the_second():
    c, pid, io = make()
    first, second = payloads(2, seed=11)
    order = burst(c, io, [("obj", first), ("obj", second)])
    assert order == [0, 1]
    assert io.read("obj", OBJ) == second
    ref = rados_ec.chunks(np.frombuffer(second, np.uint8), K, M, UNIT)
    for chunk, mine, _hinfo in shards(c, pid, "obj"):
        assert np.array_equal(mine, ref[chunk])
    c.shutdown()


def test_writes_to_one_pg_commit_in_submit_order():
    c, pid, io = make()
    by_pg: dict[int, list[str]] = {}
    for oid in names(64):
        by_pg.setdefault(c.object_pg(pid, oid), []).append(oid)
    oids = max(by_pg.values(), key=len)[:5]
    assert len(oids) == 5
    data = payloads(5, seed=12)
    be = c.pg_group(pid, oids[0]).backend
    head0 = be.pg_log.head
    order = burst(c, io, list(zip(oids, data)))
    assert order == [0, 1, 2, 3, 4]
    # each write logged in submit order on the PG
    logged = [e.oid for e in be.pg_log.entries if e.version > head0]
    assert logged == oids
    c.shutdown()


def test_a_shard_lost_while_writes_wait_on_their_encode():
    c, pid, io = make()
    oids = names(8)
    data = payloads(8, seed=13)
    comps = [io.aio_operate(oid, ObjectOperation().write_full(d))
             for oid, d in zip(oids, data)]
    c._drain_live_daemons()             # every write parked on its encode
    parked = sum(len(g.backend.waiting_encode)
                 for g in c.pools[pid]["pgs"].values())
    assert parked == len(oids)
    g = c.pg_group(pid, oids[0])
    victim = g.acting[5]
    c.bus.mark_down(victim)
    c.deliver_all()
    assert all(comp.is_complete and comp.result == 0 for comp in comps)
    for oid, d in zip(oids, data):
        assert io.read(oid, OBJ) == d
    c.shutdown()


def test_without_an_engine_the_write_path_is_as_before():
    data = payloads(12, seed=14)
    oids = names(12)
    seen = {}
    for engine in (False, True):
        c, pid, io = make(engine=engine)
        burst(c, io, list(zip(oids, data)))
        backends = [g.backend for g in c.pools[pid]["pgs"].values()]
        staged = sum(be.perf.get("encodes_staged") for be in backends)
        encodes = sum(be.perf.dump()["encode_time"]["avgcount"]
                      for be in backends)
        assert (staged, encodes) == ((12, 0) if engine else (0, 12))
        assert not any(be.waiting_encode for be in backends)
        seen[engine] = {oid: [(ch, mine.tobytes(), hinfo)
                              for ch, mine, hinfo in shards(c, pid, oid)]
                        for oid in oids}
        c.shutdown()
    assert seen[False] == seen[True]


def test_an_engine_without_threads_is_flushed_before_its_throttle_fills():
    c, pid, io = make(max_bytes=2 * OBJ)
    b0 = c.serving.perf.get("batches")
    data = payloads(6, seed=15)
    burst(c, io, list(zip(names(6), data)))
    assert c.serving.perf.get("batches") - b0 >= 3
    assert [io.read(oid, OBJ) for oid in names(6)] == data
    c.shutdown()


def test_without_ec_overwrites_only_whole_writes_and_aligned_appends():
    c, pid, io = make()
    stripe = K * UNIT
    io.write_full("o", bytes(stripe))
    for op in (ObjectOperation().write(UNIT, b"x" * UNIT),
               ObjectOperation().zero(0, UNIT),
               ObjectOperation().truncate(UNIT),
               ObjectOperation().write(2 * stripe, bytes(stripe))):
        with pytest.raises(IOError) as err:
            io.operate("o", op)
        assert err.value.errno == EOPNOTSUPP
    io.operate("o", ObjectOperation().append(b"\x01" * stripe))
    io.operate("o", ObjectOperation().write(2 * stripe, b"\x02" * stripe))
    want = bytes(stripe) + b"\x01" * stripe + b"\x02" * stripe
    assert io.read("o", 3 * stripe) == want
    ref = rados_ec.chunks(np.frombuffer(want, np.uint8), K, M, UNIT)
    crcs = rados_ec.crc32c(rados_ec.HINFO_SEED, np.stack(ref))
    for chunk, _mine, hinfo in shards(c, pid, "o"):
        assert hinfo["cumulative_shard_hashes"][chunk] == crcs[chunk]
    c.shutdown()


def test_with_ec_overwrites_a_rewrite_clears_the_hashes():
    """The port's pools by default take overwrites, whose chunk hashes
    an overwrite clears; the flag changes nothing there."""
    c, pid, io = make(overwrites=True)
    first, second = payloads(2, seed=16)
    io.write_full("o", first)
    assert all(h["cumulative_shard_hashes"] for _c, _m, h in
               shards(c, pid, "o"))
    io.write_full("o", second)
    assert not any(h["cumulative_shard_hashes"] for _c, _m, h in
                   shards(c, pid, "o"))
    io.write("o", b"\x03" * UNIT, offset=UNIT)
    assert io.read("o", OBJ)[UNIT:2 * UNIT] == b"\x03" * UNIT
    c.pool_set(pid, "allow_ec_overwrites", "false")
    with pytest.raises(IOError):
        io.write("o", b"\x04" * UNIT, offset=UNIT)
    c.shutdown()


def test_the_stages_record_their_spans_and_counters():
    c, pid, io = make()
    tracer = default_tracer()
    tracer.reset()
    burst(c, io, list(zip(names(8), payloads(8, seed=17))))
    spans = [e["name"] for e in tracer.dump(stitched=False)["traceEvents"]
             if e.get("ph") == "X"]
    for name, each in (("osd.op", 1), ("osd.queue_wait", 1),
                       ("ec.encode_wait", 1), ("ec.sub_write", K + M)):
        assert spans.count(name) == 8 * each, name
    assert "ec.encode" not in spans
    backends = [g.backend for g in c.pools[pid]["pgs"].values()]
    dump = [be.perf.dump() for be in backends]
    assert sum(d["encode_wait_time"]["avgcount"] for d in dump) == 8
    assert sum(d["sub_write_time"]["avgcount"] for d in dump) == 8 * (K + M)
    assert sum(d["encodes_staged"] for d in dump) == 8
    assert all(d["encode_parked"] == 0 for d in dump)
    c.shutdown()


def test_a_failure_domain_that_falls_back_is_logged():
    """A profile that names no failure domain keeps the port's fallback
    from host to osd on a cluster of too few hosts, and says so in the
    cluster log."""
    unnamed = {k: v for k, v in PROFILE.items()
               if k != "crush-failure-domain"}
    c = MiniCluster(n_osds=12, osds_per_host=3, chunk_size=UNIT,
                    cct=Context())
    c.create_ec_pool("small", dict(unnamed), pg_num=2)
    warn = [e for e in c.clusterlog.last(10) if e["severity"] == "WRN"]
    assert len(warn) == 1 and "falls back to osd" in warn[0]["message"]
    big = MiniCluster(n_osds=12, osds_per_host=1, chunk_size=UNIT,
                      cct=Context())
    big.create_ec_pool("wide", dict(unnamed), pg_num=2)
    assert not [e for e in big.clusterlog.last(10)
                if e["severity"] == "WRN"]
    c.shutdown()
    big.shutdown()


def test_a_named_failure_domain_gets_cephs_indep_rule():
    """crush-failure-domain=host: the rule CrushWrapper::add_simple_rule
    makes for an indep pool (chooseleaf tries 5, choose tries 100), one
    chunk a host on every PG of 12 hosts x 4 OSDs, and no fallback where
    the hosts are too few."""
    from ceph_tpu_torch.crush import (CRUSH_RULE_CHOOSELEAF_INDEP,
                                      CRUSH_RULE_EMIT, CRUSH_RULE_TAKE)
    from ceph_tpu_torch.crush.map import (CRUSH_RULE_SET_CHOOSE_TRIES,
                                          CRUSH_RULE_SET_CHOOSELEAF_TRIES)
    c = MiniCluster(n_osds=48, osds_per_host=4, chunk_size=UNIT,
                    cct=Context())
    pid = c.create_ec_pool("wide", dict(PROFILE), pg_num=32)
    pool = c.pools[pid]["pool"]
    steps = [s[0] for s in c.osdmap.crush.rules[pool.crush_rule].steps]
    assert steps == [CRUSH_RULE_SET_CHOOSELEAF_TRIES,
                     CRUSH_RULE_SET_CHOOSE_TRIES, CRUSH_RULE_TAKE,
                     CRUSH_RULE_CHOOSELEAF_INDEP, CRUSH_RULE_EMIT]
    for g in c.pools[pid]["pgs"].values():
        assert rados_ec.distinct_hosts(g.acting, lambda osd: osd // 4)
    c.shutdown()
    small = MiniCluster(n_osds=12, osds_per_host=3, chunk_size=UNIT,
                        cct=Context())
    with pytest.raises(RuntimeError, match="not fully mapped"):
        small.create_ec_pool("small", dict(PROFILE), pg_num=8)
