"""Replacing a failed OSD under its own id (``MiniCluster.replace_osd``,
the port's ``ceph osd destroy`` + ``ceph-volume lvm create --osd-id``).

A cluster of 12 hosts of one OSD, an EC 8+4 pool of ``pg_num`` 4 (every
PG holds a chunk on every OSD), a recovery scheduler and a monitor.  The
recreated OSD boots empty; with a scheduler its PGs go active in the map
callback and backfill later, under reservations and in waves, and its
empty shards serve no read and take no write before then.  The chunks
and HashInfo hashes it ends up with are held against the benchmark's
plain reference (``benchmark/reference/rados_ec.py``).
"""
from __future__ import annotations

import numpy as np
import pytest

from benchmark.reference import rados_ec
from ceph_tpu_torch.backend.ecutil import HINFO_KEY
from ceph_tpu_torch.backend.memstore import GObject
from ceph_tpu_torch.backend.messages import ECSubRead, ECSubWrite
from ceph_tpu_torch.backend.pg_backend import shard_store
from ceph_tpu_torch.client.rados import Rados
from ceph_tpu_torch.cluster import MiniCluster
from ceph_tpu_torch.common import Context
from ceph_tpu_torch.common.tracer import default_tracer
from ceph_tpu_torch.osd.osd_ops import ObjectOperation
from ceph_tpu_torch.osd.peering import PState

K, M, UNIT = 8, 4, 4096
OBJECT = K * UNIT              # one stripe: chunks of 4 KiB
PROFILE = {"plugin": "torch_rs", "technique": "reed_sol_van", "k": str(K),
           "m": str(M), "w": "8", "crush-failure-domain": "host",
           "device": "cpu"}


def payload(i: int) -> bytes:
    return np.random.default_rng(100 + i).integers(
        0, 256, OBJECT, dtype=np.uint8).tobytes()


def make(scheduler: bool = True, n: int = 6):
    """The cluster, its pool, and ``n`` objects written through the bulk
    write; with ``scheduler`` a recovery scheduler at osd_max_backfills 1
    and waves of 2 objects."""
    cct = Context()
    cct.conf.set("osd_recovery_max_active", 2)
    c = MiniCluster(n_osds=12, osds_per_host=1, chunk_size=UNIT, cct=cct)
    pid = c.create_ec_pool("ec", PROFILE, pg_num=4,
                           allow_ec_overwrites=False)
    if scheduler:
        c.enable_recovery_scheduler()
    c.attach_monitor()
    data = {f"obj{i}": payload(i) for i in range(n)}
    c.put_many(pid, data)
    return c, pid, data


def pgs(c, pid):
    return list(c.pools[pid]["pgs"].values())


def recovered(c, pid) -> int:
    return sum(g.backend.perf.get("objects_recovered") for g in pgs(c, pid))


def assert_matches_reference(c, pid, data) -> None:
    """Every object reads back, and its 12 chunks and HashInfo hashes on
    its acting set equal the plain reference's."""
    oids = sorted(data)
    chunks = {oid: rados_ec.chunks(np.frombuffer(data[oid], dtype=np.uint8),
                                   K, M, UNIT) for oid in oids}
    # every object's chunk hashes in one call of the reference
    crc = rados_ec.crc32c(rados_ec.HINFO_SEED,
                          np.stack([ch for oid in oids for ch in chunks[oid]]))
    for i, oid in enumerate(oids):
        d, want = data[oid], chunks[oid]
        crcs = crc[i * (K + M):(i + 1) * (K + M)]
        assert c.get(pid, oid, len(d)) == d, oid
        g = c.pg_group(pid, oid)
        for chunk, osd in enumerate(g.acting):
            store = shard_store(g.bus, osd)
            got = store.read(GObject(oid, osd), 0, None)
            assert got == want[chunk].tobytes(), (oid, chunk)
            hashes = store.getattr(GObject(oid, osd), HINFO_KEY)[
                "cumulative_shard_hashes"]
            assert hashes[chunk] == int(crcs[chunk]), (oid, chunk)


def spy(c, pid, osd) -> dict:
    """The messages ``osd``'s handler receives, by PG."""
    seen = {}
    for g in pgs(c, pid):
        handler = g.bus.handlers[osd]
        real = handler.handle_message
        seen[g.pgid] = []

        def handle(msg, _real=real, _seen=seen[g.pgid]):
            _seen.append(msg)
            return _real(msg)
        handler.handle_message = handle
    return seen


def assert_clean(c, pid) -> None:
    assert c.recovery is None or c.recovery.jobs == {}
    for g in pgs(c, pid):
        assert c.pg_state(g) == "active+clean" and not g.backend.stale


def test_replace_osd_rebuilds_the_victims_chunks_and_hashes():
    c, pid, data = make()
    c.replace_osd(3)
    c.deliver_all()
    assert_clean(c, pid)
    assert_matches_reference(c, pid, data)
    # each object recovered once, its logical size booked; one
    # replacement on the cluster's counters
    assert recovered(c, pid) == len(data)
    assert sum(g.backend.perf.get("bytes_recovered")
               for g in pgs(c, pid)) == len(data) * OBJECT
    assert c.perf.get("osd_replacements") == 1
    # the scheduler's waves account for every object
    assert c.recovery.perf.get("wave_objects") == len(data)
    c.shutdown()


def test_the_boot_returns_with_the_pgs_active_and_the_jobs_queued():
    c, pid, data = make()
    c.replace_osd(3)
    # the map callback is done: peered and active, the victim stale and
    # empty, its jobs queued, nothing rebuilt yet
    for g in pgs(c, pid):
        assert g.peering.state is PState.ACTIVE
        assert g.backend.stale == {3}
        assert c.pg_state(g) == "active+degraded"
        assert not any(o.oid in data for o in shard_store(g.bus, 3).objects)
    assert len(c.recovery.jobs) == len(pgs(c, pid))
    assert recovered(c, pid) == 0
    c.deliver_all()
    assert_clean(c, pid)
    assert recovered(c, pid) == len(data)
    c.shutdown()


def test_one_job_at_a_time_holds_the_victims_remote_reservation():
    c, pid, data = make()
    c.replace_osd(3)
    c.deliver_all()
    remote = c.recovery.remote_reserver(3)
    assert remote.stats.peak_in_flight == 1
    # one grant a PG whose primary is not the victim
    assert remote.stats.grants == sum(1 for g in pgs(c, pid)
                                      if g.backend.whoami != 3)
    c.shutdown()


def test_a_read_mid_backfill_is_right_and_takes_no_chunk_from_the_victim():
    c, pid, data = make()
    c.replace_osd(3)
    to_victim = spy(c, pid, 3)
    got, backfilling = {}, []

    def read_once_started():
        if backfilling or recovered(c, pid) < 1:
            return
        # the PGs whose backfill of the victim has not completed
        backfilling.extend(g for g in pgs(c, pid) if 3 in g.backend.stale)
        for oid, d in data.items():
            g = c.pg_group(pid, oid)
            if g in backfilling:
                g.backend.objects_read_and_reconstruct(
                    {oid: [(0, len(d))]},
                    lambda result, errors, _oid=oid: got.update(
                        {_oid: (result, errors)}))
    c.bus.pre_deliver_hooks.append(read_once_started)
    c.deliver_all()
    assert backfilling and got
    assert set(got) == {oid for oid in data
                        if c.pg_group(pid, oid) in backfilling}
    for oid, (result, errors) in got.items():
        assert not errors and result[oid][0][2] == data[oid], oid
    # neither the reads nor the backfill's own reads of its sources took
    # anything from the stale victim
    for g in backfilling:
        assert not [m for m in to_victim[g.pgid]
                    if isinstance(m, ECSubRead)]
    assert_clean(c, pid)
    c.shutdown()


def test_a_write_mid_backfill_lands_on_the_victim_after_the_cycle():
    c, pid, data = make()
    io = Rados(c).open_ioctx("ec")
    c.replace_osd(3)
    to_victim = spy(c, pid, 3)
    new = {"obj1": payload(50), "obj4": payload(51)}
    acks = []

    def write_once_started():
        if acks or recovered(c, pid) < 1:
            return
        # librados write_full, as rados bench writes: acked once it
        # commits on min_size current shards
        acks.extend(io.aio_operate(oid, ObjectOperation().write_full(d))
                    for oid, d in new.items())
    c.bus.pre_deliver_hooks.append(write_once_started)
    c.deliver_all()
    assert len(acks) == len(new)
    assert all(a.result >= 0 for a in acks)
    data.update(new)
    # the stale victim took no sub-write: the writes committed on the
    # current shards, and its chunks came by the backfill's pushes
    assert not [m for msgs in to_victim.values() for m in msgs
                if isinstance(m, ECSubWrite)]
    assert_clean(c, pid)
    assert_matches_reference(c, pid, data)
    c.shutdown()


def test_replacing_a_pgs_primary():
    c, pid, data = make()
    victim = pgs(c, pid)[0].backend.whoami
    c.replace_osd(victim)
    c.deliver_all()
    assert_clean(c, pid)
    assert_matches_reference(c, pid, data)
    c.shutdown()


def test_six_replacements_in_a_row_are_not_refused_as_flapping():
    c, pid, data = make(n=2)
    for _ in range(6):
        c.replace_osd(5)
        c.deliver_all()
        assert c.osdmap.is_up(5)
        assert_clean(c, pid)
    assert c.perf.get("osd_replacements") == 6
    assert "OSD_FLAPPING" not in c.health()["checks"]
    assert_matches_reference(c, pid, data)
    c.shutdown()


def test_without_a_scheduler_the_boot_repairs_inline():
    c, pid, data = make(scheduler=False)
    c.replace_osd(3)
    # rebuilt inside the map callback, object by object
    assert_clean(c, pid)
    assert recovered(c, pid) == len(data)
    assert sum(g.backend.perf.get("chain_objects") for g in pgs(c, pid)) \
        == 0
    assert_matches_reference(c, pid, data)
    c.shutdown()


def test_the_cycle_books_its_spans():
    tracer = default_tracer()
    tracer.reset()
    c, pid, data = make()
    c.replace_osd(3)
    c.deliver_all()
    tracer.flush()
    names = [ev["name"] for ev in tracer.dump(stitched=False)["traceEvents"]]
    assert names.count("recovery.object") == len(data)
    assert names.count("recovery.push") == len(data)
    assert names.count("recovery.reserve_wait") == len(pgs(c, pid))
    c.shutdown()


def test_replace_osd_needs_a_monitor():
    c = MiniCluster(n_osds=12, osds_per_host=1, chunk_size=UNIT,
                    cct=Context())
    with pytest.raises(RuntimeError, match="monitor"):
        c.replace_osd(3)
    c.shutdown()
