"""The port's async messenger (``ceph_tpu_torch.msg``) on the CPU, after
the reference's ``tests/test_async_msgr.py`` and the transport half of
``tests/test_zero_copy.py``: reactor timers and cross-thread calls, the
zero-copy stream parser under any chunking (held against the JAX
package's ``FrameParser``, bitwise), staging-buffer survival, write-queue
backpressure, the shed ladder, the sharded front end, batches over the
mux client and copies per payload byte from the copy ledger.

The bounded-thread contract is pinned here too: a served cluster plus
hundreds of logical sessions costs a FIXED set of threads (reactor +
dispatch pool + one sender), never one per connection or per client.
Every wait is bounded and every reactor, server and client stops in a
``finally`` or a fixture's teardown.
"""
import os
import random
import socket
import threading
import time

import numpy as np
import pytest

import ceph_tpu.net as jnet
import ceph_tpu_torch.net as net
from ceph_tpu.backend.wire import FrameParser
from ceph_tpu_torch.backend import wire
from ceph_tpu_torch.backend.wire import (BANNER, TAG_MESSAGE, WireError,
                                         frame_encode)
from ceph_tpu_torch.common import copy_ledger
from ceph_tpu_torch.msg import (AsyncConnection, MuxClient, Reactor,
                                ShardedFrontend, ShedPolicy, StreamParser)
from ceph_tpu_torch.msg import proto  # noqa: F401 — registers batch codecs
from ceph_tpu_torch.msg.staging import StagingPool
from ceph_tpu_torch.msg.frontend import FrontendBusy
from ceph_tpu_torch.msg.shed import DEFAULT_SHED_FRACTIONS, EBUSY
from ceph_tpu_torch.osd.mclock import BG_SCRUB, CLIENT_OP


def _data(n, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


# -- reactor -----------------------------------------------------------------

class TestReactor:
    def test_call_soon_crosses_threads(self):
        r = Reactor(name="t-soon").start()
        try:
            hits = []
            ev = threading.Event()
            r.call_soon(lambda: (hits.append(threading.current_thread()),
                                 ev.set()))
            assert ev.wait(5.0)
            # the callback ran ON the loop thread, not the caller's
            assert hits[0].name == "reactor.t-soon"
        finally:
            r.stop()

    def test_call_later_ordering_and_cancel(self):
        r = Reactor(name="t-timer").start()
        try:
            order = []
            done = threading.Event()
            r.call_later(0.05, lambda: order.append("b"))
            r.call_later(0.01, lambda: order.append("a"))
            t = r.call_later(0.02, lambda: order.append("cancelled"))
            t.cancel()
            r.call_later(0.08, lambda: (order.append("c"), done.set()))
            assert done.wait(5.0)
            assert order == ["a", "b", "c"]
        finally:
            r.stop()

    def test_stop_joins_loop_thread(self):
        r = Reactor(name="t-stop").start()
        assert r.running
        r.stop()
        assert not r.running
        assert not any(t.name == "reactor.t-stop"
                       for t in threading.enumerate())


# -- zero-copy stream parser -------------------------------------------------

def _rand_chunks(blob: bytes, rng: random.Random):
    i = 0
    while i < len(blob):
        n = rng.randint(1, 97)
        yield blob[i:i + n]
        i += n


class TestStreamParser:
    SECRETS = (None, b"k" * 32)

    def _frames(self, secret, n=12, seed=3):
        rng = random.Random(seed)
        out = []
        for i in range(n):
            segs = [bytes([65 + i]) * rng.randint(0, 5000)
                    for _ in range(rng.randint(1, 4))]
            out.append((TAG_MESSAGE,
                        [bytes(s) for s in segs],
                        frame_encode(TAG_MESSAGE, segs, secret=secret)))
        return out

    @pytest.mark.parametrize("secret", SECRETS,
                             ids=["crc", "secure"])
    def test_equivalent_to_frameparser_any_chunking(self, secret):
        """The reference FrameParser's frames out of the same bytes,
        regardless of where recv boundaries fall — including 1-byte feeds
        mid-preamble/mid-MAC — and the same real on-wire sizes its
        track_sizes reports."""
        frames = self._frames(secret)
        blob = b"".join(f[2] for f in frames)
        ref = FrameParser(secret)
        ref.track_sizes = True
        ref_out = ref.feed(blob)
        for seed in (1, 2, 7):
            sp = StreamParser(secret)
            got = []
            for chunk in _rand_chunks(blob, random.Random(seed)):
                for tag, segs in sp.feed(chunk):
                    got.append((tag, [bytes(s) for s in segs]))
            assert got == [(t, list(s)) for t, s in ref_out]
            assert sp.frame_sizes == ref.frame_sizes
            assert sp.pending() == 0

    def test_banner_is_stream_state(self):
        f = frame_encode(TAG_MESSAGE, [b"hello"])
        sp = StreamParser(expect_banner=True)
        blob = BANNER + f
        assert sp.feed(blob[:5]) == []
        out = sp.feed(blob[5:])
        assert [bytes(s) for _, s in out for s in s] == [b"hello"]
        with pytest.raises(WireError, match="banner"):
            StreamParser(expect_banner=True).feed(b"X" * len(BANNER))

    def test_corruption_raises_wire_error(self):
        good = frame_encode(TAG_MESSAGE, [b"payload" * 100])
        flipped = bytearray(good)
        flipped[len(good) // 2] ^= 0xFF
        with pytest.raises(WireError):
            StreamParser(None).feed(bytes(flipped))
        sec = frame_encode(TAG_MESSAGE, [b"payload"], secret=b"s" * 32)
        bad_mac = bytearray(sec)
        bad_mac[-1] ^= 0xFF
        with pytest.raises(WireError, match="MAC"):
            StreamParser(b"s" * 32).feed(bytes(bad_mac))

    def test_mid_stream_secret_switch(self):
        """The post-auth handoff: crc frames, then set_secret, then
        HMAC frames — one parser, one buffer."""
        key = b"q" * 32
        sp = StreamParser(None)
        a = sp.feed(frame_encode(TAG_MESSAGE, [b"clear"]))
        sp.set_secret(key)
        b = sp.feed(frame_encode(TAG_MESSAGE, [b"sealed"], secret=key))
        assert bytes(a[0][1][0]) == b"clear"
        assert bytes(b[0][1][0]) == b"sealed"

    def test_compaction_survives_long_streams(self):
        """Many frames through one parser: the consumed head compacts
        (no unbounded buffer growth) and every frame still parses."""
        sp = StreamParser(None)
        seen = 0
        payload = b"z" * 40_000
        for _ in range(16):
            for _, segs in sp.feed(
                    frame_encode(TAG_MESSAGE, [payload])):
                assert bytes(segs[0]) == payload
                seen += 1
        assert seen == 16
        assert len(sp._buf) < 3 * (len(payload) + 64)


# -- write-queue backpressure ------------------------------------------------

class TestBackpressure:
    def test_send_bounded_by_throttle_then_connection_error(self):
        """A peer that never drains exhausts the byte budget: send()
        blocks for its timeout, then fails AND closes the link — never
        an unbounded outbound buffer.  (register=False keeps the
        reactor from flushing, so the queue genuinely stalls.)"""
        import ceph_tpu_torch.net as net
        a, b = socket.socketpair()
        r = Reactor(name="t-bp").start()
        try:
            conn = AsyncConnection(a, r, name="bp", secret=b"k" * 32,
                                   write_queue_bytes=8192,
                                   register=False)
            conn.send(net.RpcCall(1, "noop", {"blob": b"x" * 3000}),
                      timeout=0.5)
            conn.send(net.RpcCall(2, "noop", {"blob": b"x" * 3000}),
                      timeout=0.5)
            with pytest.raises(ConnectionError, match="write queue full"):
                conn.send(net.RpcCall(3, "noop", {"blob": b"x" * 3000}),
                          timeout=0.3)
            assert conn.closed
        finally:
            r.stop()
            a.close(), b.close()

    def test_budget_released_as_peer_drains(self):
        import ceph_tpu_torch.net as net
        a, b = socket.socketpair()
        r = Reactor(name="t-drain").start()
        try:
            conn = AsyncConnection(a, r, name="drain", secret=b"k" * 32,
                                   write_queue_bytes=64 * 1024)
            for i in range(20):
                conn.send(net.RpcCall(i, "noop", {"blob": b"y" * 2048}),
                          timeout=2.0)
            b.setblocking(False)
            deadline = time.monotonic() + 10.0
            received = 0
            while time.monotonic() < deadline and (
                    conn.wthrottle.count > 0 or received < 20 * 2048):
                try:
                    received += len(b.recv(65536))
                except BlockingIOError:
                    time.sleep(0.01)
            assert conn.wthrottle.count == 0, "budget not fully released"
            assert received >= 20 * 2048
        finally:
            r.stop()
            a.close(), b.close()


# -- shed ladder -------------------------------------------------------------

class TestShedPolicy:
    def test_background_sheds_before_client(self):
        p = ShedPolicy(100)
        # at depth 60: scrub (threshold 50) sheds, client (100) admits
        assert p.should_shed(BG_SCRUB, 60)
        assert not p.should_shed(CLIENT_OP, 60)
        assert p.should_shed(CLIENT_OP, 100)
        snap = p.snapshot()
        assert snap["shed"][BG_SCRUB] == 1
        assert snap["shed"][CLIENT_OP] == 1 and snap["admitted"] == 1

    def test_depth_counts_logical_ops(self):
        """A mux batch sheds/admits as a unit but is COUNTED per op —
        shed_rate means the same thing batched and unbatched."""
        p = ShedPolicy(10)
        assert not p.should_shed(CLIENT_OP, 0, n=7)
        assert p.should_shed(CLIENT_OP, 10, n=3)
        assert p.snapshot()["admitted"] == 7
        assert p.shed_total == 3
        assert p.shed_rate() == pytest.approx(0.3)

    def test_ladder_ordering_matches_qos(self):
        p = ShedPolicy(1000)
        ths = {c: p.threshold(c) for c in DEFAULT_SHED_FRACTIONS}
        ordered = sorted(ths, key=ths.get)
        assert ordered[0] == BG_SCRUB and ordered[-1] == CLIENT_OP


# -- sharded front end -------------------------------------------------------

class _StubEngine:
    """depths()/submit shapes of ServingEngine, queue depth scripted."""

    def __init__(self, depth=0):
        self._depth = depth
        self.encodes = []

    def depths(self):
        return {"_total": self._depth}

    def submit_encode(self, buf, op_class, **kw):
        self.encodes.append((bytes(buf), op_class))
        return f"fut-{len(self.encodes)}"

    def submit_decode(self, chunks, op_class, **kw):
        return "dfut"

    def pressure(self):
        return self._depth / 100.0

    def start(self):
        return self

    def stop(self):
        pass

    def flush(self, timeout=None):
        pass


class TestShardedFrontend:
    def test_routing_is_stable_and_respects_locate(self):
        fe = ShardedFrontend({0: _StubEngine(), 1: _StubEngine(),
                              2: _StubEngine()})
        assert fe.shard_for("obj-a") == fe.shard_for("obj-a")
        assert {fe.shard_for(f"o{i}") for i in range(64)} == {0, 1, 2}
        placed = ShardedFrontend({0: _StubEngine(), 1: _StubEngine()},
                                 locate=lambda name: 1)
        assert placed.shard_for("anything") == 1

    def test_striped_encode_fans_pieces_across_shards(self):
        shards = {i: _StubEngine() for i in range(4)}
        fe = ShardedFrontend(shards)
        data = _data(300_000, 5)
        out = fe.submit_striped_encode("soid", data, stripe_unit=65536,
                                       stripe_count=4)
        assert len(out) >= 2                  # the object really striped
        assert len({sid for _, sid, _ in out}) >= 2
        total = sum(len(buf) for eng in shards.values()
                    for buf, _ in eng.encodes)
        assert total == len(data)             # every byte routed, once

    def test_striped_pieces_carry_the_right_bytes(self):
        """One shard so submit order == route order: each piece buffer's
        extents hold exactly the logical bytes the striper maps there."""
        eng = _StubEngine()
        fe = ShardedFrontend({0: eng})
        data = _data(300_000, 6)
        out = fe.submit_striped_encode("soid", data, stripe_unit=65536,
                                       stripe_count=4)
        routes = fe.stripe_routes("soid", len(data), stripe_unit=65536,
                                  stripe_count=4)
        assert [p for p, _, _ in routes] == [p for p, _, _ in out]
        for (pname, _sid, extents), (buf, _cls) in zip(routes,
                                                       eng.encodes):
            for p_off, l_off, n in extents:
                assert buf[p_off:p_off + n] == data[l_off:l_off + n], \
                    pname

    def test_shed_ladder_refuses_background_first(self):
        eng = _StubEngine(depth=60)
        fe = ShardedFrontend({0: eng}, queue_limit=100)
        with pytest.raises(FrontendBusy) as ei:
            fe.submit_encode("o", b"x", op_class=BG_SCRUB)
        assert ei.value.errno == EBUSY and ei.value.op_class == BG_SCRUB
        sid, fut = fe.submit_encode("o", b"x", op_class=CLIENT_OP)
        assert fut == "fut-1"
        eng._depth = 100
        with pytest.raises(FrontendBusy):
            fe.submit_encode("o", b"x", op_class=CLIENT_OP)
        stats = fe.stats()
        assert stats["routed"][0] == 1
        assert stats["shed"][0]["shed_total"] == 2

    def test_pressures_surface_engine_occupancy(self):
        fe = ShardedFrontend({0: _StubEngine(depth=50),
                              1: _StubEngine(depth=0)})
        p = fe.pressures()
        assert p[0] == pytest.approx(0.5) and p[1] == 0.0


# -- the full async stack ----------------------------------------------------

@pytest.fixture
def served(tmp_path):
    from ceph_tpu_torch.cluster import MiniCluster
    from ceph_tpu_torch.net import ClusterServer
    c = MiniCluster(n_osds=3, osds_per_host=3, chunk_size=512,
                    data_dir=tmp_path)
    server = ClusterServer(c)
    server.start()
    yield server, tmp_path / "client.admin.keyring"
    server.stop()
    c.shutdown()


class TestMuxStack:
    def test_many_sessions_bounded_threads(self, served):
        """500 logical sessions over 2 sockets: every call lands, and
        the thread census stays FIXED — reactor threads + the dispatch
        pool + one mux sender, no per-connection or per-client spawns
        (satellite 1: the net.py thread leak is structurally gone)."""
        server, keyring = served
        before = threading.active_count()
        mux = MuxClient("127.0.0.1", server.port, keyring, n_conns=2)
        try:
            mux.connect()
            s0 = mux.session()
            s0.call("mkpool", {"name": "p", "replicated": True,
                               "size": 3})
            sessions = [mux.session() for _ in range(500)]
            calls = [s.call_async("put", {"pool": "p",
                                          "oid": f"o{i % 32}",
                                          "data": _data(256, i)})
                     for i, s in enumerate(sessions)]
            for c in calls:
                c.event.wait(30.0)
                assert c.done and c.value() == 256
            # thread count is independent of session count: allow only
            # the fixed transport threads over the baseline
            grown = threading.active_count() - before
            assert grown <= 6, \
                f"thread census grew by {grown} for 500 sessions"
            st = mux.stats()
            assert st["sessions"] == 501
            assert st["connections"] <= 2
            assert st["batches_sent"] < st["calls_sent"]  # mux coalesced
        finally:
            mux.close()

    def test_reqid_dedup_is_per_session(self, served):
        """(session, rid) is the dedup key: the same rid in two sessions
        executes twice; a resent (session, rid) executes once and both
        replies carry the first execution's result."""
        import ceph_tpu_torch.net as net
        from ceph_tpu_torch.msg.proto import RpcBatch
        from ceph_tpu_torch.msg.reactor import client_reactor
        server, keyring = served
        hits = []
        server._rpc_bump = lambda ch, tag: hits.append(tag) or len(hits)
        import pickle
        with open(keyring, "rb") as f:
            key = pickle.load(f)["key"]
        sock, skey = net.dial_and_handshake("127.0.0.1", server.port, key)
        got = []
        ev = threading.Event()

        def on_msg(conn, msg):
            got.extend(msg.results)
            if len(got) >= 3:
                ev.set()
        conn = AsyncConnection(sock, client_reactor(), secret=skey,
                               name="dedup", on_message=on_msg)
        try:
            conn.send(RpcBatch([
                net.RpcCall(7, "bump", {"tag": "a"}, session="S1"),
                net.RpcCall(7, "bump", {"tag": "b"}, session="S2"),
                net.RpcCall(7, "bump", {"tag": "a"}, session="S1"),
            ]))
            assert ev.wait(20.0)
            assert hits == ["a", "b"]         # dup never re-executed
            assert server.rpc_dedup_hits >= 1
            by_order = [r.value for r in got]
            assert by_order[0] == by_order[2]  # cached first result
            assert all(r.ok for r in got)
        finally:
            conn.close()

    def test_shed_by_class_under_tiny_queue(self, served):
        """Dispatch queue clamped to 1 with every worker HELD on a gated
        rpc: background traffic bounces with EBUSY while the server
        stays up and client ops still complete.  (Holding the workers
        makes the shed deterministic — on an idle host a fast drain can
        otherwise serve the whole flood without ever filling a queue of
        one.)"""
        server, keyring = served
        server._transport.shed = ShedPolicy(1)
        server._transport.dispatcher.shed = server._transport.shed
        gate = threading.Event()
        running = threading.Semaphore(0)

        def _rpc_block(ch):
            running.release()
            gate.wait(30.0)
            return "unblocked"

        server._rpc_block = _rpc_block
        mux = MuxClient("127.0.0.1", server.port, keyring, n_conns=1)
        try:
            s = mux.session()
            s.call("mkpool", {"name": "p", "replicated": True, "size": 3})
            # ONE parked blocker stalls the whole pool: rpc dispatch
            # serializes handlers on the cluster lock, so the other
            # workers pop an op each and wait on the lock, and the flood
            # piles into the depth-1 queue
            blocker = mux.session().call_async("block", {}, timeout=30.0)
            assert running.acquire(timeout=10.0)
            outcomes = {"ok": 0, "shed": 0}
            calls = [s.call_async("ping", {"payload": i},
                                  op_class=BG_SCRUB, timeout=10.0)
                     for i in range(200)]
            gate.set()
            for c in calls:
                c.event.wait(30.0)
                try:
                    c.value()
                    outcomes["ok"] += 1
                except IOError as e:
                    assert e.errno == EBUSY
                    outcomes["shed"] += 1
            blocker.event.wait(30.0)
            assert blocker.value() == "unblocked"
            assert outcomes["shed"] > 0, "tiny queue never shed"
            assert mux.stats()["sheds_seen"] == outcomes["shed"]
            snap = server._transport.shed.snapshot()
            assert snap["shed"].get(BG_SCRUB, 0) == outcomes["shed"]
            # the link survived shedding: a client op still round-trips
            assert s.call("ping", {"payload": "after"}) == "after"
        finally:
            mux.close()

    def test_wire_accounting_partition_invariant(self, served):
        """On the async transport every tx/rx byte lands in
        exactly one dmClock class — sum(class_bytes) == tx+rx totals —
        including the new RpcBatch/RpcResultBatch frames."""
        server, keyring = served
        mux = MuxClient("127.0.0.1", server.port, keyring, n_conns=2)
        try:
            s = mux.session()
            s.call("mkpool", {"name": "p", "replicated": True, "size": 3})
            calls = [s.call_async("put", {"pool": "p", "oid": f"w{i}",
                                          "data": _data(2048, i)})
                     for i in range(32)]
            for c in calls:
                c.event.wait(30.0)
                assert c.done and c.value() == 2048
            totals = server.wire.totals()
            cls = server.wire.class_bytes()
            assert totals["tx_bytes"] > 0 and totals["rx_bytes"] > 0
            assert sum(cls.values()) == \
                totals["tx_bytes"] + totals["rx_bytes"]
            per = server.wire.per_type()
            assert per.get("RpcBatch", {}).get("rx_msgs", 0) > 0, \
                "mux batches never reached the server's accountant"
        finally:
            mux.close()

    def test_tcprados_interops_with_async_server(self, served):
        """The classic one-session client and the mux client share one
        server: same pools, same data, same watch/notify plumbing."""
        from ceph_tpu_torch.net import TcpRados
        server, keyring = served
        r = TcpRados("127.0.0.1", server.port, keyring)
        mux = MuxClient("127.0.0.1", server.port, keyring)
        try:
            r.mkpool("p", replicated=True, size=3)
            r.put("p", "shared", b"from-tcprados")
            s = mux.session()
            assert s.call("get", {"pool": "p", "oid": "shared"}) == \
                b"from-tcprados"
            s.call("put", {"pool": "p", "oid": "back",
                           "data": b"from-mux"})
            assert r.get("p", "back") == b"from-mux"
        finally:
            mux.close()
            r.close()


# -- the zero-copy transport ---------------------------------------------------

SECRET = bytes(range(32))


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def _flatten(parts: list) -> bytes:
    return b"".join(bytes(p) if isinstance(p, memoryview) else p
                    for p in parts)


def _parse_one(blob: bytes, secret, staging=None):
    p = StreamParser(secret)
    frames = p.feed(blob)
    assert len(frames) == 1 and p.pending() == 0
    tag, segs = frames[0]
    return net._decode(tag, segs, authed=True, staging=staging)


# -- the frame splice: frame_encode_parts == frame_encode --------------------

class TestFramePartsEquality:
    @pytest.mark.parametrize("secret", [None, SECRET],
                             ids=["crc", "secure"])
    def test_scattered_segment_bitwise_equal(self, secret):
        """A scattered third segment (length table + spliced payload
        views) wires byte-for-byte identically to the joined frame, in
        BOTH integrity modes — the device->wire splice never changes
        what the peer verifies."""
        pieces = [b"\x07" * 12, memoryview(bytes(range(256)) * 17),
                  b"xy", memoryview(b"z" * 4096),
                  memoryview(b"s" * 8)]          # small view: coalesces
        segs_joined = [b"RpcBatch", b"header", _flatten(pieces)]
        segs_parts = [b"RpcBatch", b"header", pieces]
        joined = wire.frame_encode(wire.TAG_MESSAGE, segs_joined,
                                   secret=secret)
        parts = wire.frame_encode_parts(wire.TAG_MESSAGE, segs_parts,
                                        secret=secret)
        assert _flatten(parts) == joined
        # the bulk views really splice unjoined (no hidden join copy)
        spliced = [p for p in parts if isinstance(p, memoryview)]
        assert len(spliced) == 2
        assert spliced[0].obj is pieces[1].obj
        assert spliced[1].obj is pieces[3].obj


# -- the sideband codec: _encode_parts == _encode ----------------------------

class TestSidebandCodec:
    @pytest.mark.parametrize("n", [1024, 4096, 65536, 1 << 20])
    def test_rpc_call_roundtrips_match_legacy(self, n):
        payload = os.urandom(n)
        msg = net.RpcCall(3, "put", {"pool": "p", "data": payload},
                          session="S1")
        parts = net._encode_parts(msg, SECRET)
        assert parts is not None
        legacy = net._encode(msg, SECRET)
        got_sb = _parse_one(_flatten(parts), SECRET)
        got_legacy = _parse_one(legacy, SECRET)
        assert bytes(got_sb.args["data"]) == payload \
            == bytes(got_legacy.args["data"])
        assert got_sb.args["pool"] == "p" and got_sb.rid == 3
        assert got_sb.session == "S1"
        # extraction never mutates the original (retries resend it)
        assert msg.args["data"] is payload

    def test_result_batch_staged_landing(self):
        from ceph_tpu_torch.msg.proto import RpcResultBatch
        payloads = [os.urandom(2048), os.urandom(5000), os.urandom(1024)]
        msg = RpcResultBatch([net.RpcResult(i, True, p)
                              for i, p in enumerate(payloads)])
        parts = net._encode_parts(msg, SECRET)
        assert parts is not None
        pool = StagingPool("test")
        base = copy_ledger.ledger().snapshot()["copied"]["staging"]
        got = _parse_one(_flatten(parts), SECRET, staging=pool)
        for r, p in zip(got.results, payloads):
            assert isinstance(r.value, memoryview)   # staged slice
            assert bytes(r.value) == p
        # all three landed with ONE staged copy of the whole sideband
        assert pool.stats["staged_buffers"] == 1
        led = copy_ledger.ledger().snapshot()["copied"]["staging"]
        assert led >= base + sum(len(p) for p in payloads)

    def test_small_payloads_stay_pickled_but_weigh_in_ledger(self):
        """Eligible-but-small values (>= PAYLOAD_MIN, < splice
        threshold) do not lift — the header rewrite would cost more
        than the copy — but their bytes still count as legacy copies,
        so the ratio cannot flatter the small-op path."""
        small = os.urandom(net._SB_SPLICE_MIN - 1)
        msg = net.RpcCall(1, "put", {"data": small}, session="S")
        assert net._encode_parts(msg, SECRET) is None
        base = copy_ledger.ledger().snapshot()["copied"]["pickle"]
        blob = net._encode(msg, SECRET)
        assert bytes(_parse_one(blob, SECRET).args["data"]) == small
        assert copy_ledger.ledger().snapshot()["copied"]["pickle"] \
            >= base + len(small)
        # sub-PAYLOAD_MIN values are invisible to the whole machinery
        tiny = net.RpcCall(2, "put", {"data": os.urandom(8)}, session="S")
        assert net._encode_parts(tiny, SECRET) is None

    def test_kill_switch_gates_encode_side_only(self):
        payload = os.urandom(4096)
        msg = net.RpcCall(9, "put", {"data": payload}, session="S")
        parts = net._encode_parts(msg, SECRET)
        assert parts is not None
        net.set_zero_copy(False)
        try:
            assert net._encode_parts(msg, SECRET) is None
        finally:
            net.set_zero_copy(True)
        # decode accepts sideband frames regardless of the switch:
        # mixed peers interoperate
        net.set_zero_copy(False)
        try:
            got = _parse_one(_flatten(parts), SECRET)
        finally:
            net.set_zero_copy(True)
        assert bytes(got.args["data"]) == payload


# -- the stream parser: chunking, reordering, lifetime -----------------------

class TestStreamParserZeroCopy:
    def _frames(self, seed: int, sizes) -> list[tuple[bytes, bytes]]:
        """(wire_blob, payload) per frame: a mix of sideband and legacy
        encodings of the same call shape."""
        rng = random.Random(seed)
        out = []
        for i, n in enumerate(sizes):
            payload = os.urandom(n)
            msg = net.RpcCall(i, "put", {"data": payload},
                              session=f"S{i}")
            if rng.random() < 0.5:
                parts = net._encode_parts(msg, SECRET)
                blob = _flatten(parts) if parts is not None \
                    else net._encode(msg, SECRET)
            else:
                blob = net._encode(msg, SECRET)
            out.append((blob, payload))
        return out

    @pytest.mark.parametrize("chunk", [1, 7, 4096])
    def test_partial_reads_any_chunking(self, chunk):
        """1-byte and odd-size partial reads across frame boundaries
        decode bitwise-identically to whole-frame feeds — including
        sideband frames whose payload segment spans many feeds."""
        frames = self._frames(chunk, [40, 1024, 9000, 64, 2048])
        stream = b"".join(b for b, _ in frames)
        p = StreamParser(SECRET)
        got = []
        for off in range(0, len(stream), chunk):
            for tag, segs in p.feed(stream[off:off + chunk]):
                got.append(net._decode(tag, segs, authed=True))
        assert [bytes(m.args["data"]) for m in got] \
            == [pl for _, pl in frames]
        assert p.pending() == 0

    def test_reordered_bursts_decode_in_arrival_order(self):
        """Frames delivered in a different burst order (the coalescer
        re-queues under backpressure) decode to exactly the payloads in
        arrival order — no cross-frame buffer state leaks."""
        frames = self._frames(99, [2048, 1024, 70000, 31, 4096])
        order = [2, 0, 4, 1, 3]
        rng = random.Random(7)
        p = StreamParser(SECRET)
        got = []
        for i in order:
            blob = frames[i][0]
            off = 0
            while off < len(blob):      # bursts misaligned with frames
                step = rng.randrange(1, 1 + len(blob) - off)
                for tag, segs in p.feed(blob[off:off + step]):
                    got.append(net._decode(tag, segs, authed=True))
                off += step
        assert [bytes(m.args["data"]) for m in got] \
            == [frames[i][1] for i in order]

    def test_staged_payloads_survive_parser_reuse(self):
        """A staged payload stays intact after the parser buffer that
        produced it is overwritten by later feeds — the staging copy is
        what makes handing views across threads safe."""
        pool = StagingPool("lifetime")
        payload = os.urandom(8192)
        msg = net.RpcCall(1, "put", {"data": payload}, session="S")
        blob = _flatten(net._encode_parts(msg, SECRET))
        p = StreamParser(SECRET)
        (tag, segs), = p.feed(blob)
        got = net._decode(tag, segs, authed=True, staging=pool)
        staged = got.args["data"]
        for i in range(2, 6):           # stomp the parser buffer
            m2 = net.RpcCall(i, "put", {"data": os.urandom(8192)},
                             session="S")
            p.feed(_flatten(net._encode_parts(m2, SECRET)))
        assert bytes(staged) == payload

    def test_retained_view_fallback_counted_and_safe(self):
        """A caller that (wrongly) retains a segment view across feeds
        pins the buffer: the next feed's BufferError fallback rebuilds
        it, COUNTS the copied bytes in the ledger, and the retained
        view still reads the original bytes."""
        p = StreamParser(SECRET)
        m1 = net.RpcCall(1, "put", {"data": os.urandom(2000)},
                         session="S")
        (tag, segs), = p.feed(net._encode(m1, SECRET))
        retained = segs[1]              # memoryview into p's buffer
        header_bytes = bytes(retained)
        base = copy_ledger.ledger().snapshot()["copied"]["fallback"]
        m2 = net.RpcCall(2, "put", {"data": os.urandom(3000)},
                         session="S")
        blob2 = net._encode(m2, SECRET)
        (tag2, segs2), = p.feed(blob2)
        got2 = net._decode(tag2, segs2, authed=True)
        assert bytes(got2.args["data"]) == m2.args["data"]
        assert copy_ledger.ledger().snapshot()["copied"]["fallback"] \
            >= base + len(blob2)
        assert bytes(retained) == header_bytes

    def test_compaction_tail_move_is_counted(self):
        """The amortized head-trim's tail move reports to the ledger:
        park a partial frame behind >64 KiB of consumed stream, then
        let the next feed compact — the moved tail bytes appear under
        ``compaction``."""
        p = StreamParser(SECRET)
        big = net._encode(net.RpcCall(1, "put",
                                      {"data": os.urandom(80000)},
                                      session="S"), SECRET)
        tail_msg = net.RpcCall(2, "put", {"data": os.urandom(4000)},
                               session="S")
        tail = net._encode(tail_msg, SECRET)
        half = len(tail) // 2
        frames = p.feed(big + tail[:half])
        assert len(frames) == 1 and p.pending() == half
        del frames                       # sever the views: buffer free
        base = copy_ledger.ledger().snapshot()["copied"]["compaction"]
        (tag, segs), = p.feed(tail[half:])
        assert bytes(net._decode(tag, segs, authed=True)
                     .args["data"]) == tail_msg.args["data"]
        assert copy_ledger.ledger().snapshot()["copied"]["compaction"] \
            >= base + half


# -- the whole stack: mux on/off equivalence + the ledger contrast -----------

class TestEndToEnd:
    def _pings(self, server, keyring, n, size, seed, zero_copy):
        from ceph_tpu_torch.msg import MuxClient
        # the cluster cct IS the process default context, so the mux
        # client's ms_zero_copy observer (adopted at construction) sees
        # the override — net.set_zero_copy alone would be re-adopted
        conf = server.cluster.cct.conf
        saved = conf.get("ms_zero_copy")
        conf.set("ms_zero_copy", zero_copy)
        mux = MuxClient("127.0.0.1", server.port, keyring, n_conns=1)
        rng = _rng(seed)
        try:
            mux.connect()
            s = mux.session()
            for i in range(n):
                payload = bytes(rng.integers(0, 256, size=size,
                                             dtype=np.uint8))
                echoed = s.call("ping", {"payload": payload},
                                timeout=30.0)
                assert bytes(echoed) == payload
        finally:
            mux.close()
            conf.set("ms_zero_copy", saved)

    def test_fused_and_legacy_arms_agree_and_contrast(self, served):
        """Both transport arms echo bulk payloads bitwise; the ledger
        separates them — the fused arm moves each served byte at most
        ~1.5 times, the legacy arm at least ~2.5 (pickle + join +
        unpickle per direction)."""
        server, keyring = served
        led = copy_ledger.ledger()
        led.reset()
        self._pings(server, keyring, 8, 65536, seed=1, zero_copy=True)
        fused = led.snapshot()
        led.reset()
        try:
            self._pings(server, keyring, 8, 65536, seed=2,
                        zero_copy=False)
        finally:
            net.set_zero_copy(True)
        legacy = led.snapshot()
        assert fused["served"] >= 8 * 2 * 65536
        assert legacy["served"] >= 8 * 2 * 65536
        assert fused["copies_per_byte"] <= 1.5, fused
        assert legacy["copies_per_byte"] >= 2.5, legacy
        # the fused arm's copies are the sanctioned landing copies, not
        # codec copies
        sanctioned = fused["copied"]["staging"] \
            + fused["copied"]["materialize"]
        assert sanctioned >= 0.9 * fused["copied_total"], fused


# -- against the reference's codec ------------------------------------------

@pytest.mark.parametrize("n", [1024, 65536])
def test_sideband_segments_bitwise_against_reference(n):
    """The sideband frame's type segment and raw payload segment (length
    table + payload bytes) are the reference's byte for byte; only the
    pickled control header names another module."""
    payload = os.urandom(n)
    args = {"pool": "p", "oid": "o", "data": payload}
    port = _flatten(net._encode_parts(
        net.RpcCall(3, "put", dict(args), session="S1"), SECRET))
    ref = _flatten(jnet._encode_parts(
        jnet.RpcCall(3, "put", dict(args), session="S1"), SECRET))
    (_, psegs), = StreamParser(SECRET).feed(port)
    (_, rsegs), = FrameParser(SECRET).feed(ref)
    assert len(psegs) == len(rsegs) == 3
    assert bytes(psegs[0]) == rsegs[0] and bytes(psegs[2]) == rsegs[2]
    got = _parse_one(port, SECRET)
    assert type(got) is net.RpcCall
    assert bytes(got.args["data"]) == payload and got.rid == 3


def test_handshake_frames_bitwise_against_reference():
    """Pre-auth frames carry no pickle: every cephx handshake message
    encodes to the reference's bytes and decodes in the other package."""
    from ceph_tpu.auth.cephx import Authorizer as JAuthorizer
    from ceph_tpu_torch.auth.cephx import Authorizer
    cases = [
        ("CephxBegin", ("client.admin",)),
        ("CephxChallenge", (b"c" * 16,)),
        ("CephxAuthenticate", (b"x" * 16, b"p" * 32)),
        ("CephxSession", (b"e" * 90, b"t" * 200)),
        ("CephxDone", (b"r" * 70,)),
    ]
    for name, fields in cases:
        mine = net._encode(getattr(net, name)(*fields), None)
        theirs = jnet._encode(getattr(jnet, name)(*fields), None)
        assert mine == theirs, name
        (tag, segs), = StreamParser(None).feed(theirs)
        assert net._decode(tag, segs, authed=False) == \
            getattr(net, name)(*fields)
    authz = ("osd", b"b" * 100, 3, 2 ** 63 + 5, b"q" * 80)
    mine = net._encode(net.CephxAuthorize(Authorizer(*authz)), None)
    assert mine == jnet._encode(jnet.CephxAuthorize(JAuthorizer(*authz)),
                                None)


def test_staged_payload_is_copied_before_the_store_keeps_it(served):
    """A staged request payload is a read-write view other views alias:
    the put handler copies it, so a later write into the staging buffer
    never reaches the stored object; a client's landed payload is
    immutable bytes (a write into it fails)."""
    server, _keyring = served
    server._rpc_mkpool(None, "p", replicated=True, size=3)
    payload = os.urandom(4096)
    msg = net.RpcCall(1, "put", {"pool": "p", "oid": "o",
                                 "data": payload}, session="S")
    pool = StagingPool("alias")
    got = _parse_one(_flatten(net._encode_parts(msg, SECRET)), SECRET,
                     staging=pool)
    staged = got.args["data"]
    assert isinstance(staged, memoryview) and not staged.readonly
    assert server._rpc_put(None, **got.args) == 4096
    staged[:16] = b"\xff" * 16                   # the buffer is reused
    assert server._rpc_get(None, "p", "o") == payload
    landed = _parse_one(_flatten(net._encode_parts(msg, SECRET)), SECRET)
    data = landed.args["data"]
    assert isinstance(data, bytes)
    with pytest.raises(TypeError):
        memoryview(data)[0] = 0
