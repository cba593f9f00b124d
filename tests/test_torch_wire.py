"""The port's v2 wire (``ceph_tpu_torch.backend.wire``) against the JAX
package's, on the CPU.

Frames are held bitwise against ``ceph_tpu.backend.wire`` for raw-bytes
segments in crc and secure mode: ``frame_encode``, ``frame_encode_parts``
(scattered segments), and both parsers (``FrameParser`` and the async
``StreamParser``) fed one byte at a time and in random chunks.  Message
frames pickle each package's own classes, so they are compared after
decoding.  The wire-mode bus (``MessageBus(wire=True)``, crc and secure)
is driven through both packages' ``make_cluster`` and every shard byte,
attribute and PG-log entry held equal, as in ``test_torch_ec_backend``.
Tolerance: bitwise everywhere.
"""
from __future__ import annotations

import dataclasses
import pickle
import random

import numpy as np
import pytest

from ceph_tpu.backend import wire as jwire
from ceph_tpu_torch.backend import wire
from ceph_tpu_torch.backend.memstore import GObject, Transaction
from ceph_tpu_torch.backend.messages import (
    ECSubWrite, ECSubWriteReply, FaultConfig, MessageBus, PGActivate,
    PGLogInfo, PGLogQuery, PushOp,
)
from ceph_tpu_torch.msg.parser import StreamParser
from test_torch_ec_backend import JAX, PORT, STRIPE, payload, run_both

SECRETS = {"crc": None, "secure": bytes(range(32))}


def _segments(seed: int) -> list[list[bytes]]:
    """Frames of 1-4 raw segments, 0 B to 9 KiB each (seeded)."""
    rng = random.Random(seed)
    return [[rng.randbytes(rng.choice((0, 1, 17, 1024, 1500, 9000)))
             for _ in range(rng.randint(1, 4))] for _ in range(12)]


def _chunks(blob: bytes, seed: int):
    rng = random.Random(seed)
    i = 0
    while i < len(blob):
        n = rng.randint(1, 97)
        yield blob[i:i + n]
        i += n


@pytest.mark.parametrize("mode", sorted(SECRETS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_frame_encode_bitwise(mode, seed):
    secret = SECRETS[mode]
    for segs in _segments(seed):
        tag = wire.TAG_MESSAGE if seed % 2 else wire.TAG_AUTH
        assert wire.frame_encode(tag, segs, secret=secret) == \
            jwire.frame_encode(tag, segs, secret=secret)


@pytest.mark.parametrize("mode", sorted(SECRETS))
def test_frame_encode_parts_bitwise(mode):
    """A scattered segment (small control pieces and views of 1 KiB and
    more) wires as the joined frame, in both packages."""
    secret = SECRETS[mode]
    rng = random.Random(5)
    pieces = [b"\x07" * 12, memoryview(rng.randbytes(4352)), b"xy",
              memoryview(rng.randbytes(4096)), memoryview(b"s" * 8)]
    segs = [b"RpcBatch", b"header", pieces]
    parts = wire.frame_encode_parts(wire.TAG_MESSAGE, segs, secret=secret)
    flat = b"".join(bytes(p) for p in parts)
    joined = [b"RpcBatch", b"header", b"".join(bytes(p) for p in pieces)]
    assert flat == jwire.frame_encode(wire.TAG_MESSAGE, joined,
                                      secret=secret)
    assert flat == b"".join(bytes(p) for p in jwire.frame_encode_parts(
        wire.TAG_MESSAGE, segs, secret=secret))
    # the bulk views splice unjoined
    assert [p.obj for p in parts if isinstance(p, memoryview)] == \
        [pieces[1].obj, pieces[3].obj]


@pytest.mark.parametrize("mode", sorted(SECRETS))
@pytest.mark.parametrize("feed", ["bytewise", "chunks", "whole"])
def test_parsers_match_the_reference(mode, feed):
    """The port's FrameParser and StreamParser give the reference
    FrameParser's frames and on-wire sizes from the same stream, however
    the stream is cut."""
    secret = SECRETS[mode]
    frames = _segments(7)
    blob = b"".join(jwire.frame_encode(wire.TAG_MESSAGE, s, secret=secret)
                    for s in frames)
    ref = jwire.FrameParser(secret)
    ref.track_sizes = True
    want = ref.feed(blob)
    assert [s for _, s in want] == frames
    if feed == "bytewise":
        pieces = [blob[i:i + 1] for i in range(len(blob))]
    elif feed == "chunks":
        pieces = list(_chunks(blob, 3))
    else:
        pieces = [blob]
    fp, sp = wire.FrameParser(secret), StreamParser(secret)
    fp.track_sizes = True
    got_fp, got_sp = [], []
    for piece in pieces:
        got_fp += fp.feed(piece)
        got_sp += [(t, [bytes(x) for x in s]) for t, s in sp.feed(piece)]
    assert got_fp == want and got_sp == want
    assert fp.frame_sizes == ref.frame_sizes == sp.frame_sizes
    assert sp.pending() == 0


def test_corruption_detected_everywhere():
    buf = bytearray(wire.frame_encode(wire.TAG_MESSAGE, [b"abc", b"defg"]))
    for pos in range(len(buf)):
        mutated = bytearray(buf)
        mutated[pos] ^= 0x40
        with pytest.raises(wire.WireError):
            if not wire.FrameParser().feed(bytes(mutated)):
                # a flipped length bit starves the parser: force it
                raise wire.WireError("incomplete (length corrupted)")


def test_secure_mode_mac():
    key = b"k" * 32
    buf = wire.frame_encode(wire.TAG_MESSAGE, [b"secret", b"data"],
                            secret=key)
    assert wire.FrameParser(key).feed(buf) == [
        (wire.TAG_MESSAGE, [b"secret", b"data"])]
    with pytest.raises(wire.WireError):
        wire.FrameParser(b"wrong" * 7).feed(buf)
    tampered = bytearray(buf)
    tampered[-20] ^= 1
    with pytest.raises(wire.WireError):
        wire.FrameParser(key).feed(bytes(tampered))


def test_message_codec_all_types():
    """Every sample message survives the codec as the port's own class
    with its fields, and its frame's type segment is the reference's
    (the payload pickles differ by the module path they name)."""
    from ceph_tpu.backend import memstore as jmem, messages as jmsg
    t = Transaction().write(GObject("o", 1), 0, b"abc").setattr(
        GObject("o", 1), "k", b"v")
    jt = jmem.Transaction().write(jmem.GObject("o", 1), 0, b"abc") \
        .setattr(jmem.GObject("o", 1), "k", b"v")
    samples = [
        (ECSubWrite(0, 7, t, at_version=3), jmsg.ECSubWrite(0, 7, jt,
                                                            at_version=3)),
        (ECSubWriteReply(1, 7), jmsg.ECSubWriteReply(1, 7)),
        (PGLogQuery(0, since=2), jmsg.PGLogQuery(0, since=2)),
        (PGLogInfo(2, 9, 1, entries=[]), jmsg.PGLogInfo(2, 9, 1,
                                                        entries=[])),
        (PGActivate(0, 12, head=9), jmsg.PGActivate(0, 12, head=9)),
        (PushOp(0, 5, "obj", {1: b"chunk"}), jmsg.PushOp(0, 5, "obj",
                                                         {1: b"chunk"})),
    ]
    for msg, ref in samples:
        [(tag, segs)] = wire.FrameParser().feed(wire.message_encode(msg))
        back = wire.message_decode(tag, segs)
        assert type(back) is type(msg)
        assert type(back).__module__ == "ceph_tpu_torch.backend.messages"
        assert pickle.dumps(back) == pickle.dumps(msg)
        [(_, jsegs)] = jwire.FrameParser().feed(jwire.message_encode(ref))
        assert segs[0] == jsegs[0]


def test_message_decode_rejects_unknown_type():
    frame = wire.frame_encode(wire.TAG_MESSAGE,
                              [b"NotAMessage", b"payload"])
    [(tag, segs)] = wire.FrameParser().feed(frame)
    with pytest.raises(wire.WireError):
        wire.message_decode(tag, segs)


def test_handshake_and_banner():
    a = wire.FramedConnection("osd.0")
    b = wire.FramedConnection("osd.1")
    assert not a.ready and not b.ready
    assert bytes(a.out).startswith(jwire.BANNER)
    payload_b = bytes(b.out)
    for i in range(0, len(payload_b), 3):      # banner split across reads
        a.receive(payload_b[i:i + 3])
    b.receive(bytes(a.out))
    assert a.ready and a.peer_hello.entity == "osd.1"
    assert b.ready and b.peer_hello.entity == "osd.0"
    a.out.clear()
    a.send(PGLogQuery(0, since=1))
    msgs = b.receive(bytes(a.out))
    assert isinstance(msgs[0], PGLogQuery) and msgs[0].since == 1
    with pytest.raises(wire.WireError):
        wire.FramedConnection("x").receive(b"ceph v027 legacy..." +
                                           b"\0" * 32)
    with pytest.raises(wire.WireError):
        wire.FramedConnection("y").send(PGLogQuery(0))


def test_every_wire_message_registers_a_sizer():
    """Every dataclass of the port's message modules that can ride a
    channel or a socket has a wire-accounting sizer, and so does every
    type of the RPC registry (the batch frames included)."""
    import importlib
    import ceph_tpu_torch.msg.proto  # noqa: F401 — joins net._TYPES
    import ceph_tpu_torch.net as net
    from ceph_tpu_torch.common.wire_accounting import registered_wire_types
    registered = registered_wire_types()
    found = set()
    for name in ("backend.messages", "net", "msg.proto", "tier.service",
                 "tier.agent"):
        mod = importlib.import_module(f"ceph_tpu_torch.{name}")
        for cname, obj in vars(mod).items():
            if isinstance(obj, type) and dataclasses.is_dataclass(obj) \
                    and obj.__module__ == mod.__name__ \
                    and not cname.startswith("_") \
                    and cname != "FaultConfig":
                found.add(cname)
    assert len(found) >= 20, sorted(found)
    assert not sorted(found - registered)
    assert not sorted(set(net._TYPES) - registered)
    assert {"RpcBatch", "RpcResultBatch"} <= set(net._TYPES)
    # every class a post-auth frame pickles is the port's own
    assert all(k.__module__.startswith("ceph_tpu_torch.")
               for k in net._TYPES.values())


def test_wire_mode_bus_with_faults():
    """Wire framing composes with cross-sender reorder + dup injection."""
    bus = MessageBus(wire=True)
    got = []

    class H:
        def handle_message(self, m):
            got.append(m)
    bus.register(1, H())
    bus.inject_faults(FaultConfig(seed=3, reorder=True, dup_prob=0.5))
    for i in range(10):
        bus.send(1, PGLogQuery(0, since=i))
    bus.deliver_all()
    assert len(got) >= 10
    assert {m.since for m in got} == set(range(10))
    assert all(isinstance(m, PGLogQuery) for m in got)


@pytest.mark.parametrize("mode", sorted(SECRETS))
def test_corrupted_bus_frame_is_detected_not_applied(mode):
    bus = MessageBus(wire=True, wire_secret=SECRETS[mode])
    got = []

    class H:
        def handle_message(self, m):
            got.append(m)
    bus.register(1, H())
    bus.send(1, PushOp(0, 5, "obj", {1: b"chunk" * 100}))
    env = bus.queues[1][0]
    frame = bytearray(env.frame)
    frame[len(frame) // 2] ^= 0x01
    env.frame = bytes(frame)
    with pytest.raises(wire.WireError):
        bus.deliver_all()
    assert got == [] and bus.delivered == 0


# -- the wire-mode bus under make_cluster, against the reference -----------

def _wire_scenario(env):
    be, bus = env.cluster()
    assert bus.wire
    data = payload(3 * STRIPE, seed=21)
    env.write(be, bus, "obj", 0, data)
    env.write(be, bus, "obj", 100, payload(40, seed=22))      # RMW
    env.write(be, bus, "obj2", 0, payload(2 * STRIPE + 5, seed=23))
    full = env.read(be, bus, "obj", 0, 3 * STRIPE)
    bus.mark_down(1)
    degraded = env.read(be, bus, "obj2", 0, 2 * STRIPE + 5)
    bus.mark_up(1)
    return {"full": full, "degraded": degraded}


@pytest.mark.parametrize("mode", sorted(SECRETS))
def test_wire_mode_make_cluster_matches_reference(mode, monkeypatch):
    secret = SECRETS[mode]
    for side in (JAX, PORT):
        mod = side.mods[1]                     # backend.ec_backend
        cls = side.MessageBus
        monkeypatch.setattr(mod, "MessageBus",
                            lambda _c=cls: _c(wire=True,
                                              wire_secret=secret))
    obs, state = run_both(_wire_scenario)
    assert state[0]["delivered"] > 0


def test_wire_mode_minicluster_end_to_end(monkeypatch):
    """A port MiniCluster over a wire-mode cluster bus: every sub-op
    serializes to framed bytes and back, data roundtrips bit-exact,
    degraded reads included."""
    import ceph_tpu_torch.cluster as cluster_mod
    from ceph_tpu_torch.cluster import MiniCluster
    from ceph_tpu_torch.common import Context
    monkeypatch.setattr(cluster_mod, "MessageBus",
                        lambda: MessageBus(wire=True,
                                           wire_secret=b"s" * 32))
    c = MiniCluster(n_osds=6, osds_per_host=2, chunk_size=512,
                    cct=Context())
    try:
        pid = c.create_ec_pool("w", {"k": "2", "m": "1", "device": "cpu"},
                               pg_num=4)
        data = np.random.default_rng(0).integers(
            0, 256, 5000, np.uint8).tobytes()
        c.put(pid, "obj", data)
        g = c.pg_group(pid, "obj")
        assert c.bus.wire and c.bus.wire_secret == b"s" * 32
        victim = next(o for o in g.acting if o != g.backend.whoami)
        c.bus.mark_down(victim)
        assert c.get(pid, "obj", 5000) == data
        c.bus.mark_up(victim)
        assert c.wire.totals()["tx_bytes"] > 0
    finally:
        c.shutdown()
