"""The port's transport fault plane against the JAX package's, on the CPU,
after the reference's ``tests/test_async_faults.py``.

One seeded ``FaultPlan`` drives both packages' ``TransportFaultHooks``
through the same sequence of sends and receives: the injected event
sequence (plane, kind, target, detail) and its digest are equal, event
for event.  Then the port's async stack runs under each fault kind
(resets, black holes, truncated replies, delays): the frame state
machine survives hostile byte delivery, every acked put reads back
(zero acked loss), reqid dedup keeps resent puts applied once (one
PG-log entry an object), and the cephx handshake is never faulted.
Waits are bounded by small ``ms_rpc_timeout``/backoff options;
servers and clients stop in ``finally``.
"""
from __future__ import annotations

import random

import numpy as np
import pytest

from ceph_tpu import failure as jfailure
from ceph_tpu.failure import transport as jtransport
from ceph_tpu_torch import convert
from ceph_tpu_torch import failure as pfailure
from ceph_tpu_torch.backend.wire import TAG_MESSAGE, WireError, frame_encode
from ceph_tpu_torch.common import Context
from ceph_tpu_torch.failure import FaultInjector, FaultPlan, TransportFaults
from ceph_tpu_torch.failure import injector as port_injector
from ceph_tpu_torch.failure import transport
from ceph_tpu_torch.msg import MuxClient, StreamParser


def _data(n, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


# -- the same plan, the same decisions ---------------------------------------

PLANS = {
    "mixed": dict(reset_prob=0.05, blackhole_prob=0.02, truncate_prob=0.02,
                  delay_prob=0.05, delay_ms=5.0),
    "resets": dict(reset_prob=0.3),
    "blackholes": dict(blackhole_prob=0.2, delay_prob=0.1, delay_ms=1.0),
}
MSG_TYPES = ("RpcResult", "RpcResultBatch", "NotifyPush")
METHODS = ("put", "get", "ping", "stat")


def _drive(failure_mod, transport_mod, plan, n: int = 400):
    """``n`` seeded send/receive decisions through one package's hooks;
    returns (actions, events, digest)."""
    inj = failure_mod.FaultInjector(plan)
    hooks = transport_mod.TransportFaultHooks(inj, sleep=lambda s: None)
    rng = random.Random(99)
    actions = []
    for _ in range(n):
        if rng.random() < 0.5:
            t = rng.choice(MSG_TYPES)
            actions.append(hooks.on_send(t, rng.randint(64, 1 << 20),
                                         target=t))
        else:
            actions.append(hooks.on_recv("RpcCall",
                                         target=rng.choice(METHODS)))
    events = [(e["plane"], e["kind"], e["target"], e.get("detail"))
              for e in inj.events]
    return actions, events, inj.event_digest(), inj.summary()


@pytest.mark.parametrize("name", sorted(PLANS))
@pytest.mark.parametrize("seed", [11, 12])
def test_same_plan_same_transport_events(name, seed):
    ref_plan = jfailure.FaultPlan(
        seed=seed, transport=jfailure.TransportFaults(**PLANS[name]))
    plan = convert.fault_plan_from_reference(ref_plan)
    assert plan == FaultPlan(seed=seed,
                             transport=TransportFaults(**PLANS[name]))
    port = _drive(pfailure, transport, plan)
    ref = _drive(jfailure, jtransport, ref_plan)
    assert port[0] == ref[0]                     # actions
    assert port[1] == ref[1]                     # events, in order
    assert port[2] == ref[2]                     # digest
    assert port[3] == ref[3]
    assert port[3]["total"] > 0


def test_plane_order_and_independent_streams():
    """The planes in the reference's order; a disabled kind draws
    nothing, so arming the transport plane never shifts the store or
    bus streams of the same seed."""
    from ceph_tpu.failure import injector as jinjector
    assert port_injector.PLANES == jinjector.PLANES == \
        ("transport", "store", "device", "bus")
    a = FaultInjector(FaultPlan(seed=3))
    b = FaultInjector(FaultPlan(seed=3, transport=TransportFaults(
        reset_prob=0.5)))
    transport.TransportFaultHooks(b, sleep=lambda s: None).on_recv(
        "RpcCall", target="put")
    assert [a.roll("store", "eio_read", 0.3) for _ in range(50)] == \
        [b.roll("store", "eio_read", 0.3) for _ in range(50)]


# -- frame state machine vs hostile byte delivery ----------------------------

SECRET = b"f" * 32


def _stream(n=8):
    return b"".join(
        frame_encode(TAG_MESSAGE, [bytes([i])] * 2 + [b"p" * (100 * i)],
                     secret=SECRET)
        for i in range(1, n + 1))


def test_parser_one_byte_at_a_time():
    blob = _stream()
    sp = StreamParser(SECRET)
    tags = []
    for i in range(len(blob)):
        tags += [tag for tag, _segs in sp.feed(blob[i:i + 1])]
    assert tags == [TAG_MESSAGE] * 8 and sp.pending() == 0


def test_parser_reordered_partial_reads():
    blob = _stream()
    rng = random.Random(17)
    cuts = sorted(rng.sample(range(1, len(blob)), 40))
    pieces = [blob[a:b] for a, b in zip([0] + cuts, cuts + [len(blob)])]
    sp = StreamParser(SECRET)
    got, i = 0, 0
    while i < len(pieces):
        k = rng.randint(1, 4)
        got += len(sp.feed(b"".join(pieces[i:i + k])))
        i += k
    assert got == 8 and sp.pending() == 0


def test_truncated_frame_yields_nothing_then_heals():
    frame = frame_encode(TAG_MESSAGE, [b"op-payload" * 50], secret=SECRET)
    sp = StreamParser(SECRET)
    assert sp.feed(frame[:len(frame) // 2]) == []
    assert sp.pending() == len(frame) // 2
    out = StreamParser(SECRET).feed(frame)
    assert len(out) == 1 and bytes(out[0][1][0]) == b"op-payload" * 50
    sp2 = StreamParser(SECRET)
    sp2.feed(frame[:60])
    with pytest.raises(WireError):
        sp2.feed(frame)                 # misaligned preamble refused


# -- the mux stack over injected transport faults ----------------------------

def _served(tmp_path, plan, **overrides):
    from ceph_tpu_torch.cluster import MiniCluster
    from ceph_tpu_torch.net import ClusterServer
    cct = Context(overrides={
        "ms_rpc_timeout": 6.0, "ms_rpc_retry_attempts": 8,
        "ms_reconnect_backoff_base": 0.01,
        "ms_reconnect_backoff_cap": 0.05, **overrides})
    c = MiniCluster(n_osds=3, osds_per_host=3, chunk_size=512,
                    cct=cct, data_dir=tmp_path)
    inj = c.inject_faults(plan)
    server = ClusterServer(c)
    server.inject_faults(inj)
    server.start()
    return c, server, inj, cct


def _hammer(mux, n_ops: int, tag: str, pool: str, unique: bool):
    """Closed-loop puts across 8 sessions; returns the ACKED model."""
    sessions = [mux.session() for _ in range(8)]
    model = {}
    for i in range(n_ops):
        oid = f"{tag}{i}" if unique else f"{tag}{i % 6}"
        data = _data(1536, seed=i)
        try:
            sessions[i % len(sessions)].call(
                "put", {"pool": pool, "oid": oid, "data": data})
        except (ConnectionError, TimeoutError, IOError):
            continue                      # unacked: no contract
        model[oid] = data
    return model


def _verify(mux, pool, model):
    s = mux.session()
    for oid, want in sorted(model.items()):
        for _attempt in range(6):
            try:
                assert s.call("get", {"pool": pool, "oid": oid}) == want
                break
            except (ConnectionError, TimeoutError):
                continue
        else:
            raise AssertionError(f"get {oid} never completed")


@pytest.mark.parametrize("kind, faults, overrides, counter", [
    ("resets", dict(reset_prob=0.10), {}, "reconnects"),
    ("blackholes", dict(blackhole_prob=0.10), {"ms_rpc_timeout": 3.0},
     "resends"),
    ("truncates", dict(truncate_prob=0.08, delay_prob=0.2, delay_ms=1.0),
     {}, "reconnects"),
])
def test_zero_acked_loss(tmp_path, kind, faults, overrides, counter):
    plan = FaultPlan(seed=5, transport=TransportFaults(**faults))
    c, server, inj, cct = _served(tmp_path, plan, **overrides)
    mux = None
    try:
        mux = MuxClient("127.0.0.1", server.port,
                        tmp_path / "client.admin.keyring", cct=cct,
                        n_conns=2)
        mux.session().call("mkpool", {"name": "p", "replicated": True,
                                      "size": 3}, timeout=30.0)
        model = _hammer(mux, 24, kind[0], "p", unique=False)
        assert model, f"no op was ever acked under {kind}"
        _verify(mux, "p", model)
        fired = inj.summary()["planes"].get("transport", {})
        assert fired, f"no {kind} fault fired"
        assert mux.stats()[counter] > 0
        assert mux.live_connections() >= 1
    finally:
        if mux is not None:
            mux.close()
        server.stop()
        c.shutdown()


def test_resent_puts_apply_once(tmp_path):
    """Black holes and resets on an EC pool: every acked put reads back,
    the server answers resends from its reqid cache, and each object's
    PG log holds exactly one entry (a re-applied put would add one)."""
    plan = FaultPlan(seed=11, transport=TransportFaults(
        reset_prob=0.05, blackhole_prob=0.05))
    c, server, inj, cct = _served(tmp_path, plan, ms_rpc_timeout=4.0)
    mux = None
    try:
        mux = MuxClient("127.0.0.1", server.port,
                        tmp_path / "client.admin.keyring", cct=cct,
                        n_conns=2)
        mux.session().call("mkpool", {
            "name": "ec", "profile": {"k": "2", "m": "1",
                                      "device": "cpu"}, "pg_num": 4},
            timeout=30.0)
        model = _hammer(mux, 24, "u", "ec", unique=True)
        assert model
        _verify(mux, "ec", model)
        pid = c.pool_ids["ec"]
        for oid in model:
            entries = [e for e in c.pg_group(pid, oid).backend.pg_log
                       .entries if e.oid == oid]
            assert len(entries) == 1, (oid, entries)
        kinds = inj.summary()["planes"]["transport"]
        assert kinds.get("blackhole", 0) > 0
        assert server.rpc_dedup_hits > 0 or mux.stats()["resends"] > 0
    finally:
        if mux is not None:
            mux.close()
        server.stop()
        c.shutdown()


def test_handshake_never_faulted(tmp_path):
    """reset_prob=1.0: post-auth frames always die, yet a fresh client
    still dials and completes cephx."""
    plan = FaultPlan(seed=1, transport=TransportFaults(reset_prob=1.0))
    c, server, inj, cct = _served(tmp_path, plan)
    mux = None
    try:
        mux = MuxClient("127.0.0.1", server.port,
                        tmp_path / "client.admin.keyring", cct=cct,
                        n_conns=2)
        mux.connect()
        assert mux.live_connections() >= 1
        assert inj.summary()["total"] == 0       # nothing post-auth yet
    finally:
        if mux is not None:
            mux.close()
        server.stop()
        c.shutdown()


def test_ms_inject_options_arm_the_server(tmp_path):
    """``ms_inject_socket_failures`` arms the server's own injector (the
    reference's 'ms inject socket failures' config surface), and a
    TcpRados put still completes through the resets."""
    from ceph_tpu_torch.cluster import MiniCluster
    from ceph_tpu_torch.net import ClusterServer, TcpRados
    cct = Context(overrides={
        "ms_inject_socket_failures": 4, "ms_rpc_timeout": 6.0,
        "ms_rpc_retry_attempts": 8, "ms_reconnect_backoff_base": 0.01,
        "ms_reconnect_backoff_cap": 0.05})
    c = MiniCluster(n_osds=3, osds_per_host=3, chunk_size=512, cct=cct,
                    data_dir=tmp_path)
    server = ClusterServer(c)
    server.start()
    r = None
    try:
        assert server.fault_hooks is not None
        r = TcpRados("127.0.0.1", server.port,
                     tmp_path / "client.admin.keyring", cct=cct)
        r.mkpool("p", replicated=True, size=3)
        for i in range(8):
            r.put("p", f"o{i}", _data(700, i))
        for i in range(8):
            assert r.get("p", f"o{i}") == _data(700, i)
        assert server._own_injector.summary()["total"] > 0
    finally:
        if r is not None:
            r.close()
        server.stop()
        c.shutdown()
