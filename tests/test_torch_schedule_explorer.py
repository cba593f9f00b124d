"""The port's schedule explorer against the JAX package's, on the CPU.

The scenarios of ``tests/test_schedule_explorer.py`` (two in-flight
writes to one object and one to another, a write against a shard's
death and revival, peering restarted mid-write, and the planted
first-reply-wins quorum race) are written once over a package's modules
and explored with the same seeds and bounds through
``ceph_tpu.utils.schedule_explorer`` (the JAX package's backend on
its ``MessageBus``) and ``ceph_tpu_torch.utils.schedule_explorer`` (the
port's): every result — schedules run, choice points, the set of traces
seen, the failing trace and its message — must be equal, and a failing
trace replays on the port as on the reference.
"""
from __future__ import annotations

import importlib
import types

import numpy as np
import pytest

K, M, CHUNK = 2, 1, 256
STRIPE = K * CHUNK


def _pkg(name: str) -> types.SimpleNamespace:
    imp = importlib.import_module
    return types.SimpleNamespace(
        explorer=imp(f"{name}.utils.schedule_explorer"),
        ECBackend=imp(f"{name}.backend.ec_backend").ECBackend,
        StripeInfo=imp(f"{name}.backend.ecutil").StripeInfo,
        PGTransaction=imp(f"{name}.backend.transaction").PGTransaction,
        OSDShard=imp(f"{name}.backend.pg_backend").OSDShard,
        Xor=imp(f"{name}.plugins.plugin_xor").ErasureCodeXor,
        messages=imp(f"{name}.backend.messages"),
        peering=imp(f"{name}.osd.peering"))


PKGS = {"jax": _pkg("ceph_tpu"), "port": _pkg("ceph_tpu_torch")}


def _payload(seed):
    return np.random.default_rng(seed).integers(
        0, 256, STRIPE, dtype=np.uint8).tobytes()


def _mk_backend(P, bus):
    ec = P.Xor()
    ec.init({"k": str(K), "m": str(M), "plugin": "xor"})
    backend = P.ECBackend(ec, P.StripeInfo(K, CHUNK), bus,
                          acting=[0, 1, 2], whoami=0)
    for s in (1, 2):
        P.OSDShard(s, bus)
    return backend


def _read(backend, bus, oid):
    out = {}
    backend.objects_read_and_reconstruct(
        {oid: [(0, STRIPE)]},
        lambda result, errors: out.update(result=result, errors=errors))
    bus.run_to_quiescence()
    if out.get("errors"):
        raise IOError(out["errors"])
    return bytes(out["result"][oid][0][2])


def concurrent_writes(P):
    def scenario(bus):
        backend = _mk_backend(P, bus)
        a, b, c = _payload(1), _payload(2), _payload(3)
        commits = []
        backend.submit_transaction(P.PGTransaction().write("obj", 0, a),
                                   on_commit=lambda t: commits.append("a"))
        backend.submit_transaction(P.PGTransaction().write("obj", 0, b),
                                   on_commit=lambda t: commits.append("b"))
        backend.submit_transaction(P.PGTransaction().write("other", 0, c),
                                   on_commit=lambda t: commits.append("c"))
        bus.run_to_quiescence()
        assert "a" in commits and "b" in commits and "c" in commits
        assert commits.index("a") < commits.index("b"), \
            "pipeline order broken"
        assert _read(backend, bus, "obj") == b, "last write must win"
        assert _read(backend, bus, "other") == c
        for oid in ("obj", "other"):
            assert all(backend.be_deep_scrub(oid).values()), \
                f"scrub inconsistency on {oid}"
    return scenario


def write_vs_recovery(P):
    def scenario(bus):
        backend = _mk_backend(P, bus)
        first, second = _payload(4), _payload(5)
        backend.submit_transaction(P.PGTransaction().write("obj", 0, first))
        bus.run_to_quiescence()
        bus.mark_down(2)
        committed = []
        backend.submit_transaction(P.PGTransaction().write("obj", 0, second),
                                   on_commit=committed.append)
        bus.run_to_quiescence()
        assert committed, "write acked while 2/3 shards up (min_size k)"
        bus.mark_up(2)
        bus.run_to_quiescence()
        assert _read(backend, bus, "obj") == second
        assert bus.handlers[2].pg_log.head == backend.pg_log.head, \
            "revived shard stale"
    return scenario


def peering_vs_writes(P):
    def scenario(bus):
        backend = _mk_backend(P, bus)
        coord = P.peering.PeeringCoordinator(backend)
        a, b = _payload(8), _payload(9)
        commits = []
        backend.submit_transaction(P.PGTransaction().write("obj", 0, a),
                                   on_commit=lambda t: commits.append("a"))
        coord.advance_map(epoch=3)
        backend.submit_transaction(P.PGTransaction().write("obj", 0, b),
                                   on_commit=lambda t: commits.append("b"))
        bus.run_to_quiescence()
        assert coord.state is P.peering.PState.ACTIVE, coord.state
        assert commits == ["a", "b"], commits
        assert _read(backend, bus, "obj") == b
        seq = [s for e, s in coord.history if e == 3]
        assert seq[0] == P.peering.PState.GET_INFO.value
        assert seq[-1] == P.peering.PState.ACTIVE.value
    return scenario


def planted_race(P):
    msgs = P.messages

    class Replica:
        def __init__(self, bus, shard, value):
            self.bus, self.shard, self.value = bus, shard, value
            bus.register(shard, self)

        def handle_message(self, m):
            if isinstance(m, msgs.PGLogQuery):
                self.bus.send(m.from_shard,
                              msgs.PGLogInfo(self.shard, self.value, 0))

    class BuggyQuorum:
        def __init__(self, bus):
            self.bus = bus
            self.first = None
            bus.register(0, self)
            bus.send(1, msgs.PGLogQuery(0))
            bus.send(2, msgs.PGLogQuery(0))

        def handle_message(self, m):
            if self.first is None:
                self.first = m.last_update

    def scenario(bus):
        svc = BuggyQuorum(bus)
        Replica(bus, 1, value=10)
        Replica(bus, 2, value=20)
        bus.run_to_quiescence()
        assert svc.first == 10, "quorum raced: adopted the wrong reply"
    return scenario


# (scenario, explorer, kwargs): the seeds and bounds of
# tests/test_schedule_explorer.py
RUNS = {
    "concurrent_writes_random": (concurrent_writes, "explore_random",
                                 {"schedules": 40}),
    "concurrent_writes_dfs": (concurrent_writes, "explore_dfs",
                              {"max_runs": 120}),
    "write_vs_recovery_random": (write_vs_recovery, "explore_random",
                                 {"schedules": 30}),
    "peering_vs_writes_random": (peering_vs_writes, "explore_random",
                                 {"schedules": 30}),
    "peering_vs_writes_dfs": (peering_vs_writes, "explore_dfs",
                              {"max_runs": 60}),
    "planted_race_dfs": (planted_race, "explore_dfs", {"max_runs": 50}),
    "planted_race_random_seed_7": (planted_race, "explore_random",
                                   {"schedules": 20, "seed": 7}),
}


def _outcome(res) -> dict:
    # the failure's first line: pytest's rewriting appends object reprs
    return {"schedules_run": res.schedules_run,
            "choice_points": res.choice_points,
            "failure_trace": res.failure_trace,
            "failure": res.failure and res.failure.splitlines()[0],
            "traces_seen": sorted(res.traces_seen), "ok": res.ok}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_exploration_equals_the_jax_package(name):
    make, how, kw = RUNS[name]
    out = {side: _outcome(getattr(P.explorer, how)(make(P), **kw))
           for side, P in PKGS.items()}
    assert out["port"] == out["jax"]
    assert out["port"]["ok"] == (not name.startswith("planted"))
    if out["port"]["ok"]:
        assert len(out["port"]["traces_seen"]) > 1


def test_failing_trace_replays_on_both():
    P, J = PKGS["port"], PKGS["jax"]
    res = P.explorer.explore_dfs(planted_race(P), max_runs=50)
    for pkg in (P, J):
        with pytest.raises(AssertionError, match="quorum raced"):
            pkg.explorer.replay(planted_race(pkg), res.failure_trace)


def test_wire_mode_bus_frames_each_delivery():
    """A ScheduledBus in wire mode decodes every frame it delivers through
    the port's backend.wire, and explores the same schedules."""
    P = PKGS["port"]

    class WireBus(P.explorer.ScheduledBus):
        def __init__(self, controller):
            super().__init__(controller)
            self.wire = True

    res = {}
    for wire in (False, True):
        bus_cls = WireBus if wire else P.explorer.ScheduledBus
        ctl = P.explorer._Controller([])
        bus = bus_cls(ctl)
        write_vs_recovery(P)(bus)
        res[wire] = (list(ctl.trace), bus.delivered)
    assert res[True] == res[False]
