"""The port's OSD EC backend against the JAX package's, on the CPU.

Every case runs one scenario twice: on ``ceph_tpu.backend.make_cluster``
(``jax_rs`` with ``device=numpy``, the reference's own test setup, or
``device=jax`` on JAX-CPU) and on ``ceph_tpu_torch.backend.make_cluster``
(``torch_rs`` with ``device=cpu``: the plain PyTorch versions of the
kernels).  The same seeded numpy payloads and the same op sequence go
through both; the scenario asserts what the reference's own test asserts
(``tests/test_ec_backend.py``, the ``make_cluster`` cases of
``tests/test_pg_log.py``, ``tests/test_min_size.py``), and the harness
then holds the two runs equal, bitwise:

- every shard's objects: bytes, attributes (``HINFO_KEY`` among them),
  the pgmeta omap with its pickled PG log entries, log bounds and
  rollback records decoded field by field (pickles name their module,
  so the raw omap bytes differ between packages by construction);
- the primary's authority PG log, and its perf counters;
- what the scenario observed: read results and errors, recovery and
  repair states;
- the number of messages each bus delivered.
"""
from __future__ import annotations

import dataclasses
import enum
import importlib
import pickle

import numpy as np
import pytest

K, M = 4, 2
CHUNK = 128
STRIPE = K * CHUNK

# perf counters both packages keep per backend (time averages left out:
# they are wall time)
PERF_KEYS = ("writes", "write_rollbacks", "reads", "read_errors",
             "write_bytes", "stripe_bytes_encoded", "read_bytes",
             "recoveries", "recovery_bytes", "recovery_failures",
             "chain_repairs", "chain_objects", "chain_fallbacks",
             "regen_repairs", "regen_objects", "regen_fallbacks",
             "log_repairs_clean", "log_repairs", "log_repair_objects",
             "shard_backfills", "backfill_objects", "pipeline_depth")


class Side:
    """One package's backend surface: attribute lookups search its
    backend, ec_backend, messages and pg_log modules in turn."""

    MODULES = ("backend", "backend.ec_backend", "backend.pg_backend",
               "backend.messages", "backend.memstore", "osd.pg_log")

    def __init__(self, pkg: str):
        self.pkg = pkg
        self.mods = [importlib.import_module(f"{pkg}.{m}")
                     for m in self.MODULES]
        self.ecutil = importlib.import_module(f"{pkg}.backend.ecutil")
        self.registry = importlib.import_module(
            f"{pkg}.plugins.registry").ErasureCodePluginRegistry.instance()
        self.Context = importlib.import_module(f"{pkg}.common").Context

    def __getattr__(self, name):
        for mod in self.mods:
            if hasattr(mod, name):
                return getattr(mod, name)
        raise AttributeError(name)


JAX = Side("ceph_tpu")
PORT = Side("ceph_tpu_torch")


def plugin(side: Side, kind: str = "rs", jax_device: str = "numpy",
           k: int = K, m: int = M, **extra):
    """The scenario's codec on ``side``: ``rs`` (jax_rs / torch_rs
    reed_sol_van), ``clay`` (over jax_rs / torch_rs) or ``regen``
    (pm_regen; ``extra`` gives d and mode).  The JAX package runs
    ``jax_device``, the port the plain versions (``device=cpu``)."""
    dev = jax_device if side is JAX else "cpu"
    rs = "jax_rs" if side is JAX else "torch_rs"
    prof = {"k": str(k), "m": str(m), "device": dev}
    if kind == "rs":
        return side.registry.factory(rs, "", prof | {
            "technique": "reed_sol_van"})
    if kind == "clay":
        return side.registry.factory("clay", "", prof | {
            "scalar_mds": rs})
    if kind == "regen":
        return side.registry.factory("pm_regen", "", prof | {
            key: str(v) for key, v in extra.items()})
    raise ValueError(kind)


def payload(n, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, size=n, dtype=np.uint8).tobytes()


def norm(x):
    """A package-neutral form of ``x``: dataclasses become (class name,
    fields...), enums their value, containers recurse, arrays bytes."""
    if isinstance(x, enum.Enum):
        return x.value
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            norm(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, dict):
        return {norm(k): norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return tuple(norm(v) for v in x)
    if isinstance(x, (set, frozenset)):
        return frozenset(norm(v) for v in x)
    if isinstance(x, np.ndarray):
        return x.tobytes()
    if isinstance(x, (bytearray, memoryview)):
        return bytes(x)
    return x


def _omap(omap: dict) -> dict:
    """The pgmeta omap with its pickles decoded: log entries (``log.*``),
    rollback records (``rb.*``) and the log bounds (``vi``)."""
    return {k: norm(pickle.loads(v))
            if k == "vi" or k.startswith(("log.", "rb.")) else bytes(v)
            for k, v in omap.items()}


class Env:
    """One side's run of a scenario: builds clusters, drives ops, and
    snapshots every cluster it built."""

    def __init__(self, side: Side, kind: str = "rs",
                 jax_device: str = "numpy", **codec):
        self.S = side
        self.kind = kind
        self.jax_device = jax_device
        self.codec = codec
        self.ec = self.new_ec()
        self.clusters: list = []

    def new_ec(self):
        return plugin(self.S, self.kind, self.jax_device, **self.codec)

    def cluster(self, chunk: int = CHUNK, min_size: int = 0,
                counting: bool = False, ec=None, conf: dict | None = None):
        """(backend, bus): make_cluster's layout, on a fresh Context;
        ``counting`` tallies sent messages by type in ``bus.sent``."""
        S, ec = self.S, ec or self.ec
        cct = S.Context()
        for key, value in (conf or {}).items():
            cct.conf.set(key, value)
        if min_size or counting:
            bus = S.MessageBus()
            n = ec.get_chunk_count()
            be = S.ECBackend(ec, S.StripeInfo(ec.get_data_chunk_count(),
                                              chunk), bus,
                             acting=list(range(n)), whoami=0, cct=cct,
                             min_size=min_size)
            for s in range(1, n):
                S.OSDShard(s, bus)
        else:
            be, bus = S.make_cluster(ec, chunk_size=chunk, cct=cct)
        if counting:
            bus.sent = {}
            send = bus.send

            def counted(to, msg, _send=send, _bus=bus):
                name = type(msg).__name__
                _bus.sent[name] = _bus.sent.get(name, 0) + 1
                _send(to, msg)
            bus.send = counted
        self.clusters.append((be, bus))
        return be, bus

    def store(self, bus, shard):
        return self.S.shard_store(bus, shard)

    def write(self, be, bus, oid, off, data, check: bool = True):
        done = []
        be.submit_transaction(self.S.PGTransaction().write(oid, off, data),
                              on_commit=done.append)
        bus.deliver_all()
        if check:
            assert done, "write did not commit"
        return done

    def read(self, be, bus, oid, off, length, fast_read=False):
        out = {}
        be.objects_read_and_reconstruct(
            {oid: [(off, length)]},
            lambda result, errors: out.update(result=result, errors=errors),
            fast_read=fast_read)
        bus.deliver_all()
        return out

    def encode(self, be, data):
        return self.S.ecutil.encode(be.sinfo, be.ec_impl, data)

    def snapshot(self) -> list:
        out = []
        for be, bus in self.clusters:
            shards = {}
            for s in be.acting:
                st = self.store(bus, s)
                shards[s] = {
                    (g.oid, g.shard): (bytes(o.data), norm(o.xattrs),
                                       _omap(o.omap), bytes(o.omap_header))
                    for g, o in st.objects.items()}
            local = be.local_shard.pg_log
            out.append({
                "shards": shards,
                "authority_log": (be.pg_log.head, be.pg_log.tail,
                                  norm(list(be.pg_log.entries))),
                "local_log": (local.head, local.tail,
                              norm(list(local.entries))),
                "perf": {key: be.perf.get(key) for key in PERF_KEYS},
                "delivered": bus.delivered,
                "stale": sorted(be.stale)})
        return out


def run_both(scenario, kind: str = "rs", jax_device: str = "numpy",
             **codec):
    """Run ``scenario(env)`` on the JAX package and on the port and hold
    their observations and final states equal; returns the port's."""
    seen = {}
    for side in (JAX, PORT):
        env = Env(side, kind, jax_device, **codec)
        observed = norm(scenario(env))
        seen[side.pkg] = (observed, env.snapshot())
    jax_obs, jax_state = seen["ceph_tpu"]
    port_obs, port_state = seen["ceph_tpu_torch"]
    assert port_obs == jax_obs
    assert len(port_state) == len(jax_state)
    for got, want in zip(port_state, jax_state):
        assert got["delivered"] == want["delivered"]
        assert got["perf"] == want["perf"]
        assert got["authority_log"] == want["authority_log"]
        assert got["local_log"] == want["local_log"]
        assert got["stale"] == want["stale"]
        assert got["shards"].keys() == want["shards"].keys()
        for s in want["shards"]:
            assert got["shards"][s] == want["shards"][s], f"shard {s}"
    return port_obs, port_state


# -- TestPipeline ----------------------------------------------------------

def pipe_write_then_read(env):
    be, bus = env.cluster()
    data = payload(3 * STRIPE)
    env.write(be, bus, "obj", 0, data)
    out = env.read(be, bus, "obj", 0, len(data))
    assert not out["errors"]
    assert out["result"]["obj"][0][2] == data
    return out


def pipe_shards_hold_chunks(env):
    be, bus = env.cluster()
    data = payload(2 * STRIPE, seed=1)
    env.write(be, bus, "obj", 0, data)
    want = env.encode(be, data)
    for chunk in range(K + M):
        got = env.store(bus, chunk).read(env.S.GObject("obj", chunk))
        assert got == want[chunk].tobytes()
    return want


def pipe_unaligned_read(env):
    be, bus = env.cluster()
    data = payload(4 * STRIPE, seed=2)
    env.write(be, bus, "obj", 0, data)
    out = env.read(be, bus, "obj", 100, 3 * STRIPE)
    assert out["result"]["obj"][0][2] == data[100:100 + 3 * STRIPE]
    return out


def pipe_read_trims_to_object_size(env):
    be, bus = env.cluster()
    data = payload(STRIPE)
    env.write(be, bus, "obj", 0, data)
    out = env.read(be, bus, "obj", 0, 10 * STRIPE)
    assert out["result"]["obj"][0][2] == data
    return out


def pipe_rmw_partial_overwrite(env):
    be, bus = env.cluster()
    data = bytearray(payload(2 * STRIPE, seed=4))
    env.write(be, bus, "obj", 0, bytes(data))
    patch = payload(40, seed=5)
    env.write(be, bus, "obj", 100, patch)
    data[100:140] = patch
    out = env.read(be, bus, "obj", 0, len(data))
    assert out["result"]["obj"][0][2] == bytes(data)
    return out


def pipe_append_grows_object(env):
    be, bus = env.cluster()
    a, b = payload(STRIPE, seed=6), payload(2 * STRIPE, seed=7)
    env.write(be, bus, "obj", 0, a)
    env.write(be, bus, "obj", STRIPE, b)
    assert be.object_size("obj") == 3 * STRIPE
    out = env.read(be, bus, "obj", 0, 3 * STRIPE)
    assert out["result"]["obj"][0][2] == a + b
    return out


def pipe_overlapping_writes_use_cache(env):
    be, bus = env.cluster()
    base = payload(STRIPE, seed=8)
    env.write(be, bus, "obj", 0, base)
    done = []
    p1, p2 = payload(10, seed=9), payload(10, seed=10)
    be.submit_transaction(env.S.PGTransaction().write("obj", 0, p1),
                          on_commit=done.append)
    be.submit_transaction(env.S.PGTransaction().write("obj", 20, p2),
                          on_commit=done.append)
    bus.deliver_all()
    assert len(done) == 2
    want = bytearray(base)
    want[0:10] = p1
    want[20:30] = p2
    out = env.read(be, bus, "obj", 0, STRIPE)
    assert out["result"]["obj"][0][2] == bytes(want)
    return {"done": done, "out": out}


def pipe_delete(env):
    be, bus = env.cluster()
    env.write(be, bus, "obj", 0, payload(STRIPE))
    done = []
    be.submit_transaction(env.S.PGTransaction().delete("obj"),
                          on_commit=done.append)
    bus.deliver_all()
    assert done
    for chunk in range(1, K + M):
        assert not bus.handlers[chunk].store.exists(
            env.S.GObject("obj", chunk))
    return done


# -- TestDegradedAndRecovery --------------------------------------------------

def degraded_read_reconstructs(env):
    be, bus = env.cluster()
    data = payload(4 * STRIPE, seed=11)
    env.write(be, bus, "obj", 0, data)
    bus.mark_down(1)
    bus.mark_down(3)
    out = env.read(be, bus, "obj", 0, len(data))
    assert not out["errors"]
    assert out["result"]["obj"][0][2] == data
    return out


def degraded_too_many_failures(env):
    be, bus = env.cluster()
    env.write(be, bus, "obj", 0, payload(STRIPE))
    for s in (1, 2, 3):
        bus.mark_down(s)
    assert not be.is_recoverable("obj", {1, 2, 3})
    with pytest.raises(IOError):
        be.ec_impl.minimum_to_decode({1}, {0, 4, 5})
    out = env.read(be, bus, "obj", 0, STRIPE)
    assert out["errors"] == {"obj": -5}
    return out


def degraded_shard_error_triggers_retry(env):
    be, bus = env.cluster()
    data = payload(2 * STRIPE, seed=12)
    env.write(be, bus, "obj", 0, data)
    bus.handlers[2].store.queue_transaction(
        env.S.Transaction().remove(env.S.GObject("obj", 2)))
    out = env.read(be, bus, "obj", 0, len(data))
    assert not out["errors"]
    assert out["result"]["obj"][0][2] == data
    return out


def degraded_fast_read(env):
    be, bus = env.cluster()
    data = payload(STRIPE, seed=13)
    env.write(be, bus, "obj", 0, data)
    out = env.read(be, bus, "obj", 0, STRIPE, fast_read=True)
    assert out["result"]["obj"][0][2] == data
    return out


def recovery_restores_lost_shard(env):
    be, bus = env.cluster()
    data = payload(3 * STRIPE, seed=14)
    env.write(be, bus, "obj", 0, data)
    lost = env.S.GObject("obj", 4)
    bus.handlers[4].store.queue_transaction(env.S.Transaction().remove(lost))
    states = []
    rop = be.recover_object("obj", {4},
                            on_complete=lambda r: states.append(r.state))
    bus.deliver_all()
    assert rop.state == env.S.RecoveryState.COMPLETE
    assert states == [env.S.RecoveryState.COMPLETE]
    assert bus.handlers[4].store.read(lost) == \
        env.encode(be, data)[4].tobytes()
    return states


def recovery_after_missed_write(env):
    be, bus = env.cluster()
    bus.mark_down(5)
    data = payload(2 * STRIPE, seed=15)
    env.write(be, bus, "obj", 0, data)
    bus.mark_up(5)
    rop = be.recover_object("obj", {5})
    bus.deliver_all()
    assert rop.state == env.S.RecoveryState.COMPLETE
    assert bus.handlers[5].store.read(env.S.GObject("obj", 5)) == \
        env.encode(be, data)[5].tobytes()
    return rop.state


# -- TestClayCluster ----------------------------------------------------------

def clay_write_read_roundtrip(env):
    be, bus = env.cluster()
    data = payload(2 * STRIPE, seed=20)
    env.write(be, bus, "obj", 0, data)
    out = env.read(be, bus, "obj", 0, len(data))
    assert not out["errors"]
    assert out["result"]["obj"][0][2] == data
    return out


def clay_recovery_uses_fractional_reads(env):
    be, bus = env.cluster()
    data = payload(2 * STRIPE, seed=21)
    env.write(be, bus, "obj", 0, data)
    lost = env.S.GObject("obj", 1)
    want = bus.handlers[1].store.read(lost)
    bus.handlers[1].store.queue_transaction(env.S.Transaction().remove(lost))
    rop = be.recover_object("obj", {1})
    bus.deliver_all()
    assert rop.state == env.S.RecoveryState.COMPLETE
    assert bus.handlers[1].store.read(lost) == want
    sub = env.ec.get_repair_subchunks(1)
    assert sum(c for _, c in sub) < env.ec.get_sub_chunk_count()
    return {"state": rop.state, "subchunks": sub}


def clay_degraded_read_reconstructs(env):
    be, bus = env.cluster()
    data = payload(2 * STRIPE, seed=22)
    env.write(be, bus, "obj", 0, data)
    bus.mark_down(2)
    out = env.read(be, bus, "obj", 0, len(data))
    assert not out["errors"]
    assert out["result"]["obj"][0][2] == data
    return out


# -- TestScrub ------------------------------------------------------------

def scrub_clean(env):
    be, bus = env.cluster()
    env.write(be, bus, "obj", 0, payload(2 * STRIPE, seed=16))
    result = be.be_deep_scrub("obj")
    assert result == {c: True for c in range(K + M)}
    return result


def scrub_detects_bitrot(env):
    be, bus = env.cluster()
    env.write(be, bus, "obj", 0, payload(2 * STRIPE, seed=17))
    store = bus.handlers[3].store
    obj = env.S.GObject("obj", 3)
    raw = bytearray(store.read(obj))
    raw[7] ^= 0xFF
    store.queue_transaction(env.S.Transaction().write(obj, 0, bytes(raw)))
    result = be.be_deep_scrub("obj")
    assert result[3] is False
    assert all(result[c] for c in range(K + M) if c != 3)
    return result


def scrub_hashless_locates_bitrot(env):
    """After an overwrite clears the chunk hashes, deep scrub falls back
    to the spare equations (one decode per candidate) to locate rot."""
    be, bus = env.cluster()
    env.write(be, bus, "obj", 0, payload(2 * STRIPE, seed=18))
    env.write(be, bus, "obj", 10, payload(20, seed=19))
    assert not be._hinfo("obj").has_chunk_hash()
    store = bus.handlers[4].store
    obj = env.S.GObject("obj", 4)
    raw = bytearray(store.read(obj))
    raw[3] ^= 0x5A
    store.queue_transaction(env.S.Transaction().write(obj, 0, bytes(raw)))
    result = be.be_deep_scrub("obj")
    assert result[4] is False
    return result


# -- TestReviewRegressions ------------------------------------------------------

def review_truncate_shrink(env):
    be, bus = env.cluster()
    data = payload(2 * STRIPE, seed=20)
    env.write(be, bus, "obj", 0, data)
    done = []
    be.submit_transaction(env.S.PGTransaction().truncate_to("obj", STRIPE),
                          on_commit=done.append)
    bus.deliver_all()
    assert done
    assert be.object_size("obj") == STRIPE
    out = env.read(be, bus, "obj", 0, 2 * STRIPE)
    assert out["result"]["obj"][0][2] == data[:STRIPE]
    for chunk in range(1, K + M):
        assert bus.handlers[chunk].store.stat(
            env.S.GObject("obj", chunk)) == CHUNK
    return out


def review_truncate_unaligned(env):
    be, bus = env.cluster()
    data = payload(2 * STRIPE, seed=21)
    env.write(be, bus, "obj", 0, data)
    cut = STRIPE + 10
    be.submit_transaction(env.S.PGTransaction().truncate_to("obj", cut))
    bus.deliver_all()
    out = env.read(be, bus, "obj", 0, 2 * STRIPE)
    got = out["result"]["obj"][0][2]
    assert got[:cut] == data[:cut]
    assert got[cut:] == b"\0" * (2 * STRIPE - len(got[:cut]))
    return out


def review_no_lost_update(env):
    be, bus = env.cluster()
    base = payload(2 * STRIPE, seed=22)
    env.write(be, bus, "obj", 0, base)
    done = []
    pa, pb, pc = payload(10, seed=23), payload(STRIPE, seed=24), \
        payload(10, seed=25)
    for off, p in ((0, pa), (0, pb), (20, pc)):
        be.submit_transaction(env.S.PGTransaction().write("obj", off, p),
                              on_commit=done.append)
    bus.deliver_all()
    assert len(done) == 3
    want = bytearray(base)
    want[:STRIPE] = pb
    want[20:30] = pc
    out = env.read(be, bus, "obj", 0, 2 * STRIPE)
    assert out["result"]["obj"][0][2] == bytes(want)
    return out


def review_shard_death_during_rmw_read(env):
    be, bus = env.cluster()
    base = payload(2 * STRIPE, seed=26)
    env.write(be, bus, "obj", 0, base)
    done = []
    patch = payload(10, seed=27)
    be.submit_transaction(env.S.PGTransaction().write("obj", 5, patch),
                          on_commit=done.append)
    bus.mark_down(1)
    bus.deliver_all()
    assert done, "write hung after read-shard death"
    want = bytearray(base)
    want[5:15] = patch
    out = env.read(be, bus, "obj", 0, 2 * STRIPE)
    assert out["result"]["obj"][0][2] == bytes(want)
    return out


def review_shard_death_during_client_read(env):
    be, bus = env.cluster()
    data = payload(2 * STRIPE, seed=28)
    env.write(be, bus, "obj", 0, data)
    out = {}
    be.objects_read_and_reconstruct(
        {"obj": [(0, len(data))]},
        lambda result, errors: out.update(result=result, errors=errors))
    bus.mark_down(2)
    bus.deliver_all()
    assert out and not out["errors"]
    assert out["result"]["obj"][0][2] == data
    return out


def review_shard_death_during_recovery_read(env):
    be, bus = env.cluster()
    data = payload(2 * STRIPE, seed=29)
    env.write(be, bus, "obj", 0, data)
    lost = env.S.GObject("obj", 5)
    bus.handlers[5].store.queue_transaction(env.S.Transaction().remove(lost))
    rop = be.recover_object("obj", {5})
    helper = min(rop._pending - {5, be.whoami})
    bus.mark_down(helper)
    bus.deliver_all()
    assert rop.state == env.S.RecoveryState.COMPLETE
    assert bus.handlers[5].store.read(lost) == \
        env.encode(be, data)[5].tobytes()
    return {"helper": helper, "state": rop.state}


def review_recovery_state_dropped(env):
    be, bus = env.cluster()
    env.write(be, bus, "obj", 0, payload(STRIPE, seed=30))
    bus.handlers[3].store.queue_transaction(
        env.S.Transaction().remove(env.S.GObject("obj", 3)))
    rop = be.recover_object("obj", {3})
    bus.deliver_all()
    assert rop.state == env.S.RecoveryState.COMPLETE
    assert not be.recovery_ops and not be._recovery_read_tids
    be.handle_push_reply(env.S.PushReply(3, "obj"))
    assert rop.state == env.S.RecoveryState.COMPLETE
    return rop.state


def review_memstore_stages_only_touched(env):
    S = env.S
    st = S.MemStore()
    a, b = S.GObject("a", 0), S.GObject("b", 0)
    st.queue_transaction(S.Transaction().write(a, 0, b"aaaa"))
    st.queue_transaction(S.Transaction().write(b, 0, b"bbbb"))
    t = S.Transaction().write(a, 0, b"xxxx")
    t.ops.append(("bogus", a))
    with pytest.raises(ValueError):
        st.queue_transaction(t)
    assert st.read(a) == b"aaaa"
    st.queue_transaction(S.Transaction().remove(a).write(a, 0, b"new"))
    assert st.read(a) == b"new" and st.read(b) == b"bbbb"
    return {"seq": st.committed_seq,
            "objects": [(g.oid, g.shard, st.read(g))
                        for g in st.list_objects()]}


def review_unrecoverable_rmw_redrives(env):
    be, bus = env.cluster()
    base = payload(2 * STRIPE, seed=31)
    env.write(be, bus, "obj", 0, base)
    done = []
    patch = payload(10, seed=32)
    be.submit_transaction(env.S.PGTransaction().write("obj", 5, patch),
                          on_commit=done.append)
    for s in (1, 2, 3):
        bus.mark_down(s)
    bus.deliver_all()
    assert not done
    bus.mark_up(1)
    bus.mark_up(2)
    bus.deliver_all()
    assert done, "write not re-driven after shards returned"
    want = bytearray(base)
    want[5:15] = patch
    out = env.read(be, bus, "obj", 0, 2 * STRIPE)
    assert out["result"]["obj"][0][2] == bytes(want)
    return out


def review_unrecoverable_recovery_redrives(env):
    be, bus = env.cluster()
    data = payload(2 * STRIPE, seed=33)
    env.write(be, bus, "obj", 0, data)
    lost = env.S.GObject("obj", 5)
    bus.handlers[5].store.queue_transaction(env.S.Transaction().remove(lost))
    rop = be.recover_object("obj", {5})
    helpers = sorted(s for s in rop._pending if s != be.whoami)[:2]
    for s in helpers:
        bus.mark_down(s)
    bus.mark_down(4 if 4 not in helpers else 2)
    assert rop.state != env.S.RecoveryState.COMPLETE
    for s in helpers:
        bus.mark_up(s)
    bus.deliver_all()
    assert rop.state == env.S.RecoveryState.COMPLETE
    assert bus.handlers[5].store.read(lost) == \
        env.encode(be, data)[5].tobytes()
    return {"helpers": helpers, "state": rop.state}


def _drain_recovery_reads(be, bus, rop):
    for s in sorted(rop._pending):
        while bus.deliver_one(s):
            pass
    while bus.deliver_one(be.whoami):
        pass


def review_push_target_death_fails(env):
    be, bus = env.cluster()
    env.write(be, bus, "obj", 0, payload(STRIPE, seed=34))
    bus.handlers[5].store.queue_transaction(
        env.S.Transaction().remove(env.S.GObject("obj", 5)))
    states = []
    rop = be.recover_object("obj", {5},
                            on_complete=lambda r: states.append(r.state))
    _drain_recovery_reads(be, bus, rop)
    assert rop.state == env.S.RecoveryState.WRITING
    bus.mark_down(5)
    bus.deliver_all()
    assert rop.state == env.S.RecoveryState.FAILED
    assert states == [env.S.RecoveryState.FAILED]
    assert not be.recovery_ops
    return states


def review_push_target_death_sticky(env):
    be, bus = env.cluster()
    env.write(be, bus, "obj", 0, payload(STRIPE, seed=35))
    for shard in (4, 5):
        bus.handlers[shard].store.queue_transaction(
            env.S.Transaction().remove(env.S.GObject("obj", shard)))
    states = []
    rop = be.recover_object("obj", {4, 5},
                            on_complete=lambda r: states.append(r.state))
    _drain_recovery_reads(be, bus, rop)
    assert rop.state == env.S.RecoveryState.WRITING
    assert rop.pending_pushes == {4, 5}
    bus.mark_down(5)
    assert rop.state == env.S.RecoveryState.WRITING
    bus.deliver_all()
    assert rop.state == env.S.RecoveryState.FAILED
    assert states == [env.S.RecoveryState.FAILED]
    return states


# -- tests/test_pg_log.py: make_cluster cases ---------------------------------

def _w(env, be, bus, oid, data):
    be.submit_transaction(env.S.PGTransaction().write(oid, 0, data))
    bus.deliver_all()


def _r(env, be, bus, oid, length):
    out = env.read(be, bus, oid, 0, length)
    assert not out.get("errors"), out["errors"]
    return out["result"][oid][0][2][:length]


def log_entries_reach_every_shard(env):
    be, bus = env.cluster()
    _w(env, be, bus, "obj", payload(STRIPE))
    _w(env, be, bus, "obj2", payload(STRIPE, 1))
    assert be.pg_log.head == 2
    heads = {}
    for shard in be.acting:
        h = bus.handlers[shard]
        log = h.pg_log if shard != be.whoami else be.local_shard.pg_log
        assert log.head == 2
        assert [e.oid for e in log.entries] == ["obj", "obj2"]
        heads[shard] = list(log.entries)
    return heads


def log_delete_logs_delete(env):
    be, bus = env.cluster()
    _w(env, be, bus, "obj", payload(STRIPE))
    be.submit_transaction(env.S.PGTransaction().delete("obj"))
    bus.deliver_all()
    assert be.pg_log.entries[-1].op == env.S.OP_DELETE
    return be.pg_log.entries[-1]


def log_down_shard_stays_behind(env):
    be, bus = env.cluster()
    _w(env, be, bus, "obj", payload(STRIPE))
    bus.mark_down(3)
    _w(env, be, bus, "obj2", payload(STRIPE, 1))
    assert be.pg_log.head == 2 and bus.handlers[3].pg_log.head == 1
    return bus.handlers[3].pg_log.head


def log_clean_shard_repair_is_free(env):
    be, bus = env.cluster(counting=True)
    for i in range(5):
        _w(env, be, bus, f"o{i}", payload(STRIPE, i))
    before = bus.sent.get("PushOp", 0)
    rop = be.start_shard_repair(3)
    bus.deliver_all()
    assert rop.state == env.S.RepairState.COMPLETE and rop.plan == "clean"
    assert bus.sent.get("PushOp", 0) == before
    return {"rop": (rop.state, rop.plan), "sent": bus.sent}


def log_missed_n_writes_replays_exactly_n(env):
    be, bus = env.cluster(counting=True)
    for i in range(10):
        _w(env, be, bus, f"base{i}", payload(STRIPE, i))
    bus.mark_down(4)
    for i in range(3):
        _w(env, be, bus, f"missed{i}", payload(STRIPE, 100 + i))
    bus.mark_up(4)
    pushes = bus.sent.get("PushOp", 0)
    rop = be.start_shard_repair(4)
    bus.deliver_all()
    assert rop.state == env.S.RepairState.COMPLETE and rop.plan == "log"
    assert rop.objects_repaired == 3
    assert bus.sent.get("PushOp", 0) - pushes == 3
    assert bus.handlers[4].pg_log.head == be.pg_log.head
    return {"rop": (rop.state, rop.plan, rop.objects_repaired),
            "sent": bus.sent}


def log_repeated_writes_replay_once(env):
    be, bus = env.cluster(counting=True)
    _w(env, be, bus, "obj", payload(STRIPE))
    bus.mark_down(4)
    for i in range(5):
        _w(env, be, bus, "obj", payload(STRIPE, i + 1))
    bus.mark_up(4)
    before = bus.sent.get("PushOp", 0)
    rop = be.start_shard_repair(4)
    bus.deliver_all()
    assert rop.state == env.S.RepairState.COMPLETE
    assert rop.objects_repaired == 1
    assert bus.sent.get("PushOp", 0) - before == 1
    return {"rop": (rop.state, rop.plan), "sent": bus.sent}


def log_missed_delete_replays_delete(env):
    be, bus = env.cluster(counting=True)
    _w(env, be, bus, "obj", payload(STRIPE))
    bus.mark_down(4)
    be.submit_transaction(env.S.PGTransaction().delete("obj"))
    bus.deliver_all()
    bus.mark_up(4)
    assert env.S.GObject("obj", 4) in bus.handlers[4].store.objects
    rop = be.start_shard_repair(4)
    bus.deliver_all()
    assert rop.state == env.S.RepairState.COMPLETE
    assert env.S.GObject("obj", 4) not in bus.handlers[4].store.objects
    return {"rop": (rop.state, rop.plan), "sent": bus.sent}


def log_past_horizon_backfill(env):
    be, bus = env.cluster(counting=True)
    be.pg_log.max_entries = 4
    for i in range(3):
        _w(env, be, bus, f"keep{i}", payload(STRIPE, i))
    bus.mark_down(4)
    for i in range(8):
        _w(env, be, bus, f"new{i}", payload(STRIPE, 50 + i))
    assert be.pg_log.tail > bus.handlers[4].pg_log.head
    bus.mark_up(4)
    rop = be.start_shard_repair(4)
    bus.deliver_all()
    assert rop.state == env.S.RepairState.COMPLETE
    assert rop.plan == "backfill" and rop.objects_repaired == 11
    rop2 = be.start_shard_repair(4)
    bus.deliver_all()
    assert rop2.plan == "clean"
    return {"rop": (rop.state, rop.plan, rop2.plan), "sent": bus.sent}


def log_divergent_shard_rewound(env):
    S = env.S
    be, bus = env.cluster(counting=True)
    _w(env, be, bus, "obj", payload(STRIPE))
    shard = bus.handlers[4]
    shard.pg_log.record(S.PGLogEntry(99, "ghost", S.OP_MODIFY))
    shard.store.queue_transaction(
        S.Transaction().write(S.GObject("ghost", 4), 0, b"x" * CHUNK))
    rop = be.start_shard_repair(4)
    bus.deliver_all()
    assert rop.state == S.RepairState.COMPLETE
    assert S.GObject("ghost", 4) not in shard.store.objects
    assert shard.pg_log.head == be.pg_log.head
    assert [e.oid for e in shard.pg_log.entries] == \
        [e.oid for e in be.pg_log.entries]
    return {"rop": (rop.state, rop.plan), "sent": bus.sent}


def log_revived_primary_repairs_itself(env):
    S = env.S
    be, bus = env.cluster(counting=True)
    _w(env, be, bus, "pre", payload(STRIPE))
    bus.mark_down(0)
    _w(env, be, bus, "missed", payload(STRIPE, 7))
    assert be.local_shard.pg_log.head == 1 < be.pg_log.head
    bus.mark_up(0)
    rop = be.start_shard_repair(0)
    bus.deliver_all()
    assert rop.state == S.RepairState.COMPLETE
    assert rop.plan == "log" and rop.objects_repaired == 1
    assert S.GObject("missed", 0) in be.local_shard.store.objects
    assert _r(env, be, bus, "missed", STRIPE) == payload(STRIPE, 7)
    return {"rop": (rop.state, rop.plan), "sent": bus.sent}


def log_revived_primary_backfills(env):
    be, bus = env.cluster(counting=True)
    be.pg_log.max_entries = 3
    _w(env, be, bus, "pre", payload(STRIPE))
    bus.mark_down(0)
    for i in range(6):
        _w(env, be, bus, f"n{i}", payload(STRIPE, i))
    bus.mark_up(0)
    rop = be.start_shard_repair(0)
    bus.deliver_all()
    assert rop.state == env.S.RepairState.COMPLETE
    assert rop.plan == "backfill"
    return {"rop": (rop.state, rop.plan), "sent": bus.sent}


def log_repair_survives_interleaved_writes(env):
    be, bus = env.cluster(counting=True)
    for i in range(4):
        _w(env, be, bus, f"o{i}", payload(STRIPE, i))
    bus.mark_down(4)
    _w(env, be, bus, "missed", payload(STRIPE, 9))
    bus.mark_up(4)
    rop = be.start_shard_repair(4)
    be.submit_transaction(
        env.S.PGTransaction().write("concurrent", 0, payload(STRIPE, 10)))
    bus.deliver_all()
    assert rop.state == env.S.RepairState.COMPLETE
    rop2 = be.start_shard_repair(4)
    bus.deliver_all()
    assert rop2.state == env.S.RepairState.COMPLETE
    assert bus.handlers[4].pg_log.head == be.pg_log.head
    return {"rop": (rop.state, rop.plan, rop2.plan), "sent": bus.sent}


# -- tests/test_min_size.py ----------------------------------------------------

MS_CHUNK, MIN_SIZE = 64, K + 1
MS_STRIPE = K * MS_CHUNK


def _ms(env):
    return env.cluster(chunk=MS_CHUNK, min_size=MIN_SIZE)


def _ms_read(env, be, bus, oid, length):
    out = env.read(be, bus, oid, 0, length)
    if out.get("errors"):
        raise IOError(out["errors"])
    return out["result"][oid][0][2]


def ms_write_parks_below_min_size(env):
    be, bus = _ms(env)
    committed = []
    for s in (4, 5):
        bus.mark_down(s)
    assert not be.is_active()
    be.submit_transaction(
        env.S.PGTransaction().write("obj", 0, payload(MS_STRIPE, 7)),
        on_commit=committed.append)
    bus.deliver_all()
    assert not committed and len(be.waiting_state) == 1
    for s in range(K + M):
        assert not env.store(bus, s).objects
    return committed


def ms_parked_write_commits_after_revive(env):
    be, bus = _ms(env)
    committed = []
    for s in (4, 5):
        bus.mark_down(s)
    be.submit_transaction(
        env.S.PGTransaction().write("obj", 0, payload(MS_STRIPE, 7)),
        on_commit=committed.append)
    bus.deliver_all()
    assert not committed
    bus.mark_up(4)
    bus.deliver_all()
    assert committed
    assert _ms_read(env, be, bus, "obj", MS_STRIPE) == payload(MS_STRIPE, 7)
    return committed


def ms_active_write_acks(env):
    be, bus = _ms(env)
    committed = []
    bus.mark_down(5)
    be.submit_transaction(
        env.S.PGTransaction().write("obj", 0, payload(MS_STRIPE, 7)),
        on_commit=committed.append)
    bus.deliver_all()
    assert committed
    return committed


def _ms_partial_write(env, be, bus, data2, shards=(1, 2)):
    committed = []
    be.submit_transaction(env.S.PGTransaction().write("obj", 0, data2),
                          on_commit=committed.append)
    progressed = True
    while progressed:
        progressed = any([bus.deliver_one(s) for s in shards])
    bus.mark_down(3)
    bus.mark_down(4)
    bus.deliver_all()
    assert not committed, "write acked below min_size"
    return committed


def ms_partial_write_rolls_back(env):
    be, bus = _ms(env)
    data1, data2 = payload(MS_STRIPE, 1), payload(MS_STRIPE, 2)
    env.write(be, bus, "obj", 0, data1)
    old = {s: env.store(bus, s).read(env.S.GObject("obj", s))
           for s in range(K + M)}
    _ms_partial_write(env, be, bus, data2)
    for s in (0, 1, 2, 5):
        assert env.store(bus, s).read(env.S.GObject("obj", s)) == old[s]
    assert _ms_read(env, be, bus, "obj", MS_STRIPE) == data1
    assert len(be.waiting_state) == 1
    return old


def ms_rolled_back_write_reexecutes(env):
    be, bus = _ms(env)
    data1, data2 = payload(MS_STRIPE, 1), payload(MS_STRIPE, 2)
    env.write(be, bus, "obj", 0, data1)
    committed = _ms_partial_write(env, be, bus, data2)
    bus.mark_up(3)
    bus.deliver_all()
    assert committed
    assert _ms_read(env, be, bus, "obj", MS_STRIPE) == data2
    assert be.pg_log.head == 2
    return committed


def ms_rollback_restores_log_and_hinfo(env):
    be, bus = _ms(env)
    env.write(be, bus, "obj", 0, payload(MS_STRIPE, 1))
    head = be.pg_log.head
    version = be._hinfo("obj").version
    _ms_partial_write(env, be, bus, payload(MS_STRIPE, 2), shards=(1,))
    assert be.pg_log.head == head
    assert be._hinfo("obj").version == version
    return be._hinfo("obj").to_dict()


def ms_roll_forward_drops_rollback_data(env):
    be, bus = _ms(env)
    env.write(be, bus, "obj", 0, payload(MS_STRIPE, 7))
    for s in range(K + M):
        h = bus.handlers[s]
        shard = h if isinstance(h, env.S.OSDShard) else h.local_shard
        assert not shard.pending_rollbacks
    return be.committed_to


def ms_deep_scrub_clean_after_rollback(env):
    be, bus = _ms(env)
    env.write(be, bus, "obj", 0, payload(MS_STRIPE, 1))
    committed = _ms_partial_write(env, be, bus, payload(MS_STRIPE, 2))
    bus.mark_up(3)
    bus.deliver_all()
    bus.mark_up(4)
    bus.deliver_all()
    assert committed
    report = be.be_deep_scrub("obj")
    assert all(report.values()), report
    return report


def ms_revived_shard_excluded_until_repaired(env):
    be, bus = _ms(env)
    env.write(be, bus, "obj", 0, payload(MS_STRIPE, 7))
    bus.mark_down(5)
    be.submit_transaction(
        env.S.PGTransaction().write("obj", 0, payload(MS_STRIPE, seed=9)))
    bus.deliver_all()
    bus.mark_up(5)
    assert 5 in be.stale and 5 not in be.current_shards()
    bus.deliver_all()
    assert 5 not in be.stale and 5 in be.current_shards()
    report = be.be_deep_scrub("obj")
    assert all(report.values())
    return report


def ms_stale_shard_not_in_fanout(env):
    be, bus = _ms(env)
    bus.mark_down(5)
    bus.mark_up(5)
    committed = []
    be.submit_transaction(
        env.S.PGTransaction().write("obj", 0, payload(MS_STRIPE, 7)),
        on_commit=committed.append)
    assert not any(isinstance(m, env.S.ECSubWrite) and m.log_entries
                   for m in bus.queues.get(5, ()))
    bus.deliver_all()
    assert committed
    return committed


PIPELINE = [pipe_write_then_read, pipe_shards_hold_chunks,
            pipe_unaligned_read, pipe_read_trims_to_object_size,
            pipe_rmw_partial_overwrite, pipe_append_grows_object,
            pipe_overlapping_writes_use_cache, pipe_delete]
DEGRADED = [degraded_read_reconstructs, degraded_too_many_failures,
            degraded_shard_error_triggers_retry, degraded_fast_read,
            recovery_restores_lost_shard, recovery_after_missed_write]
CLAY = [clay_write_read_roundtrip, clay_recovery_uses_fractional_reads,
        clay_degraded_read_reconstructs]
SCRUB = [scrub_clean, scrub_detects_bitrot, scrub_hashless_locates_bitrot]
REVIEW = [review_truncate_shrink, review_truncate_unaligned,
          review_no_lost_update, review_shard_death_during_rmw_read,
          review_shard_death_during_client_read,
          review_shard_death_during_recovery_read,
          review_recovery_state_dropped, review_memstore_stages_only_touched,
          review_unrecoverable_rmw_redrives,
          review_unrecoverable_recovery_redrives,
          review_push_target_death_fails, review_push_target_death_sticky]
PG_LOG = [log_entries_reach_every_shard, log_delete_logs_delete,
          log_down_shard_stays_behind, log_clean_shard_repair_is_free,
          log_missed_n_writes_replays_exactly_n,
          log_repeated_writes_replay_once, log_missed_delete_replays_delete,
          log_past_horizon_backfill, log_divergent_shard_rewound,
          log_revived_primary_repairs_itself, log_revived_primary_backfills,
          log_repair_survives_interleaved_writes]
MIN_SIZE_CASES = [ms_write_parks_below_min_size,
                  ms_parked_write_commits_after_revive, ms_active_write_acks,
                  ms_partial_write_rolls_back,
                  ms_rolled_back_write_reexecutes,
                  ms_rollback_restores_log_and_hinfo,
                  ms_roll_forward_drops_rollback_data,
                  ms_deep_scrub_clean_after_rollback,
                  ms_revived_shard_excluded_until_repaired,
                  ms_stale_shard_not_in_fanout]


def _ids(cases):
    return [c.__name__ for c in cases]


@pytest.mark.parametrize("scenario", PIPELINE + DEGRADED + SCRUB + REVIEW,
                         ids=_ids(PIPELINE + DEGRADED + SCRUB + REVIEW))
def test_backend_matches_reference(scenario):
    run_both(scenario)


@pytest.mark.parametrize("scenario", CLAY, ids=_ids(CLAY))
def test_clay_backend_matches_reference(scenario):
    run_both(scenario, kind="clay")


@pytest.mark.parametrize("scenario", PG_LOG, ids=_ids(PG_LOG))
def test_pg_log_cluster_matches_reference(scenario):
    run_both(scenario)


@pytest.mark.parametrize("scenario", MIN_SIZE_CASES, ids=_ids(MIN_SIZE_CASES))
def test_min_size_matches_reference(scenario):
    run_both(scenario)


# one case per path with the JAX package on its device codec (JAX-CPU)
JAX_DEVICE = [pipe_write_then_read, pipe_rmw_partial_overwrite,
              degraded_read_reconstructs, recovery_restores_lost_shard,
              log_missed_n_writes_replays_exactly_n]


@pytest.mark.parametrize("scenario", JAX_DEVICE, ids=_ids(JAX_DEVICE))
def test_backend_matches_reference_on_jax_device(scenario):
    run_both(scenario, jax_device="jax")


def test_wide_code_at_4k_stripe_unit():
    """k=8 m=4 at Ceph's 4 KiB stripe unit: write, read, degraded read of
    two non-primary shards, recovery of one."""
    def scenario(env):
        be, bus = env.cluster(chunk=4096)
        stripe = 8 * 4096
        data = {f"o{i}": payload(3 * stripe + 1000 * i, seed=40 + i)
                for i in range(3)}
        for oid, d in data.items():
            env.write(be, bus, oid, 0, d)
        reads = [env.read(be, bus, oid, 0, len(d)) for oid, d in data.items()]
        bus.mark_down(1)
        bus.mark_down(9)
        degraded = [env.read(be, bus, oid, 0, len(d))
                    for oid, d in data.items()]
        for out, (oid, d) in zip(reads + degraded, list(data.items()) * 2):
            assert not out["errors"] and out["result"][oid][0][2] == d
        bus.mark_up(1)
        bus.mark_up(9)
        bus.deliver_all()
        rop = be.recover_object("o1", {3})
        bus.deliver_all()
        assert rop.state == env.S.RecoveryState.COMPLETE
        return {"reads": reads, "degraded": degraded, "rop": rop.state}
    run_both(scenario, k=8, m=4)


# -- the PG log structure itself ----------------------------------------------

def _log_ops(S):
    log = S.PGLog(max_entries=4)
    out = [log.append("a"), log.append("b"), log.append("a", S.OP_DELETE)]
    out.append(log.catch_up_plan(0))
    out.append(log.catch_up_plan(3))
    for i in range(4):
        log.append(f"c{i}")
    log.maybe_trim()
    out += [(log.head, log.tail), log.catch_up_plan(1),
            log.entries_after(5), log.last_version_of("a")]
    out.append(log.divergent_oids([S.PGLogEntry(6, "c2"),
                                   S.PGLogEntry(8, "ghost")]))
    out.append(log.rewind(5))
    out.append(S.dedup_latest([S.PGLogEntry(1, "x"), S.PGLogEntry(2, "y"),
                               S.PGLogEntry(3, "x")]))
    other = S.PGLog()
    other.merge_authoritative(list(log.entries), log.head, 0, log.tail)
    out.append((other.head, other.tail, list(other.entries)))
    return out


def test_pg_log_structure_matches_reference():
    assert norm(_log_ops(PORT)) == norm(_log_ops(JAX))
