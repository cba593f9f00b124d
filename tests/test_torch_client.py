"""The port's librados client (``client/``: the objecter, ``Rados`` /
``IoCtx`` and the striper) against the JAX package's, on the CPU.

Every scenario runs on both packages' ``MiniCluster`` (12 OSDs on 4
hosts, ``chunk_size`` 128, k=4 m=2: ``jax_rs`` with ``device=numpy``
against ``torch_rs`` with ``device=cpu``) through
``test_torch_cluster.run_both``, which holds what the scenario observed
and the whole cluster state (every OSD store, PG logs, routing, wire
totals) equal bitwise.  The objecter stamps ``time.monotonic()``: both
packages read one fixed clock here.
"""
from __future__ import annotations

import importlib
import types

import pytest

from test_torch_cluster import (JAX, PORT, Env,  # noqa: F401
                                fixed_clock, payload, run_both)

GRACE = 20


@pytest.fixture(autouse=True)
def fixed_monotonic(monkeypatch):
    clock = types.SimpleNamespace(monotonic=lambda: 1000.0,
                                  time=lambda: 1.7e9)
    for side in (JAX, PORT):
        mod = importlib.import_module(f"{side.pkg}.client.objecter")
        monkeypatch.setattr(mod, "time", clock)


def client(env):
    return importlib.import_module(f"{env.S.pkg}.client")


def rados_mod(env):
    return importlib.import_module(f"{env.S.pkg}.client.rados")


def striper_mod(env):
    return importlib.import_module(f"{env.S.pkg}.client.striper")


def _remap(c, pid, oid):
    """Down and auto-out a shard of ``oid``'s PG through the monitor:
    CRUSH remaps the PG and the cluster backfills it."""
    mon = c.attach_monitor()
    g = c.pg_group(pid, oid)
    victim = g.acting[1]
    for r in [o for o in range(12) if o != victim][:4]:
        mon.prepare_failure(victim, r, 0.0, GRACE + 1)
    mon.propose_pending(GRACE + 1)
    mon.tick(GRACE + c.cct.conf.get("mon_osd_down_out_interval") + 10)
    return mon, list(g.acting), list(c.pg_group(pid, oid).acting)


# -- the objecter ------------------------------------------------------------

def scn_objecter_basics(env):
    c = env.cluster()
    pid = env.ec_pool(c)
    rep = c.create_replicated_pool("rep", 3, 4)
    oc = client(env).Objecter(c)
    out = []
    for p in (pid, rep):
        acked = []
        oc.write(p, "obj", payload(2048, p), on_complete=acked.append)
        out.append((acked, oc.read(p, "obj", 2048) == payload(2048, p)))
    out.append([oc._calc_target(pid, f"o{i}") for i in range(16)])
    out.append([(c.pg_group(pid, f"o{i}").pgid.ps,
                 list(c.pg_group(pid, f"o{i}").acting)) for i in range(16)])
    out.append((oc.resends, oc.stale_rejects, oc.next_tid,
                oc.check_op_timeouts(now=1e9)))
    oc.close()
    return out


def scn_objecter_resend(env):
    """A client whose map predates a remap: its write is rejected as
    stale, it refreshes its map and resends to the new acting set; a read
    does the same; a subscribed client never goes stale."""
    c = env.cluster({"mon_osd_down_out_interval": 60})
    pid = env.ec_pool(c)
    oc = client(env).Objecter(c)
    oc.write(pid, "obj", payload(1024, 1))
    stale = oc.osdmap.epoch
    mon, old, new = _remap(c, pid, "obj")
    acked = []
    oc.write(pid, "obj", payload(1024, 2), on_complete=acked.append)
    out = [old, new, stale, oc.osdmap.epoch, acked, oc.stale_rejects,
           oc.resends, c.get(pid, "obj", 1024) == payload(1024, 2)]
    oc2 = client(env).Objecter(c)
    oc2.attach(mon)
    out.append(oc2.read(pid, "obj", 1024) == payload(1024, 2))
    g = c.pg_group(pid, "obj")
    v = [o for o in g.acting if o != g.backend.whoami][0]
    for r in [o for o in range(12) if o != v][:4]:
        mon.prepare_failure(v, r, 2000.0, 2000.0 + GRACE + 1)
    mon.propose_pending(2000.0 + GRACE + 1)
    mon.tick(2000.0 + GRACE + 200)
    oc2.write(pid, "obj", payload(1024, 3))
    out += [oc2.osdmap.epoch, oc2.stale_rejects, oc2.resends,
            oc.read(pid, "obj", 1024) == payload(1024, 3),
            oc.stale_rejects, oc.resends]
    oc.close()
    oc2.close()
    return out


def scn_objecter_resend_warm_memo(env):
    """The objecter's per-PG targets are warm under the old map when a
    remap moves ``obj``'s PG: the write is rejected as stale, the newer
    map empties the memo, and the resend lands on the new acting set."""
    c = env.cluster({"mon_osd_down_out_interval": 60})
    pid = env.ec_pool(c)
    oc = client(env).Objecter(c)
    names = [f"o{i}" for i in range(24)] + ["obj"]
    warm = [oc._calc_target(pid, n) for n in names]
    oc.write(pid, "obj", payload(1024, 1))
    stale = oc._calc_target(pid, "obj")
    mon, old, new = _remap(c, pid, "obj")
    acked = []
    oc.write(pid, "obj", payload(1024, 2), on_complete=acked.append)
    moved = oc._calc_target(pid, "obj")
    g = c.pg_group(pid, "obj")
    assert stale == warm[-1] and list(stale[2]) == old
    assert moved != stale
    assert moved == (g.pgid.ps, g.backend.whoami, tuple(g.acting))
    assert list(moved[2]) == new
    out = [warm, stale, moved, acked, oc.stale_rejects, oc.resends,
           c.get(pid, "obj", 1024) == payload(1024, 2)]
    if env.S is PORT:
        # one miss a PG of the warm lap; then obj's first write, `stale`
        # and the rejected send hit the old map's memo; the newer map's
        # scan of the in-flight write misses, and the resend and `moved`
        # hit
        pgs = len({t[0] for t in warm})
        assert oc.perf.get("target_misses") == pgs + 1
        assert oc.perf.get("target_hits") == len(names) - pgs + 3 + 2
    oc.close()
    return out


@pytest.mark.parametrize("scenario", [scn_objecter_basics,
                                      scn_objecter_resend,
                                      scn_objecter_resend_warm_memo])
def test_objecter(scenario):
    run_both(scenario)


#: rados bench's object names (``benchmark_data_<host>_<pid>_object<N>``)
BENCH_NAMES = [f"benchmark_data_client0_4242_object{n}" for n in range(256)]


def _targets_across_epochs(env, hosts: int, per_host: int,
                           profile: dict | None = None):
    """The 256 ``rados bench`` names on an EC 8+4 pool of ``pg_num`` 32
    over ``hosts`` hosts through three maps, each a monitor commit the
    objecter is subscribed to: the pool's first map, an OSD marked out,
    then a ``pg_temp`` and an upmap entry.  In each the objecter's
    targets are the mapping chain's on that map, and the port's memo
    runs the chain once for each PG touched."""
    osdmap = importlib.import_module(f"{env.S.pkg}.osdmap")
    c = env.S.MiniCluster(n_osds=hosts * per_host, osds_per_host=per_host,
                          chunk_size=128, cct=env.S.Context({}))
    env.clusters.append(c)
    pid = c.create_ec_pool("bench", env.profile(k=8, m=4) | (profile or {}),
                           pg_num=32)
    mon = c.attach_monitor()
    oc = client(env).Objecter(c)
    oc.attach(mon)
    out = []

    def lap():
        hits, misses = (oc.perf.get(k) if env.S is PORT else 0
                        for k in ("target_hits", "target_misses"))
        got = [oc._calc_target(pid, n) for n in BENCH_NAMES]
        chain = {}
        for ps in sorted({t[0] for t in got}):
            acting = oc.osdmap.pg_to_up_acting_osds(osdmap.PG(pid, ps))[2]
            chain[ps] = (acting[0] if acting else -1, tuple(acting))
        assert got == [(t[0], *chain[t[0]]) for t in got]
        if env.S is PORT:
            assert oc.perf.get("target_misses") - misses == len(chain)
            assert oc.perf.get("target_hits") - hits == \
                len(BENCH_NAMES) - len(chain)
        out.append((oc.osdmap.epoch, got))
        return chain

    first = lap()
    victim = first[min(first)][1][3]
    mon.pending.new_weight[victim] = 0
    mon.propose_pending(1.0)
    second = lap()
    assert all(victim not in t[1] for t in second.values())
    temp_ps = min(second)
    acting = list(second[temp_ps][1])
    acting[0], acting[1] = acting[1], acting[0]
    mon.pending.new_pg_temp[osdmap.PG(pid, temp_ps)] = acting
    # the upmap moves a chunk to another OSD of the same host
    upmap_ps, src, dst = next(
        (ps, src, dst) for ps in sorted(second)[1:]
        for src in second[ps][1]
        for dst in range(src - src % per_host, src - src % per_host
                         + per_host)
        if dst != victim and dst not in second[ps][1])
    mon.pending.new_pg_upmap_items[osdmap.PG(pid, upmap_ps)] = [(src, dst)]
    mon.propose_pending(2.0)
    third = lap()
    assert third[temp_ps] == (acting[0], tuple(acting))
    assert dst in third[upmap_ps][1] and src not in third[upmap_ps][1]
    assert [e for e, _ in out] == [out[0][0] + i for i in range(3)]
    oc.close()
    return out


def test_objecter_targets_across_epochs():
    """Both packages over 13 hosts of 2 OSDs: the JAX package's pools
    take no ``crush-failure-domain`` key, so this pool has the rule both
    make with hosts enough for 12 chunks, ``chooseleaf indep 12 type
    host``."""
    run_both(lambda env: _targets_across_epochs(env, 13, 2))


def test_objecter_targets_across_epochs_on_the_cells_pool():
    """The port alone on the cluster cell's pool: 12 hosts of 4 OSDs,
    ``crush-failure-domain=host`` (Ceph's indep rule with its tries)."""
    env = Env(PORT)
    try:
        _targets_across_epochs(env, 12, 4, {"crush-failure-domain": "host"})
    finally:
        for c in env.clusters:
            c.shutdown()


def test_status_sweeps_objecter_timeouts():
    """``status()`` sweeps every objecter of the cluster: a parked op ages
    past ``osd_op_complaint_time`` onto ``slow_ops``."""
    def scenario(env):
        c = env.cluster({"osd_op_complaint_time": 0.0})
        pid = env.ec_pool(c)
        oc = client(env).Objecter(c)
        g = c.pg_group(pid, "p")
        for o in g.acting[1:4]:
            c.bus.mark_down(o)
        oc.write(pid, "p", payload(700))       # parked: PG inactive
        c.status()
        out = [sorted(oc.inflight), oc.perf.get("slow_ops")]
        for o in g.acting[1:4]:
            c.bus.mark_up(o)
        c.deliver_all()
        out.append(sorted(oc.inflight))
        out.append(c.get(pid, "p", 700) == payload(700))
        oc.close()
        return out
    obs, _ = run_both(scenario)
    assert obs[1] == 1 and obs[2] == ()


# -- Rados / IoCtx -------------------------------------------------------------

def scn_ioctx(env):
    R = rados_mod(env)
    ops = env.S.ops
    c = env.cluster()
    env.ec_pool(c, "data")
    c.create_replicated_pool("meta", 3, 4)
    r = R.Rados(c)
    io = r.open_ioctx("data")
    out = [r.pool_list(), r.health()]
    io.write_full("obj", b"hello world")
    io.append("obj", b"!")
    io.write("obj", b"J", offset=0)
    out += [io.read("obj"), io.stat("obj")[0], io.list_objects()]
    io.set_xattr("obj", "k", b"v")
    out += [io.get_xattr("obj", "k"), io.get_xattrs("obj")]
    io.rm_xattr("obj", "k")
    with pytest.raises(IOError):
        io.get_xattr("obj", "k")
    io.operate("obj", ops.ObjectOperation().setxattr("ver", b"1"))
    io.operate("obj", ops.ObjectOperation()
               .cmpxattr("ver", ops.CMPXATTR_EQ, b"1")
               .write_full(b"v2").setxattr("ver", b"2"))
    out.append(io.read("obj"))
    io.write_full("s", payload(300, 3))
    sid = io.snap_create("before")
    io.write_full("s", payload(200, 4))
    out.append(io.snap_list())
    io.set_read(sid)
    out.append(io.read("s"))
    io.write_full("s2", b"head")                 # writes go to the head
    io.set_read(None)
    out += [io.read("s"), io.list_objects()]
    io.snap_rollback("s", "before")
    out.append(io.read("s"))
    io.snap_remove("before")
    out.append(io.snap_list())
    got = []
    io.write_full("w", b"x")
    io2 = r.open_ioctx("data")
    ck = io.watch("w", lambda n, cookie, p: (got.append(p), b"ok")[1])
    ck2 = io2.watch("w", lambda n, cookie, p: b"two")
    out += [ck != ck2, sorted(io.notify("w", b"ding").values())]
    io.unwatch("w", ck)
    # the cookies come from a process-wide counter, which other tests in
    # the process move: the reply is held to the cookie that still
    # watches, not to its number
    again = io.notify("w", b"again")
    out += [list(again) == [ck2], list(again.values()), got]
    io.remove_object("obj")
    with pytest.raises(R.ObjectNotFound):
        io.stat("obj")
    meta = r.open_ioctx("meta")
    meta.write_full("m", b"m")
    meta.omap_set("m", {"a": b"1", "b": b"2"})
    out.append(meta.omap_get_vals("m"))
    st = r.cluster_stat()              # io_rates are wall-clock rates
    out.append((st["osdmap"], {k: v for k, v in st["pgmap"].items()
                               if k != "io_rates"}))
    return out


def scn_aio(env):
    R = rados_mod(env)
    ops = env.S.ops
    c = env.cluster()
    env.ec_pool(c, "data")
    io = R.Rados(c).open_ioctx("data")
    comps = [io.aio_operate(f"a{i}", ops.ObjectOperation()
                            .write_full(payload(300, i))) for i in range(4)]
    fired = []
    comps[0].set_complete_callback(lambda cp: fired.append(cp.result))
    out = [[cp.is_complete for cp in comps], not io.rados.objecter.inflight]
    out.append([cp.wait_for_complete() for cp in comps])
    out.append(fired)
    out.append([io.read(f"a{i}") == payload(300, i) for i in range(4)])
    # parked behind an inactive PG: completes on revival
    g = c.pg_group(io.pool_id, "a0")
    peers = [o for o in g.acting if o != g.backend.whoami][:3]
    for o in peers:
        c.bus.mark_down(o)
    out.append(io.rados.health()["status"])
    comp = io.aio_operate("a0", ops.ObjectOperation().write_full(b"v2"))
    blocked = importlib.import_module(f"{env.S.pkg}.cluster")
    with pytest.raises(blocked.BlockedWriteError):
        comp.wait_for_complete()
    out.append(comp.is_complete)
    for o in peers:
        c.bus.mark_up(o)
    c.deliver_all()
    out += [comp.is_complete, comp.result, io.read("a0"),
            io.rados.health()["status"]]
    return out


@pytest.mark.parametrize("scenario", [scn_ioctx, scn_aio])
def test_rados_ioctx(scenario):
    run_both(scenario)


# -- the striper ---------------------------------------------------------------

def scn_striper(env):
    S = striper_mod(env)
    R = rados_mod(env)
    c = env.cluster()
    env.ec_pool(c, "s")
    io = R.Rados(c).open_ioctx("s")
    st = S.RadosStriper(io, stripe_unit=512, stripe_count=3,
                        object_size=2048)
    big = payload(20_001, 1)
    out = [st.write_full("big", big), st.stat("big"),
           st.read("big") == big,
           st.read("big", 5000, offset=1234) == big[1234:6234],
           st.read("big", 10**9, offset=19_000) == big[19_000:]]
    lay = payload(512 * 3 * 2, 2)
    st.write_full("lay", lay)
    out.append([io.read(S.piece_name("lay", col)) for col in range(3)])
    out.append(io.get_xattr(S.piece_name("lay", 0), S.LAYOUT_ATTR))
    other = S.RadosStriper(io, stripe_unit=1024, stripe_count=2,
                           object_size=4096)
    out.append(other.read("big") == big)       # the writer's layout
    st.write_full("big", payload(900, 5))       # shrink: stale pieces go
    out += [st.stat("big"), sorted(io.list_objects())]
    g = c.pg_group(io.pool_id, S.piece_name("lay", 1))
    c.bus.mark_down(g.acting[2])
    out.append(st.read("lay") == lay)           # a degraded piece
    c.bus.mark_up(g.acting[2])
    c.deliver_all()
    out.append(st.remove("lay"))
    with pytest.raises(R.ObjectNotFound):
        st.stat("lay")
    st.write_full("empty", b"")
    out += [st.stat("empty"), st.read("empty"), sorted(io.list_objects())]
    return out


def test_striper():
    run_both(scn_striper)


def test_rados_over_a_durable_cluster(tmp_path):
    """``Rados`` on a durable cluster: a reopened cluster reads back what
    an IoCtx wrote, on both packages."""
    seen = {}
    for side in (JAX, PORT):
        d = tmp_path / side.pkg
        c = side.MiniCluster(n_osds=12, osds_per_host=3, chunk_size=128,
                             cct=side.Context(), data_dir=d,
                             store_backend="bluestore")
        prof = {"plugin": side.rs, "k": "4", "m": "2",
                "device": "numpy" if side is JAX else "cpu"}
        c.create_ec_pool("data", prof, pg_num=8)
        R = importlib.import_module(f"{side.pkg}.client.rados")
        io = R.Rados(c).open_ioctx("data")
        for i in range(6):
            io.write_full(f"o{i}", payload(900 + i, i))
        io.snap_create("s")
        io.write_full("o0", b"new")
        c.shutdown()
        c2 = side.MiniCluster.load(d, cct=side.Context())
        io2 = R.Rados(c2).open_ioctx("data")
        seen[side.pkg] = ([io2.read(f"o{i}") for i in range(6)],
                          io2.snap_list(), io2.list_objects())
        c2.shutdown()
    assert seen["ceph_tpu_torch"] == seen["ceph_tpu"]
    assert seen["ceph_tpu"][0][0] == b"new"
