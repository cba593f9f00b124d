"""soak_sweep: the seeded soak campaign, and a sweep of it over seeds.

The port's copy of the JAX package's soak campaign
(``tests/test_soak.py::test_soak_campaign``) and of the tool that sweeps
it (``tools/soak_sweep.py``).  One seeded campaign composes everything
against a model, as the reference's thrash-erasure-code suites run
workloads against a model-based checker while the Thrasher churns the
cluster (qa/suites/rados/thrash-erasure-code*,
src/test/osd/RadosModel.cc): op vectors with xattrs, pool snapshots
(reads at snaps checked against historical model states), shard kills
and revivals, scheduled scrub with injected bitrot, deletes, omap, and
wire-mode buses with reorder and duplicate faults, all interleaved by
one seeded RNG, with the model asserting after every step that acked
state is exactly observable state.  A sweep that finds a failure prints
the shrink hint: capture the action trace and greedily remove actions
to a minimal deterministic reproducer (the seed-113 chain reduced from
300 steps to 13 actions that way).

Where it differs from the JAX package's campaign:

- **The EC pool runs on the card.**  Its profile is ``torch_rs`` k=2
  m=2 with ``"device": device`` (``cuda`` by default): every EC write
  launches ``gf_apply.cu`` for its parity and ``crc32c.cu`` for its
  HashInfo, and a degraded read launches ``gf_apply.cu`` for its decode.
  ``device="cpu"`` runs the plain PyTorch versions (the tests);
  ``cuda`` without a card raises.  The replicated pool launches nothing.
- **It is a function, not a test**, and returns a report: the steps
  taken by action, the seconds on the host clock, the objects and snaps
  the model holds at the end and the final scrub's report (``{}``).
  Every draw of ``random.Random(seed)`` and
  ``np.random.default_rng(seed)`` is the reference's, in its order, so
  one seed is one campaign in both packages.
- **The model's checks raise** ``AssertionError`` even under ``-O``.

The wire-mode bus with faults is put in place by patching
``ceph_tpu_torch.cluster.MessageBus`` for the campaign; the patch is
undone in a ``finally``, whatever the campaign raises.

Usage:
    python -m ceph_tpu_torch.tools.soak_sweep [--seeds LO HI]
        [--pool-types ec rep] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import collections
import random
import sys
import time

import numpy as np

K, M = 2, 2
N_OSDS = 12
STEPS = 300
ACTIONS = ["write", "read", "snap", "snapread", "kill", "revive",
           "scrub", "rot", "delete", "omap"]
WEIGHTS = [30, 20, 5, 10, 10, 12, 5, 3, 5, 5]


def _expect(cond, what) -> None:
    if not cond:
        raise AssertionError(what)


def soak_campaign(seed: int, pool_type: str, device: str = "cuda",
                  steps: int = STEPS, on_settled=None) -> dict:
    """One seeded soak campaign on a 12-OSD MiniCluster whose pool is
    ``pool_type`` ("ec": torch_rs k=2 m=2 on ``device``; "rep": size 3).
    Raises ``AssertionError`` where acked state and observable state
    differ; returns the campaign's report.  ``on_settled(cluster)``, if
    given, runs once every check has passed, before the cluster shuts
    down (its telemetry is still live there)."""
    import ceph_tpu_torch.cluster as cluster_mod
    from ceph_tpu_torch.backend.memstore import GObject
    from ceph_tpu_torch.backend.messages import FaultConfig, MessageBus
    from ceph_tpu_torch.backend.pg_backend import shard_store
    from ceph_tpu_torch.backend.transaction import PGTransaction
    from ceph_tpu_torch.cluster import BlockedWriteError, MiniCluster
    from ceph_tpu_torch.common import Context
    from ceph_tpu_torch.osd.osd_ops import ObjectOperation

    t0 = time.perf_counter()
    rng = random.Random(seed)
    drng = np.random.default_rng(seed)
    taken: collections.Counter = collections.Counter()

    def bus_factory():
        bus = MessageBus(wire=True)
        bus.inject_faults(FaultConfig(seed=seed, reorder=True,
                                      dup_prob=0.1))
        return bus
    orig_bus = cluster_mod.MessageBus
    cluster_mod.MessageBus = bus_factory
    try:
        cct = Context(overrides={"mon_osd_down_out_interval": 10_000})
        c = MiniCluster(n_osds=N_OSDS, osds_per_host=3, chunk_size=512,
                        cct=cct)
        if pool_type == "ec":
            pid = c.create_ec_pool("soak", {"k": str(K), "m": str(M),
                                            "device": device}, pg_num=8)
        else:
            pid = c.create_replicated_pool("soak", size=3, pg_num=8)
        c.attach_monitor()

        oids = [f"obj{i}" for i in range(10)]
        model: dict[str, bytes] = {}
        attrs: dict[str, bytes] = {}
        snaps: dict[int, dict[str, bytes]] = {}   # snapid -> model copy
        snap_no = 0
        # oids with injected bitrot not yet scrub-repaired: reads may
        # legitimately see the rot (the reference doesn't verify
        # checksums on read; only deep scrub catches silent corruption)
        dirty_rot: set[str] = set()
        # (snapid, oid) whose CLONE captured pre-repair rot: a write on a
        # dirty head COWs the rotten state into the snapshot, which reads
        # rotten until scrub repairs the clone, so the model skips those
        # reads until a scrub
        tainted_snaps: set[tuple] = set()
        # (snapid, oid) whose snap view PERMANENTLY diverged from the
        # model (a delete COWs to the newest snap only, so older snaps
        # resolve through a covering clone that may hold later state):
        # scrub cannot heal these, so the settle phase keeps skipping
        # them
        diverged_snaps: set[tuple] = set()

        def alive_peers(g):
            return [o for o in g.acting if o not in g.bus.down]

        def revive_all():
            for g in c.pools[pid]["pgs"].values():
                for o in list(g.bus.down):
                    g.bus.mark_up(o)
                g.bus.deliver_all()

        def check(oid):
            if oid not in model or oid in dirty_rot:
                return
            try:
                got = c.operate(pid, oid, ObjectOperation().read(0, 0)
                                .getxattr("tag"))
            except IOError:
                # unreadable is legitimate only while the PG is degraded
                # (fewer than k chunks reachable); with everything up a
                # read failure is a real bug
                _expect(c.pg_group(pid, oid).bus.down,
                        f"read of {oid} failed on a healthy PG")
                return
            _expect(got.outdata(0)[:len(model[oid])] == model[oid], oid)
            _expect(got.outdata(1) == attrs[oid], oid)

        for step in range(steps):
            action = rng.choices(ACTIONS, weights=WEIGHTS)[0]
            oid = rng.choice(oids)
            taken[action] += 1
            try:
                if action == "write":
                    data = drng.integers(0, 256, rng.randrange(200, 3000),
                                         np.uint8).tobytes()
                    tag = f"s{step}".encode()
                    c.operate(pid, oid, ObjectOperation()
                              .write_full(data).setxattr("tag", tag))
                    if oid in dirty_rot:
                        # the COW (if a newer snap exists) captured the
                        # rotten pre-write state into the clones
                        for sid in snaps:
                            tainted_snaps.add((sid, oid))
                    model[oid] = data
                    attrs[oid] = tag
                    dirty_rot.discard(oid)     # overwritten wholesale
                elif action == "read":
                    check(oid)
                elif action == "snap" and snap_no < 6:
                    snap_no += 1
                    sid = c.create_pool_snap(pid, f"s{snap_no}")
                    snaps[sid] = dict(model)
                elif action == "snapread" and snaps:
                    sid = rng.choice(sorted(snaps))
                    old = snaps[sid]
                    if oid in old and (sid, oid) not in tainted_snaps \
                            and (sid, oid) not in diverged_snaps \
                            and oid not in dirty_rot:
                        # (a dirty head serves snap reads until a COW or
                        # scrub: the same visibility rule as plain reads)
                        try:
                            r = c.operate(pid, oid,
                                          ObjectOperation().read(0, 0),
                                          snapid=sid)
                        except IOError:
                            _expect(c.pg_group(pid, oid).bus.down,
                                    f"snap read of {oid} failed healthy")
                            continue
                        _expect(r.outdata(0)[:len(old[oid])] == old[oid],
                                (oid, sid))
                elif action == "kill":
                    g = c.pg_group(pid, oid)
                    peers = [o for o in alive_peers(g)
                             if o != g.backend.whoami]
                    if peers:
                        g.bus.mark_down(rng.choice(peers))
                elif action == "revive":
                    revive_all()
                elif action == "scrub":
                    # scrub only what is fully up (degraded PGs defer)
                    if not any(g.bus.down
                               for g in c.pools[pid]["pgs"].values()):
                        rep = c.scrub_pool(pid)
                        # DAMAGED objects (inconsistent recovery with too
                        # few spare equations to localise) stay reported
                        # and dirty until an operator-grade overwrite
                        still = {o.split("\x00")[0] for b in rep.values()
                                 for o in b}
                        dirty_rot &= still
                        tainted_snaps = {(sid2, o2) for sid2, o2
                                         in tainted_snaps if o2 in still}
                elif action == "rot" and model:
                    # silent bitrot on a random up non-primary shard, ONE
                    # rot per object between scrubs: multi-chunk rot is
                    # detectable but not locatable (m parity equations
                    # localise a single corruption only)
                    candidates = sorted(set(model) - dirty_rot)
                    if not candidates:
                        continue
                    victim_oid = rng.choice(candidates)
                    g = c.pg_group(pid, victim_oid)
                    peers = [o for o in alive_peers(g)
                             if o != g.backend.whoami]
                    if peers:
                        shard = rng.choice(peers)
                        st = shard_store(g.bus, shard)
                        obj = GObject(victim_oid, shard)
                        if st.exists(obj):
                            st.objects[obj].data[0] ^= 0xFF
                            dirty_rot.add(victim_oid)
                elif action == "delete" and oid in model:
                    c.operate(pid, oid, ObjectOperation().remove())
                    del model[oid]
                    del attrs[oid]
                    # delete COWs to the NEWEST snap only: older snaps'
                    # views resolve through the covering clone, which may
                    # now hold later state than their model copy, so the
                    # model stops asserting those reads
                    for sid in snaps:
                        tainted_snaps.add((sid, oid))
                elif action == "omap" and pool_type == "rep":
                    c.operate(pid, oid, ObjectOperation().omap_set(
                        {f"k{step}": f"v{step}".encode()}))
                    r = c.operate(pid, oid, ObjectOperation()
                                  .omap_get_vals_by_keys([f"k{step}"]))
                    _expect(r.outdata(0) ==
                            {f"k{step}": f"v{step}".encode()}, (oid, step))
            except BlockedWriteError:
                # inactive PG: revive everything so the parked op commits,
                # then the model write IS durable
                revive_all()
                if action == "write":
                    model[oid] = data
                    attrs[oid] = tag
                elif action == "delete":
                    model.pop(oid, None)
                    attrs.pop(oid, None)

        # settle: revive all, repair, then RESTORE any damaged objects
        # from the model (the operator's restore from backup for
        # unlocatable inconsistency), scrub clean, verify EVERY object
        revive_all()
        rep = c.scrub_pool(pid)
        damaged_heads = {o.split("\x00")[0] for b in rep.values()
                         for o in b}
        for oid2 in sorted(damaged_heads & set(model)):
            c.operate(pid, oid2, ObjectOperation()
                      .write_full(model[oid2]).setxattr("tag", attrs[oid2]))
        # damaged CLONES have no head to rewrite: the operator deletes the
        # broken snapshot copy (accepting loss of that historical view)
        for b in rep.values():
            for oid2 in b:
                if "\x00" in oid2:
                    g2 = c.pg_group(pid, oid2.split("\x00")[0])
                    g2.backend.submit_transaction(
                        PGTransaction().delete(oid2))
                    g2.bus.deliver_all()
                    g2.backend.inconsistent_objects.discard(oid2)
        # snapshots of damaged objects were laundered or restored: their
        # historical checks are void
        for sid2 in list(snaps):
            for oid2 in damaged_heads:
                snaps[sid2].pop(oid2, None)
        dirty_rot.clear()
        tainted_snaps.clear()
        c.scrub_pool(pid)
        final_scrub = c.scrub_pool(pid)
        _expect(final_scrub == {}, "scrub not clean after settle")
        for oid in sorted(model):
            check(oid)
        # snapshots still read their historical state after all the churn
        # (pairs that PERMANENTLY diverged through delete-COW stay out)
        for sid, old in snaps.items():
            for oid, want in old.items():
                if oid not in model and oid not in old:
                    continue
                if (sid, oid) in diverged_snaps:
                    continue
                try:
                    r = c.operate(pid, oid, ObjectOperation().read(0, 0),
                                  snapid=sid)
                    _expect(r.outdata(0)[:len(want)] == want, (oid, sid))
                except IOError:
                    pass   # head deleted post-snap without COW-able state
        health = c.health()["status"]
        _expect(health == "HEALTH_OK", f"health {health}")
        if on_settled is not None:
            on_settled(c)
        c.shutdown()
    finally:
        cluster_mod.MessageBus = orig_bus
    return {"seed": seed, "pool_type": pool_type,
            "device": device if pool_type == "ec" else None,
            "steps": steps, "actions": dict(sorted(taken.items())),
            "objects": len(model), "snaps": len(snaps),
            "damaged_restored": len(damaged_heads),
            "final_scrub": final_scrub, "health": health,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", nargs=2, type=int, default=[200, 240],
                    metavar=("LO", "HI"))
    ap.add_argument("--pool-types", nargs="+", default=["ec", "rep"])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the EC pool's codec runs (cpu: the plain "
                         "PyTorch versions)")
    args = ap.parse_args(argv)

    fails = []
    n = 0
    for seed in range(*args.seeds):
        for pt in args.pool_types:
            n += 1
            try:
                soak_campaign(seed, pt, device=args.device)
            except Exception as e:
                fails.append((seed, pt, str(e)[:120]))
                print(f"FAIL seed={seed} {pt}: {e}", file=sys.stderr)
    print(f"{n} campaigns, {len(fails)} failures")
    if fails:
        print("shrink a failure with the exec-copy + greedy-removal "
              "recipe in the git history of tests/test_soak.py "
              "(commit 7a8df0e's message documents the workflow)")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
