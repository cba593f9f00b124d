"""chaos_run: a seeded fault-injection campaign against a real TCP cluster.

The port's copy of the JAX package's ``tools/chaos_run.py`` (the role
qa/tasks/ceph_manager.py's Thrasher plays in the reference): ONE seed
drives every fault plane against a live ``MiniCluster`` served over real
sockets, and the campaign asserts the self-healing invariants while it
runs:

1. **Faulted traffic** — puts/gets through ``TcpRados`` while the server
   injects connection resets, black-holed requests, truncated frames and
   send delays, the bus reorders/duplicates, and stores stall reads.
   Every ACKED write must read back intact (reconnect + resend + reqid
   dedup make the acks honest).  1.5: the critical-path retry time and
   an impossible latency objective's SLO burn, raised and cleared.
2. **Flapping OSD** — one OSD cycles down/up through the monitor until
   flap damping trips: the boot is REFUSED, ``OSD_FLAPPING`` raises, an
   operator clear + boot brings it back and the check clears.
3. **Device breaker** — injected dispatch failures trip the codec
   pipeline's circuit breaker and ``DEVICE_DEGRADED`` raises; with
   injection off, the half-open probe runs the kernel, re-closes the
   breaker and health clears.
4. **Drain** — recovery reservations drain to zero and every acked
   write verifies, through the TCP client AND the local surface.
5. **Cache tier** — a flash-crowd key stream through a writeback tier,
   ``TIER_*`` raised and cleared, a cache PG's whole acting set killed
   with every acked write still answering, and hits after the heal.

Two runs with the same seed produce the same injected-event digest —
the reproducibility receipt printed in the report.

Where it differs from the JAX package's campaign:

- **The pool runs on the card.**  Its profile is ``torch_rs`` k=2 m=1
  ``reed_sol_van`` with ``"device": device`` (``cuda`` by default): on
  the card every put and degraded get launches ``gf_apply.cu`` and every
  ``hinfo_append`` launches ``crc32c.cu``.  ``device="cpu"`` runs the
  plain PyTorch versions (the tests); ``cuda`` without a card raises.
- **Phase 3 has no host fallback.**  The JAX package's batches succeed
  through a synchronous host fallback while the breaker is open; the
  port's ``CodecPipeline`` has none, by design (``ops/pipeline.py``: a
  failure on the card fails the op).  So here every future of the
  faulted batches fails, with the injected fault or, once the breaker is
  open, with ``BreakerOpen``, and no result is served; after the
  cooldown the half-open probe's parity must equal the plain version's
  bitwise.
- **The report** adds ``device``, ``launches`` (the launch ledger's
  counts for the campaign by kernel, on the campaign's route: ``cuda``
  launches of the hand kernels, or ``cpu`` calls of their plain
  versions), ``phase3`` (the failed futures by error and the probe's
  ``gf_apply`` launches) and ``timing`` (host-clock seconds, ms per TCP
  put and get).

Usage:
    python -m ceph_tpu_torch.tools.chaos_run [--seed N] [--ops N]
        [--json FILE] [--device cuda|cpu] [--data-dir D] [-q]
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import random
import shutil
import sys
import tempfile
import time
from pathlib import Path

K, M = 2, 1
CHUNK = 256
STRIPE = K * CHUNK


def pool_profile(device: str) -> dict:
    return {"plugin": "torch_rs", "k": str(K), "m": str(M),
            "device": device, "technique": "reed_sol_van"}


# the campaign's Context overrides, the JAX package's campaign's own
CAMPAIGN_OVERRIDES = {
    # short timelines so the campaign heals in seconds, not minutes
    "ms_rpc_timeout": 8.0,
    "ms_rpc_retry_attempts": 4,
    "ms_reconnect_backoff_base": 0.01,
    "ms_reconnect_backoff_cap": 0.05,
    "osd_markdown_count": 3,
    "osd_markdown_window": 1000.0,
    "pipeline_breaker_threshold": 2,
    "pipeline_breaker_cooldown": 0.05,
    # an impossible latency objective: EVERY client op in the faulted
    # window burns budget, so SLO_BURN deterministically raises while
    # traffic flows and clears once it drains past the (shortened)
    # windows — the raise/heal receipt
    "slo_client_p99_ms": 0.001,
    "slo_client_target": 0.9,
    "slo_fast_window": 2.0,
    "slo_slow_window": 4.0,
    "slo_min_ops": 4,
}


def _campaign_context():
    from ..common import Context
    return Context(overrides=dict(CAMPAIGN_OVERRIDES))


def _health_checks(cluster) -> set[str]:
    return set(cluster.health().get("checks", ()))


def _tier_phase(cluster, mon, cct, base_pid, seed, ops, rng, now,
                health_seen, say) -> dict:
    """Cache tiering under chaos (tier/): a flash-crowd key stream
    writes back through a replicated hot tier, the TIER_* checks raise
    and clear, then TWO acting OSDs of one cache PG die — every read
    still answers (degrading to base-pool proxies for the dead PG, the
    no-loss invariant), and hits resume after the OSDs boot back."""
    from ..exec.workload import WorkloadKeys

    cct.conf.set("tier_promote_min_recency", 1)
    cache = cluster.create_replicated_pool(
        "chaos_cache", size=3, pg_num=4,
        params={"hit_set_count": "2", "hit_set_period": "16"})
    svc = cluster.create_tier(cache, base_pid)

    # flash crowd: zipf-skewed keys, half the mid-campaign arrivals
    # collapsing onto the hottest 10% of the key space
    keys = WorkloadKeys(n_keys=24, dist="zipf", zipf_s=1.1,
                        flash=(0.5, 0.25, 0.5), hot_frac=0.1,
                        seed=seed, prefix="t")
    tier_model: dict[str, bytes] = {}
    n_ops = max(40, ops)
    for i in range(n_ops):
        oid = keys.key(i / n_ops)
        if oid not in tier_model or rng.random() < 0.3:
            data = rng.randbytes(STRIPE)
            svc.write(oid, data)                # acked writeback
            tier_model[oid] = data
        else:
            assert svc.read(oid) == tier_model[oid], \
                f"tier read of acked {oid} diverged"
    assert svc.stats()["counters"]["hit"] > 0

    # TIER_FLUSH_BACKLOG: two zero-budget agent passes end over the
    # (tightened) high-dirty watermark, then a funded pass drains it
    cct.conf.set("tier_target_max_objects", 4 * len(svc.resident()))
    cct.conf.set("tier_dirty_ratio_high", 0.01)
    cct.conf.set("tier_dirty_ratio_low", 0.0)
    svc.agent.tick(max_ops=0)
    svc.agent.tick(max_ops=0)
    checks = _health_checks(cluster)
    health_seen |= checks
    assert "TIER_FLUSH_BACKLOG" in checks, \
        f"starved tier agent did not raise a flush backlog: {checks}"
    for _ in range(10):
        if svc.agent.tick(max_ops=64)["dirty_ratio"] == 0.0:
            break
    assert "TIER_FLUSH_BACKLOG" not in _health_checks(cluster), \
        "TIER_FLUSH_BACKLOG did not clear after the dirty set drained"

    # TIER_FULL: residency at target raises, a hard-full pass clears
    cct.conf.set("tier_target_max_objects", max(1, len(svc.resident())))
    checks = _health_checks(cluster)
    health_seen |= checks
    assert "TIER_FULL" in checks, f"full tier did not raise: {checks}"
    svc.agent.tick(max_ops=256)
    assert "TIER_FULL" not in _health_checks(cluster), \
        "TIER_FULL did not clear after the agent evicted"
    cct.conf.set("tier_target_max_objects", 256)   # roomy again: the
    # death drill below re-promotes, and that churn must not re-trip
    # the full watermark we just proved clears

    # tier OSD death: kill one cache PG's ENTIRE acting set (a single
    # surviving replica still serves reads, so whole-set death is what
    # forces the proxy degradation).  The victims must leave every base
    # PG at most one member short (EC k=2 of 3 stays readable) and
    # every other cache PG a survivor (replicated reads need one)
    target_g = victims = None
    for g in cluster.pools[cache]["pgs"].values():
        trio = set(g.acting)
        safe = all(len(trio & set(og.acting)) <= 1
                   for og in cluster.pools[base_pid]["pgs"].values()) \
            and all(len(trio & set(og.acting)) <= 2
                    for og in cluster.pools[cache]["pgs"].values()
                    if og is not g)
        if safe:
            target_g, victims = g, tuple(g.acting)
            break
    assert target_g is not None, "no safe victim set for tier OSD death"
    affected = sorted(o for o in tier_model
                      if cluster.pg_group(cache, o) is target_g)
    if not affected:
        # the skewed key stream missed the one safe PG: pin a couple of
        # acked writebacks onto it, flushed CLEAN before the deaths (a
        # dirty object whose only copies die with the cache PG is the
        # loss writeback mode legitimately cannot prevent)
        for j in range(256):
            oid = f"pin{j:04d}"
            if cluster.pg_group(cache, oid) is target_g:
                data = rng.randbytes(STRIPE)
                svc.write(oid, data)
                tier_model[oid] = data
                affected.append(oid)
                if len(affected) >= 2:
                    break
        assert affected, "could not pin objects onto the victim PG"
        for oid in affected:
            svc.flush(oid)

    hosts = {o: o // 3 for o in range(9)}
    t = now + 100.0
    for v in victims:
        reps = [o for o in range(9)
                if o not in victims and hosts[o] != hosts[v]]
        rep_a = reps[0]
        rep_b = next(o for o in reps if hosts[o] != hosts[rep_a])
        mon.prepare_failure(v, rep_a, failed_since=t - 25.0, now=t)
        mon.prepare_failure(v, rep_b, failed_since=t - 25.0, now=t)
    mon.propose_pending(t)
    assert all(cluster.osdmap.is_down(v) for v in victims)
    health_seen |= _health_checks(cluster)

    # every acked tier write still answers: resident-on-dead-PG reads
    # degrade to base proxies, nothing blocks, nothing is lost
    pre_proxy = svc.stats()["counters"]["proxy_read"]
    for oid, want in sorted(tier_model.items()):
        assert svc.read(oid) == want, \
            f"acked tier write {oid} lost under tier OSD death"
    degraded_proxies = svc.stats()["counters"]["proxy_read"] - pre_proxy
    assert degraded_proxies >= len(affected), \
        f"dead-PG reads did not proxy: {degraded_proxies} proxies " \
        f"for {len(affected)} affected objects"

    # heal: boot the victims back, then hits resume on the healed PG
    for v in victims:
        assert mon.osd_boot(v, now=t + 5.0), f"osd.{v} re-boot refused"
    mon.propose_pending(t + 5.0)
    cluster.deliver_all()
    assert all(cluster.osdmap.is_up(v) for v in victims)
    pre_hit = svc.stats()["counters"]["hit"]
    for _ in range(2):                       # pass 1 re-promotes evicted
        for oid in affected:                 # copies, pass 2 hits
            assert svc.read(oid) == tier_model[oid]
    assert svc.stats()["counters"]["hit"] > pre_hit, \
        "healed cache PG never served a hit again"
    final = _health_checks(cluster)
    assert not any(k.startswith("TIER_") for k in final), \
        f"TIER_* still raised after heal: {final}"
    st = svc.stats()
    return {"acked_writes": len(tier_model),
            "verified": len(tier_model),
            "workload": keys.describe(),
            "victim_pg": str(target_g.pgid),
            "victims": list(victims),
            "affected_objects": len(affected),
            "degraded_proxy_reads": degraded_proxies,
            "hit_rate": round(st["hit_rate"], 4),
            "counters": st["counters"]}


def _device_breaker_phase(cluster, cct, inj, plan, rng, seed, device,
                          health_seen) -> dict:
    """Phase 3: injected dispatch failures open the pipeline's breaker
    (every future fails: no host fallback), ``DEVICE_DEGRADED`` raises;
    with injection off the half-open probe runs the kernel, its parity
    equals the plain version's bitwise, the breaker re-closes and the
    check clears."""
    from ..backend import ecutil
    from ..backend.ecutil import StripeInfo
    from ..failure.breaker import BreakerOpen
    from ..failure.injector import InjectedFault
    from ..ops import launch_ledger
    from ..ops.pipeline import CodecPipeline
    from ..plugins.registry import ErasureCodePluginRegistry

    reg = ErasureCodePluginRegistry.instance()
    ec_dev = reg.factory("torch_rs", "", pool_profile(device))
    ec_plain = reg.factory("torch_rs", "", pool_profile("cpu"))
    sinfo = StripeInfo(K, CHUNK)
    pipeline = CodecPipeline(depth=2, name=f"chaos{seed}.pipeline",
                             cct=cct)
    try:
        pipeline.inject_faults(inj)
        plan.device.dispatch_fail_prob = 1.0
        bufs = [rng.randbytes(2 * STRIPE) for _ in range(6)]
        futs = [ecutil.encode_many_pipelined(sinfo, ec_dev, [b], pipeline)
                for b in bufs]
        pipeline.flush()
        failed = collections.Counter()
        for fut in futs:
            err = fut.exception(30)
            assert isinstance(err, (InjectedFault, BreakerOpen)), \
                f"a faulted batch did not fail with the injected fault " \
                f"or BreakerOpen: {err!r}"
            failed[type(err).__name__] += 1
        assert failed["BreakerOpen"] >= 1, \
            f"the open breaker never failed a batch fast: {dict(failed)}"
        assert pipeline.breaker.state == "open", \
            f"breaker did not open: {pipeline.breaker.dump()}"
        checks = _health_checks(cluster)
        health_seen |= checks
        assert "DEVICE_DEGRADED" in checks, \
            f"DEVICE_DEGRADED not raised: {checks}"
        # injection off; after the cooldown the next submit probes
        plan.device.dispatch_fail_prob = 0.0
        time.sleep(0.06)
        with launch_ledger.recording(("gf_apply",), device) as probed:
            probe = ecutil.encode_many_pipelined(sinfo, ec_dev, [bufs[0]],
                                                 pipeline)
            pipeline.flush()
            got = probe.result(30)[0]
        want = ecutil.encode(sinfo, ec_plain, bufs[0])
        assert {c: bytes(v) for c, v in got.items()} == \
            {c: bytes(v) for c, v in want.items()}, \
            "the half-open probe's parity diverged from the plain version"
        assert sum(probed.values()) >= 1, "the probe launched no gf_apply"
        assert pipeline.breaker.state == "closed", \
            f"half-open probe did not re-close: {pipeline.breaker.dump()}"
        assert "DEVICE_DEGRADED" not in _health_checks(cluster), \
            "DEVICE_DEGRADED did not clear after the breaker closed"
        return {"breaker": pipeline.breaker.dump(),
                "phase3": {"failed": dict(sorted(failed.items())),
                           "probe_gf_apply": sum(probed.values())}}
    finally:
        pipeline.close()


def run_campaign(seed: int = 7, ops: int = 40, data_dir=None,
                 verbose: bool = False, device: str = "cuda") -> dict:
    """One full campaign; returns the report dict (raises AssertionError
    on any invariant violation).  ``device`` is the pool's: ``cuda`` (the
    hand kernels; raises without a card) or ``cpu`` (their plain
    PyTorch versions)."""
    import torch

    from ..cluster import MiniCluster
    from ..failure import (FaultConfig, FaultPlan, StoreFaults,
                           TransportFaults)
    from ..net import ClusterServer, TcpRados
    from ..ops import launch_ledger

    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, not {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("chaos_run runs the pool on the card and "
                           "torch.cuda.is_available() is False; pass "
                           "device='cpu' for the plain versions")
    if device == "cuda":
        # build or load the put path's kernels before the server takes a
        # put: nvcc inside the first put would outlast its rpc timeout
        from .rados_cli import warm_card
        warm_card()

    def say(msg):
        if verbose:
            print(f"[chaos seed={seed}] {msg}", flush=True)

    t_start = time.perf_counter()
    own_dir = None
    if data_dir is None:
        own_dir = tempfile.mkdtemp(prefix="chaos_run_")
        data_dir = own_dir
    cct = _campaign_context()
    cluster = MiniCluster(n_osds=9, osds_per_host=3, chunk_size=CHUNK,
                          cct=cct, data_dir=data_dir)
    cluster.enable_recovery_scheduler()
    plan = FaultPlan(
        seed=seed,
        bus=FaultConfig(reorder=True, dup_prob=0.15),
        transport=TransportFaults(reset_prob=0.04, blackhole_prob=0.03,
                                  truncate_prob=0.02, delay_prob=0.10,
                                  delay_ms=2.0),
        store=StoreFaults(slow_read_prob=0.05, slow_read_ms=1.0))
    inj = cluster.inject_faults(plan)
    server = ClusterServer(cluster)
    server.inject_faults(inj)
    server.start()
    mon = cluster.attach_monitor()
    health_seen: set[str] = set()
    report: dict = {"seed": seed, "ops": ops, "device": device}
    client = None
    put_s: list[float] = []
    get_s: list[float] = []
    scope = contextlib.ExitStack()
    launched = scope.enter_context(launch_ledger.recording(route=device))
    try:
        client = TcpRados("127.0.0.1", server.port,
                          Path(data_dir) / "client.admin.keyring", cct=cct)
        client.mkpool("chaos", profile=pool_profile(device), pg_num=4)
        pid = cluster.pool_ids["chaos"]

        # -- phase 1: acked writes + reads under transport+bus+store chaos
        say("phase 1: faulted traffic")
        rng = random.Random(f"workload:{seed}")
        model: dict[str, bytes] = {}
        for i in range(ops):
            oid = f"obj{i % max(1, ops // 2)}"
            data = rng.randbytes(2 * STRIPE)
            t0 = time.perf_counter()
            client.put("chaos", oid, data)      # acked == durable
            put_s.append(time.perf_counter() - t0)
            model[oid] = data
            if i % 5 == 4:
                check = sorted(model)[rng.randrange(len(model))]
                t0 = time.perf_counter()
                got = client.get("chaos", check)
                get_s.append(time.perf_counter() - t0)
                assert got == model[check], \
                    f"read of acked {check} diverged under injection"
        health_seen |= _health_checks(cluster)

        # -- phase 1.5: critical-path + SLO receipts for the window
        # above: retry time appeared (resent RPCs), the impossible
        # objective burned, and the burn CLEARS once traffic drains
        # past the burn windows — with the transitions in the clog
        say("phase 1.5: SLO burn + retry attribution")
        cluster.critpath.refresh()
        snap = cluster.critpath.snapshot()
        retry_s = sum(acc.get("retry", 0.0)
                      for acc in snap["phase_seconds"].values())
        # resends only: a reconnect healed during a call's FIRST attempt
        # stamps no net.resend span (that backoff lands in the rpc
        # span's self time), so reconnects alone guarantee nothing
        if client.resends:
            assert retry_s > 0, \
                f"{client.resends} resends but zero retry phase time " \
                f"attributed: {snap['phase_seconds']}"
        checks = _health_checks(cluster)
        health_seen |= checks
        assert "SLO_BURN" in checks or "SLO_EXHAUSTED" in checks, \
            f"impossible objective did not burn: {checks}"
        time.sleep(4.2)                      # drain past the slow window
        checks = _health_checks(cluster)
        assert "SLO_BURN" not in checks and \
            "SLO_EXHAUSTED" not in checks, \
            f"SLO burn did not clear after heal: {checks}"
        log_lines = [e["message"] for e in cluster.clusterlog.dump()]
        assert any("SLO_" in ln and "raised" in ln
                   for ln in log_lines), "no SLO raise in clusterlog"
        assert any("SLO_" in ln and "cleared" in ln
                   for ln in log_lines), "no SLO clear in clusterlog"
        report["slo"] = {
            "retry_phase_s": round(retry_s, 6),
            "traces_folded": cluster.critpath.folded,
            "classes": {cls: {"retry_s": round(acc.get("retry", 0), 6)}
                        for cls, acc in snap["phase_seconds"].items()},
        }

        # -- phase 2: flapping OSD -> damping -> operator clear
        say("phase 2: flapping OSD")
        primaries = {g.backend.whoami
                     for g in cluster.pools[pid]["pgs"].values()}
        victim = min(set(range(9)) - primaries - {0})
        hosts = {o: o // 3 for o in range(9)}
        reporters = [o for o in range(9)
                     if hosts[o] != hosts[victim] and o != victim]
        rep_a = reporters[0]
        rep_b = next(o for o in reporters if hosts[o] != hosts[rep_a])
        now, denied_at = 100.0, None
        for cycle in range(5):
            now += 30.0
            mon.prepare_failure(victim, rep_a, failed_since=now - 25.0,
                                now=now)
            mon.prepare_failure(victim, rep_b, failed_since=now - 25.0,
                                now=now)
            mon.propose_pending(now)
            assert cluster.osdmap.is_down(victim), \
                f"flap cycle {cycle}: victim not marked down"
            health_seen |= _health_checks(cluster)
            booted = mon.osd_boot(victim, now=now + 1.0)
            mon.propose_pending(now + 1.0)
            if not booted:
                denied_at = cycle
                break
        assert denied_at is not None, "flap damping never tripped"
        assert cluster.osdmap.is_down(victim)
        checks = _health_checks(cluster)
        health_seen |= checks
        assert "OSD_FLAPPING" in checks, \
            f"OSD_FLAPPING not raised: {checks}"
        mon.clear_markdown(victim)
        assert mon.osd_boot(victim, now=now + 2.0)
        mon.propose_pending(now + 2.0)
        assert cluster.osdmap.is_up(victim)
        assert "OSD_FLAPPING" not in _health_checks(cluster), \
            "OSD_FLAPPING did not clear after operator clear + boot"
        report["flap"] = {"victim": victim, "denied_at_cycle": denied_at}

        # -- phase 3: device breaker -> fail fast -> probe re-close
        say("phase 3: device breaker")
        report.update(_device_breaker_phase(cluster, cct, inj, plan, rng,
                                            seed, device, health_seen))

        # -- phase 4: drain + verify every acked write, both surfaces
        say("phase 4: drain + verify")
        for _ in range(20):
            cluster.deliver_all()
            if cluster.recovery.job_counts() == (0, 0):
                break
        assert cluster.recovery.job_counts() == (0, 0), \
            f"recovery reservations not drained: " \
            f"{cluster.recovery.job_counts()}"
        for oid, want in sorted(model.items()):
            t0 = time.perf_counter()
            got = client.get("chaos", oid)
            get_s.append(time.perf_counter() - t0)
            assert got == want, f"acked write {oid} lost (TCP read)"
            assert cluster.get(pid, oid, len(want)) == want, \
                f"acked write {oid} lost (local read)"

        # -- phase 5: cache tier flash crowd + tier OSD death
        say("phase 5: cache tier flash crowd + tier OSD death")
        report["tier"] = _tier_phase(cluster, mon, cct, pid, seed, ops,
                                     rng, now, health_seen, say)

        launches = collections.Counter()
        for key, n in launched.items():
            launches[key[0]] += n
        report.update({
            "ok": True,
            "acked_writes": len(model),
            "verified": len(model),
            "events": inj.summary(),
            "event_digest": inj.event_digest(),
            "transport": {"reconnects": client.reconnects,
                          "resends": client.resends,
                          "rpc_dedup_hits": server.rpc_dedup_hits},
            "health_seen": sorted(health_seen),
            "launches": dict(sorted(launches.items())),
            "timing": {"seconds": time.perf_counter() - t_start,
                       "puts": len(put_s),
                       "put_ms": 1e3 * sum(put_s) / max(1, len(put_s)),
                       "gets": len(get_s),
                       "get_ms": 1e3 * sum(get_s) / max(1, len(get_s))},
        })
        say(f"done: {report['events']['total']} events, digest "
            f"{report['event_digest'][:12]}")
        return report
    finally:
        scope.close()
        if client is not None:
            client.close()
        server.stop()
        cluster.shutdown()
        if own_dir is not None:
            shutil.rmtree(own_dir, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--ops", type=int, default=40,
                    help="client writes in the faulted-traffic phase")
    ap.add_argument("--data-dir", default=None,
                    help="durable cluster home (default: a temp dir)")
    ap.add_argument("--json", default=None,
                    help="write the report to this file")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the pool's codec runs (cpu: the plain "
                         "PyTorch versions)")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)
    try:
        report = run_campaign(seed=args.seed, ops=args.ops,
                              data_dir=args.data_dir,
                              verbose=not args.quiet, device=args.device)
    except AssertionError as e:
        print(f"CHAOS FAIL: {e}", file=sys.stderr)
        return 1
    out = json.dumps(report, indent=2, default=str)
    if args.json:
        Path(args.json).write_text(out + "\n")
    print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
