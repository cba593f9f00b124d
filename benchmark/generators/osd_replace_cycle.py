"""Traffic generator: replace one OSD of a filled EC pool, again and again.

A :class:`~ceph_tpu_torch.cluster.MiniCluster` of the configuration's
``hosts`` x ``osds_per_host`` OSDs, an EC pool of its profile (pool rule
``chooseleaf indep <k+m> type host``), the serving engine attached to
every EC backend, the recovery scheduler at the configuration's
``recovery`` options, and a monitor.  The set-up fills ``objects``
objects of ``object_bytes`` through the port's bulk write
(``MiniCluster.put_many``), named as ``rados bench`` names them
(``benchmark_data_<hostname>_<pid>_object<N>``, the pid drawn from the
seed), object N holding payload N mod ``distinct_payloads``, and runs
``warmup_cycles`` cycles.

One cycle is the documented disk replacement of the traffic's ``osd``:
``MiniCluster.replace_osd`` (``ceph osd destroy`` and ``ceph-volume lvm
create --osd-id``: the OSD comes back empty under its own id), then
``MiniCluster.deliver_all`` until every PG is active+clean: peering,
the scheduler's reservations, chain and wave rebuilds, the pushes.
There is no client I/O.

A window runs cycles until its length has passed, then drains the last
one.  It counts, from the PG backends' counters taken when the window
ends (at the first delivery round after it), the objects recovered and
their logical bytes (``bytes_recovered``, as ``ceph -s`` counts recovery
MiB/s) and the recovery failures; the cycles completed inside it and
every cycle's seconds; and, over the whole window and its drain, the
objects taken by chains, decode waves and the per-object path.  A
profiled window closes its span when the window ends and finishes after
the drain, so the launch ledger and the traced kernels cover the same
launches.  Traffic keys:

- ``osd``: the OSD replaced each cycle;
- ``distinct_payloads`` payloads made from the seed;
- ``hostname`` for the object names;
- ``warmup_cycles`` cycles in the set-up;
- ``cluster`` (CPU rehearsals only): keys that replace the
  configuration's ``hosts``, ``osds_per_host``, ``pg_num``, ``objects``
  and ``object_bytes``.

``correct``: every object read back whole through ``IoCtx.read``; each
of its chunks and HashInfo chunk hashes read from the OSDs of its acting
set against the reference for its payload; the acting sets unchanged by
the replacements and one OSD a host; every cycle recovered as many
objects as the replaced OSD holds (the reference's ``held_chunks``); no
recovery op failed; every PG clean.
"""
from __future__ import annotations

import json
import random
import sys
import time

import numpy as np
import torch

#: rados bench's object name
NAME = "benchmark_data_{host}_{pid}_object{n}"
#: objects a bulk write of the fill
FILL_BATCH = 32
#: the kernel libraries a cycle launches: a checkout's first run builds
#: them side by side, while the cluster and the payloads are made
KERNELS = ("gf_apply", "crc32c")
#: deliveries a cycle may take before it counts as stuck
DRAIN_PASSES = 8
#: the PG backends' counters a window reads
COUNTERS = ("objects_recovered", "bytes_recovered", "recovery_failures",
            "chain_objects", "decode_wave_objects")


class Generator:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str,
                 reference):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.ref = device, reference
        prof = config["profile"]
        self.k, self.m = int(prof["k"]), int(prof["m"])
        self.unit = int(config["stripe_unit"])
        scale = dict({key: config[key] for key in
                      ("hosts", "osds_per_host", "pg_num", "objects",
                       "object_bytes")}, **traffic.get("cluster", {}))
        self.hosts = int(scale["hosts"])
        self.per_host = int(scale["osds_per_host"])
        self.pg_num = int(scale["pg_num"])
        self.object_bytes = int(scale["object_bytes"])
        if self.object_bytes % (self.k * self.unit):
            raise ValueError("object_bytes must be whole stripes")
        self.osd = int(traffic["osd"])
        pid = random.Random(seed).randrange(2, 1 << 22)
        self.names = [NAME.format(host=traffic["hostname"], pid=pid, n=n)
                      for n in range(int(scale["objects"]))]
        self.cluster = self.io = self.engine = self.sched = None
        self.acting0: dict[str, list[int]] = {}
        self.held: dict[str, int] = {}
        # one (seconds, objects recovered, failures) a cycle, warm-up too
        self.cycles: list[tuple[float, int, int]] = []
        self.unclean = 0
        self._t_end = None
        self._probe = None
        self._at_end = None
        self._draining = False

    # -- inputs --------------------------------------------------------------

    def _make_payloads(self) -> None:
        """The payloads, one at a time from a generator on the device."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(self.seed) % (1 << 63))
        n = int(self.traffic["distinct_payloads"])
        self.payloads = [torch.randint(0, 256, (self.object_bytes,),
                                       dtype=torch.uint8, device=self.device,
                                       generator=gen).cpu().numpy().tobytes()
                         for _ in range(n)]

    def _payload_of(self, n: int) -> int:
        return n % len(self.payloads)

    # -- the cluster ---------------------------------------------------------

    def _make_cluster(self) -> None:
        from ceph_tpu_torch.client.rados import Rados
        from ceph_tpu_torch.cluster import MiniCluster
        from ceph_tpu_torch.common import Context
        prof, eng = self.config["profile"], self.config["engine"]
        if self.config["osd_objectstore"] != "memstore":
            raise ValueError("the generator runs memstore OSDs only")
        cct = Context()
        # each recovery option passed, so that a changed default cannot
        # move it
        for key, value in self.config["recovery"].items():
            cct.conf.set(key, value)
        self.cluster = MiniCluster(
            n_osds=self.hosts * self.per_host, osds_per_host=self.per_host,
            chunk_size=self.unit, cct=cct)
        profile = {key: str(prof[key]) for key in
                   ("plugin", "technique", "k", "m", "w",
                    "crush-failure-domain")}
        if self.device != "cuda":
            profile["device"] = self.device
        self.pool = self.cluster.create_ec_pool(
            "rados_bench", profile, pg_num=self.pg_num,
            allow_ec_overwrites=bool(self.config["allow_ec_overwrites"]))
        self.engine = self.cluster.enable_serving(
            max_bytes=int(eng["throttle_bytes"]),
            max_ops=int(eng["throttle_ops"]),
            fail_fast=bool(eng["fail_fast"]),
            batch_max_delay_ms=float(eng["batch_max_delay_ms"]),
            batch_max_ops=int(eng["batch_max_ops"]),
            pipeline_depth=int(eng["pipeline_depth"]))
        self.sched = self.cluster.enable_recovery_scheduler()
        self.cluster.attach_monitor()
        self.io = Rados(self.cluster).open_ioctx("rados_bench")
        self.cluster.bus.pre_deliver_hooks.append(self._on_round)

    def _fill(self) -> None:
        """Every object, a batch of :data:`FILL_BATCH` a bulk write."""
        for i in range(0, len(self.names), FILL_BATCH):
            self.cluster.put_many(self.pool, {
                name: self.payloads[self._payload_of(n)]
                for n, name in enumerate(self.names[i:i + FILL_BATCH], i)})
        self.acting0 = {name: list(self.cluster.pg_group(self.pool,
                                                         name).acting)
                        for name in self.names}
        self.held = self.ref.held_chunks(self.osd, self.acting0)

    def _start_builds(self) -> list:
        """Start building :data:`KERNELS` (on a card); their futures."""
        if self.device != "cuda":
            return []
        from concurrent.futures import ThreadPoolExecutor
        from ceph_tpu_torch.ops import cuda_build
        pool = ThreadPoolExecutor(len(KERNELS))
        builds = [pool.submit(cuda_build.load, name) for name in KERNELS]
        pool.shutdown(wait=False)
        return builds

    def setup(self) -> None:
        # a tree without the replacement fails here, in seconds
        from ceph_tpu_torch.cluster import MiniCluster
        MiniCluster.replace_osd
        builds = self._start_builds()
        self._make_cluster()
        self._make_payloads()
        for build in builds:
            build.result()
        t0 = time.monotonic()
        self._fill()
        t_fill = time.monotonic() - t0
        if self.device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        for _ in range(int(self.traffic["warmup_cycles"])):
            self._cycle()
        print(f"osd_replace_cycle set-up: fill {t_fill:.3f} s, "
              f"{len(self.held)} objects on osd.{self.osd}, warm-up "
              f"cycles {[round(c[0], 3) for c in self.cycles]} s",
              file=sys.stderr)

    # -- the cycle -----------------------------------------------------------

    def _counters(self) -> dict:
        out = dict.fromkeys(COUNTERS, 0)
        for g in self.cluster.pools[self.pool]["pgs"].values():
            for key in COUNTERS:
                out[key] += g.backend.perf.get(key)
        for key in ("waves", "wave_objects", "jobs_scheduled"):
            out[key] = self.sched.perf.get(key)
        return out

    def _on_round(self) -> None:
        """The bus's pre-delivery hook: the window ends at the first
        delivery round of a drain after its length has passed."""
        if self._draining and self._t_end is not None and \
                self._at_end is None and time.monotonic() >= self._t_end:
            self._close_window()

    def _close_window(self) -> None:
        self._at_end = self._counters()
        if self._probe is not None:
            self._probe.end_window()

    def _clean(self) -> bool:
        return self.sched.job_counts() == (0, 0) and all(
            self.cluster.pg_state(g) == "active+clean" and
            not g.backend.stale and not g.backend.shard_repairs
            for g in self.cluster.pools[self.pool]["pgs"].values())

    def _cycle(self) -> bool:
        """One replacement and its backfill; False when the cluster went
        idle with a PG still unclean."""
        before = self._counters()
        t0 = time.monotonic()
        self.cluster.replace_osd(self.osd)
        self._draining = True
        try:
            for _ in range(DRAIN_PASSES):
                self.cluster.deliver_all()
                if self._clean():
                    break
        finally:
            self._draining = False
        after = self._counters()
        self.cycles.append((time.monotonic() - t0,
                            after["objects_recovered"] -
                            before["objects_recovered"],
                            after["recovery_failures"] -
                            before["recovery_failures"]))
        if not self._clean():
            self.unclean += 1
            return False
        return True

    def window(self, seconds: float, probe=None) -> dict:
        if probe is not None:
            probe.start()
        self._probe, self._at_end = probe, None
        before = self._counters()
        n0 = len(self.cycles)
        t_end = self._t_end = time.monotonic() + seconds
        ends = []
        while time.monotonic() < self._t_end:
            ok = self._cycle()
            ends.append(time.monotonic())
            if not ok:
                break
        if self._at_end is None:
            self._close_window()
        at_end, after = self._at_end, self._counters()
        self._t_end = None
        if probe is not None:
            probe.finish()
        self._probe = None

        def delta(key, upto=after):
            return upto[key] - before[key]
        recovered = delta("objects_recovered", at_end)
        failed = delta("recovery_failures", at_end)
        chain, waves = delta("chain_objects"), \
            delta("decode_wave_objects")
        out = {"seconds": seconds,
               "attempted": recovered + failed,
               "failed": failed,
               "bytes": delta("bytes_recovered", at_end),
               "objects": recovered,
               "cycles": sum(1 for e in ends if e <= t_end),
               "cycle_s": [c[0] for c in self.cycles[n0:]],
               "chain_objects": chain,
               "decode_wave_objects": waves,
               "per_object_objects": delta("objects_recovered") - chain -
               waves,
               "waves": delta("waves"),
               "wave_objects": delta("wave_objects"),
               "jobs_scheduled": delta("jobs_scheduled")}
        # the cycles are no metric of the result line: they go to stderr
        print(f"osd_replace_cycle window: {json.dumps(out)}",
              file=sys.stderr)
        return out

    def stop(self) -> None:
        """Every window drains its last cycle: flush the engine, so
        nothing is left on the card."""
        self.cluster.bus.pre_deliver_hooks.remove(self._on_round)
        self.engine.flush()
        if self.device == "cuda":
            torch.cuda.synchronize()

    # -- the comparison ------------------------------------------------------

    def check(self) -> dict:
        """Bytes that differ from the reference (read back, and chunk by
        chunk on the OSDs), chunk hashes that differ, acting sets that
        moved or put two chunks on one host, cycles that recovered
        another count of objects than the replaced OSD holds, failed
        recoveries, and PGs left unclean, each beside its limit 0.  The
        read-back runs with the program's instruments off: the profiled
        window's spans stay the newest in the tracer's ring."""
        from ceph_tpu_torch.backend.ecutil import HINFO_KEY
        from ceph_tpu_torch.backend.memstore import GObject
        from ceph_tpu_torch.backend.pg_backend import shard_store
        from ceph_tpu_torch.common import instruments
        t0 = time.monotonic()
        want: dict[int, list] = {}
        read_bad = chunk_bad = crc_bad = placement = moved = 0
        with instruments.disabled():
            for n, name in enumerate(self.names):
                j = self._payload_of(n)
                pay = np.frombuffer(self.payloads[j], dtype=np.uint8)
                if j not in want:
                    want[j] = self.ref.chunks(pay, self.k, self.m,
                                              self.unit, device=self.device)
                got = np.frombuffer(self.io.read(name, self.object_bytes),
                                    dtype=np.uint8)
                read_bad += (pay.size if got.shape != pay.shape else
                             int(np.count_nonzero(got != pay)))
                g = self.cluster.pg_group(self.pool, name)
                moved += list(g.acting) != self.acting0[name]
                placement += not self.ref.distinct_hosts(
                    g.acting, lambda osd: osd // self.per_host)
            crcs = self._reference_crcs(want)
            for n, name in enumerate(self.names):
                j = self._payload_of(n)
                g = self.cluster.pg_group(self.pool, name)
                for c, osd in enumerate(g.acting):
                    ref = want[j][c]
                    obj = GObject(name, osd)
                    store = shard_store(g.bus, osd)
                    try:
                        mine = np.frombuffer(store.read(obj, 0, None),
                                             dtype=np.uint8)
                        hinfo = store.getattr(obj, HINFO_KEY)
                    except (FileNotFoundError, KeyError):
                        chunk_bad += ref.size
                        crc_bad += 1
                        continue
                    chunk_bad += (ref.size if mine.shape != ref.shape else
                                  int(np.count_nonzero(mine != ref)))
                    hashes = hinfo["cumulative_shard_hashes"]
                    crc_bad += (len(hashes) != len(g.acting) or
                                hashes[c] != int(crcs[j][c]))
        held = len(self.held)
        print(f"osd_replace_cycle check: {time.monotonic() - t0:.3f} s",
              file=sys.stderr)
        return {"read_bad_bytes": (read_bad, 0),
                "chunk_bad_bytes": (chunk_bad, 0),
                "hinfo_crc_mismatches": (crc_bad, 0),
                "acting_sets_moved": (moved, 0),
                "acting_sets_sharing_a_host": (placement, 0),
                "cycles_not_recovering_the_held_objects": (
                    sum(1 for _s, rec, _f in self.cycles if rec != held),
                    0),
                "recovery_failures": (sum(f for _s, _r, f in self.cycles),
                                      0),
                "pgs_left_unclean": (self.unclean + sum(
                    1 for g in self.cluster.pools[self.pool]["pgs"].values()
                    if self.cluster.pg_state(g) != "active+clean"), 0)}

    def _reference_crcs(self, want: dict) -> dict[int, np.ndarray]:
        """Each payload's chunk hashes, all chunks at once."""
        order = sorted(want)
        rows = np.stack([chunk for j in order for chunk in want[j]])
        crc = self.ref.crc32c(self.ref.HINFO_SEED, rows, device=self.device)
        n = self.k + self.m
        return {j: crc[i * n:(i + 1) * n] for i, j in enumerate(order)}
