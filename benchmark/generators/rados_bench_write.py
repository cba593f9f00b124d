"""Traffic generator: ``rados bench write`` through the port's librados.

A :class:`~ceph_tpu_torch.cluster.MiniCluster` of the configuration's
``hosts`` x ``osds_per_host`` OSDs, an EC pool of its profile (pool rule
``chooseleaf indep <k+m> type host``), the serving engine attached to
every EC backend, and a librados ``IoCtx`` on the pool.  ``clients`` ops
stay in flight (``rados bench -t``): each is an ``aio_operate`` of one
``write_full`` of ``op_bytes``, and each completion issues the next
write, while the loop runs ``MiniCluster.deliver_all``, the cluster's
cooperative delivery loop, on this thread.  Traffic keys:

- ``distinct_payloads`` payloads made from the seed, cycled through;
- ``objects`` object names in rados bench's form,
  ``benchmark_data_<hostname>_<pid>_object<N>`` with the pid drawn from
  the seed and ``N`` taken mod ``objects``: after the first lap every
  write rewrites a whole object;
- ``warmup_seconds`` of the loop, and at least one lap of the names, in
  the set-up;
- ``cluster`` (CPU rehearsals only): keys that replace the
  configuration's ``hosts``, ``osds_per_host`` and ``pg_num``.

A window runs the loop for its length: writes issued until it ends,
then the loop drains what is in flight.  It counts the writes that
complete inside it, latency on the client's clock from ``aio_operate``
to the completion, and the deltas of the engine's batch counters and of
its pipeline's ``pack_time``.  The loop runs in slices of :data:`SLICE_S` seconds
(each slice drains before the next starts), which keeps one
``deliver_all`` call far below the bus's round limit.  A profiled window
closes its span after the drain, so the launch ledger and the traced
kernels cover the same launches.

``correct``: every object read back whole through ``IoCtx.read``, each
of its chunks and HashInfo chunk hashes read from the OSDs of its acting
set, against the reference for the payload of its last acknowledged
write; the acting sets one OSD a host; no write failed.
"""
from __future__ import annotations

import random
import time

import numpy as np
import torch

from benchmark.stats import nearest_rank

#: seconds of one pass of the loop: it drains at the end of each
SLICE_S = 10.0
#: rados bench's object name
NAME = "benchmark_data_{host}_{pid}_object{n}"
#: the kernel libraries the loop launches: a checkout's first run builds
#: them side by side, while the cluster and the payloads are made
KERNELS = ("gf_apply", "crc32c")


class Generator:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str,
                 reference):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.ref = device, reference
        prof = config["profile"]
        self.k, self.m = int(prof["k"]), int(prof["m"])
        self.unit = int(config["stripe_unit"])
        self.op_bytes = int(traffic["op_bytes"])
        if self.op_bytes % (self.k * self.unit):
            raise ValueError("op_bytes must be whole stripes")
        self.clients = int(traffic["clients"])
        layout = dict({key: config[key] for key in
                       ("hosts", "osds_per_host", "pg_num")},
                      **traffic.get("cluster", {}))
        self.hosts = int(layout["hosts"])
        self.per_host = int(layout["osds_per_host"])
        self.pg_num = int(layout["pg_num"])
        pid = random.Random(seed).randrange(2, 1 << 22)
        self.names = [NAME.format(host=traffic["hostname"], pid=pid, n=n)
                      for n in range(int(traffic["objects"]))]
        self.issued = 0
        self.in_flight = 0
        self.until = 0.0
        self.done: list[tuple] = []        # (t_submit, t_done, ok)
        self.acked: dict[str, int] = {}    # name -> payload of its last ack
        self.failed = 0
        self.cluster = self.io = self.engine = None

    # -- inputs --------------------------------------------------------------

    def _make_payloads(self) -> None:
        """The payloads, one at a time from a generator on the device."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(self.seed) % (1 << 63))
        n = int(self.traffic["distinct_payloads"])
        self.payloads = [torch.randint(0, 256, (self.op_bytes,),
                                       dtype=torch.uint8, device=self.device,
                                       generator=gen).cpu().numpy().tobytes()
                         for _ in range(n)]

    # -- the cluster ---------------------------------------------------------

    def _make_cluster(self) -> None:
        from ceph_tpu_torch.client.rados import Rados
        from ceph_tpu_torch.cluster import MiniCluster
        from ceph_tpu_torch.common import Context
        prof, eng = self.config["profile"], self.config["engine"]
        if self.config["osd_objectstore"] != "memstore":
            raise ValueError("the generator runs memstore OSDs only")
        self.cluster = MiniCluster(
            n_osds=self.hosts * self.per_host, osds_per_host=self.per_host,
            chunk_size=self.unit, cct=Context())
        profile = {key: str(prof[key]) for key in
                   ("plugin", "technique", "k", "m", "w",
                    "crush-failure-domain")}
        if self.device != "cuda":
            profile["device"] = self.device
        self.pool = self.cluster.create_ec_pool(
            "rados_bench", profile, pg_num=self.pg_num,
            allow_ec_overwrites=bool(self.config["allow_ec_overwrites"]))
        # each setting passed, so that a changed default cannot move it
        self.engine = self.cluster.enable_serving(
            max_bytes=int(eng["throttle_bytes"]),
            max_ops=int(eng["throttle_ops"]),
            fail_fast=bool(eng["fail_fast"]),
            batch_max_delay_ms=float(eng["batch_max_delay_ms"]),
            batch_max_ops=int(eng["batch_max_ops"]),
            pipeline_depth=int(eng["pipeline_depth"]))
        self.rados = Rados(self.cluster)
        self.io = self.rados.open_ioctx("rados_bench")

    def _warm_shapes(self) -> None:
        """Book every launch shape the loop can make before the window (a
        key's first launch is timed synchronously by the launch ledger):
        an encode batch of 1 to ``clients`` writes, and one write's
        HashInfo crcs."""
        from ceph_tpu_torch.ops import rs_kernels
        from ceph_tpu_torch.ops.codec import RSCodec
        mat = RSCodec(self.k, self.m, device=self.device) \
            .parity_matrix_device()
        cols = self.op_bytes // self.k
        for ops in range(1, self.clients + 1):
            rs_kernels.gf_apply(mat, torch.zeros(
                (self.k, ops * cols), dtype=torch.uint8, device=self.device))
        rs_kernels.crc32c_rows(torch.zeros(
            (self.k + self.m, cols), dtype=torch.uint8, device=self.device))
        if self.device == "cuda":
            torch.cuda.synchronize()

    # -- the loop ------------------------------------------------------------

    def _issue(self) -> None:
        from ceph_tpu_torch.osd.osd_ops import ObjectOperation
        i = self.issued
        self.issued += 1
        self.in_flight += 1
        name = self.names[i % len(self.names)]
        j = i % len(self.payloads)
        t0 = time.monotonic()
        comp = self.io.aio_operate(
            name, ObjectOperation().write_full(self.payloads[j]))
        comp.set_complete_callback(
            lambda c, name=name, j=j, t0=t0: self._on_done(c, name, j, t0))

    def _on_done(self, comp, name: str, j: int, t0: float) -> None:
        t1 = time.monotonic()
        ok = not isinstance(comp.reply, Exception) and comp.result >= 0
        self.done.append((t0, t1, ok))
        if ok:
            self.acked[name] = j
        else:
            self.failed += 1
        self.in_flight -= 1
        if t1 < self.until:
            self._issue()

    def _run(self, seconds: float) -> None:
        """The loop for ``seconds``, slice by slice; it returns with no
        write in flight."""
        end = time.monotonic() + seconds
        while True:
            now = time.monotonic()
            if now >= end:
                return
            self.until = min(end, now + SLICE_S)
            while self.in_flight < self.clients:
                self._issue()
            self.cluster.deliver_all()
            if self.in_flight:
                raise RuntimeError(f"{self.in_flight} writes unfinished "
                                   f"after the cluster went idle")

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
        builds = self._start_builds()
        self._make_cluster()
        self._make_payloads()
        for build in builds:
            build.result()
        self._warm_shapes()
        if self.device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t_end = time.monotonic() + float(self.traffic["warmup_seconds"])
        while self.issued < len(self.names) or time.monotonic() < t_end:
            self._run(max(0.0, t_end - time.monotonic()) or 0.05)

    def _counters(self) -> dict:
        pack = self.engine.pipeline.perf.dump()["pack_time"]
        return {"batches": self.engine.perf.get("batches"),
                "ops_coalesced": self.engine.perf.get("ops_coalesced"),
                "pack_s": pack["sum"], "packs": pack["avgcount"],
                "issued": self.issued}

    def window(self, seconds: float, probe=None) -> dict:
        if probe is not None:
            probe.start()
        before = self._counters()
        n0 = len(self.done)
        t0 = time.monotonic()
        self._run(seconds)
        t1 = t0 + seconds
        after = self._counters()
        if probe is not None:
            probe.end_window()
            probe.finish()
        done = [d for d in self.done[n0:] if d[1] < t1]
        lat = sorted(t_done - t_sub for t_sub, t_done, _ok in done)
        return {"seconds": seconds,
                "attempted": after["issued"] - before["issued"],
                "failed": sum(1 for d in done if not d[2]),
                "bytes": sum(1 for d in done if d[2]) * self.op_bytes,
                "latency_p95_s": nearest_rank(lat, 95),
                "latencies": len(lat),
                **{key: after[key] - before[key]
                   for key in ("batches", "ops_coalesced", "pack_s",
                               "packs")}}

    def stop(self) -> None:
        """The loop is drained at the end of every window: flush the
        engine, so nothing is left on the card."""
        self.engine.flush()
        if self.device == "cuda":
            torch.cuda.synchronize()

    # -- the comparison ------------------------------------------------------

    def check(self) -> dict:
        """Bytes that differ from the reference (read back, and chunk by
        chunk on the OSDs), chunk hashes that differ, acting sets that
        put two chunks on one host, failed writes, and objects never
        acknowledged, each beside its limit 0.  The read-back runs with
        the program's instruments off: the profiled window's spans stay
        the newest in the tracer's ring."""
        from ceph_tpu_torch.backend.ecutil import HINFO_KEY
        from ceph_tpu_torch.backend.memstore import GObject
        from ceph_tpu_torch.backend.pg_backend import shard_store
        from ceph_tpu_torch.common import instruments
        want: dict[int, list] = {}
        read_bad = chunk_bad = crc_bad = placement = 0
        with instruments.disabled():
            for name, j in sorted(self.acked.items()):
                if j not in want:
                    want[j] = self.ref.chunks(
                        np.frombuffer(self.payloads[j], dtype=np.uint8),
                        self.k, self.m, self.unit, device=self.device)
                got = np.frombuffer(self.io.read(name, self.op_bytes),
                                    dtype=np.uint8)
                pay = np.frombuffer(self.payloads[j], dtype=np.uint8)
                read_bad += (pay.size if got.shape != pay.shape else
                             int(np.count_nonzero(got != pay)))
                g = self.cluster.pg_group(self.pool, name)
                placement += not self.ref.distinct_hosts(
                    g.acting, lambda osd: osd // self.per_host)
            crcs = self._reference_crcs(want)
            for name, j in sorted(self.acked.items()):
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
        return {"read_bad_bytes": (read_bad, 0),
                "chunk_bad_bytes": (chunk_bad, 0),
                "hinfo_crc_mismatches": (crc_bad, 0),
                "acting_sets_sharing_a_host": (placement, 0),
                "writes_failed": (self.failed, 0),
                "objects_never_acked": (len(self.names) - len(self.acked),
                                        0)}

    def _reference_crcs(self, want: dict) -> dict[int, np.ndarray]:
        """Each payload's chunk hashes, all chunks at once."""
        order = sorted(want)
        rows = np.stack([chunk for j in order for chunk in want[j]])
        crc = self.ref.crc32c(self.ref.HINFO_SEED, rows, device=self.device)
        n = self.k + self.m
        return {j: crc[i * n:(i + 1) * n] for i, j in enumerate(order)}
