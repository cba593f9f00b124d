"""Traffic generator: closed-loop writers on a started ``ServingEngine``.

``clients`` clients, each submitting its next write (``submit_encode`` of
a payload of ``op_bytes``) the moment its last one completes (the loop of
``ceph_tpu_torch/exec/workload.py``'s ``closed_loop``, copied, made to run
until told to stop instead of to a count of ops).  Traffic keys:

- ``distinct_payloads`` payloads made from the seed, cycled through; on a
  card they live in pinned host memory, written whole before the first
  op, so no page of a payload is first touched or moved inside the loop;
- ``warmup_seconds`` of the same loop before the first window;
- ``sample_every``: one op in that many, from an offset drawn from the
  seed, keeps a copy of its result for the check.

The configuration gives the profile, ``stripe_unit`` and the engine's
settings.  The window counts the ops that complete inside it; the loop
runs on between windows and stops after the last one.  The card's peak
memory is reset once the set-up is done, so ``memory_peak_bytes`` is
what the served path holds, not the making of its inputs.

``correct``: every sampled op's result, every byte of its twelve chunks,
against the plain reference's chunks of its payload, and no op failed or
left unfinished.
"""
from __future__ import annotations

import random
import threading
import time

import numpy as np
import torch

from benchmark.stats import nearest_rank

#: seconds the loop waits for its last ops to finish after it stops
DRAIN_S = 60.0


def make_engine(config: dict, device: str):
    """The profile's plugin and a started engine with the configuration's
    settings (each passed, so a changed default cannot move the cell)."""
    from ceph_tpu_torch.backend import StripeInfo
    from ceph_tpu_torch.exec import ServingEngine
    from ceph_tpu_torch.plugins.registry import ErasureCodePluginRegistry
    prof, eng = config["profile"], config["engine"]
    profile = {"plugin": prof["plugin"], "k": str(prof["k"]),
               "m": str(prof["m"]), "technique": prof["technique"],
               "device": device}
    ec = ErasureCodePluginRegistry.instance().factory(
        prof["plugin"], "", profile)
    sinfo = StripeInfo(int(prof["k"]), int(config["stripe_unit"]))
    engine = ServingEngine(
        ec_impl=ec, sinfo=sinfo, name="benchmark",
        max_bytes=int(eng["throttle_bytes"]),
        max_ops=int(eng["throttle_ops"]),
        fail_fast=bool(eng["fail_fast"]),
        batch_max_delay_ms=float(eng["batch_max_delay_ms"]),
        batch_max_ops=int(eng["batch_max_ops"]),
        pipeline_depth=int(eng["pipeline_depth"]))
    return ec, sinfo, engine


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
        rng = random.Random(seed)
        self.every = int(traffic["sample_every"])
        self.offset = rng.randrange(self.every)
        self._lock = threading.Lock()
        self._submitted = 0
        self._running = False
        self._in_flight = 0
        self._idle = threading.Condition(self._lock)
        self.done: list[tuple] = []          # (t_submit, t_done, ok)
        self.samples: list[tuple] = []       # (payload index, result)
        self.engine = self.ec = None

    # -- inputs --------------------------------------------------------------

    def _make_payloads(self) -> None:
        """The payloads, one at a time from a generator on the device,
        into one host block (pinned on a card)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(self.seed) % (1 << 63))
        n = int(self.traffic["distinct_payloads"])
        block = torch.empty((n, self.op_bytes), dtype=torch.uint8,
                            pin_memory=self.device == "cuda")
        for i in range(n):
            block[i].copy_(torch.randint(0, 256, (self.op_bytes,),
                                         dtype=torch.uint8,
                                         device=self.device, generator=gen))
        self.block = block.numpy()
        self.requests = list(self.block)

    def _chunks(self, i: int) -> dict[int, np.ndarray]:
        """The reference's twelve chunks of payload i."""
        stripes = self.op_bytes // (self.k * self.unit)
        data = self.block[i].reshape(stripes, self.k, self.unit) \
            .transpose(1, 0, 2).reshape(self.k, -1)
        parity = self.ref.apply(
            self.ref.reed_sol_van(self.k, self.m),
            torch.from_numpy(np.ascontiguousarray(data)).to(self.device))
        parity = parity.cpu().numpy()
        return {c: (data[c] if c < self.k else parity[c - self.k])
                for c in range(self.k + self.m)}

    # -- the loop ------------------------------------------------------------

    def _submit_next(self) -> None:
        with self._lock:
            if not self._running:
                return
            i = self._submitted
            self._submitted += 1
            self._in_flight += 1
        j = i % len(self.requests)
        fut = self.engine.submit_encode(self.requests[j])
        fut.add_done_callback(
            lambda f, i=i, j=j: self._on_done(f, i, j))

    def _on_done(self, fut, i: int, j: int) -> None:
        ok = fut.exception(0) is None
        if ok and i % self.every == self.offset:
            copy = {c: np.array(v) for c, v in fut.result(0).items()}
            with self._lock:
                self.samples.append((j, copy))
        with self._lock:
            self.done.append((fut.t_submit, fut.t_done, ok))
            self._in_flight -= 1
            if not self._in_flight:
                self._idle.notify_all()
        self._submit_next()

    def _warm_shapes(self) -> None:
        """Book every launch shape the loop can make (a batch of 1 to
        ``clients`` ops) before the window: a first launch of a shape is
        timed synchronously by the program's launch ledger."""
        from ceph_tpu_torch.ops import rs_kernels
        mat = self.ec.codec.parity_matrix_device()
        cols = self.op_bytes // self.k
        for ops in range(1, self.clients + 1):
            rs_kernels.gf_apply(mat, torch.zeros(
                (self.k, ops * cols), dtype=torch.uint8, device=self.device))
        if self.device == "cuda":
            torch.cuda.synchronize()

    def setup(self) -> None:
        self.ec, _sinfo, self.engine = make_engine(self.config, self.device)
        self._make_payloads()
        self._warm_shapes()
        if self.device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        self.engine.start()
        self._running = True
        for _ in range(self.clients):
            self._submit_next()
        time.sleep(float(self.traffic["warmup_seconds"]))

    def _counters(self) -> dict:
        eng = self.engine.perf
        pack = self.engine.pipeline.perf.dump()["pack_time"]
        with self._lock:
            submitted = self._submitted
        return {"batches": eng.get("batches"),
                "ops_coalesced": eng.get("ops_coalesced"),
                "pack_s": pack["sum"], "packs": pack["avgcount"],
                "submitted": submitted}

    def window(self, seconds: float, probe=None) -> dict:
        if probe is not None:
            probe.start()
        before = self._counters()
        t0 = time.monotonic()
        time.sleep(seconds)
        t1 = time.monotonic()
        after = self._counters()
        if probe is not None:
            probe.end_window()
            self.stop_loop()
            probe.finish()
        with self._lock:
            done = [d for d in self.done if t0 <= d[1] < t1]
        lat = sorted(t_done - t_sub for t_sub, t_done, _ok in done)
        return {"seconds": t1 - t0,
                "attempted": after["submitted"] - before["submitted"],
                "failed": sum(1 for d in done if not d[2]),
                "bytes": len(done) * self.op_bytes,
                "latency_p95_s": nearest_rank(lat, 95),
                "latencies": len(lat),
                **{k: after[k] - before[k]
                   for k in ("batches", "ops_coalesced", "pack_s", "packs")}}

    def stop_loop(self) -> None:
        """Submit no more, and wait for what is in flight."""
        with self._lock:
            self._running = False
            if not self._idle.wait_for(lambda: not self._in_flight,
                                       DRAIN_S):
                raise TimeoutError(f"{self._in_flight} ops unfinished "
                                   f"{DRAIN_S} s after the loop stopped")
        if self.device == "cuda":
            torch.cuda.synchronize()

    def stop(self) -> None:
        if self._running:
            self.stop_loop()
        self.engine.stop()
        self.engine = self.ec = None

    def check(self) -> dict:
        """Bytes that differ from the reference over the sampled ops,
        failed ops, and a run with no op sampled, each beside its limit
        0.  A chunk that is missing or of the wrong size counts whole."""
        want: dict[int, dict] = {}
        bad = 0
        for j, got in self.samples:
            if j not in want:
                want[j] = self._chunks(j)
            for c, ref_chunk in want[j].items():
                mine = got.get(c)
                bad += (ref_chunk.size if mine is None
                        or mine.shape != ref_chunk.shape
                        else int(np.count_nonzero(mine != ref_chunk)))
        failed = sum(1 for d in self.done if not d[2])
        return {"result_bad_bytes": (bad, 0),
                "ops_failed": (failed, 0),
                "no_sample": (0 if self.samples else 1, 0)}
