"""Traffic generator: encode and degraded decode of stripes that live on the card.

The traffic of ``ceph_erasure_code_benchmark`` with the data already in
device memory: a batch of ``stripes`` distinct stripes, held shard-major
as [k, stripes * chunk], is encoded by ``RSCodec.encode_device``, and a
batch of survivors [stripes, k, chunk] (chunk ids ``survivors``) is
decoded by ``RSCodec.decode_batch_device`` into the ``erasures``.  There
are ``input_sets`` such pairs of batches, all of the same shapes and all
distinct; the calls go round them, an encode and a decode of one set,
then of the next, dispatched ahead with no wait inside the window; the
window ends when the card has finished what was dispatched.

Traffic keys: ``stripes``, ``erasures``, ``input_sets``,
``warmup_calls``.  The configuration gives the profile and
``stripe_bytes``.

``correct``: the parity and the recovered chunks of the first call on
each input set and of the last call of each window, every byte, each
against the plain reference computed over its own inputs on the same
device after the windows.  Consecutive calls read different inputs, so
an output buffer shared by calls in flight together, or a result kept
from the call before, shows.
"""
from __future__ import annotations

import time

import torch


def make_codec(config: dict, device: str):
    """The profile's plugin through the port's registry, on ``device``."""
    from ceph_tpu_torch.plugins.registry import ErasureCodePluginRegistry
    prof = config["profile"]
    profile = {"plugin": prof["plugin"], "k": str(prof["k"]),
               "m": str(prof["m"]), "technique": prof["technique"],
               "device": device}
    return ErasureCodePluginRegistry.instance().factory(
        prof["plugin"], "", profile)


def generator(seed: int, device: str) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return gen


class Generator:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str,
                 reference):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.ref = device, reference
        prof = config["profile"]
        self.k, self.m = int(prof["k"]), int(prof["m"])
        self.stripes = int(traffic["stripes"])
        self.chunk = int(config["stripe_bytes"]) // self.k
        self.erasures = sorted(int(e) for e in traffic["erasures"])
        self.survivors = [c for c in range(self.k + self.m)
                          if c not in self.erasures][:self.k]
        self.sets = int(traffic["input_sets"])
        self.kept: list[tuple] = []           # (input set, parity, recovered)
        self.ec = self.codec = None
        self.data: list[torch.Tensor] = []
        self.surv: list[torch.Tensor] = []

    def _sync(self) -> None:
        if self.device == "cuda":
            torch.cuda.synchronize()

    def _pair(self, s: int):
        parity = self.codec.encode_device(self.data[s])
        rec = self.codec.decode_batch_device(self.surv[s], self.survivors,
                                             self.erasures)
        return parity, rec

    def setup(self) -> None:
        self.ec = make_codec(self.config, self.device)
        self.codec = self.ec.codec
        gen = generator(self.seed, self.device)
        n = self.stripes * self.chunk
        for _ in range(self.sets):
            self.data.append(torch.randint(
                0, 256, (self.k, n), dtype=torch.uint8, device=self.device,
                generator=gen))
            self.surv.append(torch.randint(
                0, 256, (self.stripes, self.k, self.chunk), dtype=torch.uint8,
                device=self.device, generator=gen))
        for i in range(int(self.traffic["warmup_calls"])):
            self._pair(i % self.sets)
        self._sync()

    def window(self, seconds: float, probe=None) -> dict:
        self._sync()
        if probe is not None:
            probe.start()
        t0 = time.perf_counter()
        pairs, first = 0, {}
        while True:
            s = pairs % self.sets
            out = self._pair(s)
            pairs += 1
            first.setdefault(s, out)
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        elapsed = time.perf_counter() - t0
        if probe is not None:
            probe.end_window()
            probe.finish()
        self.kept += [(i, *o) for i, o in first.items()] + [(s, *out)]
        stripe_bytes = self.k * self.chunk
        return {"seconds": elapsed, "attempted": 2 * pairs, "failed": 0,
                "bytes": 2 * pairs * self.stripes * stripe_bytes}

    def stop(self) -> None:
        self.ec = self.codec = None

    def check(self) -> dict:
        """Bytes that differ from the reference, each beside its limit 0."""
        ref = self.ref
        parity_mat = ref.reed_sol_van(self.k, self.m)
        rec_mat = ref.recovery_matrix(parity_mat, self.survivors,
                                      self.erasures)
        bad_parity = bad_rec = 0
        for s in range(self.sets):
            kept = [(p, r) for i, p, r in self.kept if i == s]
            if not kept:
                continue
            want_parity = ref.apply(parity_mat, self.data[s])
            folded = self.surv[s].transpose(0, 1).reshape(self.k, -1)
            want_rec = ref.apply(rec_mat, folded).view(
                len(self.erasures), self.stripes, self.chunk).transpose(0, 1)
            for parity, rec in kept:
                bad_parity += int((parity != want_parity).sum())
                bad_rec += int((rec != want_rec).sum())
            del want_parity, want_rec
        return {"encode_bad_bytes": (bad_parity, 0),
                "decode_bad_bytes": (bad_rec, 0)}
