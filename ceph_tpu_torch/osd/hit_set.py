"""Hit sets: bloom-filter records of recently accessed objects.

Analog of the reference's HitSet machinery (reference: src/osd/HitSet.h —
BloomHitSet over a compressible bloom filter with fpp/target_size/seed
params; PrimaryLogPG.h:952-966 accumulates one per period and persists an
archive ring).  The tiering agent estimates object "temperature" from how
many recent hit sets contain the object (PrimaryLogPG::agent_estimate_temp)
and evicts cold objects.

Divergence note: the reference's period is wall-clock
(hit_set_period seconds); here the period counts OPS so the in-process
cluster stays deterministic — same ring semantics, testable boundaries.

A copy of ``ceph_tpu.osd.hit_set``; its hashes are the port's host
``ecutil.crc32c``.
"""
from __future__ import annotations

import math
import struct

from ..backend.ecutil import crc32c

_HDR = struct.Struct("<IIQ")      # nbits, nhash, inserts


class BloomHitSet:
    """Bloom filter over object names (HitSet.h:323 BloomHitSet).

    Sized from ``target_size`` expected insertions at ``fpp`` false
    positive probability: m = -n*ln(p)/ln(2)^2 bits, k = m/n*ln(2)
    hashes — the standard construction the reference's
    compressible_bloom_filter uses.
    """

    def __init__(self, target_size: int = 1000, fpp: float = 0.05,
                 seed: int = 0):
        n = max(1, int(target_size))
        p = min(max(fpp, 1e-6), 0.5)
        self.nbits = max(8, int(-n * math.log(p) / (math.log(2) ** 2)))
        self.nhash = max(1, round(self.nbits / n * math.log(2)))
        self.seed = seed
        self.bits = bytearray((self.nbits + 7) // 8)
        self.inserts = 0

    def _positions(self, oid: str):
        data = oid.encode()
        h1 = crc32c(0xFFFFFFFF ^ (self.seed & 0xFFFFFFFF), data)
        h2 = crc32c(h1, data) | 1          # odd stride: full period
        for i in range(self.nhash):
            yield (h1 + i * h2) % self.nbits

    def insert(self, oid: str) -> None:
        for pos in self._positions(oid):
            self.bits[pos >> 3] |= 1 << (pos & 7)
        self.inserts += 1

    def contains(self, oid: str) -> bool:
        return all(self.bits[pos >> 3] & (1 << (pos & 7))
                   for pos in self._positions(oid))

    def is_full(self) -> bool:
        return self.inserts >= max(1, int(
            self.nbits * (math.log(2) ** 2) / -math.log(0.05)))

    # -- (de)serialisation (the archive object payload) ---------------------

    def to_bytes(self) -> bytes:
        return _HDR.pack(self.nbits, self.nhash, self.inserts) + \
            bytes(self.bits)

    @classmethod
    def from_bytes(cls, blob: bytes) -> "BloomHitSet":
        nbits, nhash, inserts = _HDR.unpack_from(blob)
        hs = cls.__new__(cls)
        hs.nbits, hs.nhash, hs.inserts = nbits, nhash, inserts
        hs.seed = 0
        hs.bits = bytearray(blob[_HDR.size:_HDR.size + (nbits + 7) // 8])
        return hs


# internal archive objects live outside the user namespace (NUL-embedded,
# like clone oids' SNAP_SEP)
HIT_SET_PREFIX = "hit_set\x00"


def archive_oid(n: int) -> str:
    return f"{HIT_SET_PREFIX}{n:08d}"


def is_hit_set_oid(oid: str) -> bool:
    return oid.startswith(HIT_SET_PREFIX)
