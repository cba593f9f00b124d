"""torch_rs: the Reed-Solomon plugin on the card.

The port's counterpart of the JAX package's ``jax_rs`` plugin: systematic
RS over GF(2^8) whose encode_chunks/decode_chunks run through
:class:`ceph_tpu_torch.ops.RSCodec` (the hand CUDA kernels on the card).

Profile parameters:
  k, m        chunk counts (defaults 7/3, jerasure's defaults,
              ErasureCodeJerasure.h:81)
  technique   reed_sol_van (systematic ext-Vandermonde; default) |
              vandermonde (ISA gf_gen_rs_matrix) | cauchy (gf_gen_cauchy1)
  w           Galois field width; only 8 is supported
  device      cuda (the hand kernels; default) | cpu (their plain PyTorch
              versions) | numpy (host reference codec) | auto (numpy below
              the threshold bytes per call, cuda at or above it)
  device-threshold   byte cutoff for device=auto (alias: jax-threshold);
              default 8 MiB
  variant     accepted for jax_rs profile compatibility and not read: the
              card always runs the kernel, a CPU tensor its plain version
  mapping    DDD_D_-style chunk remapping (ErasureCode.cc:274-293)
"""
from __future__ import annotations

from typing import Mapping

import numpy as np

from .. import __version__
from ..ops.codec import RSCodec, TECHNIQUES
from .base import DeviceRouting, ErasureCode
from .interface import ErasureCodeProfile
from .registry import ErasureCodePlugin, ErasureCodePluginRegistry


class ErasureCodeTorchRS(DeviceRouting, ErasureCode):
    DEFAULT_K = "7"
    DEFAULT_M = "3"

    def __init__(self, technique: str = "reed_sol_van"):
        super().__init__()
        self.technique = technique
        self.k = 0
        self.m = 0
        self.w = 8
        self.codec: RSCodec | None = None
        self.device = "cuda"

    # -- init --------------------------------------------------------------

    def init(self, profile: ErasureCodeProfile) -> None:
        super().init(profile)
        self.parse_mapping(profile)
        self.k = self.to_int("k", profile, self.DEFAULT_K)
        self.m = self.to_int("m", profile, self.DEFAULT_M)
        self.w = self.to_int("w", profile, "8")
        if self.w != 8:
            raise ValueError(f"w={self.w} must be 8 (GF(2^8))")
        if self.chunk_mapping and len(self.chunk_mapping) != self.k + self.m:
            raise ValueError(
                f"mapping {profile.get('mapping')} maps "
                f"{len(self.chunk_mapping)} chunks instead of {self.k + self.m}")
        self.sanity_check_k_m(self.k, self.m)
        technique = self.to_string("technique", profile, self.technique)
        if technique not in TECHNIQUES:
            raise ValueError(
                f"technique={technique} must be one of {sorted(TECHNIQUES)}")
        self.technique = technique
        self.parse_device_routing(profile)
        # one codec per backend; 'auto' keeps cuda and numpy and routes per
        # call size
        dev = "cuda" if self.device == "auto" else self.device
        self.codec = RSCodec(self.k, self.m, technique=self.technique,
                             device=dev)
        self._cpu_codec = self.codec if dev == "numpy" else \
            RSCodec(self.k, self.m, technique=self.technique, device="numpy")
        profile["plugin"] = profile.get("plugin", "torch_rs")
        self._profile = profile

    def _route(self, nbytes: int) -> RSCodec:
        return self.codec if self.use_device(nbytes) else self._cpu_codec

    def device_codec(self, nbytes: int) -> RSCodec | None:
        """The tensor codec (cuda or cpu) a call of this size runs on, or
        None when routing says host (numpy device, or an auto call below
        the threshold).  The capability hook ``ecutil`` probes for."""
        codec = self._route(int(nbytes))
        return codec if codec.device != "numpy" else None

    # -- counts ------------------------------------------------------------

    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    # -- encode/decode -----------------------------------------------------

    def encode_chunks(self, want_to_encode: set,
                      encoded: dict[int, np.ndarray]) -> None:
        k, m = self.k, self.m
        data = np.stack([encoded[self.chunk_index(i)] for i in range(k)])
        parity = self._route(data.nbytes).encode(data)
        for i in range(m):
            encoded[self.chunk_index(k + i)][:] = parity[i]

    def decode_chunks(self, want_to_read: set, chunks: Mapping[int, np.ndarray],
                      decoded: dict[int, np.ndarray]) -> None:
        erasures = [i for i in range(self.k + self.m) if i not in chunks]
        if not erasures:
            return
        # chunk ids on the wire are PHYSICAL positions; the codec's matrix
        # rows are LOGICAL — translate through the profile mapping both
        # ways (encode remaps via chunk_index; decode must invert it)
        avail, erasures_l = self.remap_for_decode(
            {i: decoded[i] for i in chunks}, erasures)
        nbytes = sum(v.nbytes for v in avail.values())
        rec = self._route(nbytes).decode(avail, erasures_l)
        for e, buf in rec.items():
            decoded[self.chunk_index(e)][:] = buf

    def partial_sum_coefficients(self, erasures: set, sources: list[int]):
        """RS is linear over GF(2^8): the decode matrix row for each
        erased chunk IS the per-source coefficient vector, so a hop
        chain can accumulate ``coeff * local_chunk`` partial sums.  Chunk
        ids in and out are PHYSICAL; the codec works in logical rows.
        Returns ``(coeffs, rows)`` — ``coeffs[source] = (c_row0, ...)``
        and ``rows`` the erased physical chunk each row reconstructs."""
        # remap_for_decode carries the VALUE through: {logical: physical}
        avail_l, erasures_l = self.remap_for_decode(
            {int(c): int(c) for c in sources},
            sorted(int(e) for e in erasures))
        if len(avail_l) < self.k or not erasures_l:
            return None
        erasures_l = sorted(erasures_l)
        D, src = self.codec.decode_matrix(erasures_l,
                                          available=list(avail_l))
        coeffs = {int(avail_l[s]): tuple(int(D[r, i])
                                         for r in range(D.shape[0]))
                  for i, s in enumerate(src)}
        rows = [self.chunk_index(e) for e in erasures_l]
        return coeffs, rows


class ErasureCodePluginTorchRS(ErasureCodePlugin):
    def factory(self, directory: str,
                profile: ErasureCodeProfile) -> ErasureCodeTorchRS:
        technique = profile.get("technique", "reed_sol_van")
        instance = ErasureCodeTorchRS(technique)
        instance.init(dict(profile))
        return instance


def __erasure_code_version__() -> str:
    return __version__


def __erasure_code_init__(name: str, directory: str) -> None:
    ErasureCodePluginRegistry.instance().add(name, ErasureCodePluginTorchRS())
