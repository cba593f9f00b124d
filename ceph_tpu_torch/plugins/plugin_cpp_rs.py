"""cpp_rs: the native C++ Reed-Solomon codec as a framework plugin.

The port's counterpart of the JAX package's ``cpp_rs``: it wraps the
native runtime's codec (native/src/plugin_cpp_rs.cc, loaded through the C
registry's dlopen contract, see ``ceph_tpu_torch.native``) in the Python
plugin interface, the layering of the reference, where the C++ isa plugin
wraps the isa-l assembly kernels (reference:
src/erasure-code/isa/ErasureCodeIsa.cc).  It is the synchronous host
path: one stripe's latency on the SIMD codec with no device dispatch,
the ``isa`` of the north-star comparison; ``torch_rs`` is the card's.

Profile: k, m, technique in {reed_sol_van (default), cauchy,
vandermonde_isa}, mapping.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np

from .. import __version__
from .base import ErasureCode
from .interface import ErasureCodeProfile
from .registry import ErasureCodePlugin, ErasureCodePluginRegistry


class ErasureCodeCppRS(ErasureCode):
    def __init__(self):
        super().__init__()
        self.k = 7
        self.m = 3
        self._codec = None

    def init(self, profile: ErasureCodeProfile) -> None:
        super().init(profile)
        from ..native import NativeRegistry
        self.parse_mapping(profile)
        self.k = self.to_int("k", profile, "7")
        self.m = self.to_int("m", profile, "3")
        if self.chunk_mapping and len(self.chunk_mapping) != self.k + self.m:
            raise ValueError(
                f"mapping {profile.get('mapping')} maps "
                f"{len(self.chunk_mapping)} chunks instead of {self.k + self.m}")
        technique = self.to_string("technique", profile, "reed_sol_van")
        self.sanity_check_k_m(self.k, self.m)
        self._codec = NativeRegistry.instance().factory(
            "cpp_rs", {"k": self.k, "m": self.m, "technique": technique})
        profile["plugin"] = profile.get("plugin", "cpp_rs")
        self._profile = profile

    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def encode_chunks(self, want_to_encode: set,
                      encoded: dict[int, np.ndarray]) -> None:
        data = np.stack([encoded[self.chunk_index(i)]
                         for i in range(self.k)])
        parity = self._codec.encode(data)
        for i in range(self.m):
            encoded[self.chunk_index(self.k + i)][:] = parity[i]

    def decode_chunks(self, want_to_read: set,
                      chunks: Mapping[int, np.ndarray],
                      decoded: dict[int, np.ndarray]) -> None:
        n = self.k + self.m
        erasures = [i for i in range(n) if i not in chunks]
        if not erasures:
            return
        # physical positions -> the codec's logical rows
        avail, erasures_l = self.remap_for_decode(chunks, erasures)
        chunk_size = next(iter(chunks.values())).nbytes
        out = self._codec.decode(avail, erasures_l, chunk_size)
        for e, buf in out.items():
            decoded[self.chunk_index(e)][:] = buf


class ErasureCodePluginCppRS(ErasureCodePlugin):
    def factory(self, directory: str,
                profile: ErasureCodeProfile) -> ErasureCodeCppRS:
        instance = ErasureCodeCppRS()
        instance.init(dict(profile))
        return instance


def __erasure_code_version__() -> str:
    return __version__


def __erasure_code_init__(name: str, directory: str) -> None:
    ErasureCodePluginRegistry.instance().add(name, ErasureCodePluginCppRS())
