"""xor: the trivial k-data/1-parity example plugin.

Mirror of the reference's example plugin
(reference: src/test/erasure-code/ErasureCodeExample.h — XOR k=2, m=1),
generalised to any k >= 2, m = 1.  Exists for the same reason the
reference's does: a minimal real plugin for registry and interface tests,
and the m=1 region_xor fast path (cf. ErasureCodeIsa.cc:119-131).  The port's
copy of the JAX package's plugin: host numpy only, as there.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np

from .. import __version__
from .base import ErasureCode
from .interface import ErasureCodeProfile
from .registry import ErasureCodePlugin, ErasureCodePluginRegistry


class ErasureCodeXor(ErasureCode):
    def __init__(self):
        super().__init__()
        self.k = 2

    def init(self, profile: ErasureCodeProfile) -> None:
        super().init(profile)
        self.k = self.to_int("k", profile, "2")
        m = self.to_int("m", profile, "1")
        if m != 1:
            raise ValueError(f"xor plugin requires m=1, got m={m}")
        self.sanity_check_k_m(self.k, 1)
        profile["plugin"] = profile.get("plugin", "xor")
        self._profile = profile

    def get_chunk_count(self) -> int:
        return self.k + 1

    def get_data_chunk_count(self) -> int:
        return self.k

    def encode_chunks(self, want_to_encode: set,
                      encoded: dict[int, np.ndarray]) -> None:
        parity = encoded[0].copy()
        for i in range(1, self.k):
            parity ^= encoded[i]
        encoded[self.k][:] = parity

    def decode_chunks(self, want_to_read: set, chunks: Mapping[int, np.ndarray],
                      decoded: dict[int, np.ndarray]) -> None:
        erasures = [i for i in range(self.k + 1) if i not in chunks]
        if len(erasures) > 1:
            raise IOError(f"xor cannot recover {len(erasures)} erasures")
        if not erasures:
            return
        e = erasures[0]
        acc = None
        for i in range(self.k + 1):
            if i == e:
                continue
            acc = decoded[i].copy() if acc is None else acc ^ decoded[i]
        decoded[e][:] = acc


class ErasureCodePluginXor(ErasureCodePlugin):
    def factory(self, directory: str, profile: ErasureCodeProfile) -> ErasureCodeXor:
        instance = ErasureCodeXor()
        instance.init(dict(profile))
        return instance


def __erasure_code_version__() -> str:
    return __version__


def __erasure_code_init__(name: str, directory: str) -> None:
    ErasureCodePluginRegistry.instance().add(name, ErasureCodePluginXor())
