"""ErasureCode base class: shared default behaviour for all plugins.

Python mirror of the reference base class (reference:
src/erasure-code/ErasureCode.{h,cc}): profile parsing helpers, chunk
remapping via ``mapping=DDD_D_`` strings, ``encode_prepare`` padding,
first-k-available ``minimum_to_decode`` and ``decode_concat``.

Alignment: the reference aligns chunks to SIMD_ALIGN=32 bytes for AVX
(ErasureCode.cc:42); the JAX package aligns to 128 bytes (the TPU lane
width), and this port keeps 128 so stored shards and HashInfo come out
byte-identical to it.  get_chunk_size(n)*k >= n still holds, which is the
only contract the interface requires (ErasureCodeInterface.h:278).
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..ops.codec import torch_device
from .interface import ErasureCodeInterface, ErasureCodeProfile

SIMD_ALIGN = 32          # reference AVX alignment (ErasureCode.cc:42)
CHUNK_ALIGN = 128        # the JAX package's chunk alignment, kept


# Calls of at least this many bytes run on the device under device=auto;
# the JAX package's ``ec_device_threshold_bytes`` default.
DEVICE_THRESHOLD_BYTES = 8 * 1024 * 1024


class DeviceRouting:
    """The device routing policy of the device-backed plugins: ``device``
    is cuda (the default) | cpu | numpy | auto.  Only a profile that asks
    for auto gets the size split: a call of at least the threshold
    (profile ``device-threshold``, or its alias ``jax-threshold``, else
    :data:`DEVICE_THRESHOLD_BYTES`) runs on cuda, a smaller one on the
    numpy host codec."""

    DEVICES = ("cuda", "cpu", "numpy", "auto")

    def parse_device_routing(self, profile) -> None:
        self.device = self.to_string("device", profile, "cuda")
        if self.device not in self.DEVICES:
            raise ValueError(
                f"device={self.device} must be cuda|cpu|numpy|auto")
        self.device_threshold = DEVICE_THRESHOLD_BYTES
        for key in ("device-threshold", "jax-threshold"):
            if key in profile:
                self.device_threshold = self.to_int(
                    key, profile, str(DEVICE_THRESHOLD_BYTES))
                break

    def use_device(self, nbytes: int) -> bool:
        """Should this call run on a torch device (cuda or cpu)?"""
        if self.device != "auto":
            return self.device != "numpy"
        return nbytes >= self.device_threshold

    def tensor_device(self) -> torch.device:
        """The torch device of a call :meth:`use_device` sends to tensors:
        the CPU for device=cpu, else the card (raising without one)."""
        return torch_device("cpu" if self.device == "cpu" else "cuda")


class ErasureCode(ErasureCodeInterface):
    DEFAULT_RULE_ROOT = "default"
    DEFAULT_RULE_FAILURE_DOMAIN = "host"

    def __init__(self):
        self._profile: ErasureCodeProfile = {}
        self.chunk_mapping: list[int] = []
        self.rule_root = self.DEFAULT_RULE_ROOT
        self.rule_failure_domain = self.DEFAULT_RULE_FAILURE_DOMAIN
        self.rule_device_class = ""

    # -- profile helpers (ErasureCode.cc:295-343) --------------------------

    @staticmethod
    def to_int(name: str, profile: ErasureCodeProfile, default: str) -> int:
        if not profile.get(name):
            profile[name] = default
        try:
            return int(profile[name])
        except ValueError as e:
            raise ValueError(f"could not convert {name}={profile[name]} to int") from e

    @staticmethod
    def to_bool(name: str, profile: ErasureCodeProfile, default: str) -> bool:
        if not profile.get(name):
            profile[name] = default
        return profile[name] in ("yes", "true")

    @staticmethod
    def to_string(name: str, profile: ErasureCodeProfile, default: str) -> str:
        if not profile.get(name):
            profile[name] = default
        return profile[name]

    @staticmethod
    def sanity_check_k_m(k: int, m: int) -> None:
        if k < 2:
            raise ValueError(f"k={k} must be >= 2")
        if m < 1:
            raise ValueError(f"m={m} must be >= 1")

    # -- init / rules ------------------------------------------------------

    def init(self, profile: ErasureCodeProfile) -> None:
        self.rule_root = self.to_string("crush-root", profile,
                                        self.DEFAULT_RULE_ROOT)
        self.rule_failure_domain = self.to_string("crush-failure-domain", profile,
                                                  self.DEFAULT_RULE_FAILURE_DOMAIN)
        self.rule_device_class = self.to_string("crush-device-class", profile, "")
        self._profile = profile

    def get_profile(self) -> ErasureCodeProfile:
        return self._profile

    def create_rule(self, name: str, crush) -> int:
        """ErasureCode::create_rule semantics (ErasureCode.cc:64-83): an
        'indep' rule rooted at crush-root over crush-failure-domain."""
        return crush.add_simple_rule(
            name, self.rule_root, self.rule_failure_domain,
            self.rule_device_class, mode="indep",
            num_rep=self.get_chunk_count())

    # -- chunk mapping (ErasureCode.cc:274-293) ----------------------------

    def parse_mapping(self, profile: ErasureCodeProfile) -> None:
        mapping = profile.get("mapping")
        if not mapping:
            return
        data_pos, coding_pos = [], []
        for position, ch in enumerate(mapping):
            (data_pos if ch == "D" else coding_pos).append(position)
        self.chunk_mapping = data_pos + coding_pos

    def chunk_index(self, i: int) -> int:
        return self.chunk_mapping[i] if len(self.chunk_mapping) > i else i

    def remap_for_decode(self, chunks, erasures):
        """Translate physically-keyed available chunks + erasure ids into
        the codec's logical row space (decode-side counterpart of the
        chunk_index remap encode applies)."""
        if not self.chunk_mapping:
            return dict(chunks), list(erasures)
        inv = [0] * len(self.chunk_mapping)
        for logical, phys in enumerate(self.chunk_mapping):
            inv[phys] = logical
        return ({inv[i]: v for i, v in chunks.items()},
                [inv[i] for i in erasures])

    def get_chunk_mapping(self) -> list[int]:
        return self.chunk_mapping

    # -- sizes -------------------------------------------------------------

    def get_alignment(self) -> int:
        return CHUNK_ALIGN

    def get_chunk_size(self, object_size: int) -> int:
        """Per-chunk-aligned sizing (cf. ErasureCodeJerasure.cc:80-104
        per_chunk_alignment branch, with CHUNK_ALIGN as alignment)."""
        k = self.get_data_chunk_count()
        alignment = self.get_alignment()
        chunk_size = (object_size + k - 1) // k
        modulo = chunk_size % alignment
        if modulo:
            chunk_size += alignment - modulo
        return max(chunk_size, alignment)

    # -- minimum_to_decode (ErasureCode.cc:103-146) ------------------------

    def _minimum_to_decode(self, want_to_read: set, available: set) -> set:
        want_to_read = set(want_to_read)
        available = set(available)
        if want_to_read <= available:
            return set(want_to_read)
        k = self.get_data_chunk_count()
        if len(available) < k:
            raise IOError(
                f"cannot decode: {len(available)} chunks available, need {k}")
        return set(sorted(available)[:k])

    def minimum_to_decode(self, want_to_read: set, available: set
                          ) -> dict[int, list[tuple[int, int]]]:
        minimum = self._minimum_to_decode(want_to_read, available)
        sub = [(0, self.get_sub_chunk_count())]
        return {i: list(sub) for i in sorted(minimum)}

    def minimum_to_decode_with_cost(self, want_to_read: set,
                                    available: Mapping[int, int]) -> set:
        """Pick decode sources by repair cost (ErasureCode.cc:137-146
        semantics, made topology-aware): when the wanted chunks all
        survive, read them directly regardless of cost; otherwise take
        the cheapest |minimum| sources — ``available`` maps chunk id to
        a cost such as CRUSH distance from the repair target, so chains
        prefer near survivors (cf. the repair-cost-aware selection of
        the product-matrix regenerating-code work, arXiv:1412.3022)."""
        if set(want_to_read) <= set(available):
            return set(want_to_read)
        base = self._minimum_to_decode(want_to_read, set(available))
        ranked = sorted(available, key=lambda c: (available[c], c))
        return set(ranked[:len(base)])

    def partial_sum_coefficients(self, erasures: set, sources: list[int]):
        """Per-source decode coefficients for chained streaming repair:
        ``(coeffs, rows)`` where ``coeffs[source chunk]`` is one GF
        coefficient per erased row and ``rows`` lists the erased chunk
        each row reconstructs, such that XOR over sources of
        ``coeff * chunk`` yields each erased chunk — the partial sums a
        RapidRAID-style hop chain accumulates.  None (the default) means
        the code has no whole-chunk linear repair form (sub-chunked/
        clay, LRC locality) and the caller must keep centralized
        decode."""
        return None

    # -- encode (ErasureCode.cc:151-204) -----------------------------------

    def encode_prepare(self, raw: bytes) -> dict[int, np.ndarray]:
        """Split+pad ``raw`` into k data chunks and allocate m parity chunks,
        with the reference's padding layout (ErasureCode.cc:151-186): chunks
        fully covered by the payload are slices; the straddling chunk is
        zero-padded; fully-padded chunks are zeros."""
        k = self.get_data_chunk_count()
        m = self.get_coding_chunk_count()
        raw = np.frombuffer(raw, dtype=np.uint8) if isinstance(raw, (bytes, bytearray)) \
            else np.asarray(raw, dtype=np.uint8)
        blocksize = self.get_chunk_size(len(raw))
        padded_chunks = k - len(raw) // blocksize
        encoded: dict[int, np.ndarray] = {}
        for i in range(k - padded_chunks):
            encoded[self.chunk_index(i)] = raw[i * blocksize:(i + 1) * blocksize].copy()
        if padded_chunks:
            remainder = len(raw) - (k - padded_chunks) * blocksize
            buf = np.zeros(blocksize, dtype=np.uint8)
            buf[:remainder] = raw[(k - padded_chunks) * blocksize:]
            encoded[self.chunk_index(k - padded_chunks)] = buf
            for i in range(k - padded_chunks + 1, k):
                encoded[self.chunk_index(i)] = np.zeros(blocksize, dtype=np.uint8)
        for i in range(k, k + m):
            encoded[self.chunk_index(i)] = np.zeros(blocksize, dtype=np.uint8)
        return encoded

    def encode(self, want_to_encode: set, data: bytes) -> dict[int, np.ndarray]:
        encoded = self.encode_prepare(data)
        self.encode_chunks(set(range(self.get_chunk_count())), encoded)
        return {i: encoded[i] for i in want_to_encode}

    # -- decode (ErasureCode.cc:212-253) -----------------------------------

    def _decode(self, want_to_read: set,
                chunks: Mapping[int, np.ndarray]) -> dict[int, np.ndarray]:
        chunks = {i: np.asarray(v, dtype=np.uint8) for i, v in chunks.items()}
        if set(want_to_read) <= set(chunks):
            return {i: chunks[i] for i in want_to_read}
        k = self.get_data_chunk_count()
        m = self.get_coding_chunk_count()
        blocksize = len(next(iter(chunks.values())))
        decoded: dict[int, np.ndarray] = {}
        for i in range(k + m):
            if i in chunks:
                decoded[i] = chunks[i]
            else:
                decoded[i] = np.zeros(blocksize, dtype=np.uint8)
        self.decode_chunks(set(want_to_read), chunks, decoded)
        return {i: decoded[i] for i in want_to_read}

    def decode(self, want_to_read: set, chunks: Mapping[int, np.ndarray],
               chunk_size: int = 0) -> dict[int, np.ndarray]:
        return self._decode(want_to_read, chunks)

    def decode_concat(self, chunks: Mapping[int, np.ndarray]) -> bytes:
        """Decode and concatenate the data chunks (ErasureCode.cc:345-361)."""
        k = self.get_data_chunk_count()
        want = {self.chunk_index(i) for i in range(k)}
        decoded = self._decode(want, chunks)
        return b"".join(decoded[self.chunk_index(i)].tobytes() for i in range(k))

    # subclasses must provide encode_chunks/decode_chunks and the counts
    def encode_chunks(self, want_to_encode, encoded):
        raise NotImplementedError("encode_chunks not implemented")

    def decode_chunks(self, want_to_read, chunks, decoded):
        raise NotImplementedError("decode_chunks not implemented")
