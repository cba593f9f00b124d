"""The erasure-code plugin contract.

Python mirror of the reference's ``ErasureCodeInterface``
(reference: src/erasure-code/ErasureCodeInterface.h:170-462).  All codes are
systematic (interface doc :20-141).  Buffers are ``bytes``/``numpy uint8``
instead of bufferlists; an ``ErasureCodeProfile`` is a ``dict[str, str]``
(:155) validated by the plugin's ``init`` (:188).
"""
from __future__ import annotations

import abc
from typing import Mapping

import numpy as np

ErasureCodeProfile = dict  # map<string,string> (ErasureCodeInterface.h:155)


class ErasureCodeInterface(abc.ABC):
    """Abstract erasure code, method-for-method with the reference contract."""

    @abc.abstractmethod
    def init(self, profile: ErasureCodeProfile) -> None:
        """Initialize from a profile; raise ValueError on invalid parameters.

        On success the instance's get_profile() reflects the defaults it
        filled in (ErasureCodeInterface.h:188-196 semantics).
        """

    @abc.abstractmethod
    def get_profile(self) -> ErasureCodeProfile:
        """The profile as completed during init (:196)."""

    @abc.abstractmethod
    def create_rule(self, name: str, crush) -> int:
        """Create a CRUSH rule suited to this code in ``crush`` (:212)."""

    @abc.abstractmethod
    def get_chunk_count(self) -> int:
        """k + m (:227)."""

    @abc.abstractmethod
    def get_data_chunk_count(self) -> int:
        """k (:237)."""

    def get_coding_chunk_count(self) -> int:
        """m (:249)."""
        return self.get_chunk_count() - self.get_data_chunk_count()

    def get_sub_chunk_count(self) -> int:
        """>1 only for array/regenerating codes like clay (:259)."""
        return 1

    @abc.abstractmethod
    def get_chunk_size(self, object_size: int) -> int:
        """Chunk size for an object: get_chunk_size(n) * k >= n (:278)."""

    @abc.abstractmethod
    def minimum_to_decode(self, want_to_read: set, available: set
                          ) -> dict[int, list[tuple[int, int]]]:
        """Chunks (and per-chunk (sub-chunk offset, count) runs) needed to
        decode ``want_to_read`` out of ``available`` (:297).  Raises IOError
        when decoding is impossible."""

    @abc.abstractmethod
    def minimum_to_decode_with_cost(self, want_to_read: set,
                                    available: Mapping[int, int]) -> set:
        """Like minimum_to_decode but with per-chunk retrieval costs (:326)."""

    def supports_regenerating_repair(self) -> bool:
        """True when the code repairs a single lost chunk from d helper
        inner products (beta bytes each) instead of a k-chunk decode —
        the capability probe recovery/regen.py plans against."""
        return False

    def minimum_to_repair(self, shard: int, d: int,
                          costs: Mapping[int, int]) -> "set | list":
        """Helper set for repairing ``shard`` given per-chunk retrieval
        ``costs``.  Default: the cheapest decode set — non-regenerating
        codes repair by decoding, so helper selection degenerates to
        :meth:`minimum_to_decode_with_cost`.  Regenerating plugins
        override to return exactly ``d`` ranked helpers (and that rank
        order is the stream order their combine matrix expects)."""
        avail = {c: v for c, v in costs.items() if c != shard}
        return self.minimum_to_decode_with_cost({shard}, avail)

    @abc.abstractmethod
    def encode(self, want_to_encode: set, data: bytes) -> dict[int, np.ndarray]:
        """Split+pad ``data`` into k chunks, compute m parity chunks, return
        the requested subset {chunk index: chunk bytes} (:365)."""

    @abc.abstractmethod
    def encode_chunks(self, want_to_encode: set,
                      encoded: dict[int, np.ndarray]) -> None:
        """Low-level: fill the parity chunks of ``encoded`` in place (:370)."""

    @abc.abstractmethod
    def decode(self, want_to_read: set, chunks: Mapping[int, np.ndarray],
               chunk_size: int = 0) -> dict[int, np.ndarray]:
        """Decode the requested chunks from the available ones (:407)."""

    @abc.abstractmethod
    def decode_chunks(self, want_to_read: set, chunks: Mapping[int, np.ndarray],
                      decoded: dict[int, np.ndarray]) -> None:
        """Low-level: reconstruct missing chunks in ``decoded`` in place (:411)."""

    @abc.abstractmethod
    def get_chunk_mapping(self) -> list[int]:
        """Chunk index remapping, [] if identity (:448)."""

    @abc.abstractmethod
    def decode_concat(self, chunks: Mapping[int, np.ndarray]) -> bytes:
        """Decode the data chunks and return their concatenation (:460)."""
