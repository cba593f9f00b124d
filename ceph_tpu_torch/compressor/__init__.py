"""Compression plugin registry (the EC registry's sibling pattern).

Mirror of the reference's compressor layer (reference:
src/compressor/Compressor.h — abstract ``compress/decompress`` :91-95,
``create(cct, type)`` factory :97-98, algorithm name/type mapping :76-77;
plugins under src/compressor/{zlib,snappy,zstd,lz4} loaded through the same
dlopen registry pattern as erasure-code plugins).  Algorithms available in
this environment: zlib (stdlib), zstd (zstandard), lzma/bz2 (stdlib extras);
snappy and lz4 are registered as unavailable and fail factory() with the
same error shape as an unloadable plugin.

The port's copy of ``ceph_tpu.compressor``. ``zstd`` registers only where ``zstandard`` imports.
"""
from __future__ import annotations

import abc
import bz2 as _bz2
import lzma as _lzma
import threading
import zlib as _zlib


class Compressor(abc.ABC):
    """(Compressor.h:33-95)."""

    name: str = ""

    @abc.abstractmethod
    def compress(self, data: bytes) -> bytes: ...

    @abc.abstractmethod
    def decompress(self, data: bytes) -> bytes: ...


class ZlibCompressor(Compressor):
    name = "zlib"

    def __init__(self, level: int = 5):
        self.level = level

    def compress(self, data: bytes) -> bytes:
        return _zlib.compress(bytes(data), self.level)

    def decompress(self, data: bytes) -> bytes:
        return _zlib.decompress(bytes(data))


class ZstdCompressor(Compressor):
    name = "zstd"

    def __init__(self, level: int = 1):
        import zstandard
        self._c = zstandard.ZstdCompressor(level=level)
        self._d = zstandard.ZstdDecompressor()

    def compress(self, data: bytes) -> bytes:
        return self._c.compress(bytes(data))

    def decompress(self, data: bytes) -> bytes:
        return self._d.decompress(bytes(data))


class LzmaCompressor(Compressor):
    name = "lzma"

    def compress(self, data: bytes) -> bytes:
        return _lzma.compress(bytes(data))

    def decompress(self, data: bytes) -> bytes:
        return _lzma.decompress(bytes(data))


class Bz2Compressor(Compressor):
    name = "bz2"

    def compress(self, data: bytes) -> bytes:
        return _bz2.compress(bytes(data))

    def decompress(self, data: bytes) -> bytes:
        return _bz2.decompress(bytes(data))


class CompressorRegistry:
    """Name -> factory map (the dlopen registry's shape, in-process)."""

    _instance = None
    _lock = threading.Lock()

    def __init__(self):
        self._factories = {
            "zlib": ZlibCompressor,
            "lzma": LzmaCompressor,
            "bz2": Bz2Compressor,
        }
        # the reference also ships snappy and lz4; algorithms whose library
        # is missing surface as load failures, never as ImportError
        self._unavailable = {"snappy", "lz4"}
        try:
            import zstandard  # noqa: F401
            self._factories["zstd"] = ZstdCompressor
        except ImportError:
            self._unavailable.add("zstd")

    @classmethod
    def instance(cls) -> "CompressorRegistry":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def supported(self) -> list[str]:
        return sorted(self._factories)

    def create(self, type: str, **kwargs) -> Compressor:
        """Compressor::create (Compressor.h:97)."""
        if type in self._unavailable:
            raise FileNotFoundError(
                f"load dlopen(libceph_{type}): library not available "
                f"(-ENOENT)")
        factory = self._factories.get(type)
        if factory is None:
            raise ValueError(f"unknown compression algorithm {type!r}")
        return factory(**kwargs)

    def register(self, name: str, factory) -> None:
        self._factories[name] = factory
        self._unavailable.discard(name)


def create(type: str, **kwargs) -> Compressor:
    return CompressorRegistry.instance().create(type, **kwargs)


__all__ = ["Compressor", "CompressorRegistry", "create", "ZlibCompressor",
           "ZstdCompressor", "LzmaCompressor", "Bz2Compressor"]
