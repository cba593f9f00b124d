"""The at-rest checksum error of the BlueStore-like object store.

A cut of ``ceph_tpu.backend.bluestore`` to its exception: the OSD shard
and the EC backend catch :class:`ChecksumError` from any store's read
(an EIO reply, a rotten recovery source, a chain hop's abort).  The
store itself (``BlueStoreLite``: blobs, extents and per-blob crc32c at
rest) is still to port; the port's shards run on :class:`MemStore`,
which never raises it.
"""
from __future__ import annotations


class ChecksumError(IOError):
    """A blob's bytes at rest no longer match their stored crc32c (the
    reference returns -EIO from _verify_csum)."""
