"""Carry codec state from the JAX package into this port.

A codec has no weights; its state is its matrices (the parity matrix and
the erasure-signature LRU of decode matrices) and, per object, the running
shard checksums of a HashInfo.  Both cross as plain numpy arrays and
dicts, so this module imports nothing of the JAX package:

- :func:`codec_from_reference` takes a reference ``RSCodec``'s
  ``parity_mat`` and its decode-LRU entries;
- :func:`bitmatrix_from_reference` takes a reference jerasure bitmatrix
  plugin's ``coding`` matrix;
- :func:`hashinfo_from_dict` takes ``HashInfo.to_dict()``.

A placement has no weights either: its state is the CRUSH map and the
OSDMap, which cross as the reference's ``to_dict()`` output, read
unchanged by :func:`crushmap_from_reference` and
:func:`osdmap_from_reference` (whose ``to_dict`` writes the same dict
back).

An OSD backend has no weights either: its state is the shard stores
(object bytes, attributes, and the pgmeta omap holding the pickled PG
log, its bounds and the rollback records).  They cross as a plain-dict
dump of the reference's ``MemStore``s, read by
:func:`shard_stores_from_reference`, which rebuilds the pickled PG log
entries and rollback records as the port's classes without importing
the reference package (``OSDShard`` boots its PG log from them).
"""
from __future__ import annotations

import io
import pickle

import numpy as np

from .backend.ecutil import HashInfo
from .backend.memstore import GObject, MemStore, _Object
from .crush.map import CrushMap
from .ops.codec import RSCodec, _DecodeTables
from .osd.pg_log import PGLogEntry
from .osdmap.osdmap import OSDMap
from .plugins.plugin_jerasure import ErasureCodeJerasureBitmatrix


def codec_from_reference(parity_mat: np.ndarray, k: int, m: int,
                         technique: str,
                         decode_tables: dict | None = None,
                         device: str = "cuda") -> RSCodec:
    """A port ``RSCodec`` holding the reference codec's state.

    ``decode_tables`` maps an LRU signature ``(erasures, available)`` (the
    reference's ``_decode_cache`` keys) to ``(D, src)``.  The LRU is
    pre-filled in the given order and, for a tensor device, every matrix
    is uploaded once now.  Raises ValueError if ``parity_mat`` is not this
    port's own construction for ``technique``."""
    codec = RSCodec(k, m, technique=technique, device=device)
    parity_mat = np.asarray(parity_mat, dtype=np.uint8)
    if parity_mat.shape != codec.parity_mat.shape or \
            not np.array_equal(parity_mat, codec.parity_mat):
        raise ValueError(f"parity_mat differs from the port's {technique} "
                         f"construction for k={k} m={m}")
    for sig, (D, src) in (decode_tables or {}).items():
        erasures, available = sig
        sig = (tuple(int(e) for e in erasures),
               None if available is None else tuple(int(a) for a in available))
        entry = codec._insert_entry(
            sig, _DecodeTables(np.ascontiguousarray(D, dtype=np.uint8),
                               [int(s) for s in src]))
        if device != "numpy":
            codec._entry_device(entry)
    if device != "numpy":
        codec._upload_parity()
    return codec


def bitmatrix_from_reference(coding: np.ndarray, technique: str, k: int,
                             m: int, w: int, packetsize: int = 2048,
                             device: str = "cuda"
                             ) -> ErasureCodeJerasureBitmatrix:
    """The port's jerasure bitmatrix plugin (liberation, blaum_roth,
    liber8tion, or a w=16/32 wide-word technique) for a reference plugin
    whose ``coding`` bitmatrix is given.  Raises ValueError if ``coding``
    is not this port's own construction for the profile."""
    ec = ErasureCodeJerasureBitmatrix(technique)
    ec.init({"technique": technique, "k": str(k), "m": str(m), "w": str(w),
             "packetsize": str(packetsize), "device": device})
    coding = np.asarray(coding, dtype=np.uint8)
    if coding.shape != ec.coding.shape or \
            not np.array_equal(coding, ec.coding):
        raise ValueError(f"coding differs from the port's {technique} "
                         f"construction for k={k} m={m} w={w}")
    return ec


def hashinfo_from_dict(d: dict) -> HashInfo:
    """The port's HashInfo from the reference's ``HashInfo.to_dict()``."""
    return HashInfo.from_dict(d)


def crushmap_from_reference(d: dict) -> CrushMap:
    """The port's CrushMap from the reference's ``CrushMap.to_dict()``."""
    return CrushMap.from_dict(d)


def osdmap_from_reference(d: dict) -> OSDMap:
    """The port's OSDMap from the reference's ``OSDMap.to_dict()``."""
    return OSDMap.from_dict(d)


# the classes a reference pgmeta omap pickles, by (module, name) -> the
# port's own; any other class in the stream is refused
_OMAP_CLASSES = {
    ("ceph_tpu.osd.pg_log", "PGLogEntry"): PGLogEntry,
    ("ceph_tpu.backend.memstore", "GObject"): GObject,
}


class _OmapUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        cls = _OMAP_CLASSES.get((module, name))
        if cls is None:
            raise pickle.UnpicklingError(
                f"{module}.{name} is not a PG log or rollback class")
        return cls


def _omap_value(key: str, value: bytes) -> bytes:
    """One pgmeta omap value re-pickled with the port's classes: the PG
    log entries (``log.*``), the rollback records (``rb.*``, op tuples
    naming GObjects) and the log bounds (``vi``).  Other keys pass."""
    if not (key == "vi" or key.startswith(("log.", "rb."))):
        return bytes(value)
    obj = _OmapUnpickler(io.BytesIO(bytes(value))).load()
    return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)


def shard_stores_from_reference(dump: dict) -> dict[int, MemStore]:
    """The port's ``MemStore`` per shard from a dump of the reference's.

    ``dump`` maps shard id -> a list of objects, each a dict with
    ``oid``, ``shard``, ``data`` (bytes), ``xattrs`` (name -> value),
    ``omap`` (key -> bytes) and ``omap_header`` (bytes): what the
    reference store's ``list_objects``, ``read``, ``getattrs``,
    ``get_omap`` and ``get_omap_header`` return.  Object bytes and
    attributes (``HINFO_KEY`` among them) carry over unchanged; the
    pickled PG log entries and rollback records are rebuilt as the port's
    ``PGLogEntry`` and ``GObject``."""
    stores: dict[int, MemStore] = {}
    for shard, objects in dump.items():
        store = MemStore()
        for rec in objects:
            obj = GObject(str(rec["oid"]), int(rec["shard"]))
            store.objects[obj] = _Object(
                bytearray(rec["data"]), dict(rec["xattrs"]),
                {k: _omap_value(k, v) for k, v in rec["omap"].items()},
                bytes(rec["omap_header"]))
        stores[int(shard)] = store
    return stores

