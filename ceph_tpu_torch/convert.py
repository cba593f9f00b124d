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

A cluster's state is its pools and each OSD's one store, which holds a
collection (``pg.<pool>.<ps>``) per PG shard it hosts and the daemon's
superblock: :func:`cluster_from_reference` loads a dump of every OSD's
store into a port ``MiniCluster`` built with the same pools.

A served cluster's state adds its cephx secrets: the entity keys and
each service's rotating secrets, read by :func:`keyring_from_reference`
from a reference ``KeyServer`` (its pickled server file names the
reference's classes).  A fault campaign's state is its seeded plan:
:func:`fault_plan_from_reference` copies a reference ``FaultPlan``'s
planes field by field, so both packages roll the same decisions.
"""
from __future__ import annotations

import io
import pickle

import numpy as np

from .backend.ecutil import HashInfo
from .backend.memstore import GObject, MemStore, Transaction, _Object
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


def cluster_from_reference(meta: dict, stores: dict, cct=None,
                           device: str | None = None, data_dir=None,
                           store_backend: str = "file"):
    """A port ``MiniCluster`` holding the state of a reference one.

    ``meta`` is the cluster's shape: ``n_osds``, ``osds_per_host``,
    ``chunk_size`` and ``pools``, a list in creation order of dicts with
    ``name``, ``type``, ``size``, ``pg_num``, ``params`` (the pool's
    profile or options), ``snap_seq``, ``snaps`` and ``removed_snaps``
    (the reference's own cluster metadata).  ``stores`` maps an OSD id
    to a dump of its one ``MemStore`` in the form
    :func:`shard_stores_from_reference` reads: every PG collection's
    objects under their collection-prefixed oids, and the superblock,
    whose ``sb`` attribute lists the OSD's PGs as ``(pool, ps)`` pairs.

    Every store is loaded before the pools are created, so each PG shard
    boots its PG log from its collection.  An EC pool of the ``jax_rs``
    plugin becomes ``torch_rs`` (the same GF(2^8) codes and layouts);
    ``device``, when given, replaces each EC profile's ``device`` key.
    The cluster's object list is rediscovered from the primaries' stores,
    as a reopened reference cluster does.

    With ``data_dir`` the cluster is durable: each OSD's objects are
    written through one transaction into its ``store_backend`` store
    ("file" or "bluestore") under ``data_dir``, and the pool definitions
    persist to ``cluster_meta.pkl``, so ``MiniCluster.load(data_dir)``
    reopens the cluster."""
    from .cluster import MiniCluster
    from .osd.hit_set import is_hit_set_oid
    from .osd.osd_daemon import OSDDaemon
    from .osd.primary_log_pg import is_clone_oid
    from .osdmap import PG, POOL_TYPE_REPLICATED
    c = MiniCluster(n_osds=int(meta["n_osds"]),
                    osds_per_host=int(meta["osds_per_host"]),
                    chunk_size=int(meta["chunk_size"]), cct=cct,
                    data_dir=data_dir, store_backend=store_backend)
    for osd, objects in stores.items():
        t = Transaction()
        for rec in objects:
            obj = GObject(str(rec["oid"]), int(rec["shard"]))
            xattrs = dict(rec["xattrs"])
            if obj.oid == OSDDaemon.SUPERBLOCK and "sb" in xattrs:
                sb = dict(xattrs["sb"])
                sb["pgids"] = [PG(int(pool), int(ps))
                               for pool, ps in sb["pgids"]]
                xattrs["sb"] = sb
            t.touch(obj)
            if rec["data"]:
                t.write(obj, 0, bytes(rec["data"]))
            for name, value in xattrs.items():
                t.setattr(obj, name, value)
            if rec["omap"]:
                t.omap_setkeys(obj, {k: _omap_value(k, v)
                                     for k, v in rec["omap"].items()})
            if rec["omap_header"]:
                t.omap_setheader(obj, bytes(rec["omap_header"]))
        c.osds[int(osd)].store.queue_transaction(t)
    for p in meta["pools"]:
        params = dict(p["params"])
        if p["type"] == POOL_TYPE_REPLICATED:
            pid = c.create_replicated_pool(p["name"], int(p["size"]),
                                           int(p["pg_num"]), params=params)
        else:
            if params.get("plugin") == "jax_rs":
                params["plugin"] = "torch_rs"
            if device is not None:
                params["device"] = device
            pid = c.create_ec_pool(p["name"], params, int(p["pg_num"]))
        pool = c.pools[pid]["pool"]
        pool.snap_seq = int(p.get("snap_seq", 0))
        pool.snaps = {int(s): str(n) for s, n in p.get("snaps", {}).items()}
        pool.removed_snaps = {int(s) for s in p.get("removed_snaps", ())}
        for g in c.pools[pid]["pgs"].values():
            c.objects.setdefault(pid, set()).update(
                o for o in g.backend._local_oids()
                if not is_clone_oid(o) and not is_hit_set_oid(o))
    # the snap fields were set after pool creation persisted the pools
    c._save_meta()
    return c


def keyring_from_reference(keyserver, data_dir=None):
    """A port cephx ``KeyServer`` holding a reference one's secrets: every
    entity key and every service's rotating generations, current one
    included.  With ``data_dir`` it also writes the server-only file and
    the client keyring there as a port ``ClusterServer`` does, so a
    server over that directory authenticates the reference's clients
    and a reference client keyring authenticates the port's."""
    from .auth.cephx import KeyServer, _RotatingSecret
    ks = KeyServer()
    ks.entity_keys = {str(n): bytes(k)
                      for n, k in keyserver.entity_keys.items()}
    ks.rotating = {
        str(svc): _RotatingSecret(
            secrets={int(i): bytes(v) for i, v in rs.secrets.items()},
            current=int(rs.current))
        for svc, rs in keyserver.rotating.items()}
    if data_dir is not None:
        from .net import save_keys
        save_keys(ks, data_dir)
    return ks


def fault_plan_from_reference(plan):
    """A port ``FaultPlan`` with a reference plan's seed and every plane's
    fields (bus, transport, store, device)."""
    import dataclasses
    from .failure import config as fc
    planes = {"bus": fc.FaultConfig, "transport": fc.TransportFaults,
              "store": fc.StoreFaults, "device": fc.DeviceFaults}
    return fc.FaultPlan(seed=int(plan.seed), **{
        name: klass(**{f.name: getattr(getattr(plan, name), f.name)
                       for f in dataclasses.fields(klass)})
        for name, klass in planes.items()})
