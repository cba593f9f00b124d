"""The port's durable stores and durable MiniCluster against the JAX
package's, on the CPU.

The same seeded numpy payloads and the same op sequence go through
``ceph_tpu`` (``jax_rs`` with ``device=numpy``) and ``ceph_tpu_torch``
(``torch_rs`` with ``device=cpu``), each under its own directory, and
the two runs are held equal bitwise (tolerance 0):

- the compressor registry: algorithms, compressed bytes, load errors;
- FileStore: the WAL replay with a torn tail (objects, sequence, the
  truncated log);
- BlueStoreLite: the block file byte for byte, every blob (offset,
  length, csum, compression), the allocator's free list after rebuild,
  clone refcounts, zlib compression and ``ChecksumError`` on a flipped
  byte;
- a durable cluster on either backend written, shut down (or crashed),
  reloaded with ``MiniCluster.load`` (boot peering and boot repair) and
  read: every OSD store, every PG log, the object lists and
  ``cluster_meta.pkl``;
- ``convert.cluster_from_reference`` into a durable port cluster that
  ``MiniCluster.load`` reopens.

Nothing the port writes to disk may pickle a ``torch.Tensor`` or a class
of the JAX package: every WAL record, snapshot and metadata file is
unpickled class by class and walked.
"""
from __future__ import annotations

import importlib
import io
import pickle

import numpy as np
import pytest
import torch

from test_torch_cluster import (CHUNK, JAX, PORT, STRIPE, _dump_store, _log,
                                _meta, fixed_clock, payload)  # noqa: F401
from test_torch_ec_backend import _omap, norm

K, M = 4, 2


def imp(side, mod):
    return importlib.import_module(f"{side.pkg}.{mod}")


# -- what a store holds, package-neutral -----------------------------------

def store_state(store) -> dict:
    """Every object of a store through its public read surface, the pgmeta
    omap's pickles decoded."""
    out = {}
    for g in store.list_objects():
        out[(g.oid, g.shard)] = (store.read(g), norm(store.getattrs(g)),
                                 _omap(store.get_omap(g)),
                                 bytes(store.get_omap_header(g)))
    return out


def durable_state(c) -> dict:
    pools = {}
    for pid, p in sorted(c.pools.items()):
        pools[pid] = {ps: {"acting": list(g.acting),
                           "authority_log": _log(g.backend.pg_log),
                           "shard_logs": {s: _log(h.pg_log) for s, h in
                                          sorted(g.bus.handlers.items())},
                           "stale": sorted(g.backend.stale)}
                      for ps, g in sorted(p["pgs"].items())}
    return {"pools": pools,
            "stores": {o: store_state(d.store)
                       for o, d in sorted(c.osds.items())},
            "objects": {pid: sorted(v) for pid, v in c.objects.items()}}


# -- what a file on disk pickles ---------------------------------------------

_ALLOWED_ROOTS = ("builtins", "collections", "copyreg", "_codecs",
                  "numpy")


class _Walker(pickle.Unpickler):
    """Records every class a pickle names; refuses torch."""

    def __init__(self, f, seen: set):
        super().__init__(f)
        self.seen = seen

    def find_class(self, module, name):
        self.seen.add((module, name))
        return super().find_class(module, name)


def walk_pickle(buf: bytes, seen: set):
    obj = _Walker(io.BytesIO(buf), seen).load()
    stack = [obj]
    while stack:
        x = stack.pop()
        assert not isinstance(x, torch.Tensor), "a tensor reached the disk"
        if isinstance(x, dict):
            stack.extend(x.keys())
            stack.extend(x.values())
        elif isinstance(x, (list, tuple, set, frozenset)):
            stack.extend(x)
        elif hasattr(x, "__dict__"):
            stack.extend(vars(x).values())
    return obj


def _frames(buf: bytes):
    import struct
    frame = struct.Struct("<II")
    off = 0
    while off + frame.size <= len(buf):
        length, _crc = frame.unpack_from(buf, off)
        yield buf[off + frame.size:off + frame.size + length]
        off += frame.size + length


def check_disk(root) -> set:
    """Walk every WAL record, snapshot and metadata pickle under ``root``;
    return the (module, class) pairs they name."""
    seen: set = set()
    n = 0
    for path in sorted(root.rglob("*")):
        if path.name in ("wal.log", "kv.log"):
            for rec in _frames(path.read_bytes()):
                walk_pickle(rec, seen)
                n += 1
        elif path.name in ("objects.snap", "kv.snap", "cluster_meta.pkl"):
            walk_pickle(path.read_bytes(), seen)
            n += 1
    assert n
    for module, name in seen:
        assert not module.startswith("torch"), (module, name)
        assert module.startswith(("ceph_tpu_torch.",) + _ALLOWED_ROOTS), \
            (module, name)
    return seen


def _pgmeta_classes(store) -> set:
    """The classes pickled into the pgmeta omaps (PG log entries,
    rollback records)."""
    seen: set = set()
    for g in store.list_objects():
        for key, v in store.get_omap(g).items():
            if key == "vi" or key.startswith(("log.", "rb.")):
                walk_pickle(bytes(v), seen)
    return seen


# -- the compressor registry -------------------------------------------------

ALGOS = ["zlib", "lzma", "bz2"]


@pytest.mark.parametrize("algo", ALGOS)
def test_compressor_bytes_equal(algo):
    data = payload(20000, 3) + b"A" * 30000
    out = {}
    for side in (JAX, PORT):
        reg = imp(side, "compressor").CompressorRegistry()
        c = reg.create(algo)
        blob = c.compress(data)
        assert c.decompress(blob) == data
        out[side.pkg] = (reg.supported(), blob, c.name)
    assert out["ceph_tpu_torch"] == out["ceph_tpu"]


@pytest.mark.parametrize("algo,exc", [("snappy", FileNotFoundError),
                                      ("lz4", FileNotFoundError),
                                      ("brotli", ValueError)])
def test_compressor_unavailable(algo, exc):
    msgs = []
    for side in (JAX, PORT):
        mod = imp(side, "compressor")
        with pytest.raises(exc) as e:
            mod.create(algo)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    # zstd is optional on both sides, the same way
    regs = [imp(s, "compressor").CompressorRegistry() for s in (JAX, PORT)]
    assert regs[0].supported() == regs[1].supported()
    assert regs[0]._unavailable == regs[1]._unavailable


# -- FileStore ---------------------------------------------------------------

def _txns(side, n: int = 12) -> list:
    """A seeded op sequence over the Transaction surface."""
    ms = imp(side, "backend.memstore")
    G, T = ms.GObject, ms.Transaction
    rng = np.random.default_rng(5)
    out = []
    for i in range(n):
        g = G(f"o{i % 4}", i % 3)
        t = T()
        kind = i % 6
        if kind == 0:
            t.write(g, int(rng.integers(0, 600)), payload(700, i))
        elif kind == 1:
            t.write(g, 0, payload(300, i)).setattr(g, "a", {"i": i})
        elif kind == 2:
            t.omap_setkeys(g, {f"k{i}": payload(9, i)}).omap_setheader(
                g, b"h%d" % i)
        elif kind == 3:
            t.clone(g, G(f"c{i}", 0)).truncate(g, 123)
        elif kind == 4:
            t.zero(g, 10, 40).write(g, 1000, payload(64, i))
        else:
            t.remove(G(f"c{i - 2}", 0)).touch(G(f"t{i}", 1))
        out.append(t)
    return out


@pytest.mark.parametrize("cut", [1, 9, 0])
def test_filestore_wal_replay_torn_tail(tmp_path, cut):
    """Both FileStores journal the same transactions with no checkpoint;
    the WAL loses ``cut`` bytes of its last record (0: intact); reopened,
    both replay the same prefix and truncate the same torn tail."""
    seen = {}
    for side in (JAX, PORT):
        FS = imp(side, "backend.filestore").FileStore
        d = tmp_path / side.pkg
        st = FS(d, checkpoint_every=1000)
        for t in _txns(side):
            st.queue_transaction(t)
        full = store_state(st)
        st._wal.close()                     # a crash: no checkpoint
        wal = d / "wal.log"
        size = wal.stat().st_size
        if cut:
            with open(wal, "r+b") as f:
                f.truncate(size - cut)
        re = FS(d)
        seen[side.pkg] = (store_state(re), re.committed_seq,
                          len(list(_frames(wal.read_bytes()))),
                          store_state(re) == full)
        re.queue_transaction(_txns(side)[0])     # appends after the cut
        re.close(checkpoint=False)
        again = FS(d)
        seen[side.pkg] += (store_state(again), again.committed_seq)
        again.close()
        if side is PORT:
            check_disk(d)
    assert seen["ceph_tpu_torch"] == seen["ceph_tpu"]
    assert seen["ceph_tpu"][1] == (12 if cut == 0 else 11)
    assert seen["ceph_tpu"][3] == (cut == 0)


def test_filestore_snapshot_and_wal(tmp_path):
    """A checkpoint every 5 transactions: the snapshot plus the WAL after
    it reopen to the same state on both sides."""
    seen = {}
    for side in (JAX, PORT):
        FS = imp(side, "backend.filestore").FileStore
        d = tmp_path / side.pkg
        st = FS(d, checkpoint_every=5)
        for t in _txns(side):
            st.queue_transaction(t)
        st._wal.close()
        re = FS(d)
        seen[side.pkg] = (store_state(re), re.committed_seq,
                          len(list(_frames((d / "wal.log").read_bytes()))))
        re.close()
        if side is PORT:
            check_disk(d)
    assert seen["ceph_tpu_torch"] == seen["ceph_tpu"]


# -- BlueStoreLite -----------------------------------------------------------

def _blobs(bs) -> dict:
    return {bid: (b.poff, b.plen, b.alloc, b.raw_len, b.csum, b.comp, b.refs)
            for bid, b in sorted(bs.blobs.items())}


def _onodes(bs) -> dict:
    return {(g.oid, g.shard): (o.size, [(e.loff, e.length, e.blob, e.boff)
                                        for e in o.extents])
            for g, o in sorted(bs.onodes.items(),
                               key=lambda kv: (kv[0].oid, kv[0].shard))}


def _bs_run(side, d, compression=None, fuzz: int = 150):
    """The op sequence and an rmw fuzz; returns what the store shows."""
    bl = imp(side, "backend.bluestore")
    ms = imp(side, "backend.memstore")
    G, T = ms.GObject, ms.Transaction
    bs = bl.BlueStoreLite(d, min_alloc=512, compression=compression,
                          checkpoint_every=64)
    for t in _txns(side):
        bs.queue_transaction(t)
    rng = np.random.default_rng(42)
    g = G("fuzz", 0)
    for i in range(fuzz):
        kind = int(rng.integers(0, 10))
        off = int(rng.integers(0, 5000))
        ln = int(rng.integers(1, 2000))
        t = T()
        if kind < 5:
            t.write(g, off, payload(ln, 1000 + i))
        elif kind < 6:
            t.write(g, off, b"Z" * 3 * ln)            # compressible
        elif kind < 8:
            t.zero(g, off, ln)
        else:
            t.truncate(g, off)
        if i % 25 == 0:
            t.clone(g, G(f"snap{i}", 0))
        bs.queue_transaction(t)
    return bs


@pytest.mark.parametrize("compression", [None, "zlib"])
def test_bluestore_block_file_and_blobs(tmp_path, compression):
    """The block file byte for byte, every blob and extent, the refcounts
    of shared blobs, and the allocator after a reopen (free list rebuilt
    from the blob table) equal the reference's."""
    seen = {}
    for side in (JAX, PORT):
        d = tmp_path / side.pkg
        bs = _bs_run(side, d, compression)
        refcount: dict = {}
        for onode in bs.onodes.values():
            for e in onode.extents:
                refcount[e.blob] = refcount.get(e.blob, 0) + 1
        assert refcount == {bid: b.refs for bid, b in bs.blobs.items()}
        live = (store_state(bs), _blobs(bs), _onodes(bs), bs.usage(),
                [list(r) for r in bs.alloc.runs], bs.alloc.watermark)
        bs.close()
        re = imp(side, "backend.bluestore").BlueStoreLite(
            d, min_alloc=512, compression=compression)
        seen[side.pkg] = live + (
            (d / "block").read_bytes(), store_state(re), _blobs(re),
            [list(r) for r in re.alloc.runs], re.alloc.watermark,
            re.usage())
        re.close()
        if side is PORT:
            check_disk(d)
    assert seen["ceph_tpu_torch"] == seen["ceph_tpu"]
    if compression:
        assert seen["ceph_tpu"][3]["compressed_blobs"] > 0


def test_bluestore_checksum_error_on_flipped_byte(tmp_path):
    out = {}
    for side in (JAX, PORT):
        bl = imp(side, "backend.bluestore")
        ms = imp(side, "backend.memstore")
        d = tmp_path / side.pkg
        bs = bl.BlueStoreLite(d, min_alloc=512)
        g = ms.GObject("rot", 0)
        bs.queue_transaction(ms.Transaction().write(g, 0, payload(3000, 9)))
        bs.checkpoint()
        blob = bs.blobs[bs.onodes[g].extents[0].blob]
        with open(d / "block", "r+b") as f:
            f.seek(blob.poff + 100)
            b = f.read(1)
            f.seek(blob.poff + 100)
            f.write(bytes([b[0] ^ 0x40]))
        with pytest.raises(bl.ChecksumError) as e:
            bs.read(g)
        assert isinstance(e.value, IOError)
        out[side.pkg] = (str(e.value), blob.csum)
        bs.close()
    assert out["ceph_tpu_torch"] == out["ceph_tpu"]


def test_bluestore_torn_wal_tail(tmp_path):
    seen = {}
    for side in (JAX, PORT):
        bl = imp(side, "backend.bluestore")
        d = tmp_path / side.pkg
        bs = bl.BlueStoreLite(d, min_alloc=512, checkpoint_every=1000)
        for t in _txns(side):
            bs.queue_transaction(t)
        bs._wal.close()
        bs._block.close()
        wal = d / "kv.log"
        with open(wal, "r+b") as f:
            f.truncate(wal.stat().st_size - 3)
        re = bl.BlueStoreLite(d, min_alloc=512)
        seen[side.pkg] = (store_state(re), re.committed_seq, _blobs(re),
                          [list(r) for r in re.alloc.runs],
                          wal.stat().st_size > 0)
        re.close()
    assert seen["ceph_tpu_torch"] == seen["ceph_tpu"]
    assert seen["ceph_tpu"][1] == 11


# -- the durable cluster -----------------------------------------------------

def _profile(side) -> dict:
    return {"plugin": side.rs, "technique": "reed_sol_van", "k": str(K),
            "m": str(M), "device": "numpy" if side is JAX else "cpu"}


def _victim(c, pid):
    prim = {g.backend.whoami for g in c.pools[pid]["pgs"].values()}
    return min(o for o in range(c.n_osds) if o not in prim)


def durable_run(side, root, backend: str, crash: bool) -> dict:
    """Write, snapshot a pool, mute a check, take an OSD down through
    overwrites, then shut down (or crash: the stores close without a
    checkpoint) and reopen with ``MiniCluster.load``: boot peering and
    boot repair bring the OSD back.  Returns what both sides compare."""
    d = root / side.pkg
    c = side.MiniCluster(n_osds=12, osds_per_host=3, chunk_size=CHUNK,
                         cct=side.Context(), data_dir=d,
                         store_backend=backend)
    pid = c.create_ec_pool("ec", _profile(side), pg_num=8)
    rep = c.create_replicated_pool("rep", size=3, pg_num=4)
    data = {f"obj{i}": payload(3 * STRIPE + 37 * i, i) for i in range(10)}
    rdata = {f"r{i}": payload(300 + i, 40 + i) for i in range(4)}
    for oid, v in data.items():
        c.put(pid, oid, v)
    for oid, v in rdata.items():
        c.put(rep, oid, v)
    c.create_pool_snap(pid, "s1")
    c.mute_health("SLOW_OPS")
    v = _victim(c, pid)
    c.bus.mark_down(v)
    for i in range(4):
        data[f"obj{i}"] = payload(2 * STRIPE + 5, 200 + i)
        c.put(pid, f"obj{i}", data[f"obj{i}"])
    before = durable_state(c)
    if crash:
        for o in c.osds.values():
            o.store.close(checkpoint=False)
    else:
        c.shutdown()
    c2 = side.MiniCluster.load(d, cct=side.Context())
    try:
        loaded = durable_state(c2)
        reads = {oid: c2.get(pid, oid, len(b)) for oid, b in data.items()}
        assert reads == data
        assert {oid: c2.get(rep, oid, len(b))
                for oid, b in rdata.items()} == rdata
        g = c2.pg_group(pid, "obj0")
        for o in g.acting[1:3]:
            c2.bus.mark_down(o)
        degraded = c2.get(pid, "obj0", len(data["obj0"]))
        for o in g.acting[1:3]:
            c2.bus.mark_up(o)
        c2.deliver_all()
        with open(d / "cluster_meta.pkl", "rb") as f:
            meta = pickle.load(f)
        for p in meta["pools"]:          # the one difference: the codec
            assert p["params"].pop("plugin", side.rs) == side.rs
            p["params"].pop("device", None)
        meta = norm(meta)
        pool = c2.pools[pid]["pool"]
        out = {"victim": v, "before": before, "loaded": loaded,
               "after": durable_state(c2), "reads": reads,
               "degraded": degraded, "meta": meta,
               "snaps": dict(pool.snaps), "muted": sorted(
                   c2.health_engine.muted)}
    finally:
        c2.shutdown()
    if side is PORT:
        seen = check_disk(d)
        assert ("ceph_tpu_torch.backend.memstore", "GObject") in seen or \
            backend == "bluestore"
        for o in c2.osds.values():
            for module, _name in _pgmeta_classes(o.store):
                assert module.startswith(("ceph_tpu_torch.", "builtins"))
    return out


@pytest.mark.parametrize("backend,crash", [("file", False),
                                           ("bluestore", False),
                                           ("file", True),
                                           ("bluestore", True)])
def test_durable_cluster_reload(tmp_path, backend, crash):
    seen = {s.pkg: norm(durable_run(s, tmp_path, backend, crash))
            for s in (JAX, PORT)}
    want, got = seen["ceph_tpu"], seen["ceph_tpu_torch"]
    for key in want:
        if key in ("before", "loaded", "after"):
            for part in want[key]:
                assert got[key][part] == want[key][part], (key, part)
        else:
            assert got[key] == want[key], key
    meta = want["meta"]
    assert meta["store_backend"] == backend
    assert meta["health_mutes"] == ("SLOW_OPS",)
    assert want["snaps"] == {1: "s1"}
    # the boot repair brought the victim's shards level with the primary
    for ps, pg in want["after"]["pools"][1].items():
        heads = {log[0] for log in pg["shard_logs"].values()}
        assert len(heads) == 1, ps


def test_cluster_meta_and_pool_profile_persist(tmp_path):
    """cluster_meta.pkl holds the same definitions on both sides; the port
    keeps a pool's profile as persisted (no ``device`` key added)."""
    metas = {}
    for side in (JAX, PORT):
        d = tmp_path / side.pkg
        c = side.MiniCluster(n_osds=6, osds_per_host=2, chunk_size=CHUNK,
                             cct=side.Context(), data_dir=d,
                             store_backend="bluestore")
        c.create_ec_pool("ec", _profile(side), pg_num=4)
        c.create_replicated_pool("cache", 3, 4,
                                 params={"hit_set_count": "2"})
        c.pool_set(2, "hit_set_period", 16)
        c.shutdown()
        with open(d / "cluster_meta.pkl", "rb") as f:
            metas[side.pkg] = pickle.load(f)
        c2 = side.MiniCluster.load(d, cct=side.Context())
        assert c2.pools[2]["pool"].params["hit_set_period"] == "16"
        c2.shutdown()
    assert metas["ceph_tpu_torch"]["pools"][0]["params"]["device"] == "cpu"
    for m in metas.values():
        for p in m["pools"]:
            p["params"].pop("plugin", None)
            p["params"].pop("device", None)
    assert metas["ceph_tpu_torch"] == metas["ceph_tpu"]


def test_durable_card_pool_without_a_card_stores_nothing(tmp_path,
                                                         monkeypatch):
    """A durable cluster's EC pool with no device key runs on the card:
    without one a put raises and nothing reaches the disk's object list."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    c = PORT.MiniCluster(n_osds=6, osds_per_host=2, chunk_size=CHUNK,
                         cct=PORT.Context(), data_dir=tmp_path / "d",
                         store_backend="bluestore")
    try:
        pid = c.create_ec_pool("card", {"k": "4", "m": "2"}, pg_num=2)
        with pytest.raises(RuntimeError, match="cuda"):
            c.put(pid, "x", payload(STRIPE))
        for o in c.osds.values():
            assert not any(g.oid.endswith("\x00x")
                           for g in o.store.list_objects())
    finally:
        c.shutdown()


# -- state carried across ------------------------------------------------------

@pytest.mark.parametrize("backend", ["file", "bluestore"])
def test_convert_into_a_durable_cluster(tmp_path, backend):
    """A reference cluster's store dumps become a durable port cluster on
    disk; ``MiniCluster.load`` reopens it (boot repair included) and it
    reads the same bytes the reference does after its own reopen."""
    from ceph_tpu_torch import convert
    jd = tmp_path / "ref"
    jc = JAX.MiniCluster(n_osds=12, osds_per_host=3, chunk_size=CHUNK,
                         cct=JAX.Context(), data_dir=jd,
                         store_backend=backend)
    pid = jc.create_ec_pool("ec", _profile(JAX), pg_num=8)
    rep = jc.create_replicated_pool("rep", 3, 4)
    data = {f"obj{i}": payload(2 * STRIPE + 11 * i, 70 + i) for i in range(8)}
    for oid, v in data.items():
        jc.put(pid, oid, v)
    jc.put(rep, "r", b"replica")
    jc.create_pool_snap(rep, "rs")
    v = _victim(jc, pid)
    jc.bus.mark_down(v)
    data["obj1"] = payload(STRIPE, 99)
    jc.put(pid, "obj1", data["obj1"])
    meta = _meta(jc)
    dump = {o: _dump_store(d.store) for o, d in jc.osds.items()}
    pd = tmp_path / "port"
    pc = convert.cluster_from_reference(meta, dump, cct=PORT.Context(),
                                        device="cpu", data_dir=pd,
                                        store_backend=backend)
    assert durable_state(pc)["stores"] == durable_state(jc)["stores"]
    pc.shutdown()
    jc.shutdown()
    out = {}
    for side, d in ((JAX, jd), (PORT, pd)):
        c = side.MiniCluster.load(d, cct=side.Context())
        try:
            assert {oid: c.get(pid, oid, len(b))
                    for oid, b in data.items()} == data
            assert c.get(rep, "r", 7) == b"replica"
            st = durable_state(c)
            out[side.pkg] = (st["stores"], st["objects"], st["pools"],
                             dict(c.pools[rep]["pool"].snaps))
        finally:
            c.shutdown()
    assert out["ceph_tpu_torch"] == out["ceph_tpu"]
    check_disk(pd)


def test_port_data_dir_opens_without_jax(tmp_path):
    """A port data dir reopens in a fresh interpreter that has neither
    ``jax`` nor ``ceph_tpu`` loaded."""
    import subprocess
    import sys
    from pathlib import Path
    d = tmp_path / "d"
    c = PORT.MiniCluster(n_osds=6, osds_per_host=2, chunk_size=CHUNK,
                         cct=PORT.Context(), data_dir=d,
                         store_backend="bluestore")
    pid = c.create_ec_pool("ec", _profile(PORT), pg_num=4)
    c.put(pid, "x", payload(1000, 1))
    c.shutdown()
    root = Path(__file__).resolve().parents[1]
    code = (
        "import sys\n"
        "from ceph_tpu_torch.cluster import MiniCluster\n"
        f"c = MiniCluster.load({str(d)!r})\n"
        f"assert c.get({pid}, 'x', 1000) == {payload(1000, 1)!r}\n"
        "c.shutdown()\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'ceph_tpu.')) or m == 'ceph_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


# -- the shapes phase ``shapes`` times for the durable path ----------------------

def test_path_shapes_name_the_durable_launches():
    """``path_shapes.durable_shapes`` names every ``gf_apply`` and
    ``crc32c_rows`` call of ``chip_smoke.py``'s phase ``durable`` with its
    count: the phase itself (``chip_smoke.phase_durable``: BlueStore and
    FileStore clusters of 12 OSDs on 4 hosts, pg_num 32, a 4 KiB stripe
    unit, torch_rs k=8 m=4, a monitor quorum, the client, a cache tier and
    a store fault plan) runs here with ``device=cpu`` at 64 KiB objects
    (the widths follow the object size; the counts do not)."""
    import importlib.util
    from pathlib import Path
    from ceph_tpu_torch.backend import ecutil
    from ceph_tpu_torch.ops import rs_kernels
    from ceph_tpu_torch.plugins.registry import ErasureCodePluginRegistry
    from ceph_tpu_torch.tools import path_shapes as PS
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    CS = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(CS)
    obj = 64 << 10
    with PS.recorded_launches(rs_kernels) as seen:
        lines, _n_apply, _n_crc = CS.phase_durable(
            rs_kernels, ecutil, ErasureCodePluginRegistry, obj_bytes=obj,
            device="cpu")
    want = PS.durable_shapes(ErasureCodePluginRegistry.instance(),
                             obj_bytes=obj)
    assert dict(seen) == dict(PS.shape_counts(want))
    faults = lines["faults"]
    assert faults["lost_acked_writes"] == 0
    assert faults["outcome"]["injected_eio"] > 0
    assert lines["monitor"]["repair"]["perf"]["recoveries"] == 64
    assert lines["tier"]["flush"]["agent"]["flushes"] == PS.DURABLE_TIER
    for key in ("bluestore_reload", "filestore_reload"):
        assert not any(lines[key]["boot_launches"].values())
    assert lines["filestore_reload"]["hashinfo_crcs_checked"] == \
        PS.DURABLE_FILE * 12
    assert lines["bluestore"]["write"]["hashinfo_crcs_checked"] == 64 * 12
