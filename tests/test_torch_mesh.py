"""The port's device mesh (``ceph_tpu_torch.parallel.mesh``) against the
JAX package's, bitwise, in one process.

The reference runs on conftest's 8 forced XLA host devices
(``ceph_tpu.parallel.mesh.make_mesh(8)``: dp 2, sp 4); the port on
``make_mesh(8, devices=["cpu"] * 8)``, whose shards run the kernels'
plain PyTorch versions.  Inputs come from a numpy seed.  The cases: the
mesh shape rule, both encode steps (parity, checksum, rotated), the
checksum past 2^31, the decode step with a survivor count that divides dp
and one that does not, and the placement step on the dry run's rep-3 map
(``__graft_entry__.py``), on ``tests/test_mesh.py``'s map with holes and
with an ``n_osds`` below the largest OSD id.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceph_tpu.crush as jcrush
import ceph_tpu_torch.crush as tcrush
from ceph_tpu.crush.jax_mapper import BulkMapper as JaxBulkMapper
from ceph_tpu.gf import cauchy1, decode_matrix, ref
from ceph_tpu.parallel import mesh as J
from ceph_tpu_torch.crush.torch_mapper import BulkMapper
from ceph_tpu_torch.parallel import mesh as T

NONE = 0x7FFFFFFF


@pytest.fixture(scope="module")
def meshes():
    return J.make_mesh(8), T.make_mesh(8, devices=["cpu"] * 8)


def _equal(jax_out, port_out):
    a, b = np.asarray(jax_out), np.asarray(port_out)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


# -- make_mesh -----------------------------------------------------------------

@pytest.mark.parametrize("n", range(1, 9))
def test_make_mesh_shape_matches_jax(n):
    port = T.make_mesh(n, devices=["cpu"] * 8)
    assert port.shape == dict(J.make_mesh(n).shape)
    assert len(port.shards()) == n and port.devices == [port.device(0, 0)]


def test_make_mesh_refuses_more_devices_than_present():
    with pytest.raises(ValueError, match="only 8 present"):
        J.make_mesh(9)
    with pytest.raises(ValueError, match="only 8 present"):
        T.make_mesh(9, devices=["cpu"] * 8)
    with pytest.raises(ValueError):
        T.make_mesh(8, dp=3, devices=["cpu"] * 8)


def test_make_mesh_defaults_to_every_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    mesh = T.make_mesh()
    assert mesh.shape == {"dp": 2, "sp": 2}
    assert [str(d) for d in mesh.devices] == [f"cuda:{i}" for i in range(4)]


# -- the encode steps ------------------------------------------------------------

@pytest.mark.parametrize("k,m,stripes_per_dp,n_per_sp",
                         [(8, 4, 2, 128), (4, 2, 1, 64), (6, 3, 3, 32)])
def test_sharded_encode_step_matches_jax(meshes, k, m, stripes_per_dp,
                                         n_per_sp):
    jm, tm = meshes
    pm = cauchy1(k, m)
    rng = np.random.default_rng(k * 100 + m)
    data = rng.integers(0, 256, size=(stripes_per_dp * 2, k, n_per_sp * 4),
                        dtype=np.uint8)
    want = J.sharded_encode_step(jm, pm)(data)
    got = T.sharded_encode_step(tm, pm)(data)
    for w, g in zip(want, got):
        _equal(w, g)
    parity, checksum, rotated = (np.asarray(g) for g in got)
    assert checksum.dtype == np.int64
    np.testing.assert_array_equal(parity[0], ref.encode(pm, data[0]))
    np.testing.assert_array_equal(
        checksum, parity.astype(np.int64).sum(axis=(1, 2)))
    np.testing.assert_array_equal(
        rotated, np.roll(parity, data.shape[0] // 2, axis=0))


def test_sharded_batch_encode_step_matches_jax(meshes):
    jm, tm = meshes
    pm = cauchy1(8, 4)
    data = np.random.default_rng(5).integers(0, 256, size=(4, 8, 256),
                                             dtype=np.uint8)
    _equal(J.sharded_batch_encode_step(jm, pm)(data),
           T.sharded_batch_encode_step(tm, pm)(data))


def test_encode_step_refuses_shapes_that_do_not_split(meshes):
    _jm, tm = meshes
    step = T.sharded_encode_step(tm, cauchy1(4, 2))
    with pytest.raises(ValueError):
        step(np.zeros((3, 4, 64), dtype=np.uint8))        # B % dp
    with pytest.raises(ValueError):
        step(np.zeros((2, 4, 66), dtype=np.uint8))        # N % sp


def test_checksum_past_2_31_is_int64_unwrapped(meshes):
    """An all-0xFF parity block of 2 MiB + 64 KiB a chunk, m = 4: each
    stripe's byte sum passes 2^31.  The reference's reduction
    ``parity.astype(int32).sum(axis=(1, 2))`` under conftest's x64 gives
    int64; the port's step gives the same, unwrapped (the parity matrix
    [[1]] * 4 copies the one all-0xFF data row into every parity row)."""
    _jm, tm = meshes
    n = (2 << 20) + (64 << 10)
    data = np.full((2, 1, n), 0xFF, dtype=np.uint8)
    parity, checksum, _rot = T.sharded_encode_step(
        tm, np.ones((4, 1), dtype=np.uint8))(data)
    want = jnp.asarray(np.full((2, 4, n), 0xFF, dtype=np.uint8)).astype(
        jnp.int32).sum(axis=(1, 2))
    assert want.dtype == jnp.int64
    assert int(want[0]) == 4 * n * 255 > 2 ** 31
    _equal(want, checksum)
    assert (np.asarray(parity) == 0xFF).all()


# -- the decode step ---------------------------------------------------------------

@pytest.mark.parametrize("k,m,erasures", [(8, 4, [0, 9]), (7, 3, [1, 8]),
                                          (5, 3, [0, 2, 4])])
def test_sharded_decode_step_matches_jax(meshes, k, m, erasures):
    """Survivor counts 8 (divides dp = 2), 7 and 5 (zero-padded)."""
    jm, tm = meshes
    pm = cauchy1(k, m)
    rng = np.random.default_rng(k)
    data = rng.integers(0, 256, size=(k, 512), dtype=np.uint8)
    full = np.concatenate([data, ref.encode(pm, data)], axis=0)
    D, src = decode_matrix(pm, erasures)
    want = J.sharded_decode_step(jm)(D, full[src])
    got = T.sharded_decode_step(tm)(D, full[src])
    _equal(want, got)
    np.testing.assert_array_equal(np.asarray(got), full[erasures])


def test_decode_step_refuses_mismatched_shapes(meshes):
    jm, tm = meshes
    D = np.zeros((2, 5), dtype=np.uint8)
    chunks = np.zeros((6, 128), dtype=np.uint8)
    with pytest.raises(ValueError):
        J.sharded_decode_step(jm)(D, chunks)
    with pytest.raises(ValueError, match="5 columns for 6"):
        T.sharded_decode_step(tm)(D, chunks)


# -- the steps on blocks shard() placed, as the codec pipeline calls them

def test_shard_pads_and_feeds_the_encode_step_as_jax_pads(meshes):
    """Three stripes zero-padded to four (dp = 2), the pipeline's [k, S*c]
    batch seen as [S, k, c]: the step on ``shard``'s blocks equals the
    reference's step on the ``np.pad``-ed array, and ``full(out=...)``
    into the unpadded layout drops the padding."""
    jm, tm = meshes
    pm = cauchy1(4, 2)
    host = np.random.default_rng(9).integers(0, 256, size=(4, 3 * 256),
                                             dtype=np.uint8)
    view = torch.from_numpy(host).view(4, 3, 256).transpose(0, 1)
    placed = T.shard(tm, view, ("dp", None, "sp"), (4, 4, 256))
    got = T.sharded_batch_encode_step(tm, pm)(placed)
    padded = np.pad(np.ascontiguousarray(np.asarray(view)),
                    ((0, 1), (0, 0), (0, 0)))
    _equal(J.sharded_batch_encode_step(jm, pm)(padded), got)
    out = np.empty((2, 3 * 256), dtype=np.uint8)
    got.full(out=torch.from_numpy(out).view(2, 3, 256).transpose(0, 1))
    np.testing.assert_array_equal(out, ref.encode(pm, host))


def test_decode_step_on_placed_blocks_matches_jax(meshes):
    """Five survivors padded to six and 500 bytes to 504 (sp = 4), the
    decode matrix given as column blocks a shard, as the pipeline gives
    the codec's card copies: equal to the reference's step on the padded
    arrays and, with the padding dropped, to the lost rows."""
    jm, tm = meshes
    pm = cauchy1(5, 3)
    data = np.random.default_rng(3).integers(0, 256, size=(5, 500),
                                             dtype=np.uint8)
    full = np.concatenate([data, ref.encode(pm, data)], axis=0)
    D, src = decode_matrix(pm, [0, 2, 4])
    Dp = np.pad(D, ((0, 0), (0, 1)))
    cols = [torch.from_numpy(np.ascontiguousarray(Dp[:, c:c + 3]))
            for c in (0, 3)]
    D_sh = T.Sharded(tm, Dp.shape, (None, "dp"),
                     {(i, j): cols[i] for i, j in tm.shards()})
    chunks = T.shard(tm, full[src], ("dp", "sp"), (6, 504))
    got = T.sharded_decode_step(tm)(D_sh, chunks)
    _equal(J.sharded_decode_step(jm)(
        Dp, np.pad(full[src], ((0, 1), (0, 4)))), got)
    out = np.empty((3, 500), dtype=np.uint8)
    got.full(out=torch.from_numpy(out))
    np.testing.assert_array_equal(out, full[[0, 2, 4]])


def test_shard_refuses_shapes_that_do_not_split_or_shrink(meshes):
    _jm, tm = meshes
    x = np.zeros((4, 64), dtype=np.uint8)
    with pytest.raises(ValueError, match="does not split"):
        T.shard(tm, x, ("dp", "sp"), (4, 66))
    with pytest.raises(ValueError, match="smaller"):
        T.shard(tm, x, ("dp", "sp"), (2, 64))
    placed = T.shard(tm, x, ("dp", "sp"))
    with pytest.raises(ValueError, match="is wanted"):
        T.sharded_decode_step(tm)(np.zeros((1, 4), dtype=np.uint8),
                                  T.shard(tm, x, ("dp", None)))
    assert placed.shape == (4, 64) and placed.nbytes == x.nbytes


# -- the placement step ---------------------------------------------------------------

def _rep3_map(crush):
    """``__graft_entry__.py``'s dry-run map: 4 hosts of 2 OSDs,
    chooseleaf firstn 3 over hosts."""
    cmap = crush.CrushMap()
    cmap.set_type_name(1, "host")
    hosts = [cmap.add_bucket(crush.CRUSH_BUCKET_STRAW2, 1,
                             [2 * h, 2 * h + 1], [0x10000, 0x10000])
             for h in range(4)]
    root = cmap.add_bucket(crush.CRUSH_BUCKET_STRAW2, 2, hosts,
                           [0x20000] * 4)
    ruleno = cmap.add_rule([(crush.CRUSH_RULE_TAKE, root, 0),
                            (crush.CRUSH_RULE_CHOOSELEAF_FIRSTN, 3, 1),
                            (crush.CRUSH_RULE_EMIT, 0, 0)])
    cmap.finalize()
    return cmap, ruleno


def _holes_map(crush):
    """``tests/test_mesh.py``'s map: INDEP asks 3 leaves of 2 hosts, so
    position 3 stays a hole."""
    cmap = crush.CrushMap()
    cmap.set_type_name(1, "host")
    hosts = [cmap.add_bucket(crush.CRUSH_BUCKET_STRAW2, 1,
                             [2 * h, 2 * h + 1], [0x10000, 0x10000])
             for h in range(2)]
    root = cmap.add_bucket(crush.CRUSH_BUCKET_STRAW2, 2, hosts,
                           [0x20000] * 2)
    ruleno = cmap.add_rule([(crush.CRUSH_RULE_TAKE, root, 0),
                            (crush.CRUSH_RULE_CHOOSELEAF_INDEP, 3, 1),
                            (crush.CRUSH_RULE_EMIT, 0, 0)])
    cmap.finalize()
    return cmap, ruleno


@pytest.fixture
def own_jax_kernel_cache(monkeypatch):
    """A kernel cache of the reference's own for the test.  Its
    ``BulkMapper._kernel`` (``ceph_tpu/crush/jax_mapper.py:182-200``), first
    built inside a ``shard_map`` trace, keeps that trace's table arrays in
    the process-wide cache keyed by map content, so a second placement
    step over an equal map at another seed count raises JAX's
    ``UnexpectedTracerError`` (a reference fault, PERF.md section 6).
    Without this, one case here would break the next, and
    ``tests/test_mesh.py`` in the same worker."""
    monkeypatch.setattr(JaxBulkMapper, "_global_cache", None)


@pytest.mark.usefixtures("own_jax_kernel_cache")
@pytest.mark.parametrize("make_map,n_osds,n_seeds",
                         [(_rep3_map, 8, 64), (_holes_map, 4, 64),
                          (_rep3_map, 5, 32), (_holes_map, 2, 32)])
def test_sharded_placement_step_matches_jax(meshes, make_map, n_osds,
                                            n_seeds):
    """``n_osds`` 5 and 2 sit below the maps' largest ids (7, 3): the
    reference's scatter drops those ids from the histogram."""
    jm, tm = meshes
    jmap, jrule = make_map(jcrush)
    tmap, trule = make_map(tcrush)
    xs = np.random.default_rng(n_seeds).integers(
        0, 1 << 32, size=n_seeds, dtype=np.uint64).astype(np.uint32)
    want = J.sharded_placement_step(jm, JaxBulkMapper(jmap), jrule,
                                    n_osds)(xs)
    got = T.sharded_placement_step(tm, BulkMapper(tmap, device="cpu"),
                                   trule, n_osds)(xs)
    for w, g in zip(want, got):
        _equal(w, g)
    out, hist = (np.asarray(g) for g in got)
    valid = out[(out >= 0) & (out != NONE) & (out < n_osds)]
    np.testing.assert_array_equal(hist, np.bincount(valid, minlength=n_osds))
    if make_map is _holes_map:
        assert (out == NONE).any()
    if n_osds < 8 and make_map is _rep3_map:
        assert (out >= n_osds).any()


def test_histogram_drops_out_of_range_ids_as_jax_does():
    """JAX's ``zeros(4).at[[1, 5, 7, 2]].add(1)`` drops 5 and 7."""
    want = jnp.zeros(4, jnp.int32).at[jnp.asarray([1, 5, 7, 2])].add(1)
    got = T._histogram(torch.tensor([[1, 5], [7, 2], [NONE, -1]],
                                    dtype=torch.int32), 4)
    _equal(want, got.numpy())
    assert got.tolist() == [0, 1, 1, 0]


def test_placement_step_refuses_seeds_that_do_not_split(meshes):
    _jm, tm = meshes
    cmap, ruleno = _rep3_map(tcrush)
    step = T.sharded_placement_step(tm, BulkMapper(cmap, device="cpu"),
                                    ruleno, 8)
    with pytest.raises(ValueError, match="do not split"):
        step(np.arange(7, dtype=np.uint32))
