"""The port's kernel-sweep path against the JAX package's sweep kernels.

Inputs come from ``np.random.default_rng(seed)`` and go through both
packages as numpy arrays.  The JAX side runs ``tools/kernel_sweep.py``'s
kernel bodies under ``pl.pallas_call(..., interpret=True)`` with the
BlockSpecs of ``make_v1``/``make_bd``/``make_copy`` (those builders call
``pallas_call`` without ``interpret`` and would need a TPU), and the host
codec ``ceph_tpu.gf.ref``.  On the CPU the port's wrappers run their plain
PyTorch versions.  The arithmetic is integer, so every comparison is
bitwise (max abs err 0).

Two faults of the reference shape the bd cases: ``_kernel_bd`` takes
exactly four data and four output refs, so only groups = 4 traces; and
``make_bd`` returns ``outs[0]``, in which only group 0's column tiles are
written.  So group g's tiles are read from ``outs[g]``, and groups = 2 is
held against the host codec alone.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ceph_tpu.gf import ref as jref
from ceph_tpu.ops.pallas_kernels import expand_bits_plane_major as jexpand
from ceph_tpu_torch.gf.matrix import cauchy1
from ceph_tpu_torch.ops import rs_kernels as trk
from ceph_tpu_torch.ops import sweep_kernels as sk
from ceph_tpu_torch.tools import kernel_sweep as tks
from tools import kernel_sweep as jks


def _rand(rng, shape):
    return rng.integers(0, 256, size=shape, dtype=np.uint8)


def _bmat(mat: np.ndarray) -> torch.Tensor:
    return trk.expand_bits_plane_major(torch.from_numpy(mat))


def _jax_bmat(mat, acc):
    return jnp.asarray(jexpand(mat),
                       dtype=jnp.bfloat16 if acc == "bf16" else jnp.int8)


def _v1_interpret(mat, data, tile, acc):
    r, k = mat.shape
    n = data.shape[1]
    return np.asarray(pl.pallas_call(
        functools.partial(jks._kernel_v1, r=r, k=k, acc_dtype=acc),
        out_shape=jax.ShapeDtypeStruct((r, n), jnp.uint8),
        grid=(n // tile,),
        in_specs=[pl.BlockSpec((8 * r, 8 * k), lambda i: (0, 0)),
                  pl.BlockSpec((k, tile), lambda i: (0, i))],
        out_specs=pl.BlockSpec((r, tile), lambda i: (0, i)),
        interpret=True)(_jax_bmat(mat, acc), jnp.asarray(data)))


def _bd_interpret(mat, data, tile, acc, groups):
    r, k = mat.shape
    n = data.shape[1]
    bexp = np.asarray(jexpand(mat))
    bd = np.zeros((groups * 8 * r, groups * 8 * k), dtype=np.uint8)
    for g in range(groups):
        bd[g * 8 * r:(g + 1) * 8 * r, g * 8 * k:(g + 1) * 8 * k] = bexp
    in_specs = [pl.BlockSpec((groups * 8 * r, groups * 8 * k),
                             lambda i: (0, 0))]
    in_specs += [pl.BlockSpec((k, tile), lambda i, _g=g: (0, i * groups + _g))
                 for g in range(groups)]
    outs = pl.pallas_call(
        functools.partial(jks._kernel_bd, r=r, k=k, acc_dtype=acc,
                          groups=groups),
        out_shape=[jax.ShapeDtypeStruct((r, n), jnp.uint8)] * groups,
        grid=(n // (tile * groups),),
        in_specs=in_specs,
        out_specs=[pl.BlockSpec((r, tile),
                                lambda i, _g=g: (0, i * groups + _g))
                   for g in range(groups)],
        interpret=True,
    )(jnp.asarray(bd, dtype=jnp.bfloat16 if acc == "bf16" else jnp.int8),
      *([jnp.asarray(data)] * groups))
    return [np.asarray(o) for o in outs]


def _copy_interpret(data, r, tile):
    k, n = data.shape
    return np.asarray(pl.pallas_call(
        functools.partial(jks._copy_kernel, r=r, k=k),
        out_shape=jax.ShapeDtypeStruct((r, n), jnp.uint8),
        grid=(n // tile,),
        in_specs=[pl.BlockSpec((k, tile), lambda i: (0, i))],
        out_specs=pl.BlockSpec((r, tile), lambda i: (0, i)),
        interpret=True)(jnp.asarray(data)))


# -- the plane-major bit-matrix ------------------------------------------------

@pytest.mark.parametrize("r,k", [(1, 1), (1, 2), (2, 6), (3, 5), (4, 8),
                                 (8, 16)])
def test_expand_bits_plane_major_matches_jax(r, k):
    mat = _rand(np.random.default_rng(r * 31 + k), (r, k))
    got = _bmat(mat)
    assert got.dtype == torch.uint8 and got.shape == (8 * r, 8 * k)
    assert np.array_equal(got.numpy(), np.asarray(jexpand(mat)))


def test_plane_major_is_not_chunk_major():
    """Row b*k + j holds bit b of data row j (the chunk-major unpack of
    rs_kernels puts it at 8j + b)."""
    data = _rand(np.random.default_rng(5), (3, 40))
    planes = sk.unpack_plane_major(torch.from_numpy(data)).numpy()
    for b in range(8):
        for j in range(3):
            assert np.array_equal(planes[b * 3 + j], (data[j] >> b) & 1)
    bits = sk.unpack_plane_major(torch.from_numpy(data[:2]))
    assert np.array_equal(sk.pack_plane_major(bits, 2).numpy(), data[:2])


# -- against the TPU kernels in interpret mode ---------------------------------

@pytest.mark.parametrize("acc", ["int8", "bf16"])
@pytest.mark.parametrize("r,k", [(4, 8), (2, 6)])
def test_bitplane_apply_matches_kernel_v1_interpret(acc, r, k):
    rng = np.random.default_rng(r * 10 + k)
    mat, data = _rand(rng, (r, k)), _rand(rng, (k, 1024))
    want = _v1_interpret(mat, data, 256, acc)
    bmat, d = _bmat(mat), torch.from_numpy(data)
    assert np.array_equal(sk.bitplane_apply_plain(bmat, d, r, k).numpy(),
                          want)
    assert np.array_equal(
        sk.bitplane_apply(bmat, d, r, k, acc, tile_n=256).numpy(), want)
    assert np.array_equal(want, jref.apply_matrix(mat, data))


@pytest.mark.parametrize("acc", ["int8", "bf16"])
def test_bitplane_apply_bd_matches_kernel_bd_interpret(acc):
    r, k, groups, tile, n = 4, 8, 4, 256, 2048
    rng = np.random.default_rng(44)
    mat, data = _rand(rng, (r, k)), _rand(rng, (k, n))
    outs = _bd_interpret(mat, data, tile, acc, groups)
    bd = torch.block_diag(*[_bmat(mat)] * groups)
    got = sk.bitplane_apply_bd_plain(bd, torch.from_numpy(data), r, k,
                                     groups, tile).numpy()
    wrapped = sk.bitplane_apply_bd(bd, torch.from_numpy(data), r, k, groups,
                                   acc, tile).numpy()
    assert np.array_equal(got, wrapped)
    for t in range(n // tile):          # tile t is written in outs[t % G]
        cols = slice(t * tile, (t + 1) * tile)
        assert np.array_equal(got[:, cols], outs[t % groups][:, cols])


@pytest.mark.parametrize("r,k,n,tile", [
    (4, 8, 1024, 256),
    (8, 8, 512, 256),           # r = k
    (1, 8, 512, 256),           # r = 1
    (16, 64, 512, 256),         # the xor_apply yardsticks' k, narrow n
    (64, 128, 256, 256),
    (4, 8, 32768, 32768),       # the sweep's wide tile
])
def test_copy_rows_matches_copy_kernel_interpret(r, k, n, tile):
    data = _rand(np.random.default_rng(7 + k + r), (k, n))
    want = _copy_interpret(data, r, tile)
    d = torch.from_numpy(data)
    assert np.array_equal(sk.copy_rows_plain(d, r).numpy(), want)
    assert np.array_equal(sk.copy_rows(d, r, tile).numpy(), want)


# -- against the host codec, every column ----------------------------------------

@pytest.mark.parametrize("groups", [2, 4])
@pytest.mark.parametrize("r,k,n,tile", [
    (4, 8, 3000, 256),        # ragged: the last span is partial
    (2, 6, 512, 256),         # fewer columns than one span
    (1, 2, 1, 512),
    (8, 16, 2048, 256),       # the widest stack the kernel takes
])
def test_bitplane_apply_bd_matches_host_codec(groups, r, k, n, tile):
    rng = np.random.default_rng(groups * 1000 + n)
    mat, data = _rand(rng, (r, k)), _rand(rng, (k, n))
    bd = torch.block_diag(*[_bmat(mat)] * groups)
    got = sk.bitplane_apply_bd(bd, torch.from_numpy(data), r, k, groups,
                               "int8", tile)
    assert got.shape == (r, n)
    assert np.array_equal(got.numpy(), jref.apply_matrix(mat, data))


@pytest.mark.parametrize("n", [1, 127, 1000])
def test_bitplane_apply_matches_host_codec_at_ragged_widths(n):
    rng = np.random.default_rng(n)
    mat, data = _rand(rng, (4, 8)), _rand(rng, (8, n))
    got = sk.bitplane_apply(_bmat(mat), torch.from_numpy(data), 4, 8, "bf16")
    assert np.array_equal(got.numpy(), jref.apply_matrix(mat, data))


# -- the wrappers on CPU tensors -------------------------------------------------

def test_cpu_tensors_take_the_plain_route_and_count_nothing():
    sk.reset_launches()
    rng = np.random.default_rng(3)
    mat, data = _rand(rng, (4, 8)), torch.from_numpy(_rand(rng, (8, 600)))
    bmat = _bmat(mat)
    plain = sk.bitplane_apply_plain(bmat, data, 4, 8)
    for acc in sk.ACCS:
        assert torch.equal(sk.bitplane_apply(bmat, data, 4, 8, acc), plain)
        assert torch.equal(sk.bitplane_apply_bd(
            torch.block_diag(bmat, bmat), data, 4, 8, 2, acc, 256), plain)
    assert torch.equal(sk.copy_rows(data, 3), data[:3])
    # numpy inputs and bool / int8 bit-matrices are taken as 0/1 bytes
    assert torch.equal(sk.bitplane_apply(bmat.numpy().astype(bool),
                                         data.numpy(), 4, 8), plain)
    assert torch.equal(sk.bitplane_apply(bmat.to(torch.int8), data, 4, 8),
                       plain)
    assert sk.launches == {"bitplane_apply": 0, "bitplane_apply_bd": 0,
                           "copy_rows": 0}


def _raises(exc, fn):
    with pytest.raises(exc):
        fn()


@pytest.mark.parametrize("case", [
    "data_dtype", "bmat_dtype", "bmat_shape", "data_rows", "acc", "tile",
    "too_many_rows", "too_many_bytes", "no_groups", "copy_r", "copy_dim",
    "meta_device"])
def test_wrappers_reject_bad_inputs(case):
    bmat = torch.zeros((32, 64), dtype=torch.uint8)
    data = torch.zeros((8, 256), dtype=torch.uint8)
    calls = {
        "data_dtype": (TypeError, lambda: sk.bitplane_apply(
            bmat, data.to(torch.int32), 4, 8)),
        "bmat_dtype": (TypeError, lambda: sk.bitplane_apply(
            bmat.float(), data, 4, 8)),
        "bmat_shape": (ValueError, lambda: sk.bitplane_apply(
            bmat[:16], data, 4, 8)),
        "data_rows": (ValueError, lambda: sk.bitplane_apply(
            bmat, data[:7], 4, 8)),
        "acc": (ValueError, lambda: sk.bitplane_apply(
            bmat, data, 4, 8, acc="fp8")),
        "tile": (ValueError, lambda: sk.bitplane_apply(
            bmat, data, 4, 8, tile_n=1000)),
        # groups * r = 64 output rows, over the kernel's 32
        "too_many_rows": (ValueError, lambda: sk.bitplane_apply_bd(
            torch.zeros((8 * 64, 8 * 16 * 8), dtype=torch.uint8),
            torch.zeros((16, 256), dtype=torch.uint8), 8, 16, 8)),
        # groups * round_up(20, 4) = 80 data bytes per column, over 64
        "too_many_bytes": (ValueError, lambda: sk.bitplane_apply_bd(
            torch.zeros((4 * 32, 4 * 160), dtype=torch.uint8),
            torch.zeros((20, 256), dtype=torch.uint8), 4, 20, 4)),
        "no_groups": (ValueError, lambda: sk.bitplane_apply_bd(
            bmat, data, 4, 8, 0)),
        "copy_r": (ValueError, lambda: sk.copy_rows(data, 9)),
        "copy_dim": (ValueError, lambda: sk.copy_rows(data[0], 1)),
        "meta_device": (ValueError, lambda: sk.copy_rows(
            torch.empty((8, 256), dtype=torch.uint8, device="meta"), 4)),
    }
    sk.reset_launches()
    exc, fn = calls[case]
    _raises(exc, fn)
    assert sum(sk.launches.values()) == 0


@pytest.mark.parametrize("tile", [32768, 8192])
def test_copy_rows_accepts_a_tile_wider_than_n(tile):
    """tile_n is a block's columns a turn, not a stage: 32768 on 256
    columns is taken, and nothing is launched for a CPU tensor."""
    sk.reset_launches()
    data = torch.from_numpy(_rand(np.random.default_rng(tile), (8, 256)))
    assert torch.equal(sk.copy_rows(data, 4, tile), data[:4])
    assert sum(sk.launches.values()) == 0


# -- the port's sweep variants ------------------------------------------------------

@pytest.mark.parametrize("variant", ["v1_int8", "v1_bf16", "bd2_int8",
                                     "bd4_bf16", "copy"])
def test_sweep_variants_on_cpu_tensors(variant):
    """make_v1 / make_bd / make_copy apply_fns at a ragged N against the
    host codec (the copy against the data's first r rows)."""
    mat = torch.from_numpy(cauchy1(8, 4))
    data = _rand(np.random.default_rng(9), (8, 8192 * 4 + 1000))
    fn = {"v1_int8": lambda: tks.make_v1(mat, 512, "int8"),
          "v1_bf16": lambda: tks.make_v1(mat, 256, "bf16"),
          "bd2_int8": lambda: tks.make_bd(mat, 4096, "int8", 2),
          "bd4_bf16": lambda: tks.make_bd(mat, 256, "bf16", 4),
          "copy": lambda: tks.make_copy(mat, 8192)}[variant]()
    got = fn(mat, torch.from_numpy(data)).numpy()
    want = data[:4] if variant == "copy" else jref.apply_matrix(
        cauchy1(8, 4), data)
    assert np.array_equal(got, want)
