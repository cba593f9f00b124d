"""The port's GF(2^8) apply and crc32c rows against the JAX package.

Inputs come from ``np.random.default_rng(seed)`` and go through both
packages as numpy arrays.  On the CPU the port's wrappers run their plain
PyTorch versions; the JAX side runs the Pallas kernels in interpret mode
(as tests/test_pallas.py does) and the XLA bitslice/lookup paths.  The
arithmetic is integer, so every comparison is bitwise (tolerance 0).
"""
import numpy as np
import pytest
import torch

from ceph_tpu.ops import rs_kernels as jrk
from ceph_tpu.ops.pallas_kernels import gf_apply_pallas, gf_apply_stripes_pallas
from ceph_tpu_torch.backend import ecutil as tecutil
from ceph_tpu_torch.gf import ref as tref
from ceph_tpu_torch.ops import rs_kernels as trk

# the port's ways to compute the apply on the CPU: its two plain versions,
# and the wrapper (which takes gf_apply_plain for a CPU tensor)
PLAIN = {"bitslice": trk.gf_apply_bitslice, "lookup": trk.gf_apply_lookup}
VARIANTS = ["bitslice", "lookup", "wrapper"]
JAX_VARIANTS = ["bitslice", "lookup"]


def _rand(rng, shape):
    return rng.integers(0, 256, size=shape, dtype=np.uint8)


def _apply(variant, mat, data) -> torch.Tensor:
    m, d = torch.from_numpy(mat), torch.from_numpy(data)
    if variant == "wrapper":
        return trk.gf_apply(m, d)
    return PLAIN[variant](m, d)


def _apply_stripes(variant, mat, data, S) -> torch.Tensor:
    if variant == "wrapper":
        return trk.gf_apply_stripes(mat, data, S)
    k = mat.shape[1]
    return torch.cat([_apply(variant, mat, data[s * k:(s + 1) * k])
                      for s in range(S)])


def _np(t: torch.Tensor) -> np.ndarray:
    assert t.device.type == "cpu" and t.dtype == torch.uint8
    return t.numpy()


# -- horizontal layout: [k, N] -> [r, N] --------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("r,k,n,tile", [
    (4, 8, 2048, 512),       # even tiles
    (2, 4, 3000, 512),       # ragged tail
    (3, 5, 512, 1024),       # single partial tile
    (1, 2, 256, 256),        # minimal shapes
])
def test_gf_apply_matches_pallas_interpret(variant, r, k, n, tile):
    rng = np.random.default_rng(r * 100 + k)
    mat, data = _rand(rng, (r, k)), _rand(rng, (k, n))
    want = np.asarray(gf_apply_pallas(mat, data, tile_n=tile, interpret=True))
    got = _np(_apply(variant, mat, data))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("jax_variant", JAX_VARIANTS)
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("shape", [(1, 2, 128), (4, 8, 1024), (3, 10, 333),
                                   (4, 8, 1), (2, 8, 127), (4, 20, 1000)])
def test_gf_apply_matches_jax_xla(variant, jax_variant, shape):
    r, k, n = shape
    rng = np.random.default_rng(42 + n)
    mat, data = _rand(rng, (r, k)), _rand(rng, (k, n))
    want = np.asarray(jrk.gf_apply(mat, data, variant=jax_variant))
    got = _np(_apply(variant, mat, data))
    assert np.array_equal(got, want)
    assert np.array_equal(got, tref.apply_matrix(mat, data))


def test_gf_apply_auto_and_plain_entry_points_agree():
    rng = np.random.default_rng(3)
    mat, data = _rand(rng, (4, 8)), _rand(rng, (8, 777))
    want = tref.apply_matrix(mat, data)
    m, d = torch.from_numpy(mat), torch.from_numpy(data)
    assert np.array_equal(_np(trk.gf_apply_plain(m, d)), want)
    assert np.array_equal(_np(trk.gf_apply_bitslice(m, d)), want)
    assert np.array_equal(_np(trk.gf_apply_lookup(m, d)), want)
    tiny = _rand(rng, (1, 2))          # r*k < 8 takes the lookup branch
    assert np.array_equal(
        _np(trk.gf_apply_plain(torch.from_numpy(tiny), d[:2])),
        tref.apply_matrix(tiny, data[:2]))


@pytest.mark.parametrize("tf32", [True, False])
def test_bitslice_restores_the_callers_tf32_setting(tf32):
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        rng = np.random.default_rng(4)
        mat, data = _rand(rng, (4, 8)), _rand(rng, (8, 64))
        got = trk.gf_apply_bitslice(torch.from_numpy(mat),
                                    torch.from_numpy(data))
        assert np.array_equal(_np(got), tref.apply_matrix(mat, data))
        assert torch.backends.cuda.matmul.allow_tf32 is tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


# -- vertical layout: [S*k, N] -> [S*r, N] ------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("r,k,S,n,groups,tile", [
    (4, 8, 8, 1024, 4, 512),     # even groups
    (4, 8, 6, 1024, 4, 512),     # stripe count not a group multiple
    (2, 4, 3, 700, 4, 256),      # ragged columns + groups > stripes
    (4, 8, 1, 512, 4, 512),      # single stripe
    (1, 2, 5, 129, 4, 128),      # odd stripes, one-row matrix
])
def test_gf_apply_stripes_matches_pallas_interpret(variant, r, k, S, n,
                                                   groups, tile):
    rng = np.random.default_rng(r * 1000 + S)
    mat, data = _rand(rng, (r, k)), _rand(rng, (S * k, n))
    want = np.asarray(gf_apply_stripes_pallas(
        mat, data, S, groups=groups, tile_n=tile, interpret=True))
    got = _np(_apply_stripes(variant, mat, data, S))
    assert got.shape == (S * r, n)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("S,n", [(1, 1), (3, 127), (7, 1000)])
def test_gf_apply_stripes_matches_jax_fallback(S, n):
    rng = np.random.default_rng(S * 7 + n)
    mat, data = _rand(rng, (4, 8)), _rand(rng, (S * 8, n))
    want = np.asarray(jrk.gf_apply_stripes(mat, data, S))
    got = _np(trk.gf_apply_stripes(torch.from_numpy(mat),
                                   torch.from_numpy(data), S))
    assert np.array_equal(got, want)
    for s in range(S):
        assert np.array_equal(got[s * 4:(s + 1) * 4],
                              tref.apply_matrix(mat, data[s * 8:(s + 1) * 8]))


def test_gf_apply_stripes_rejects_row_mismatch():
    with pytest.raises(ValueError):
        trk.gf_apply_stripes(np.ones((4, 8), np.uint8),
                             np.zeros((17, 64), np.uint8), 2)


# -- helpers shared with the JAX package --------------------------------------

def test_expand_bits_raw_matches_jax():
    rng = np.random.default_rng(9)
    mat = _rand(rng, (3, 5))
    want = np.asarray(jrk.expand_bits_raw(mat))
    got = trk.expand_bits_raw(torch.from_numpy(mat)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("k,n", [(2, 1), (5, 333), (8, 4096)])
def test_xor_reduce_matches_jax(k, n):
    rng = np.random.default_rng(k + n)
    data = _rand(rng, (k, n))
    want = np.asarray(jrk.xor_reduce(data))
    got = trk.xor_reduce(torch.from_numpy(data)).numpy()
    assert np.array_equal(got, want)
    ones = np.ones((1, k), np.uint8)       # the parity row of ones
    assert np.array_equal(got, tref.apply_matrix(ones, data))


# -- crc32c rows ---------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 3, 1000, 4096])
def test_crc32c_rows_matches_jax(n):
    rng = np.random.default_rng(n)
    rows = _rand(rng, (5, n))
    want = np.asarray(jrk.crc32c_rows(rows)).astype(np.int64)
    got = trk.crc32c_rows(torch.from_numpy(rows))
    assert got.dtype == torch.int64 and got.shape == (5,)
    assert np.array_equal(got.numpy(), want)
    host = [tecutil.crc32c(0, row) for row in rows]
    assert got.tolist() == host


def test_crc32c_rows_chains_into_seeded_crc():
    rng = np.random.default_rng(17)
    rows = _rand(rng, (3, 2500))
    c0 = trk.crc32c_rows(rows).tolist()
    for row, c in zip(rows, c0):
        seeded = tecutil.crc32c(0xFFFFFFFF, row)
        assert seeded == tecutil.crc32c_zeros(0xFFFFFFFF, len(row)) ^ c


# -- wrapper contract on the CPU -----------------------------------------------

def test_cpu_tensors_never_count_a_launch():
    trk.reset_launches()
    rng = np.random.default_rng(1)
    mat, data = _rand(rng, (2, 4)), _rand(rng, (8, 64))
    trk.gf_apply(mat, data[:4])
    trk.gf_apply_stripes(mat, data, 2)
    trk.xor_apply(_rand(rng, (3, 8)) & 1, data)
    trk.crc32c_rows(data)
    assert trk.launches == {"gf_apply": 0, "gf_apply_stripes": 0,
                            "xor_apply": 0, "crc32c_rows": 0}


def test_wrapper_rejects_bad_inputs():
    with pytest.raises(TypeError):
        trk.gf_apply(torch.zeros((2, 4), dtype=torch.int32),
                     torch.zeros((4, 8), dtype=torch.uint8))
    with pytest.raises(TypeError):
        trk.gf_apply([[1, 2]], np.zeros((2, 8), np.uint8))
    meta = torch.empty((4, 64), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        trk.gf_apply(torch.ones((2, 4), dtype=torch.uint8, device="meta"),
                     meta)
