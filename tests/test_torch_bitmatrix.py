"""The port's GF(2) bitmatrix and GF(2^w) modules and its xor_apply against
the JAX package.

``ceph_tpu_torch.gf.bitmatrix`` and ``gf.gfw`` are copies of the JAX
package's numpy modules; every construction in the envelopes the JAX tests
cover must come out equal.  ``rs_kernels.xor_apply_plain`` (what the
wrapper runs for a CPU tensor) is held against the JAX package's
``xor_apply`` on JAX-CPU (its XLA bit-plane matmul) and against
``xor_apply_pallas`` in interpret mode.  All of it is exact integer
arithmetic, so every comparison is bitwise.
"""
import itertools

import numpy as np
import pytest
import torch

from ceph_tpu.gf import bitmatrix as jbm
from ceph_tpu.gf.gfw import GFW as JGFW
from ceph_tpu.ops import rs_kernels as jrk
from ceph_tpu.ops.pallas_kernels import xor_apply_pallas
from ceph_tpu_torch.gf import bitmatrix as bm
from ceph_tpu_torch.gf import gfw as tgfw
from ceph_tpu_torch.ops import rs_kernels as trk

LIBERATION = [(2, 3), (4, 5), (7, 7), (5, 11)]
BLAUM_ROTH = [(2, 4), (4, 6), (6, 6), (8, 10), (4, 7)]
LIBER8TION = [2, 4, 8]


# -- constructions ---------------------------------------------------------------

@pytest.mark.parametrize("k,w", LIBERATION)
def test_liberation_matches_jax(k, w):
    assert np.array_equal(bm.liberation_bitmatrix(k, w),
                          jbm.liberation_bitmatrix(k, w))


@pytest.mark.parametrize("k,w", BLAUM_ROTH)
def test_blaum_roth_matches_jax(k, w):
    assert np.array_equal(bm.blaum_roth_bitmatrix(k, w),
                          jbm.blaum_roth_bitmatrix(k, w))


@pytest.mark.parametrize("k", LIBER8TION)
def test_liber8tion_matches_jax(k):
    assert np.array_equal(bm.liber8tion_bitmatrix(k),
                          jbm.liber8tion_bitmatrix(k))


@pytest.mark.parametrize("fn,args", [
    ("liberation_bitmatrix", (4, 6)), ("liberation_bitmatrix", (4, 2)),
    ("liberation_bitmatrix", (8, 7)), ("blaum_roth_bitmatrix", (4, 5)),
    ("blaum_roth_bitmatrix", (8, 6)), ("liber8tion_bitmatrix", (9,)),
])
def test_construction_envelopes_match_jax(fn, args):
    with pytest.raises(ValueError) as got:
        getattr(bm, fn)(*args)
    with pytest.raises(ValueError) as want:
        getattr(jbm, fn)(*args)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("w", [16, 32])
def test_field_matches_jax(w):
    gf, jgf = tgfw.gfw(w), JGFW(w)
    assert tgfw.gfw(w) is gf                 # one field per width
    assert gf.poly == jgf.poly
    rng = np.random.default_rng(w)
    xs = [int(x) for x in rng.integers(1, 1 << min(w, 31), 24)]
    for a, b in zip(xs[:12], xs[12:]):
        assert gf.mul(a, b) == jgf.mul(a, b)
        assert gf.inv(a) == jgf.inv(a)
        assert gf.pow(a, b % 97) == jgf.pow(a, b % 97)
        assert np.array_equal(gf.mul_bitmatrix(a), jgf.mul_bitmatrix(a))
    if w == 16:
        assert np.array_equal(gf._exp, jgf._exp)
        assert np.array_equal(gf._log, jgf._log)


@pytest.mark.parametrize("w", [16, 32])
@pytest.mark.parametrize("technique", ["reed_sol_van", "cauchy"])
@pytest.mark.parametrize("k,m", [(4, 2), (8, 4), (3, 3)])
def test_wide_constructions_match_jax(w, technique, k, m):
    gf, jgf = tgfw.gfw(w), JGFW(w)
    if technique == "reed_sol_van":
        mat, jmat = gf.vandermonde(k, m), jgf.vandermonde(k, m)
    else:
        mat, jmat = gf.cauchy(k, m), jgf.cauchy(k, m)
    assert mat.tolist() == jmat.tolist()
    assert np.array_equal(gf.expand_bitmatrix(mat),
                          jgf.expand_bitmatrix(jmat))


def test_field_rejects_other_widths():
    for w in (8, 12):
        with pytest.raises(ValueError):
            tgfw.GFW(w)


# -- decode matrices -------------------------------------------------------------

_CODES = ([("liberation", k, w) for k, w in LIBERATION[:2]]
          + [("blaum_roth", 4, 6), ("liber8tion", 4, 8), ("liber8tion", 8, 8)]
          + [("reed_sol_van", 3, 16), ("cauchy", 3, 32)])


def _coding(name, k, w):
    if name == "liberation":
        return bm.liberation_bitmatrix(k, w)
    if name == "blaum_roth":
        return bm.blaum_roth_bitmatrix(k, w)
    if name == "liber8tion":
        return bm.liber8tion_bitmatrix(k)
    gf = tgfw.gfw(w)
    mat = gf.vandermonde(k, 2) if name == "reed_sol_van" else gf.cauchy(k, 2)
    return gf.expand_bitmatrix(mat)


@pytest.mark.parametrize("name,k,w", _CODES)
def test_decode_bitmatrix_matches_jax_every_pair(name, k, w):
    coding = _coding(name, k, w)
    n = k + 2
    patterns = [(e,) for e in range(n)] + \
        list(itertools.combinations(range(n), 2))
    for erasures in patterns:
        avail = [i for i in range(n) if i not in erasures]
        D, src = bm.decode_bitmatrix(coding, k, w, list(erasures), avail)
        jD, jsrc = jbm.decode_bitmatrix(coding, k, w, list(erasures), avail)
        assert src == jsrc and np.array_equal(D, jD), erasures
    D, src = bm.decode_bitmatrix(coding, k, w, [0])
    jD, jsrc = jbm.decode_bitmatrix(coding, k, w, [0])
    assert src == jsrc and np.array_equal(D, jD)


def test_decode_bitmatrix_failures_match_jax():
    coding = bm.blaum_roth_bitmatrix(4, 7)   # w=7: (data, data) undecodable
    for mod in (bm, jbm):
        with pytest.raises(np.linalg.LinAlgError):
            mod.decode_bitmatrix(coding, 4, 7, [0, 1])
        with pytest.raises(ValueError):
            mod.decode_bitmatrix(coding, 4, 7, [0], available=[1, 2])
    rng = np.random.default_rng(3)
    for _ in range(4):
        M = rng.integers(0, 2, (10, 10), dtype=np.uint8)
        try:
            want = jbm.gf2_invert(M)
        except np.linalg.LinAlgError:
            with pytest.raises(np.linalg.LinAlgError):
                bm.gf2_invert(M)
            continue
        assert np.array_equal(bm.gf2_invert(M), want)


@pytest.mark.parametrize("w,ps", [(5, 4), (8, 8), (16, 4)])
def test_packet_layout_matches_jax(w, ps):
    chunks = np.random.default_rng(w).integers(0, 256, (3, w * ps * 3),
                                               dtype=np.uint8)
    p = bm.to_packets(chunks, w, ps)
    assert np.array_equal(p, jbm.to_packets(chunks, w, ps))
    assert np.array_equal(bm.from_packets(p, w, ps),
                          jbm.from_packets(p, w, ps))
    assert np.array_equal(bm.from_packets(p, w, ps), chunks)
    with pytest.raises(ValueError):
        bm.to_packets(chunks[:, :-4], w, ps)


# -- xor_apply -------------------------------------------------------------------

_XOR_SHAPES = [(14, 28, 700), (16, 48, 1000), (64, 128, 333), (128, 256, 129)]


@pytest.mark.parametrize("R,K,P", _XOR_SHAPES)
def test_xor_apply_plain_matches_jax_xla(R, K, P):
    rng = np.random.default_rng(R + K)
    W = rng.integers(0, 2, (R, K), dtype=np.uint8)
    packets = rng.integers(0, 256, (K, P), dtype=np.uint8)
    want = np.asarray(jrk.xor_apply(W, packets, variant="xla"))
    got = trk.xor_apply_plain(torch.from_numpy(W), torch.from_numpy(packets))
    assert np.array_equal(got.numpy(), want)
    # the wrapper takes the plain version for CPU tensors and numpy arrays
    assert np.array_equal(trk.xor_apply(W, packets).numpy(), want)
    assert np.array_equal(bm.xor_apply_host(W, packets), want)


@pytest.mark.parametrize("R,K,P", _XOR_SHAPES)
def test_xor_apply_plain_matches_pallas_interpret(R, K, P):
    rng = np.random.default_rng(R * K + P)
    W = rng.integers(0, 2, (R, K), dtype=np.uint8)
    packets = rng.integers(0, 256, (K, P), dtype=np.uint8)
    want = np.asarray(xor_apply_pallas(W, packets, tile_n=256,
                                       interpret=True))
    got = trk.xor_apply(torch.from_numpy(W), torch.from_numpy(packets))
    assert got.dtype == torch.uint8 and got.shape == (R, P)
    assert np.array_equal(got.numpy(), want)


def test_xor_apply_reads_bit_zero_like_the_jax_device_path():
    """int8/bool W and odd values: bit 0 counts, as in the mod-2 matmul."""
    rng = np.random.default_rng(11)
    W = rng.integers(-3, 4, (6, 9)).astype(np.int8)
    packets = rng.integers(0, 256, (9, 40), dtype=np.uint8)
    want = np.asarray(jrk.xor_apply(W, packets, variant="xla"))
    assert np.array_equal(trk.xor_apply(W, packets).numpy(), want)
    assert np.array_equal(
        trk.xor_apply(torch.from_numpy((W & 1).astype(bool)),
                      torch.from_numpy(packets)).numpy(), want)


def test_xor_apply_edges_and_errors():
    packets = torch.arange(24, dtype=torch.uint8).reshape(3, 8)
    zero = trk.xor_apply(torch.zeros((2, 3), dtype=torch.uint8), packets)
    assert zero.shape == (2, 8) and not zero.any()
    one = trk.xor_apply(torch.tensor([[1, 1, 1]], dtype=torch.uint8), packets)
    assert torch.equal(one[0], packets[0] ^ packets[1] ^ packets[2])
    assert trk.xor_apply(np.ones((2, 3), np.uint8),
                         np.zeros((3, 0), np.uint8)).shape == (2, 0)
    with pytest.raises(ValueError):
        trk.xor_apply(np.ones((2, 4), np.uint8), packets)
    with pytest.raises(ValueError):
        trk.xor_apply(np.ones(3, np.uint8), packets)
    with pytest.raises(TypeError):
        trk.xor_apply(np.ones((2, 3), np.float32), packets)
    with pytest.raises(TypeError):
        trk.xor_apply([[1, 0, 1]], packets)
    with pytest.raises(TypeError):
        trk.xor_apply(np.ones((2, 3), np.uint8), packets.to(torch.int16))
    with pytest.raises(ValueError, match="cuda or cpu"):
        trk.xor_apply(torch.ones((2, 3), dtype=torch.uint8, device="meta"),
                      packets.to("meta"))
    assert "xor_apply" in trk.launches
