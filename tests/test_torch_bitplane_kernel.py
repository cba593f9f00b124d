"""The arithmetic of the bit-plane kernel of ``csrc/sweep_kernels.cu``,
emulated in numpy step by step and held bitwise against the JAX package's
sweep kernels (``tools/kernel_sweep.py``'s ``_kernel_v1``/``_kernel_bd``
under ``pl.pallas_call(..., interpret=True)``).

The kernel multiplies out^T = bits^T . B^T on mma.sync: a warp tile is 64
columns of a span of G column tiles, four 16-row M tiles; lane (gid, tig)
builds its A fragments from the column words of its two runs of 4
columns (4 row words of the staged tile, transposed), with K ordered
g*8kp + plane*kp + j and the rows and planes looked up per 4 K values;
B holds the bit-matrix with the output bits ordered n = 32*(u/4) +
8*(b/2) + 2*(u%4) + b%2, as ready fragments or as one compact byte a
lane; the accumulators then give lane tig all 8 bits of stacked row
4*pass + tig, which 3 byte gathers per bit repack.  The emulation follows
those steps (test code, not a second path of the port), with the PTX
fragment layouts of m16n8k32 (s8) and m16n8k16 (bf16), and must give what
the reference gives.  Inputs come from ``np.random.default_rng(seed)``;
integer arithmetic, tolerance 0.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl

from ceph_tpu.gf import ref as jref
from ceph_tpu.ops.codec import RSCodec as JRSCodec
from ceph_tpu.ops.pallas_kernels import expand_bits_plane_major as jexpand
from ceph_tpu_torch.tools import path_shapes
from tools import kernel_sweep as jks

WC = 64             # columns of a warp tile
NP = 32             # output bits of a pass


def _kinfo(K, k, kp):
    """Per 4 K values: (plane, ring row of their first data row)."""
    out = []
    for c in range(K // 4):
        kk = 4 * c
        gi, rem = divmod(kk, 8 * kp)
        out.append((rem // kp, gi * kp + rem % kp))
    return out


def _b_matrix(bmat, r, k, G, kp, npass):
    """B[kk, n] in the kernel's K and N orders, from the plane-major
    (block-diagonal) bit-matrix."""
    K = 8 * G * kp
    B = np.zeros((K, npass * NP), np.int64)
    for nn in range(npass * NP):
        w32 = nn & 31
        u = 4 * (nn >> 5) + ((w32 & 7) >> 1)
        bo = 2 * (w32 >> 3) + (w32 & 1)
        if u >= G * r:
            continue
        go, io = divmod(u, r)
        for kk in range(K):
            gi, rem = divmod(kk, 8 * kp)
            bi, j = divmod(rem, kp)
            if j < k:
                B[kk, nn] = bmat[go * 8 * r + bo * r + io,
                                 gi * 8 * k + bi * k + j] & 1
    return B


def _b_fragments(B, ksteps, bf16, compact):
    """B as the kernel stores it, expanded and decoded back to a matrix
    through the mma B fragment layout (b0: K values per*tig.., b1: the
    same + KSTEP/2; column n = 8nt + gid)."""
    kstep, per = (16, 2) if bf16 else (32, 4)
    npn = B.shape[1]
    back = np.zeros_like(B)
    for p_nt in range(npn // 8):
        for ks in range(ksteps):
            for lane in range(32):
                gid, tig = lane >> 2, lane & 3
                nn = 8 * p_nt + gid
                words, bits = [0, 0], 0
                for h in range(2):
                    kk = kstep * ks + h * (kstep // 2) + per * tig
                    for y in range(per):
                        c = int(B[kk + y, nn])
                        bits |= c << (h * per + y)
                        words[h] |= ((0x3F80 if c else 0) << (16 * y)) \
                            if bf16 else c << (8 * y)
                if compact:                       # expand_b
                    x = bits
                    if bf16:
                        words = [((x & 1) | ((x & 2) << 15)) * 0x3F80,
                                 (((x >> 2) & 1) | ((x & 8) << 13)) * 0x3F80]
                    else:
                        words = [((x & 15) * 0x00204081) & 0x01010101,
                                 (((x >> 4) & 15) * 0x00204081) & 0x01010101]
                for h in range(2):
                    kk = kstep * ks + h * (kstep // 2) + per * tig
                    for y in range(per):
                        v = (words[h] >> (16 * y if bf16 else 8 * y)) & \
                            (0xFFFF if bf16 else 0xFF)
                        back[kk + y, nn] = (v == 0x3F80) if bf16 else v
    return back


def bitplane_emulated(bmat, data, r, k, G, tile_n, acc, compact=False):
    """The kernel's result out [r, N] for the plane-major (block-diagonal
    for G > 1) bit-matrix ``bmat`` and data [k, N]."""
    bf16 = acc == "bf16"
    kstep, per = (16, 2) if bf16 else (32, 4)
    kp = -(-k // 4) * 4
    gkp, n = G * kp, data.shape[1]
    K = 8 * gkp
    ksteps = K // kstep
    rows = 4
    while rows < G * r:
        rows *= 2
    npass = rows // 4
    kinfo = _kinfo(K, k, kp)
    B = _b_fragments(_b_matrix(bmat, r, k, G, kp, npass), ksteps, bf16,
                     compact)
    out = np.zeros((r, n), np.uint8)
    span = G * tile_n
    lanes = np.arange(32)
    gid, tig = lanes >> 2, lanes & 3
    for unit in range(-(-n // span)):
        for st in range(tile_n // WC):
            col0 = unit * span + st * WC
            if col0 >= n:
                break
            ring = np.zeros((gkp, WC), np.int64)          # staged tile
            for g in range(G):
                for j in range(k):
                    c = col0 + g * tile_n + np.arange(WC)
                    ok = c < n
                    ring[g * kp + j, ok] = data[j, c[ok]]
            # A [4 M tiles, 16 rows, K] from the lanes' fragments
            A = np.zeros((4, 16, K), np.int64)
            for ks in range(ksteps):
                for c2 in range(2):
                    kk0 = kstep * ks + c2 * (kstep // 2) + per * tig
                    for lane in range(32):
                        plane, row = kinfo[kk0[lane] >> 2]
                        sh = plane + (8 * (kk0[lane] & 3) if bf16 else 0)
                        for t in range(4):
                            for h in range(2):
                                col = 32 * (t >> 1) + 4 * gid[lane] + \
                                    2 * (t & 1) + h
                                w = sum(int(ring[row + y, col]) << (8 * y)
                                        for y in range(4))
                                reg = (w >> sh) & (0x0101 if bf16
                                                   else 0x01010101)
                                for y in range(per):
                                    A[t, gid[lane] + 8 * h, kk0[lane] + y] = \
                                        (reg >> (8 * y)) & 1
            for p in range(npass):
                D = A @ B[:, p * NP:(p + 1) * NP]          # [4, 16, 32]
                u = 4 * p + tig
                for lane in range(32):
                    if u[lane] >= G * r:
                        continue
                    go, io = divmod(int(u[lane]), r)
                    for half in range(2):
                        for c in range(4):
                            t, h = 2 * half + (c >> 1), c & 1
                            byte = 0
                            for b in range(8):
                                nn = 8 * (b >> 1) + 2 * tig[lane] + (b & 1)
                                byte |= (int(D[t, gid[lane] + 8 * h, nn]) & 1
                                         ) << b
                            colo = col0 + go * tile_n + 32 * half + \
                                4 * gid[lane] + c
                            if colo < n:
                                out[io, colo] = byte
    return out


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


def _bd4_interpret(mat, data, tile, acc):
    """``_kernel_bd`` at groups = 4 (the only count it traces); group g's
    column tiles are read from ``outs[g]``."""
    r, k = mat.shape
    n, groups = data.shape[1], 4
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
    merged = np.zeros((r, n), np.uint8)
    for g, o in enumerate(outs):
        o = np.asarray(o).reshape(r, -1, groups, tile)
        merged.reshape(r, -1, groups, tile)[:, :, g] = o[:, :, g]
    return merged, bd


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("acc", ["int8", "bf16"])
@pytest.mark.parametrize("r,k", [(4, 8), (2, 6), (5, 3)])
def test_bitplane_emulation_matches_kernel_v1(r, k, acc, compact):
    rng = np.random.default_rng(10 * r + k)
    mat = rng.integers(0, 256, size=(r, k), dtype=np.uint8)
    tile = 256
    data = rng.integers(0, 256, size=(k, 2 * tile), dtype=np.uint8)
    want = _v1_interpret(mat, data, tile, acc)
    assert np.array_equal(want, jref.apply_matrix_fast(mat, data))
    got = bitplane_emulated(np.asarray(jexpand(mat)), data, r, k, 1, tile,
                            acc, compact)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("acc", ["int8", "bf16"])
def test_bitplane_emulation_matches_kernel_bd(acc):
    rng = np.random.default_rng(77)
    r, k, tile = 4, 8, 256
    mat = rng.integers(0, 256, size=(r, k), dtype=np.uint8)
    data = rng.integers(0, 256, size=(k, 4 * tile), dtype=np.uint8)
    want, bd = _bd4_interpret(mat, data, tile, acc)
    assert np.array_equal(want, jref.apply_matrix_fast(mat, data))
    for compact in (False, True):
        got = bitplane_emulated(bd, data, r, k, 4, tile, acc, compact)
        assert np.array_equal(got, want)


def test_bitplane_emulation_at_the_limits_with_a_ragged_tail():
    """G*r = 32 with G*kp = 64 (two passes of stacked rows past the first
    32 output bits, k not a multiple of 4), over a ragged N: against the
    host codec, as the reference traces only full tiles."""
    rng = np.random.default_rng(78)
    for r, k, G in ((8, 13, 4), (32, 5, 1)):
        mat = rng.integers(0, 256, size=(r, k), dtype=np.uint8)
        bexp = np.asarray(jexpand(mat))
        bd = np.zeros((G * 8 * r, G * 8 * k), np.uint8)
        for g in range(G):
            bd[g * 8 * r:(g + 1) * 8 * r, g * 8 * k:(g + 1) * 8 * k] = bexp
        n = 256 * G + 77
        data = rng.integers(0, 256, size=(k, n), dtype=np.uint8)
        got = bitplane_emulated(bd, data, r, k, G, 256, "int8",
                                compact=G > 1)
        assert np.array_equal(got, jref.apply_matrix_fast(mat, data))


def test_path_shapes_times_the_sweeps_five_bitplane_variants():
    """The shapes ``path_shapes.py`` and phase ``shapes`` time the kernel
    at: the sweep's Cauchy RS(8,4) over [8, 8 Mi], int8 and bf16 at
    G = 1, int8 at G = 4 and 2, bf16 at G = 4."""
    shapes = path_shapes.sweep_shapes(path_shapes.load_package())
    assert [(s["kernel"], s["acc"], s["groups"], s["tile_n"])
            for s in shapes] == [
        ("bitplane_apply", "int8", 1, 8192),
        ("bitplane_apply", "bf16", 1, 8192),
        ("bitplane_apply_bd", "int8", 4, 8192),
        ("bitplane_apply_bd", "int8", 2, 8192),
        ("bitplane_apply_bd", "bf16", 4, 4096)]
    cauchy = JRSCodec(8, 4, technique="cauchy", device="numpy").parity_mat
    for s in shapes:
        assert np.array_equal(s["mat"], cauchy)
        assert (s["rows"], s["cols"], s["path"]) == (8, 8 << 20, "sweep")
