"""The arithmetic of the redesigned kernels, emulated in plain numpy/torch
and held bitwise against the JAX package.

``csrc/gf_apply.cu`` looks products up in packed split-nibble tables
(``rs_kernels.packed_nibble_tables``) and turns packed words into rows
with 4x4 ``__byte_perm`` transposes; ``csrc/xor_apply.cu`` XORs staged
rows directly or selects XOR combinations of 4 rows by W's nibbles
(``rs_kernels.xor_nibble_index``), by the density rule
``rs_kernels.xor_form``.  The emulations below follow the kernels' steps
(test code, not a second path of the port) and must give what
``gf_apply_pallas`` / ``xor_apply_pallas`` give in interpret mode and what
``ceph_tpu.gf.ref.apply_matrix_fast`` gives.  Inputs come from
``np.random.default_rng(seed)``; integer arithmetic, tolerance 0.
"""
import numpy as np
import pytest
import torch

from ceph_tpu.gf import bitmatrix as jbm
from ceph_tpu.gf import ref as jref
from ceph_tpu.gf import gfw as jgfw
from ceph_tpu.ops.pallas_kernels import gf_apply_pallas, xor_apply_pallas
from ceph_tpu_torch.ops import rs_kernels as trk


def _rand(rng, shape):
    return rng.integers(0, 256, size=shape, dtype=np.uint8)


def byte_perm(x: np.ndarray, y: np.ndarray, sel: int) -> np.ndarray:
    """CUDA's __byte_perm(x, y, sel) on uint32 arrays: byte i of the result
    is byte (sel >> 4i) & 7 of the 8 bytes y:x."""
    xy = x.astype(np.uint64) | (y.astype(np.uint64) << np.uint64(32))
    out = np.zeros_like(x, dtype=np.uint32)
    for i in range(4):
        s = np.uint64(((sel >> (4 * i)) & 7) * 8)
        out |= (((xy >> s) & np.uint64(0xFF)).astype(np.uint32)
                << np.uint32(8 * i))
    return out


def transpose4(a0, a1, a2, a3):
    """The kernel's 4x4 byte transpose: words of 4 columns (byte q = row
    q) -> words of 4 rows (byte c = column c)."""
    l01, h01 = byte_perm(a0, a1, 0x5140), byte_perm(a0, a1, 0x7362)
    l23, h23 = byte_perm(a2, a3, 0x5140), byte_perm(a2, a3, 0x7362)
    return (byte_perm(l01, l23, 0x5410), byte_perm(l01, l23, 0x7632),
            byte_perm(h01, h23, 0x5410), byte_perm(h01, h23, 0x7632))


def gf_apply_emulated(mat: np.ndarray, data: np.ndarray) -> np.ndarray:
    """gf_apply.cu's steps: per group of 4 output rows, XOR over data rows
    of T_lo[b & 15] ^ T_hi[b >> 4] into one packed word per column, then
    the byte transposes of 4 columns at a time, rows past r dropped."""
    r, k = mat.shape
    n = data.shape[1]
    tab = trk.packed_nibble_tables(torch.from_numpy(mat)).numpy()
    tab = tab.astype(np.uint32)                     # [G, k, 2, 16]
    cols = -(-n // 16) * 16                         # a thread's 16-byte run
    padded = np.zeros((k, cols), np.uint8)
    padded[:, :n] = data
    out = np.zeros((tab.shape[0] * 4, cols), np.uint8)
    for g in range(tab.shape[0]):
        acc = np.zeros(cols, np.uint32)
        for j in range(k):
            b = padded[j]
            acc ^= tab[g, j, 0, b & 15] ^ tab[g, j, 1, b >> 4]
        quads = acc.reshape(-1, 4)                  # 4 columns per transpose
        rows = transpose4(*(quads[:, c] for c in range(4)))
        for q in range(4):
            out[4 * g + q] = rows[q].view(np.uint8)
    return out[:r, :n]


@pytest.mark.parametrize("r", [1, 2, 4, 5, 8])
@pytest.mark.parametrize("k", [2, 8, 20])
def test_packed_nibble_lookup_matches_pallas_and_host(r, k):
    rng = np.random.default_rng(100 * r + k)
    n = 16 * 9 + 5                                  # ragged: 153 columns
    mat, data = _rand(rng, (r, k)), _rand(rng, (k, n))
    got = gf_apply_emulated(mat, data)
    assert np.array_equal(got, jref.apply_matrix_fast(mat, data))
    want = np.asarray(gf_apply_pallas(mat, data, tile_n=256, interpret=True))
    assert np.array_equal(got, want)


def test_packed_nibble_tables_hold_the_products():
    rng = np.random.default_rng(5)
    mat = _rand(rng, (6, 3))
    tab = trk.packed_nibble_tables(mat).numpy()
    assert tab.shape == (2, 3, 2, 16) and tab.max() < 2**32
    for g, j, h, e in [(0, 0, 0, 7), (1, 2, 1, 15), (1, 1, 0, 0), (0, 2, 1, 9)]:
        b = e << 4 if h else e
        for q in range(4):
            i = 4 * g + q
            want = jref.apply_matrix(mat[i:i + 1, j:j + 1],
                                     np.array([[b]], np.uint8))[0, 0] \
                if i < 6 else 0
            assert (int(tab[g, j, h, e]) >> (8 * q)) & 0xFF == want


def test_byte_transpose_is_a_transpose():
    rng = np.random.default_rng(6)
    words = rng.integers(0, 2**32, size=(4, 7), dtype=np.uint64).astype(
        np.uint32)
    rows = transpose4(*words)
    cols_bytes = np.stack([w.view(np.uint8).reshape(7, 4) for w in words])
    for q in range(4):
        assert np.array_equal(rows[q].view(np.uint8).reshape(7, 4),
                              cols_bytes[:, :, q].T)


# -- xor_apply: direct and XOR-combination forms --------------------------------

SLICE = 16          # input rows per staged slice in xor_apply.cu


def xor_direct_emulated(W: np.ndarray, packets: np.ndarray) -> np.ndarray:
    """Direct form: per 16-row slice, each output row XORs the staged rows
    whose bit its 16-bit slice mask sets, walking the set bits."""
    R, K = W.shape
    out = np.zeros((R, packets.shape[1]), np.uint8)
    for s0 in range(0, K, SLICE):
        for r in range(R):
            mask = sum(int(W[r, s0 + b] & 1) << b
                       for b in range(min(SLICE, K - s0)))
            while mask:
                b = (mask & -mask).bit_length() - 1
                mask &= mask - 1
                out[r] ^= packets[s0 + b]
    return out


def xor_tables_emulated(W: np.ndarray, packets: np.ndarray) -> np.ndarray:
    """Tables form: per group of 4 input rows, the 16 XOR combinations in
    Gray-code order (two halves of 8, as two warps build them), then each
    output row XORs the combination its nibble selects."""
    R, K = W.shape
    P = packets.shape[1]
    nib = trk.xor_nibble_index(torch.from_numpy(W)).numpy()
    groups = nib.shape[1]
    rows = np.zeros((groups * 4, P), np.uint8)
    rows[:K] = packets
    out = np.zeros((R, P), np.uint8)
    for g in range(groups):
        x = rows[4 * g:4 * g + 4]
        comb = np.zeros((16, P), np.uint8)
        for h in (0, 1):
            v = x[3].copy() if h else np.zeros(P, np.uint8)
            comb[h * 8] = v
            for t in range(1, 8):
                v = v ^ x[(t & -t).bit_length() - 1]
                comb[h * 8 + (t ^ (t >> 1))] = v
        for r in range(R):
            if nib[r, g]:
                out[r] ^= comb[nib[r, g]]
    return out


def _jerasure_W(name):
    if name == "liber8tion":
        return jbm.liber8tion_bitmatrix(8)                      # [16, 64]
    field = jgfw.GFW(16)
    return field.expand_bitmatrix(field.vandermonde(8, 4))     # [64, 128]


W_CASES = ["liber8tion", "w16", "rand_5x6", "rand_9x14", "rand_3x30",
           "rand_2x1"]


def _W(case, rng):
    if not case.startswith("rand"):
        return np.ascontiguousarray(_jerasure_W(case), dtype=np.uint8)
    r, k = map(int, case.split("_")[1].split("x"))
    return rng.integers(0, 2, size=(r, k), dtype=np.uint8)


@pytest.mark.parametrize("form", ["direct", "tables"])
@pytest.mark.parametrize("case", W_CASES)
def test_xor_forms_match_pallas_interpret(form, case):
    rng = np.random.default_rng(len(case) * 31 + len(form))
    W = _W(case, rng)
    packets = _rand(rng, (W.shape[1], 200))
    emulate = xor_direct_emulated if form == "direct" else xor_tables_emulated
    got = emulate(W, packets)
    want = np.asarray(xor_apply_pallas(W, packets, tile_n=256,
                                       interpret=True))
    assert np.array_equal(got, want)
    assert np.array_equal(got, trk.xor_apply_plain(
        torch.from_numpy(W), torch.from_numpy(packets)).numpy())


def test_xor_nibble_index_packs_four_bits_per_group():
    rng = np.random.default_rng(8)
    W = rng.integers(0, 2, size=(7, 13), dtype=np.uint8)
    W[2, 5] = 3                                    # only bit 0 counts
    nib = trk.xor_nibble_index(W).numpy()
    assert nib.shape == (7, 4) and nib.dtype == np.uint8
    for r in range(7):
        for g in range(4):
            want = sum(int(W[r, 4 * g + b] & 1) << b
                       for b in range(4) if 4 * g + b < 13)
            assert nib[r, g] == want


def test_xor_form_rule_picks_tables_on_dense_w16_and_direct_on_liber8tion():
    dense, sparse = _jerasure_W("w16"), _jerasure_W("liber8tion")
    assert trk.xor_form(dense) == "tables"
    assert trk.xor_form(sparse) == "direct"
    # the rule's two sides, counted here as the kernel counts them
    nib = trk.xor_nibble_index(dense).numpy()
    assert int(dense.sum()) > (nib != 0).sum() + 8 * nib.shape[1]
    assert trk.xor_form(np.zeros((4, 8), np.uint8)) == "direct"
    assert trk.xor_form(np.ones((64, 64), np.uint8)) == "tables"


def test_xor_apply_form_on_the_cpu_runs_the_plain_version():
    rng = np.random.default_rng(9)
    W = rng.integers(0, 2, size=(6, 10), dtype=np.uint8)
    packets = _rand(rng, (10, 77))
    want = trk.xor_apply_plain(torch.from_numpy(W), torch.from_numpy(packets))
    trk.reset_launches()
    for form in ("auto", "direct", "tables"):
        assert torch.equal(trk.xor_apply_form(W, packets, form), want)
    assert trk.launches["xor_apply"] == 0
    with pytest.raises(ValueError):
        trk.xor_apply_form(W, packets, "bitplane")
