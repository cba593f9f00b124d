"""GF(2^8) arithmetic tables, generated — not stored — at import time.

Field: GF(2^8) with primitive polynomial 0x11D (x^8+x^4+x^3+x^2+1), the
polynomial used by both gf-complete (jerasure w=8 default) and Intel ISA-L,
i.e. the field behind the reference's `jerasure` and `isa` erasure-code
plugins (reference: src/erasure-code/jerasure/, src/erasure-code/isa/).

Everything here is numpy (host side); the CUDA kernels in
ceph_tpu_torch.ops read ``MUL_TABLE`` from a copy on the card.
"""
from __future__ import annotations

import numpy as np

GF_POLY = 0x11D  # x^8 + x^4 + x^3 + x^2 + 1, primitive over GF(2)
GF_ORDER = 256


def _gen_exp_log() -> tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= GF_POLY
    exp[255:510] = exp[0:255]
    # log[0] is mathematically undefined; callers must special-case 0.
    log[0] = 0
    return exp, log


EXP_TABLE, LOG_TABLE = _gen_exp_log()


def gf_mul(a: int, b: int) -> int:
    """Scalar GF(2^8) multiply."""
    if a == 0 or b == 0:
        return 0
    return int(EXP_TABLE[int(LOG_TABLE[a]) + int(LOG_TABLE[b])])


def gf_div(a: int, b: int) -> int:
    if b == 0:
        raise ZeroDivisionError("GF(2^8) division by zero")
    if a == 0:
        return 0
    return int(EXP_TABLE[(int(LOG_TABLE[a]) - int(LOG_TABLE[b])) % 255])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("GF(2^8) inverse of zero")
    return int(EXP_TABLE[(255 - int(LOG_TABLE[a])) % 255])


def gf_pow(a: int, n: int) -> int:
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(EXP_TABLE[(int(LOG_TABLE[a]) * n) % 255])


def _gen_mul_table() -> np.ndarray:
    """Full 256x256 multiplication table, MUL[a, b] = a*b in GF(2^8)."""
    a = np.arange(256)
    la = LOG_TABLE[a]
    # sum of logs mod 255, exp; zero rows/cols handled by mask
    s = (la[:, None] + la[None, :]) % 255
    t = EXP_TABLE[s].astype(np.uint8)
    t[0, :] = 0
    t[:, 0] = 0
    return t


MUL_TABLE = _gen_mul_table()


def gf_mul_vec(a, b):
    """Elementwise GF(2^8) multiply of uint8 numpy arrays (broadcasting)."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    return MUL_TABLE[a.astype(np.intp), b.astype(np.intp)]


def mul_bitmatrix(c: int) -> np.ndarray:
    """The 8x8 GF(2) matrix of 'multiply by constant c'.

    Column j holds the bits (little-endian: row i = bit i) of c * 2^j, so for
    a byte d with bit vector x, (M @ x) mod 2 is the bit vector of c*d.
    This is the bit-matrix representation jerasure's cauchy/bitmatrix
    techniques use (reference: src/erasure-code/jerasure/ErasureCodeJerasure.h:142-171);
    here it is the bridge from GF(2^8) matmul to a GF(2) matmul.
    """
    m = np.zeros((8, 8), dtype=np.uint8)
    for j in range(8):
        v = gf_mul(c, 1 << j)
        for i in range(8):
            m[i, j] = (v >> i) & 1
    return m


def expand_bitmatrix(A: np.ndarray) -> np.ndarray:
    """Expand a GF(2^8) matrix [r, c] into its GF(2) bit-matrix [8r, 8c]."""
    A = np.asarray(A, dtype=np.uint8)
    r, c = A.shape
    out = np.zeros((8 * r, 8 * c), dtype=np.uint8)
    for i in range(r):
        for j in range(c):
            out[8 * i:8 * i + 8, 8 * j:8 * j + 8] = mul_bitmatrix(int(A[i, j]))
    return out
