"""GF(2^w) for w in {16, 32}: matrix construction for wide-word codes.

The port's copy of the JAX package's ``gf/gfw.py`` (numpy only).  The
reference's jerasure plugin accepts w in {8, 16, 32}
(reference: src/erasure-code/jerasure/ErasureCodeJerasure.cc:191-197);
GF(2^8) lives in gf/tables.py.  This module supplies the WIDE fields —
only for building coding matrices and decode inversions (k*m scalars):
the DATA path never does wide-field arithmetic, because a GF(2^w)
matrix expands to a [w*m, w*k] GF(2) bitmatrix (column j of entry a =
bits of a*x^j) and the apply is then the SAME packet-layout XOR apply
the bitmatrix techniques run (gf/bitmatrix.py,
ops.rs_kernels.xor_apply).  Word size never touches the kernel: it just
changes how many packets a chunk splits into.

Primitive polynomials match gf-complete's defaults so the constructions
line up with the published jerasure semantics: w=16 -> 0x1100B,
w=32 -> 0x400007.

:func:`gfw` hands out one field per width per process: building GF(2^16)
fills 65,536-entry log/exp tables in a Python loop, the slow part of a
w=16 plugin's init.
"""
from __future__ import annotations

import functools

import numpy as np

POLY = {16: 0x1100B, 32: 0x400007}


class GFW:
    """Scalar GF(2^w) arithmetic (log/exp tables for w=16; carryless
    multiply + reduction for w=32, where tables don't fit)."""

    def __init__(self, w: int):
        if w not in POLY:
            raise ValueError(f"w={w} must be 16 or 32")
        self.w = w
        self.poly = POLY[w]
        self.mask = (1 << w) - 1
        self._log = self._exp = None
        if w == 16:
            exp = np.zeros(1 << 16, dtype=np.uint32)
            log = np.zeros(1 << 16, dtype=np.uint32)
            x = 1
            for i in range((1 << 16) - 1):
                exp[i] = x
                log[x] = i
                x <<= 1
                if x & (1 << 16):
                    x = (x ^ self.poly) & 0xFFFF
            self._exp, self._log = exp, log

    def mul(self, a: int, b: int) -> int:
        if a == 0 or b == 0:
            return 0
        if self.w == 16:
            return int(self._exp[(int(self._log[a]) + int(self._log[b]))
                                 % 0xFFFF])
        # carryless multiply then reduce (w=32)
        r = 0
        x, y = int(a), int(b)
        while y:
            if y & 1:
                r ^= x
            y >>= 1
            x <<= 1
        for bit in range(63, self.w - 1, -1):
            if r & (1 << bit):
                r ^= self.poly << (bit - self.w) | (1 << bit)
        return r & self.mask

    def pow(self, a: int, n: int) -> int:
        r = 1
        while n:
            if n & 1:
                r = self.mul(r, a)
            a = self.mul(a, a)
            n >>= 1
        return r

    def inv(self, a: int) -> int:
        if a == 0:
            raise ZeroDivisionError("GF inverse of 0")
        return self.pow(a, (1 << self.w) - 2)

    # -- coding matrices ----------------------------------------------------

    def vandermonde(self, k: int, m: int) -> np.ndarray:
        """Systematic extended-Vandermonde parity matrix [m, k] (the
        reed_sol_van construction, Plank & Ding 2003, generalized to
        this field).  object dtype: w=32 values exceed int64-safe ops."""
        rows, cols = k + m, k
        V = [[self.pow(r, c) for c in range(cols)] for r in range(rows)]
        # Gaussian elimination to make the top k x k identity (column ops)
        for i in range(k):
            if V[i][i] == 0:
                for j in range(i + 1, cols):
                    if V[i][j] != 0:
                        for r in range(rows):
                            V[r][i], V[r][j] = V[r][j], V[r][i]
                        break
            inv = self.inv(V[i][i])
            if V[i][i] != 1:
                for r in range(rows):
                    V[r][i] = self.mul(V[r][i], inv)
            for j in range(cols):
                if j != i and V[i][j] != 0:
                    c = V[i][j]
                    for r in range(rows):
                        V[r][j] ^= self.mul(c, V[r][i])
        out = np.empty((m, k), dtype=object)
        for r in range(m):
            for c in range(k):
                out[r, c] = V[k + r][c]
        return out

    def cauchy(self, k: int, m: int) -> np.ndarray:
        """gf_gen_cauchy1-style matrix [m, k]: entry = inv((k+i) ^ j)."""
        out = np.empty((m, k), dtype=object)
        for i in range(m):
            for j in range(k):
                out[i, j] = self.inv((k + i) ^ j)
        return out

    # -- GF(2) expansion (the data-path bridge) ------------------------------

    def mul_bitmatrix(self, a: int) -> np.ndarray:
        """[w, w] GF(2) matrix of multiply-by-a: column j = bits of
        a * x^j (the jerasure_matrix_to_bitmatrix cell)."""
        w = self.w
        out = np.zeros((w, w), dtype=np.uint8)
        v = int(a)
        for j in range(w):
            for i in range(w):
                out[i, j] = (v >> i) & 1
            v = self.mul(v, 2)
        return out

    def expand_bitmatrix(self, A: np.ndarray) -> np.ndarray:
        """GF(2^w) matrix [r, c] -> GF(2) bitmatrix [w*r, w*c]."""
        r, c = A.shape
        w = self.w
        out = np.zeros((w * r, w * c), dtype=np.uint8)
        for i in range(r):
            for j in range(c):
                out[w * i:w * i + w, w * j:w * j + w] = \
                    self.mul_bitmatrix(int(A[i, j]))
        return out


@functools.lru_cache(maxsize=None)
def gfw(w: int) -> GFW:
    """The process's one :class:`GFW` for width ``w`` (16 or 32)."""
    return GFW(w)
