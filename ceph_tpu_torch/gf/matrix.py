"""Reed-Solomon generator-matrix construction and GF(2^8) linear algebra.

Host-side (numpy, exact integer math). Three matrix families, matching the
semantics of the reference's plugins:

- ``rs_vandermonde_isa``: Intel ISA-L ``gf_gen_rs_matrix`` semantics
  (reference: src/erasure-code/isa/ErasureCodeIsa.cc:384-387): parity row r
  is the geometric row (2^r)^j.  Only guaranteed MDS inside ISA-L's safe
  envelope k<=32, m<=4 (m=4 => k<=21), enforced by callers
  (reference: src/erasure-code/isa/ErasureCodeIsa.cc:323-364).
- ``cauchy1``: ISA-L ``gf_gen_cauchy1_matrix`` semantics: parity row i
  (absolute row index i >= k) entry j = inverse(i ^ j).  MDS for all k+m<=256.
- ``rs_vandermonde_jerasure``: jerasure ``reed_sol_vandermonde_coding_matrix``
  semantics (Plank & Ding 2003 "Note: Correction to the 1997 Tutorial on
  Reed-Solomon Coding"): extended-Vandermonde matrix made systematic by
  elementary column operations, then normalised so the first parity row is
  all ones.  (The jerasure/gf-complete submodules are empty in the reference
  checkout, so this construction follows the published algorithm; MDS and
  structural properties are property-tested in tests/test_gf_matrix.py.)

Decode matrices are built exactly the way the isa plugin does
(reference: src/erasure-code/isa/ErasureCodeIsa.cc:151-311): take the k
generator rows of k surviving chunks, invert, and multiply back through the
generator rows of the lost chunks.
"""
from __future__ import annotations

import numpy as np

from .tables import gf_inv, gf_mul, gf_pow, gf_mul_vec, MUL_TABLE


def rs_vandermonde_isa(k: int, m: int) -> np.ndarray:
    """Parity matrix [m, k]: row r, col j = 2^(r*j) (ISA-L gf_gen_rs_matrix)."""
    a = np.zeros((m, k), dtype=np.uint8)
    gen = 1
    for r in range(m):
        p = 1
        for j in range(k):
            a[r, j] = p
            p = gf_mul(p, gen)
        gen = gf_mul(gen, 2)
    return a


def cauchy1(k: int, m: int) -> np.ndarray:
    """Parity matrix [m, k]: row i+k, col j = inv((i+k) ^ j) (gf_gen_cauchy1)."""
    a = np.zeros((m, k), dtype=np.uint8)
    for i in range(m):
        for j in range(k):
            a[i, j] = gf_inv((i + k) ^ j)
    return a


def rs_vandermonde_jerasure(k: int, m: int) -> np.ndarray:
    """Parity matrix [m, k]: systematic EXTENDED Vandermonde exactly as
    jerasure's ``reed_sol_vandermonde_coding_matrix`` builds it (Plank &
    Ding 2003 "Note: Correction to the 1997 Tutorial on Reed-Solomon
    Coding"; jerasure manual: "its first row is all 1s").

    Construction:

    1. extended Vandermonde over rows 0..k+m-1: natural rows
       V[i, j] = i^j (with 0^0 = 1, so row 0 is e_0) for all but the LAST
       row, which is the extension row e_{k-1};
    2. systematize: elementary column ops turning the top k x k block into
       the identity right-multiply V by inv(V_top), so the parity block is
       uniquely ``V_bottom @ inv(V_top)``;
    3. column normalisation (divide every column by the first coding
       row's entry, then rescale the data rows to restore the identity):
       the first parity row becomes ALL ONES — plain XOR, which is also
       why the RAID-6 P drive under ``reed_sol_r6_op`` is an XOR
       (reference: src/erasure-code/jerasure/ErasureCodeJerasure.h:111);
    4. row normalisation of the remaining coding rows (each divided by its
       first element) so the first COLUMN of the parity block is all ones
       too — reed_sol.c's final "first column of each row" step.

    Validated against an independent longhand-field re-derivation of the
    published algorithm in tests/test_ec_external_vectors.py.
    """
    rows, cols = k + m, k
    vdm = np.zeros((rows, cols), dtype=np.uint8)
    for i in range(rows - 1):
        vdm[i, 0] = 1
        for j in range(1, cols):
            vdm[i, j] = gf_mul(int(vdm[i, j - 1]), i)
    vdm[rows - 1, cols - 1] = 1          # the extension row e_{k-1}

    top_inv = gf_invert(vdm[:k, :])
    parity = gf_matmul(vdm[k:, :], top_inv)

    for j in range(cols):
        c = int(parity[0, j])
        if c == 0:
            raise ValueError(f"degenerate vandermonde col k={k} m={m} j={j}")
        if c != 1:
            parity[:, j] = gf_mul_vec(parity[:, j], gf_inv(c))
    for r in range(1, m):
        c = int(parity[r, 0])
        if c == 0:
            raise ValueError(f"degenerate vandermonde row k={k} m={m} r={r}")
        if c != 1:
            parity[r, :] = gf_mul_vec(parity[r, :], gf_inv(c))
    return parity


def generator_matrix(parity: np.ndarray) -> np.ndarray:
    """Full systematic generator [k+m, k] = [I_k ; parity]."""
    m, k = parity.shape
    return np.concatenate([np.eye(k, dtype=np.uint8), parity], axis=0)


def gf_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """GF(2^8) matrix product (XOR-accumulated) of uint8 matrices."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    assert a.shape[1] == b.shape[0]
    prod = MUL_TABLE[a[:, :, None].astype(np.intp), b[None, :, :].astype(np.intp)]
    return np.bitwise_xor.reduce(prod, axis=1)


def gf_invert(mat: np.ndarray) -> np.ndarray:
    """Invert a square GF(2^8) matrix by Gauss-Jordan elimination."""
    mat = np.asarray(mat, dtype=np.uint8)
    n = mat.shape[0]
    assert mat.shape == (n, n)
    aug = np.concatenate([mat.copy(), np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        piv = col
        while piv < n and aug[piv, col] == 0:
            piv += 1
        if piv == n:
            raise np.linalg.LinAlgError("singular GF(2^8) matrix")
        if piv != col:
            aug[[col, piv], :] = aug[[piv, col], :]
        v = int(aug[col, col])
        if v != 1:
            aug[col, :] = gf_mul_vec(aug[col, :], gf_inv(v))
        for r in range(n):
            t = int(aug[r, col])
            if r != col and t != 0:
                aug[r, :] ^= gf_mul_vec(aug[col, :], t)
    return aug[:, n:].copy()


def decode_matrix(parity: np.ndarray, erasures: list[int],
                  available: list[int] | None = None) -> tuple[np.ndarray, list[int]]:
    """Build the decode matrix for a set of erased chunk indices.

    Returns ``(D, src)`` where ``src`` lists the k surviving chunk indices
    used as decode input and ``D`` is [len(erasures), k] with
    ``lost[e] = XOR_j D[e, j] * chunk[src[j]]``.

    Mirrors the isa plugin's decode-table construction
    (reference: src/erasure-code/isa/ErasureCodeIsa.cc:227-307): pick the
    first k surviving rows of the generator, invert, and for lost parity rows
    multiply the parity row back through the inverse.
    """
    m, k = parity.shape
    n = k + m
    erased = set(int(e) for e in erasures)
    if available is None:
        available = [i for i in range(n) if i not in erased]
    else:
        available = [int(a) for a in available if int(a) not in erased]
    if len(available) < k:
        raise ValueError(f"need {k} chunks, only {len(available)} available")
    src = sorted(available)[:k]

    gen = generator_matrix(parity)
    sub = gen[src, :]                    # [k, k]
    inv = gf_invert(sub)                 # data[j] = XOR inv[j, :] @ chunks[src]
    rows = []
    for e in sorted(erased):
        if e < k:
            rows.append(inv[e, :])
        else:
            rows.append(gf_matmul(parity[e - k:e - k + 1, :], inv)[0])
    return np.stack(rows, axis=0).astype(np.uint8), src
