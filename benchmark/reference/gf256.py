"""Plain Reed-Solomon over GF(2^8): the benchmark's reference.

Everything the comparison that decides ``correct`` needs, built here from
first principles and from nothing of the program under test:

- the field's product table, by carry-less multiplication reduced by the
  field polynomial (0x11D, the polynomial of jerasure's w=8 and ISA-L);
- jerasure's ``reed_sol_vandermonde_coding_matrix`` (Plank & Ding 2003):
  the extended Vandermonde matrix made systematic, then normalised so
  that the first parity row and the first parity column are all ones;
- decoding as linear algebra: the data is the inverse of the survivors'
  generator rows times the survivors, and a lost chunk is its generator
  row times the data;
- the bulk product ``out[r] = XOR_j mat[r, j] * data[j]`` as table
  gathers in plain PyTorch, on whatever device the data is on, in column
  blocks so that its temporaries stay small.

The matrix algebra is NumPy on the host (matrices are at most 256 x 256).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

POLY = 0x11D
#: columns a bulk product gathers at once (bounds its int64 index temporary)
BLOCK = 1 << 22


@functools.lru_cache(maxsize=4)
def mul_table(poly: int = POLY) -> np.ndarray:
    """[256, 256] uint8: a * b in GF(2)[x] / poly, by shift and add."""
    a = np.arange(256, dtype=np.int64)[:, None]
    b = np.arange(256, dtype=np.int64)[None, :]
    out = np.zeros((256, 256), dtype=np.int64)
    for _ in range(8):
        out ^= np.where(b & 1, a, 0)
        b = b >> 1
        a = a << 1
        a = np.where(a & 0x100, a ^ poly, a)
    return out.astype(np.uint8)


def inverse(a: int, poly: int = POLY) -> int:
    """The multiplicative inverse of a nonzero field element."""
    hits = np.flatnonzero(mul_table(poly)[a] == 1)
    if a == 0 or len(hits) != 1:
        raise ZeroDivisionError(f"{a} has no inverse mod {poly:#x}")
    return int(hits[0])


def matmul(a: np.ndarray, b: np.ndarray, poly: int = POLY) -> np.ndarray:
    """GF(2^8) product of two small uint8 matrices."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    prod = mul_table(poly)[a[:, :, None], b[None, :, :]]
    return np.bitwise_xor.reduce(prod, axis=1).astype(np.uint8)


def invert(mat: np.ndarray, poly: int = POLY) -> np.ndarray:
    """Gauss-Jordan inverse of a square GF(2^8) matrix."""
    mat = np.asarray(mat, dtype=np.uint8)
    n = mat.shape[0]
    table = mul_table(poly)
    aug = np.concatenate([mat, np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        rows = np.flatnonzero(aug[col:, col]) + col
        if not len(rows):
            raise np.linalg.LinAlgError("singular GF(2^8) matrix")
        aug[[col, rows[0]]] = aug[[rows[0], col]]
        aug[col] = table[inverse(int(aug[col, col]), poly)][aug[col]]
        for r in range(n):
            if r != col and aug[r, col]:
                aug[r] ^= table[int(aug[r, col])][aug[col]]
    return aug[:, n:].copy()


def reed_sol_van(k: int, m: int, poly: int = POLY) -> np.ndarray:
    """jerasure's reed_sol_van parity matrix [m, k] for w = 8."""
    table = mul_table(poly)
    rows = k + m
    vdm = np.zeros((rows, k), dtype=np.uint8)
    for i in range(rows - 1):          # row i = (1, i, i^2, ...), 0^0 = 1
        vdm[i, 0] = 1
        for j in range(1, k):
            vdm[i, j] = table[vdm[i, j - 1], i]
    vdm[rows - 1, k - 1] = 1           # the extension row e_{k-1}
    parity = matmul(vdm[k:], invert(vdm[:k], poly), poly)
    for j in range(k):                 # first parity row to all ones
        parity[:, j] = table[inverse(int(parity[0, j]), poly)][parity[:, j]]
    for r in range(1, m):              # first parity column to all ones
        parity[r] = table[inverse(int(parity[r, 0]), poly)][parity[r]]
    return parity


def generator(parity: np.ndarray) -> np.ndarray:
    """[k + m, k]: the identity over the parity rows."""
    m, k = parity.shape
    return np.concatenate([np.eye(k, dtype=np.uint8), parity])


def recovery_matrix(parity: np.ndarray, survivors: list[int],
                    lost: list[int], poly: int = POLY) -> np.ndarray:
    """[len(lost), k]: lost chunk e = XOR_j R[e, j] * survivor j, for k
    survivors given by chunk id in the order their rows are stacked."""
    gen = generator(parity)
    data_from_survivors = invert(gen[list(survivors)], poly)
    return matmul(gen[list(lost)], data_from_survivors, poly)


def apply(mat: np.ndarray, data, poly: int = POLY) -> torch.Tensor:
    """out[r, N] = XOR_j mat[r, j] * data[j, N] over GF(2^8), on the
    device of ``data`` ([k, N] uint8 tensor or NumPy array)."""
    if isinstance(data, np.ndarray):
        data = torch.from_numpy(np.ascontiguousarray(data, dtype=np.uint8))
    mat = np.asarray(mat, dtype=np.uint8)
    r, k = mat.shape
    if data.dim() != 2 or data.shape[0] != k or data.dtype != torch.uint8:
        raise ValueError(f"data {tuple(data.shape)} {data.dtype} for a "
                         f"[{r}, {k}] matrix")
    table = torch.from_numpy(mul_table(poly)).to(data.device)
    n = int(data.shape[1])
    out = torch.zeros((r, n), dtype=torch.uint8, device=data.device)
    for c0 in range(0, n, BLOCK):
        c1 = min(n, c0 + BLOCK)
        idx = data[:, c0:c1].long()
        for i in range(r):
            for j in range(k):
                c = int(mat[i, j])
                if c:
                    out[i, c0:c1] ^= table[c][idx[j]]
    return out
