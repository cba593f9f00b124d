"""Pure-numpy Reed-Solomon codec: the exact host-side reference.

Used (a) as the oracle the CUDA kernels are tested against and (b) as the
low-latency CPU path for single small stripes, where a device round-trip
is not worth it.  ``apply_matrix_fast`` runs the native runtime's SIMD
region kernel (``ec_apply_matrix``: GFNI/AVX-512, GFNI/AVX2 or AVX2
pshufb; ``ceph_tpu_torch.native``), bit for bit ``apply_matrix``.
"""
from __future__ import annotations

import numpy as np

from .. import native
from .tables import MUL_TABLE
from .matrix import decode_matrix


def apply_matrix(mat: np.ndarray, data: np.ndarray) -> np.ndarray:
    """out[i] = XOR_j mat[i, j] * data[j] over GF(2^8).

    mat: [r, k] uint8, data: [k, N] uint8 -> [r, N] uint8.
    """
    mat = np.asarray(mat, dtype=np.uint8)
    data = np.asarray(data, dtype=np.uint8)
    r, k = mat.shape
    out = np.zeros((r, data.shape[1]), dtype=np.uint8)
    for i in range(r):
        acc = None
        for j in range(k):
            c = int(mat[i, j])
            if c == 0:
                continue
            term = data[j] if c == 1 else MUL_TABLE[c][data[j].astype(np.intp)]
            acc = term.copy() if acc is None else np.bitwise_xor(acc, term)
        if acc is not None:
            out[i] = acc
    return out


def apply_matrix_fast(mat: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Production CPU path: the SIMD region kernel of the native runtime;
    where the library could not be built, :func:`apply_matrix` (counted
    in ``native.plain_calls``).  Bit-identical to ``apply_matrix``."""
    lib = native.host_lib()
    if lib is None:
        native.count_plain("apply_matrix")
        return apply_matrix(mat, data)
    mat = np.ascontiguousarray(mat, dtype=np.uint8)
    data = np.ascontiguousarray(data, dtype=np.uint8)
    if mat.ndim != 2 or data.ndim != 2 or data.shape[0] != mat.shape[1]:
        raise ValueError(f"mat {list(mat.shape)} does not apply to data "
                         f"{list(data.shape)}")
    r, k = mat.shape
    n = data.shape[1]
    if k == 0 or n == 0:
        return np.zeros((r, n), dtype=np.uint8)
    out = np.empty((r, n), dtype=np.uint8)
    lib.ec_apply_matrix(mat.ctypes.data, r, k, data.ctypes.data,
                        out.ctypes.data, n)
    return out


def encode(parity_mat: np.ndarray, data: np.ndarray) -> np.ndarray:
    """data: [k, N] -> parity [m, N]."""
    return apply_matrix(parity_mat, data)


def decode(parity_mat: np.ndarray, chunks: dict[int, np.ndarray],
           erasures: list[int]) -> dict[int, np.ndarray]:
    """Recover erased chunks from surviving ones.

    chunks: {index: [N] uint8} of surviving chunks, erasures: lost indices.
    """
    D, src = decode_matrix(parity_mat, erasures, available=list(chunks))
    stack = np.stack([chunks[i] for i in src], axis=0)
    rec = apply_matrix(D, stack)
    return {e: rec[i] for i, e in enumerate(sorted(erasures))}
