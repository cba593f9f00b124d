"""GF(2) bitmatrix codes: liberation, blaum_roth, liber8tion.

The port's copy of the JAX package's ``gf/bitmatrix.py`` (numpy only).
The reference's jerasure plugin exposes three bitmatrix-only RAID-6
techniques (reference: src/erasure-code/jerasure/ErasureCodeJerasure.h:191-252)
whose CPU implementations compile the bitmatrix into a word-XOR schedule
(`jerasure_smart_bitmatrix_to_schedule`,
reference: src/erasure-code/jerasure/ErasureCodeJerasure.cc:453-509).  Here
the apply is one call of :func:`ceph_tpu_torch.ops.rs_kernels.xor_apply`
(a hand CUDA kernel on the card) or :func:`xor_apply_host` (numpy): both
XOR the packets the bitmatrix selects, so no schedule is needed.

Data layout (jerasure packet semantics): a chunk of B bytes is processed in
groups of w*packetsize bytes; within a group, packet p is bytes
[p*ps, (p+1)*ps).  Bitmatrix row/column index i corresponds to packet i of
each group.  Encode: parity_packets = W_coding @ data_packets over GF(2),
XOR acting bytewise.

Matrix constructions (the jerasure/gf-complete submodules are empty in the
reference checkout, so these follow the published algorithms; validity as
RAID-6 codes — every single and double erasure decodable — is property-
tested in tests/test_bitmatrix.py, and tests/test_torch_bitmatrix.py holds
this copy equal to the JAX package's):

- liberation (Plank, "The RAID-6 Liberation Codes", FAST 2008): w prime,
  k <= w.  P block: identities.  Q block column j: the cyclic shift by j,
  plus for j > 0 one extra bit at row (j*(w-1)/2) mod w, column offset
  (row + j - 1) mod w — the published minimal-density construction.
- blaum_roth (Blaum & Roth array codes): w+1 prime.  Q block column j is
  multiplication by x^j in the ring GF(2)[x]/(1 + x + ... + x^w)
  (powers of the companion matrix).
- liber8tion: w = 8, m = 2, k <= 8.  Plank's published liber8tion matrices
  were found by search to minimise XOR count; this implementation uses the
  geometric RAID-6 bitmatrix over GF(2^8) (X_j = mul-by-2^j), which has the
  identical parameter envelope and fault tolerance.  NOT bit-identical to
  CPU jerasure's liber8tion output (nothing can be: the submodule
  implementing it is absent from the reference checkout).
"""
from __future__ import annotations

import numpy as np

from .tables import gf_pow, mul_bitmatrix


def is_prime(n: int) -> bool:
    if n < 2:
        return False
    p = 2
    while p * p <= n:
        if n % p == 0:
            return False
        p += 1
    return True


def liberation_bitmatrix(k: int, w: int) -> np.ndarray:
    """Coding bitmatrix [2w, kw] of the liberation code (w prime, k <= w)."""
    if w <= 2 or not is_prime(w):
        raise ValueError(f"w={w} must be greater than two and be prime")
    if k > w:
        raise ValueError(f"k={k} must be less than or equal to w={w}")
    M = np.zeros((2 * w, k * w), dtype=np.uint8)
    for j in range(k):
        for i in range(w):
            M[i, j * w + i] = 1                        # P: identity
            M[w + i, j * w + (j + i) % w] = 1          # Q: cyclic shift by j
        if j > 0:
            i = (j * ((w - 1) // 2)) % w
            M[w + i, j * w + (i + j - 1) % w] = 1      # the extra liberty bit
    return M


def blaum_roth_bitmatrix(k: int, w: int) -> np.ndarray:
    """Coding bitmatrix [2w, kw] of the Blaum-Roth code (w+1 prime, k <= w).

    w == 7 is tolerated without the primality check for backward
    compatibility, exactly like the reference
    (ErasureCodeJerasure.cc:461-471: "back in Firefly, w = 7 was the
    default and produced usable chunks").  WARNING: w=7 is NOT MDS —
    1+x+...+x^7 = (1+x)^7 over GF(2), so x^i + x^j is a zero divisor and
    every (data, data) double erasure is undecodable; single erasures and
    data+parity pairs still decode ("usable", not safe).  The plugin never
    defaults to it.
    """
    if w != 7 and (w <= 2 or not is_prime(w + 1)):
        raise ValueError(f"w={w} must be greater than two and w+1 prime")
    if k > w:
        raise ValueError(f"k={k} must be less than or equal to w={w}")
    # companion matrix of multiply-by-x in GF(2)[x]/(1 + x + ... + x^w):
    # x * x^j = x^(j+1) for j < w-1; x * x^(w-1) = x^w = 1 + x + ... + x^(w-1)
    C = np.zeros((w, w), dtype=np.uint8)
    for j in range(w - 1):
        C[j + 1, j] = 1
    C[:, w - 1] = 1
    M = np.zeros((2 * w, k * w), dtype=np.uint8)
    X = np.eye(w, dtype=np.uint8)
    for j in range(k):
        M[:w, j * w:(j + 1) * w] = np.eye(w, dtype=np.uint8)
        M[w:, j * w:(j + 1) * w] = X
        X = (C @ X) % 2
    return M


def liber8tion_bitmatrix(k: int) -> np.ndarray:
    """Coding bitmatrix [16, 8k] of the w=8 RAID-6 code (k <= 8).

    Geometric construction X_j = mul_bitmatrix(2^j): X_i + X_j =
    M(2^i XOR 2^j) is invertible for i != j because 2^i != 2^j in GF(2^8),
    so every double erasure decodes (see module docstring re Plank's
    hand-searched minimal-density table).
    """
    if k > 8:
        raise ValueError(f"k={k} must be less than or equal to 8")
    M = np.zeros((16, 8 * k), dtype=np.uint8)
    for j in range(k):
        M[:8, 8 * j:8 * j + 8] = np.eye(8, dtype=np.uint8)
        M[8:, 8 * j:8 * j + 8] = mul_bitmatrix(gf_pow(2, j))
    return M


def gf2_invert(M: np.ndarray) -> np.ndarray:
    """Invert a square 0/1 matrix over GF(2) by Gauss-Jordan."""
    M = np.asarray(M, dtype=np.uint8) & 1
    n, n2 = M.shape
    if n != n2:
        raise ValueError(f"matrix {M.shape} is not square")
    aug = np.concatenate([M.copy(), np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        pivot = col + int(np.argmax(aug[col:, col]))
        if aug[pivot, col] == 0:
            raise np.linalg.LinAlgError(f"singular over GF(2) at column {col}")
        if pivot != col:
            aug[[col, pivot]] = aug[[pivot, col]]
        rows = np.flatnonzero(aug[:, col])
        rows = rows[rows != col]
        aug[rows] ^= aug[col]
    return aug[:, n:]


def decode_bitmatrix(coding: np.ndarray, k: int, w: int,
                     erasures: list[int],
                     available: list[int] | None = None
                     ) -> tuple[np.ndarray, list[int]]:
    """Decode matrix for a bitmatrix code.

    coding: [m*w, k*w] coding part; returns (D, src) where src lists the k
    survivor chunk ids used (first k available, like the interface default
    _minimum_to_decode) and D [len(erasures)*w, k*w] maps their packets to
    the erased chunks' packets: erased = D @ survivors over GF(2).
    """
    m = coding.shape[0] // w
    n = k + m
    R = np.zeros((n * w, k * w), dtype=np.uint8)
    for i in range(k):
        R[i * w:(i + 1) * w, i * w:(i + 1) * w] = np.eye(w, dtype=np.uint8)
    R[k * w:] = coding
    erasures = sorted(int(e) for e in erasures)
    pool = (sorted(set(range(n)) - set(erasures)) if available is None
            else sorted(set(available) - set(erasures)))
    if len(pool) < k:
        raise ValueError(
            f"{len(pool)} survivors cannot decode a k={k} bitmatrix code")
    src = pool[:k]
    S = np.concatenate([R[c * w:(c + 1) * w] for c in src])
    Sinv = gf2_invert(S)
    D = np.concatenate(
        [(R[e * w:(e + 1) * w].astype(np.int64) @ Sinv.astype(np.int64)) % 2
         for e in erasures]).astype(np.uint8)
    return D, src


# -- packet layout + host apply --------------------------------------------

def to_packets(chunks: np.ndarray, w: int, ps: int) -> np.ndarray:
    """[c, B] chunk bytes -> [c*w, B/w] packet rows.

    jerasure group layout: a chunk is processed in groups of w*ps bytes;
    within a group, packet p is bytes [p*ps, (p+1)*ps).  Bitmatrix row i of
    chunk c gathers packet i of every group:
    row[c*w + i] = concat over groups g of chunk[g*w*ps + i*ps : ... + ps].
    """
    c, B = chunks.shape
    if B % (w * ps):
        raise ValueError(
            f"chunk size {B} not a multiple of w*packetsize={w * ps}")
    return np.ascontiguousarray(
        chunks.reshape(c, -1, w, ps).swapaxes(1, 2).reshape(c * w, -1))


def from_packets(packets: np.ndarray, w: int, ps: int) -> np.ndarray:
    """[c*w, P] packet rows -> [c, P*w] chunk bytes (inverse of to_packets)."""
    cw, P = packets.shape
    c = cw // w
    return np.ascontiguousarray(
        packets.reshape(c, w, -1, ps).swapaxes(1, 2).reshape(c, -1))


def xor_apply_host(W: np.ndarray, packets: np.ndarray) -> np.ndarray:
    """out[r] = XOR of packets[i] where W[r, i] == 1 (numpy host path)."""
    W = np.asarray(W, dtype=bool)
    out = np.zeros((W.shape[0], packets.shape[1]), dtype=np.uint8)
    for r in range(W.shape[0]):
        sel = packets[W[r]]
        if len(sel):
            out[r] = np.bitwise_xor.reduce(sel, axis=0)
    return out
