"""Product-matrix regenerating codes: exact-repair MSR/MBR plugin.

Implements the Rashmi-Shah-Kumar product-matrix construction
(arXiv:1005.4178; the batched-GF formulation of arXiv:1412.3022, "Fast
Product-Matrix Regenerating Codes"): every stored chunk is ``alpha``
symbol rows produced as an encoding-vector x message-matrix product, so
a lost chunk is rebuilt from ``d`` helpers that each ship ONE inner
product ``psi_f . stored_chunk`` (beta = chunk/alpha bytes) instead of
their whole chunk — total repair wire d*beta instead of the k-chunk
decode floor.

Two operating points (the alpha/beta/gamma tradeoff):

- **MBR** (minimum bandwidth, any ``k <= d <= n-1``): alpha = d symbol
  rows per chunk, B = kd - k(k-1)/2 message symbols.  Repair wire is
  d*beta = alpha*beta = exactly the lost chunk's stored bytes
  (~1.0 B/B), but storage expands: each stored chunk holds
  alpha = d > B/k message-symbol equivalents (the expansion is stated,
  not hidden — ``get_stored_chunk_size`` returns the real on-disk
  size).  The code is NOT systematic: every read decodes from any k
  stored chunks.
- **MSR** (minimum storage, ``d = 2k-2`` exactly): alpha = k-1,
  B = k*alpha, systematized via ``G = A . A_top^-1`` so data chunks are
  stored raw (zero storage overhead beyond the usual m parity chunks).
  Repair wire is d*beta = d/alpha = 2.0 B/B at d = 2k-2 — between the
  MBR point and the k floor.

The whole chunk row is ONE codeword (no per-stripe sub-blocking): the
backend's write planner already forces sub-chunked codes to
whole-object rewrites, and MSR with alpha = 1 is positionwise linear,
so a stored chunk reshaped ``(alpha, N)`` gives the symbol rows
directly.

The port's copy of the JAX package's ``pm_regen`` plugin.  Every GF
matrix product goes through :func:`ceph_tpu_torch.ops.codec.
gf_inner_product_device` (the ``gf_apply`` kernel on the card) or the
exact host codec, as the shared :class:`~ceph_tpu_torch.plugins.base.
DeviceRouting` policy says: cuda (the default, for a profile with no
``device`` key) | cpu (the plain PyTorch version) | numpy | auto.  A
failure on the card raises; no product is served on the host instead.
"""
from __future__ import annotations

import collections
import math
import threading
from typing import Mapping

import numpy as np
import torch

from .. import __version__
from ..gf import matrix as gfm
from ..gf import ref as gfref
from ..gf import tables as gft
from ..ops import codec as _codec
from .base import CHUNK_ALIGN, DeviceRouting, ErasureCode
from .interface import ErasureCodeProfile
from .registry import ErasureCodePlugin, ErasureCodePluginRegistry

# decode-plan LRU capacity (erasure-signature cache, the isa table-cache
# sizing ops/codec.py also uses)
PLAN_CACHE_SIZE = 256


def _select_rows(enc: np.ndarray, avail: list[int], alpha: int,
                 need: int) -> list[int]:
    """Greedy GF(2^8) row-pivot selection: scan the available chunks'
    symbol rows in order and keep the first ``need`` linearly
    independent ones.  Returns global row indices into ``enc``; raises
    IOError when the available rows do not reach full rank."""
    pivots: list[tuple[int, np.ndarray]] = []
    chosen: list[int] = []
    for c in avail:
        for r in range(alpha):
            gi = c * alpha + r
            row = enc[gi].copy()
            for pc, pr in pivots:
                f = int(row[pc])
                if f:
                    row ^= gft.gf_mul_vec(f, pr)
            nz = np.nonzero(row)[0]
            if nz.size == 0:
                continue
            pc = int(nz[0])
            row = gft.gf_mul_vec(gft.gf_inv(int(row[pc])), row)
            pivots.append((pc, row))
            chosen.append(gi)
            if len(chosen) == need:
                return chosen
    raise IOError(
        f"cannot decode: {len(avail)} chunks supply rank "
        f"{len(chosen)} < {need}")


class ErasureCodePMRegen(DeviceRouting, ErasureCode):
    """Product-matrix MSR/MBR over GF(2^8), poly 0x11D."""

    def __init__(self, directory: str = ""):
        super().__init__()
        self.directory = directory
        self.k = 0
        self.m = 0
        self.d = 0
        self.mode = "mbr"
        self.alpha = 0
        self.B = 0

    # -- init --------------------------------------------------------------

    def init(self, profile: ErasureCodeProfile) -> None:
        super().init(profile)
        if profile.get("mapping"):
            raise ValueError("pm_regen does not support mapping=")
        k = self.to_int("k", profile, "3")
        m = self.to_int("m", profile, "2")
        self.sanity_check_k_m(k, m)
        mode = self.to_string("mode", profile, "mbr")
        if mode not in ("mbr", "msr"):
            raise ValueError(f"mode={mode} must be mbr|msr")
        n = k + m
        if n > 255:
            raise ValueError(f"k+m={n} exceeds the GF(2^8) node limit 255")
        d = self.to_int("d", profile,
                        str(k if mode == "mbr" else 2 * k - 2))
        if mode == "mbr":
            if not k <= d <= n - 1:
                raise ValueError(
                    f"mbr requires k <= d <= k+m-1; got k={k} d={d} n={n}")
            self.alpha = d
            self.B = k * d - k * (k - 1) // 2
        else:
            if d != 2 * k - 2:
                raise ValueError(
                    f"msr is implemented at the d=2k-2 point only; "
                    f"got k={k} d={d} (want d={2 * k - 2})")
            if d > n - 1:
                raise ValueError(
                    f"msr d=2k-2={d} needs k+m-1 >= d; got n={n}")
            self.alpha = k - 1
            self.B = k * self.alpha
        w = self.to_int("w", profile, "8")
        if w != 8:
            raise ValueError(f"w={w} must be 8")
        self.k, self.m, self.d, self.mode = k, m, d, mode
        self.parse_device_routing(profile)
        profile["plugin"] = profile.get("plugin", "pm_regen")
        self._profile = profile
        self._build_matrices()
        self._plan_cache: collections.OrderedDict = collections.OrderedDict()
        self._plan_lock = threading.Lock()

    def _build_matrices(self) -> None:
        """Encoding vectors + the flattened symbol-space generator.

        ``_psi`` (n x d) are the encoding vectors; ``_enc`` (n*alpha x B)
        maps the B free message symbols to every node's symbol rows —
        the symmetric message-matrix structure folded into one plain
        linear map so decode is a rank-B solve."""
        k, d, n, alpha, B = self.k, self.d, self.k + self.m, self.alpha, self.B
        if self.mode == "mbr":
            xs = list(range(1, n + 1))
        else:
            # lambda_i = x_i^alpha must be distinct (x -> x^alpha is not
            # injective when gcd(alpha, 255) > 1, e.g. alpha=3)
            xs, seen = [], set()
            for cand in range(1, 256):
                lam = gft.gf_pow(cand, alpha)
                if lam in seen:
                    continue
                xs.append(cand)
                seen.add(lam)
                if len(xs) == n:
                    break
            if len(xs) < n:
                raise ValueError(
                    f"cannot pick {n} encoding vectors with distinct "
                    f"lambda for alpha={alpha}")
        self._x = xs
        psi = np.zeros((n, d), dtype=np.uint8)
        enc = np.zeros((n * alpha, B), dtype=np.uint8)
        if self.mode == "mbr":
            # message matrix M (d x d) = [[S, T], [T^T, 0]]: S symmetric
            # k x k, T arbitrary k x (d-k).  slot() maps entry (r, j) of
            # M to its free-symbol index (None inside the zero block).
            idx: dict[tuple[int, int], int] = {}
            s = 0
            for i in range(k):
                for j in range(i, k):
                    idx[(i, j)] = s
                    s += 1
            for i in range(k):
                for j in range(k, d):
                    idx[(i, j)] = s
                    s += 1
            assert s == B

            def slot(r: int, j: int) -> int | None:
                if r < k and j < k:
                    return idx[(min(r, j), max(r, j))]
                if r < k:
                    return idx[(r, j)]
                if j < k:
                    return idx[(j, r)]
                return None

            for i, x in enumerate(xs):
                for t in range(d):
                    psi[i][t] = gft.gf_pow(x, t)
            for i in range(n):
                for r in range(alpha):          # chunk_i row r = M[r] . psi_i
                    for t in range(d):
                        sl = slot(r, t)
                        if sl is not None:
                            enc[i * alpha + r][sl] ^= int(psi[i][t])
            self._enc = enc
        else:
            # message matrix M (2alpha x alpha) = [S1; S2], both
            # symmetric alpha x alpha; psi_i = (phi_i, lambda_i * phi_i)
            half = alpha * (alpha + 1) // 2
            pair: dict[tuple[int, int], int] = {}
            s = 0
            for i in range(alpha):
                for j in range(i, alpha):
                    pair[(i, j)] = s
                    s += 1
            assert 2 * half == B

            self._lam = [gft.gf_pow(x, alpha) for x in xs]
            for i, x in enumerate(xs):
                for t in range(alpha):
                    phi = gft.gf_pow(x, t)
                    psi[i][t] = phi
                    psi[i][alpha + t] = gft.gf_mul(self._lam[i], phi)
            for i in range(n):
                for r in range(alpha):   # chunk_i row r = phi S1[:,r] + lam phi S2[:,r]
                    for t in range(alpha):
                        sl = pair[(min(r, t), max(r, t))]
                        enc[i * alpha + r][sl] ^= int(psi[i][t])
                        enc[i * alpha + r][half + sl] ^= int(psi[i][alpha + t])
            # systematize: G = A . A_top^-1 so the first k chunks store
            # the raw data rows (A_top is invertible by the MDS property)
            try:
                top_inv = gfm.gf_invert(enc[:k * alpha])
            except np.linalg.LinAlgError as e:
                raise ValueError(
                    "msr systematization failed (A_top singular)") from e
            self._enc = gfm.gf_matmul(enc, top_inv)
        self._psi = psi

    # -- counts / sizes ----------------------------------------------------

    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_coding_chunk_count(self) -> int:
        return self.m

    def get_sub_chunk_count(self) -> int:
        return self.alpha

    def get_alignment(self) -> int:
        if self.mode == "mbr":
            # k * chunk_size must divide into B message symbols
            quantum = self.B // math.gcd(self.B, self.k)
        else:
            quantum = self.alpha      # chunk reshapes to (alpha, N)
        return math.lcm(CHUNK_ALIGN, quantum)

    def get_stored_chunk_size(self, chunk_size: int) -> int:
        """On-disk bytes per chunk for a logical share of ``chunk_size``
        bytes.  MBR expands by alpha*k/B (> 1: the bandwidth-vs-storage
        trade, stated honestly); MSR stores exactly the share."""
        if self.mode == "msr":
            return chunk_size
        if (self.k * chunk_size) % self.B:
            raise ValueError(
                f"chunk_size={chunk_size} is not aligned: k*chunk_size "
                f"must be a multiple of B={self.B}")
        return self.alpha * (self.k * chunk_size // self.B)

    @property
    def requires_full_chunk_io(self) -> bool:
        """MBR chunks are non-systematic linear blends of the whole
        object — every read/degraded-RMW must fetch whole chunks."""
        return self.mode == "mbr"

    # -- minimum_to_decode -------------------------------------------------

    def minimum_to_decode(self, want_to_read: set, available: set
                          ) -> dict[int, list[tuple[int, int]]]:
        if self.mode == "msr":
            return super().minimum_to_decode(want_to_read, available)
        # MBR stores no raw shares: a data-chunk want is NOT satisfied by
        # the chunk of the same id, so never take the direct-read
        # shortcut — any k stored chunks decode everything.
        avail = set(available)
        if len(avail) < self.k:
            raise IOError(
                f"cannot decode: {len(avail)} chunks available, "
                f"need {self.k}")
        sub = [(0, self.alpha)]
        return {i: list(sub) for i in sorted(avail)[:self.k]}

    def minimum_to_decode_with_cost(self, want_to_read: set,
                                    available: Mapping[int, int]) -> set:
        if self.mode == "msr":
            return super().minimum_to_decode_with_cost(want_to_read,
                                                       available)
        if len(available) < self.k:
            raise IOError(
                f"cannot decode: {len(available)} chunks available, "
                f"need {self.k}")
        ranked = sorted(available, key=lambda c: (available[c], c))
        return set(ranked[:self.k])

    # -- encode ------------------------------------------------------------

    def encode_chunks(self, want_to_encode: set, encoded: dict) -> None:
        k, n, alpha = self.k, self.k + self.m, self.alpha
        rows = [np.asarray(encoded[i], dtype=np.uint8) for i in range(k)]
        Lc = len(rows[0])
        if self.mode == "mbr":
            W = np.concatenate(rows)
            if W.size % self.B:
                raise ValueError(
                    f"k*chunk_size={W.size} not a multiple of B={self.B}")
            msg = W.reshape(self.B, W.size // self.B)
            sym = self._matmul(self._enc, msg)            # (n*alpha, N)
            for i in range(n):
                encoded[i] = np.ascontiguousarray(
                    sym[i * alpha:(i + 1) * alpha].reshape(-1))
        else:
            if Lc % alpha:
                raise ValueError(
                    f"chunk_size={Lc} not a multiple of alpha={alpha}")
            D = np.concatenate(rows).reshape(k * alpha, Lc // alpha)
            P = self._matmul(self._enc[k * alpha:], D)    # (m*alpha, N)
            for j in range(self.m):
                encoded[k + j] = np.ascontiguousarray(
                    P[j * alpha:(j + 1) * alpha].reshape(-1))

    # -- decode ------------------------------------------------------------

    def _decode_plan(self, avail: tuple[int, ...]
                     ) -> tuple[list[int], np.ndarray]:
        """(selected row indices, inverse of the selected B x B system)
        for an availability signature, LRU-cached per signature."""
        with self._plan_lock:
            hit = self._plan_cache.get(avail)
            if hit is not None:
                self._plan_cache.move_to_end(avail)
                return hit
        chosen = _select_rows(self._enc, list(avail), self.alpha, self.B)
        inv = gfm.gf_invert(self._enc[chosen])
        with self._plan_lock:
            self._plan_cache[avail] = (chosen, inv)
            if len(self._plan_cache) > PLAN_CACHE_SIZE:
                self._plan_cache.popitem(last=False)
        return chosen, inv

    def _solve_message(self, chunks: Mapping[int, np.ndarray]) -> np.ndarray:
        """Recover the (B, N) message-symbol matrix from any rank-B set
        of available stored chunks."""
        alpha = self.alpha
        avail = tuple(sorted(chunks))
        chosen, inv = self._decode_plan(avail)
        sym = {c: np.asarray(chunks[c], dtype=np.uint8).reshape(alpha, -1)
               for c in avail}
        y = np.stack([sym[gi // alpha][gi % alpha] for gi in chosen])
        return self._matmul(inv, y)

    def decode_chunks(self, want_to_read: set, chunks: Mapping,
                      decoded: dict) -> None:
        alpha = self.alpha
        missing = set(want_to_read) - set(chunks)
        if not missing:
            return
        msg = self._solve_message(chunks)
        for i in missing:
            out = self._matmul(self._enc[i * alpha:(i + 1) * alpha], msg)
            decoded[i][:] = out.reshape(-1)

    def decode_concat(self, chunks: Mapping[int, np.ndarray]) -> bytes:
        if self.mode == "msr":
            return super().decode_concat(chunks)
        # MBR: the data bytes ARE the message symbols (W reshaped), not
        # any stored chunk — always a full rank-B solve.
        return self._solve_message(chunks).tobytes()

    # -- regenerating repair ----------------------------------------------

    def supports_regenerating_repair(self) -> bool:
        return True

    def minimum_to_repair(self, shard: int, d: int,
                          costs: Mapping[int, int]) -> list[int]:
        """The d cheapest helpers for regenerating ``shard``, in rank
        order (the order the combine matrix expects)."""
        avail = {c: costs[c] for c in costs if c != shard}
        if len(avail) < d:
            raise IOError(
                f"cannot regenerate chunk {shard}: {len(avail)} helpers "
                f"available, need {d}")
        ranked = sorted(avail, key=lambda c: (avail[c], c))
        return ranked[:d]

    def repair_projection(self, lost: int) -> np.ndarray:
        """(1, alpha) projection row a helper applies to its stored
        chunk's symbol rows: psi_lost (MBR) / phi_lost (MSR)."""
        if self.mode == "mbr":
            return self._psi[lost].reshape(1, self.alpha).copy()
        return self._psi[lost][:self.alpha].reshape(1, self.alpha).copy()

    def repair_combine(self, lost: int, helpers: list[int]) -> np.ndarray:
        """(alpha, d) matrix the newcomer applies to the d stacked
        helper beta-streams (in ``helpers`` order) to regenerate the
        lost chunk's symbol rows bitwise-exactly."""
        if len(set(helpers)) != self.d or lost in helpers:
            raise ValueError(f"need {self.d} distinct helpers != {lost}")
        psi_rep = np.stack([self._psi[h] for h in helpers])
        try:
            inv = gfm.gf_invert(psi_rep)
        except np.linalg.LinAlgError as e:     # cannot happen: distinct x
            raise IOError("repair matrix singular") from e
        if self.mode == "mbr":
            return inv
        alpha = self.alpha
        left = np.zeros((alpha, 2 * alpha), dtype=np.uint8)
        for j in range(alpha):
            left[j][j] = 1
            left[j][alpha + j] = self._lam[lost]
        return gfm.gf_matmul(left, inv)

    # -- GF matmul routing -------------------------------------------------

    def _matmul(self, mat: np.ndarray, data: np.ndarray) -> np.ndarray:
        mat = np.ascontiguousarray(mat, dtype=np.uint8)
        data = np.ascontiguousarray(data, dtype=np.uint8)
        if not self.use_device(data.nbytes):
            return gfref.apply_matrix_fast(mat, data)
        dev = self.tensor_device()
        out = _codec.gf_inner_product_device(torch.from_numpy(mat).to(dev),
                                             torch.from_numpy(data).to(dev))
        return out.cpu().numpy()


class ErasureCodePluginPMRegen(ErasureCodePlugin):
    def factory(self, directory: str, profile: ErasureCodeProfile):
        interface = ErasureCodePMRegen(directory)
        interface.init(profile)
        return interface


def __erasure_code_version__() -> str:
    return __version__


def __erasure_code_init__(name: str, directory: str) -> None:
    ErasureCodePluginRegistry.instance().add(name,
                                             ErasureCodePluginPMRegen())
