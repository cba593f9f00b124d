"""shec: Shingled Erasure Code plugin on the card.

The port's counterpart of the JAX package's ``shec`` plugin, a behavioural
mirror of the reference shec plugin
(reference: src/erasure-code/shec/ErasureCodeShec.{h,cc}): a Reed-Solomon
Vandermonde coding matrix with shingle-shaped zero windows so each parity
covers only a sliding window of data chunks, trading durability (c < m
arbitrary-failure tolerance) for cheaper local repair.

Parameters (ErasureCodeShec.h:36-60, parse at ErasureCodeShec.cc:276-344):
  k, m, c     data/parity counts and durability estimate; defaults (4, 3, 2);
              constraints: all > 0, c <= m <= k, k <= 12, k + m <= 20
  technique   multiple (default; the (m1,c1)/(m2,c2) split minimising
              recovery effort) | single (one shingle group)
  w           GF width; only 8 is supported here (GF(2^8), the field of
              the ``gf_apply`` kernel; the reference also allows 16/32)
  device      cuda (the ``gf_apply`` kernel; the default) | cpu (its plain
              PyTorch version) | numpy (``gf.ref.apply_matrix``) | auto,
              routed by :class:`DeviceRouting`; ``device-threshold`` (alias
              ``jax-threshold``) is the auto cutoff.  The JAX package's
              default is auto.

The decode-plan search (``_make_decoding``) mirrors
``shec_make_decoding_matrix`` (ErasureCodeShec.cc:531-755): enumerate parity
subsets from small to large, build the square window system over the touched
data chunks, accept the first invertible minimal one; plans are cached per
(want, avails) signature like ErasureCodeShecTableCache.
"""
from __future__ import annotations

import collections
import threading
from typing import Mapping

import numpy as np
import torch

from .. import __version__
from ..gf import matrix as gfm
from ..gf import ref as gfref
from ..ops import rs_kernels
from .base import DeviceRouting, ErasureCode
from .interface import ErasureCodeProfile
from .registry import ErasureCodePlugin, ErasureCodePluginRegistry

MULTIPLE = 0
SINGLE = 1

PLAN_CACHE_SIZE = 2516  # same budget as the isa/shec table caches


def _recovery_efficiency(k: int, m1: int, m2: int, c1: int, c2: int) -> float:
    """shec_calc_recovery_efficiency1 (ErasureCodeShec.cc:420-459): average
    chunks read to repair one failure under the (m1,c1)/(m2,c2) split."""
    if m1 < c1 or m2 < c2:
        return -1.0
    if (m1 == 0 and c1 != 0) or (m2 == 0 and c2 != 0):
        return -1.0
    r_eff_k = [10 ** 8] * k
    r_e1 = 0.0
    for m_g, c_g in ((m1, c1), (m2, c2)):
        for rr in range(m_g):
            start = ((rr * k) // m_g) % k
            end = (((rr + c_g) * k) // m_g) % k
            cc = start
            first = True
            while first or cc != end:
                first = False
                r_eff_k[cc] = min(r_eff_k[cc],
                                  ((rr + c_g) * k) // m_g - (rr * k) // m_g)
                cc = (cc + 1) % k
            r_e1 += ((rr + c_g) * k) // m_g - (rr * k) // m_g
    r_e1 += sum(r_eff_k)
    return r_e1 / (k + m1 + m2)


def shec_coding_matrix(k: int, m: int, c: int,
                       technique: int = MULTIPLE) -> np.ndarray:
    """The shingled coding matrix [m, k]
    (shec_reedsolomon_coding_matrix, ErasureCodeShec.cc:461-528): an RS
    Vandermonde matrix with each parity row's coverage restricted to a
    shingle window by zeroing the complement."""
    if technique != SINGLE:
        m1_best, c1_best = -1, -1
        min_r_e1 = 100.0
        for c1 in range(c // 2 + 1):
            for m1 in range(m + 1):
                c2, m2 = c - c1, m - m1
                if m1 < c1 or m2 < c2:
                    continue
                if (m1 == 0 and c1 != 0) or (m2 == 0 and c2 != 0):
                    continue
                if (m1 != 0 and c1 == 0) or (m2 != 0 and c2 == 0):
                    continue
                r_e1 = _recovery_efficiency(k, m1, m2, c1, c2)
                if min_r_e1 - r_e1 > np.finfo(float).eps and r_e1 < min_r_e1:
                    min_r_e1, c1_best, m1_best = r_e1, c1, m1
        m1, c1 = m1_best, c1_best
        m2, c2 = m - m1, c - c1
    else:
        m1, c1, m2, c2 = 0, 0, m, c

    mat = gfm.rs_vandermonde_jerasure(k, m).copy()
    for row_base, m_g, c_g in ((0, m1, c1), (m1, m2, c2)):
        for rr in range(m_g):
            end = ((rr * k) // m_g) % k
            start = (((rr + c_g) * k) // m_g) % k
            cc = start
            while cc != end:
                mat[row_base + rr, cc] = 0
                cc = (cc + 1) % k
    return mat


class ErasureCodeShec(DeviceRouting, ErasureCode):
    DEFAULT_K, DEFAULT_M, DEFAULT_C = 4, 3, 2

    def __init__(self, technique: int = MULTIPLE):
        super().__init__()
        self.technique = technique
        self.k = 0
        self.m = 0
        self.c = 0
        self.w = 8
        self.matrix: np.ndarray | None = None
        self.device = "cuda"
        self._matrix_dev: dict[torch.device, torch.Tensor] = {}
        self._plan_cache: collections.OrderedDict = collections.OrderedDict()
        self._cache_lock = threading.Lock()

    # -- init (parse, ErasureCodeShec.cc:276-384) ---------------------------

    def init(self, profile: ErasureCodeProfile) -> None:
        super().init(profile)
        has = [name for name in ("k", "m", "c") if profile.get(name)]
        if not has:
            self.k, self.m, self.c = self.DEFAULT_K, self.DEFAULT_M, self.DEFAULT_C
            profile.update(k=str(self.k), m=str(self.m), c=str(self.c))
        elif len(has) != 3:
            raise ValueError("(k, m, c) must all be chosen or all defaulted")
        else:
            self.k = self.to_int("k", profile, str(self.DEFAULT_K))
            self.m = self.to_int("m", profile, str(self.DEFAULT_M))
            self.c = self.to_int("c", profile, str(self.DEFAULT_C))
        k, m, c = self.k, self.m, self.c
        if k <= 0 or m <= 0 or c <= 0:
            raise ValueError(f"k={k} m={m} c={c} must be positive")
        if m < c:
            raise ValueError(f"c={c} must be <= m={m}")
        if k > 12:
            raise ValueError(f"k={k} must be <= 12")
        if k + m > 20:
            raise ValueError(f"k+m={k + m} must be <= 20")
        if k < m:
            raise ValueError(f"m={m} must be <= k={k}")
        self.w = self.to_int("w", profile, "8")
        if self.w != 8:
            raise ValueError(f"w={self.w} must be 8 (GF(2^8))")
        self.parse_device_routing(profile)
        self.matrix = shec_coding_matrix(k, m, c, self.technique)
        profile["plugin"] = profile.get("plugin", "shec")
        self._profile = profile

    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    # -- decode-plan search (shec_make_decoding_matrix) ---------------------

    def _make_decoding(self, want: tuple[int, ...], avails: tuple[int, ...]):
        """Find the minimal repair plan for the (want, avails) 0/1 vectors.

        Returns (minimum_chunks, plan); plan is None when no matrix solve is
        needed, else (in_ids, out_cols, Dinv): recovered data chunk
        ``out_cols[i]`` = XOR_j Dinv[i, j] * chunk[in_ids[j]].  Raises
        IOError when no invertible repair window exists.
        """
        k, m = self.k, self.m
        mat = self.matrix
        want = list(want)
        # a wanted missing parity needs every data chunk its row touches
        # (ErasureCodeShec.cc:540-548)
        for i in range(m):
            if want[k + i] and not avails[k + i]:
                for j in range(k):
                    if mat[i, j]:
                        want[j] = 1

        sig = (tuple(want), tuple(avails))
        with self._cache_lock:
            hit = self._plan_cache.get(sig)
            if hit is not None:
                self._plan_cache.move_to_end(sig)
                return hit

        mindup, minp = k + 1, k + 1
        best = None
        for pp in range(1 << m):
            p = [i for i in range(m) if pp & (1 << i)]
            if len(p) > minp:
                continue
            if any(not avails[k + pi] for pi in p):
                continue
            tmprow = [0] * (k + m)
            tmpcol = [0] * k
            for i in range(k):
                if want[i] and not avails[i]:
                    tmpcol[i] = 1
            for pi in p:
                tmprow[k + pi] = 1
                for j in range(k):
                    if mat[pi, j]:
                        tmpcol[j] = 1
                        if avails[j]:
                            tmprow[j] = 1
            dup_row = sum(tmprow)
            dup_col = sum(tmpcol)
            if dup_row != dup_col:
                continue
            dup = dup_row
            if dup == 0:
                mindup = 0
                best = ([], [], None)
                break
            if dup < mindup:
                rows = [i for i in range(k + m) if tmprow[i]]
                cols = [j for j in range(k) if tmpcol[j]]
                tmpmat = np.zeros((dup, dup), dtype=np.uint8)
                for ri, i in enumerate(rows):
                    for ci, j in enumerate(cols):
                        tmpmat[ri, ci] = (1 if i == j else 0) if i < k \
                            else mat[i - k, j]
                try:
                    dinv = gfm.gf_invert(tmpmat)
                except np.linalg.LinAlgError:
                    continue
                mindup, minp = dup, len(p)
                best = (rows, cols, dinv)
        if best is None:
            raise IOError("shec: can't find recover matrix")

        rows, cols, dinv = best
        minimum = set(rows)
        for i in range(k):
            if want[i] and avails[i]:
                minimum.add(i)
        # an available wanted parity still counts itself unless its whole
        # window is already being read (ErasureCodeShec.cc:712-721)
        for i in range(m):
            if want[k + i] and avails[k + i] and (k + i) not in minimum:
                if any(mat[i, j] and not want[j] for j in range(k)):
                    minimum.add(k + i)
        # the cached minimum is a frozenset so callers mutating the returned
        # set cannot corrupt the cache
        result = (frozenset(minimum),
                  None if dinv is None else (rows, cols, dinv))
        with self._cache_lock:
            self._plan_cache[sig] = result
            if len(self._plan_cache) > PLAN_CACHE_SIZE:
                self._plan_cache.popitem(last=False)
        return result

    def _vectors(self, want_to_read, available):
        n = self.k + self.m
        for i in list(want_to_read) + list(available):
            if i < 0 or i >= n:
                raise ValueError(f"chunk index {i} out of range")
        want = tuple(1 if i in want_to_read else 0 for i in range(n))
        avails = tuple(1 if i in available else 0 for i in range(n))
        return want, avails

    def minimum_to_decode(self, want_to_read: set, available: set
                          ) -> dict[int, list[tuple[int, int]]]:
        want, avails = self._vectors(set(want_to_read), set(available))
        minimum, _ = self._make_decoding(want, avails)
        return {i: [(0, 1)] for i in sorted(minimum)}

    def minimum_to_decode_with_cost(self, want_to_read: set,
                                    available: Mapping[int, int]) -> set:
        want, avails = self._vectors(set(want_to_read), set(available))
        minimum, _ = self._make_decoding(want, avails)
        return set(minimum)

    # -- encode/decode ------------------------------------------------------

    def _apply(self, mat: np.ndarray, stack: np.ndarray) -> np.ndarray:
        """mat ·GF(2^8) stack: ``rs_kernels.gf_apply`` on the routed torch
        device, or ``gf.ref.apply_matrix`` on the host.  The coding matrix
        is uploaded once per device; a decode or row-subset matrix per
        call."""
        if not self.use_device(stack.nbytes):
            return gfref.apply_matrix(mat, stack)
        dev = self.tensor_device()
        if mat is not self.matrix:
            mat_dev = torch.from_numpy(np.ascontiguousarray(mat)).to(dev)
        elif (mat_dev := self._matrix_dev.get(dev)) is None:
            mat_dev = self._matrix_dev[dev] = torch.from_numpy(mat).to(dev)
        data = torch.from_numpy(np.ascontiguousarray(stack)).to(dev)
        return rs_kernels.gf_apply(mat_dev, data).cpu().numpy()

    def encode_chunks(self, want_to_encode: set,
                      encoded: dict[int, np.ndarray]) -> None:
        k, m = self.k, self.m
        data = np.stack([encoded[i] for i in range(k)])
        parity = self._apply(self.matrix, data)
        for i in range(m):
            encoded[k + i][:] = parity[i]

    def decode_chunks(self, want_to_read: set, chunks: Mapping[int, np.ndarray],
                      decoded: dict[int, np.ndarray]) -> None:
        k, m = self.k, self.m
        want, avails = self._vectors(
            set(want_to_read), set(chunks))
        _, plan = self._make_decoding(want, avails)
        if plan is not None:
            rows, cols, dinv = plan
            stack = np.stack([decoded[i] for i in rows])
            rec = self._apply(dinv, stack)
            for i, col in enumerate(cols):
                if not avails[col]:
                    decoded[col][:] = rec[i]
        # re-encode wanted erased parities from the (now repaired) data
        # (ErasureCodeShec.cc:803-808)
        lost_parity = [i for i in range(m)
                       if want[k + i] and not avails[k + i]]
        if lost_parity:
            data = np.stack([decoded[i] for i in range(k)])
            rec = self._apply(self.matrix[lost_parity, :], data)
            for i, pi in enumerate(lost_parity):
                decoded[k + pi][:] = rec[i]


class ErasureCodePluginShec(ErasureCodePlugin):
    def factory(self, directory: str,
                profile: ErasureCodeProfile) -> ErasureCodeShec:
        t = profile.get("technique", "multiple")
        if t == "single":
            technique = SINGLE
        elif t == "multiple":
            technique = MULTIPLE
        else:
            raise ValueError(
                f"technique={t} is not a valid coding technique "
                f"(single, multiple)")
        profile = dict(profile)
        profile["technique"] = t
        instance = ErasureCodeShec(technique)
        instance.init(profile)
        return instance


def __erasure_code_version__() -> str:
    return __version__


def __erasure_code_init__(name: str, directory: str) -> None:
    ErasureCodePluginRegistry.instance().add(name, ErasureCodePluginShec())
