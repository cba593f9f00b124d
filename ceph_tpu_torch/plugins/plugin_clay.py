"""clay: Coupled-LAYer MSR regenerating code plugin.

Behavioural mirror of the reference clay plugin
(reference: src/erasure-code/clay/ErasureCodeClay.{h,cc}): an MSR
(minimum-storage regenerating) code built by coupling the planes of a
scalar MDS code, so that repairing a single lost chunk reads only a
``1/q`` fraction of each helper chunk instead of whole chunks.

Geometry (ErasureCodeClay.h:29-31, parse at ErasureCodeClay.cc:185-282):
  q = d - k + 1, nu pads k+m to a multiple of q, t = (k + m + nu) / q.
  The k+m+nu chunks sit on a q x t grid (node = y*q + x); each chunk has
  sub_chunk_no = q^t sub-chunks ("planes" z, indexed by base-q digit
  vectors).  A plane point (x, y, z) is a *dot* when z_vec[y] == x; other
  points pair with their *sewing partner* (z_vec[y], y, z_sw), z_sw being z
  with digit y replaced by x.

Two sub-codecs (ErasureCodeClay.h:35-40):
  mds   scalar RS(k+nu, m) applied per-plane to the uncoupled values
  pft   pairwise transform: an RS(2, 2) on (C_hi, C_lo) -> (U_hi, U_lo)
        whose partial solves convert between coupled chunk data C and
        uncoupled values U (any 2 of the 4 determine the rest)

Parameters: k, m (defaults 4, 2), d in [k, k+m-1] (default k+m-1, the
repair helper count), scalar_mds in {jerasure, isa, shec, torch_rs},
technique per sub-plugin.  Profile device=... is forwarded to sub-codecs.

The port's copy of the JAX package's clay plugin: ``scalar_mds=torch_rs``
takes the place of ``jax_rs``, with the same techniques.  A profile with
no ``device`` key leaves the sub-codecs at their own default, the card.

Python buffers: every chunk is a numpy array viewed as
[sub_chunk_no, sc_size]; sub-chunk views alias the parent buffer so the
in-place sub-codec writes land directly in the output chunks.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np

from .. import __version__
from .base import ErasureCode
from .interface import ErasureCodeProfile
from .registry import ErasureCodePlugin, ErasureCodePluginRegistry


class ErasureCodeClay(ErasureCode):
    DEFAULT_K = "4"
    DEFAULT_M = "2"

    def __init__(self, directory: str = ""):
        super().__init__()
        self.directory = directory
        self.k = 0
        self.m = 0
        self.d = 0
        self.w = 8
        self.q = 0
        self.t = 0
        self.nu = 0
        self.sub_chunk_no = 0
        self.mds: ErasureCode | None = None
        self.pft: ErasureCode | None = None

    # -- init / parse (ErasureCodeClay.cc:62-88,185-282) --------------------

    def init(self, profile: ErasureCodeProfile) -> None:
        self.parse(profile)
        super().init(profile)
        registry = ErasureCodePluginRegistry.instance()
        self.mds = registry.factory(self.mds_profile["plugin"],
                                    self.directory, self.mds_profile)
        self.pft = registry.factory(self.pft_profile["plugin"],
                                    self.directory, self.pft_profile)
        profile["plugin"] = profile.get("plugin", "clay")
        self._profile = profile

    def parse(self, profile: ErasureCodeProfile) -> None:
        self.k = self.to_int("k", profile, self.DEFAULT_K)
        self.m = self.to_int("m", profile, self.DEFAULT_M)
        self.sanity_check_k_m(self.k, self.m)
        self.d = self.to_int("d", profile, str(self.k + self.m - 1))

        scalar_mds = profile.get("scalar_mds") or "jerasure"
        if scalar_mds not in ("jerasure", "isa", "shec", "torch_rs"):
            raise ValueError(
                f"scalar_mds {scalar_mds!r} is not supported, use one of "
                f"'jerasure', 'isa', 'shec', 'torch_rs'")
        technique = profile.get("technique") or ""
        if not technique:
            technique = "single" if scalar_mds == "shec" else "reed_sol_van"
        allowed = {
            "jerasure": ("reed_sol_van", "reed_sol_r6_op", "cauchy_orig",
                         "cauchy_good", "liber8tion"),
            "isa": ("reed_sol_van", "cauchy"),
            "shec": ("single", "multiple"),
            "torch_rs": ("reed_sol_van", "vandermonde", "cauchy"),
        }[scalar_mds]
        if technique not in allowed:
            raise ValueError(
                f"technique {technique!r} is not supported with "
                f"scalar_mds={scalar_mds}, use one of {allowed}")
        if not (self.k <= self.d <= self.k + self.m - 1):
            raise ValueError(
                f"value of d {self.d} must be within "
                f"[{self.k}, {self.k + self.m - 1}]")

        self.q = self.d - self.k + 1
        self.nu = (self.q - (self.k + self.m) % self.q) % self.q
        if self.k + self.m + self.nu > 254:
            raise ValueError(f"k+m+nu={self.k + self.m + self.nu} > 254")
        self.t = (self.k + self.m + self.nu) // self.q
        self.sub_chunk_no = self.q ** self.t

        device = profile.get("device", "")
        common = {"technique": technique, "w": "8"}
        if device:
            common["device"] = device
        if scalar_mds == "shec":
            common["c"] = "2"
        self.mds_profile = dict(common, plugin=scalar_mds,
                                k=str(self.k + self.nu), m=str(self.m))
        self.pft_profile = dict(common, plugin=scalar_mds, k="2", m="2")

    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_sub_chunk_count(self) -> int:
        return self.sub_chunk_no

    def get_chunk_size(self, object_size: int) -> int:
        """Chunks must split into sub_chunk_no aligned sub-chunks
        (ErasureCodeClay.cc:90-96)."""
        scalar_align = self.pft.get_chunk_size(1)
        alignment = self.sub_chunk_no * self.k * scalar_align
        padded = -(-object_size // alignment) * alignment
        return padded // self.k

    # -- plane geometry -----------------------------------------------------

    def _plane_vector(self, z: int) -> list[int]:
        """Base-q digits of z, most significant first (get_plane_vector,
        ErasureCodeClay.cc:888-894)."""
        v = [0] * self.t
        for i in range(self.t):
            v[self.t - 1 - i] = z % self.q
            z //= self.q
        return v

    def _z_sw(self, x: int, y: int, z: int, z_vec: list[int]) -> int:
        return z + (x - z_vec[y]) * self.q ** (self.t - 1 - y)

    # -- pairwise transform helpers -----------------------------------------

    def _pft_solve(self, known: dict[int, np.ndarray],
                   want: dict[int, np.ndarray]) -> None:
        """Solve the RS(2,2) pair relation: indices 0/1 are the coupled
        values (high-x node first), 2/3 the uncoupled ones.  ``known`` maps
        2 indices to value views, ``want`` maps the missing indices to
        output views (all 4 present between them); writes in place."""
        decoded = dict(known)
        decoded.update(want)
        for i in range(4):
            if i not in decoded:  # throwaway output (temp_buf in the C++)
                decoded[i] = np.zeros_like(next(iter(known.values())))
        self.pft.decode_chunks(set(want), known, decoded)

    def _pair_views(self, x: int, y: int, z_vec: list[int]):
        """Canonical pft index mapping for the pair at (x, y): returns
        (iC_xy, iC_sw, iU_xy, iU_sw) — the coupled/uncoupled pft indices of
        node_xy and its sewing partner (the i0..i3 permutation at
        ErasureCodeClay.cc:436-441)."""
        if z_vec[y] > x:
            return 1, 0, 3, 2
        return 0, 1, 2, 3

    # -- encode / decode (ErasureCodeClay.cc:127-183) -----------------------

    def encode_chunks(self, want_to_encode: set,
                      encoded: dict[int, np.ndarray]) -> None:
        k, m, nu = self.k, self.m, self.nu
        chunk_size = len(encoded[0])
        chunks: dict[int, np.ndarray] = {}
        parity_chunks: set[int] = set()
        for i in range(k + m):
            if i < k:
                chunks[i] = encoded[i]
            else:
                chunks[i + nu] = encoded[i]
                parity_chunks.add(i + nu)
        for i in range(k, k + nu):  # shortening: virtual zero chunks
            chunks[i] = np.zeros(chunk_size, dtype=np.uint8)
        self._decode_layered(parity_chunks, chunks)

    def decode_chunks(self, want_to_read: set, chunks: Mapping[int, np.ndarray],
                      decoded: dict[int, np.ndarray]) -> None:
        k, m, nu = self.k, self.m, self.nu
        erasures: set[int] = set()
        coded: dict[int, np.ndarray] = {}
        for i in range(k + m):
            if i not in chunks:
                erasures.add(i if i < k else i + nu)
            coded[i if i < k else i + nu] = decoded[i]
        chunk_size = len(coded[0])
        for i in range(k, k + nu):
            coded[i] = np.zeros(chunk_size, dtype=np.uint8)
        self._decode_layered(erasures, coded)

    def decode(self, want_to_read: set, chunks: Mapping[int, np.ndarray],
               chunk_size: int = 0) -> dict[int, np.ndarray]:
        """Route single-failure reads with fractional helper chunks through
        the repair path (ErasureCodeClay.cc:107-122)."""
        chunks = {i: np.asarray(v, dtype=np.uint8) for i, v in chunks.items()}
        if chunks and self.is_repair(set(want_to_read), set(chunks)) and \
                chunk_size > len(next(iter(chunks.values()))):
            return self._repair(set(want_to_read), chunks, chunk_size)
        return self._decode(want_to_read, chunks)

    # -- repair predicates (ErasureCodeClay.cc:284-329) ---------------------

    def is_repair(self, want_to_read: set, available: set) -> bool:
        if want_to_read <= available:
            return False
        if len(want_to_read) > 1:
            return False
        lost = next(iter(want_to_read))
        lost_node = lost if lost < self.k else lost + self.nu
        for x in range(self.q):
            node = (lost_node // self.q) * self.q + x
            node = node if node < self.k else node - self.nu
            if node != lost and node not in available:
                return False
        return len(available) >= self.d

    def get_repair_subchunks(self, lost_node: int) -> list[tuple[int, int]]:
        """(offset, count) runs of the sub-chunks a helper must send to
        repair lost_node (ErasureCodeClay.cc:363-379): the planes whose
        y_lost digit equals x_lost."""
        q, t = self.q, self.t
        y_lost, x_lost = lost_node // q, lost_node % q
        seq_sc_count = q ** (t - 1 - y_lost)
        num_seq = q ** y_lost
        index = x_lost * seq_sc_count
        runs = []
        for _ in range(num_seq):
            runs.append((index, seq_sc_count))
            index += q * seq_sc_count
        return runs

    def get_repair_sub_chunk_count(self, want_to_read: set) -> int:
        weight = [0] * self.t
        for node in want_to_read:
            weight[node // self.q] += 1
        remaining = 1
        for y in range(self.t):
            remaining *= self.q - weight[y]
        return self.sub_chunk_no - remaining

    def minimum_to_decode(self, want_to_read: set, available: set
                          ) -> dict[int, list[tuple[int, int]]]:
        if self.is_repair(set(want_to_read), set(available)):
            return self._minimum_to_repair(set(want_to_read), set(available))
        return super().minimum_to_decode(want_to_read, available)

    def _minimum_to_repair(self, want_to_read: set, available: set
                           ) -> dict[int, list[tuple[int, int]]]:
        """d helpers, sub-chunk runs only (ErasureCodeClay.cc:331-361)."""
        lost = next(iter(want_to_read))
        lost_node = lost if lost < self.k else lost + self.nu
        runs = self.get_repair_subchunks(lost_node)
        minimum: dict[int, list[tuple[int, int]]] = {}
        for j in range(self.q):  # same-column nodes first
            if j == lost_node % self.q:
                continue
            rep = (lost_node // self.q) * self.q + j
            if rep < self.k:
                minimum[rep] = list(runs)
            elif rep >= self.k + self.nu:
                minimum[rep - self.nu] = list(runs)
        for chunk in sorted(available):
            if len(minimum) >= self.d:
                break
            minimum.setdefault(chunk, list(runs))
        assert len(minimum) == self.d
        return minimum

    # -- layered decode (ErasureCodeClay.cc:646-739) ------------------------

    def _decode_layered(self, erased_chunks: set[int],
                        chunks: dict[int, np.ndarray]) -> None:
        """Recover every erased chunk in place.  ``chunks`` maps all q*t
        node ids to full-size buffers; erased ones hold garbage/zeros."""
        q, t, m = self.q, self.t, self.m
        k, nu = self.k, self.nu
        erased = set(erased_chunks)
        size = len(chunks[0])
        assert size % self.sub_chunk_no == 0
        sc_size = size // self.sub_chunk_no
        assert erased

        # pad erasures to m with virtual/parity nodes so the MDS decode has
        # a fixed shape (ErasureCodeClay.cc:656-663)
        for i in range(k + nu, q * t):
            if len(erased) >= m:
                break
            erased.add(i)
        assert len(erased) == m

        # work on copies: the erasure padding above recruits intact parity
        # nodes, whose buffers belong to the caller (and may be read-only
        # np.frombuffer views) — results are written back at the end
        C = {node: np.array(buf, dtype=np.uint8).reshape(
                self.sub_chunk_no, sc_size)
             for node, buf in chunks.items()}
        U = np.zeros((q * t, self.sub_chunk_no, sc_size), dtype=np.uint8)

        # plane order = number of erased nodes whose dot lies in the plane
        order = np.zeros(self.sub_chunk_no, dtype=np.int64)
        z_vecs = [self._plane_vector(z) for z in range(self.sub_chunk_no)]
        for z in range(self.sub_chunk_no):
            order[z] = sum(1 for i in erased if i % q == z_vecs[z][i // q])
        max_iscore = len({i // q for i in erased})

        for iscore in range(max_iscore + 1):
            planes = [z for z in range(self.sub_chunk_no) if order[z] == iscore]
            for z in planes:
                self._decode_erasures(erased, z, z_vecs[z], C, U, sc_size)
            for z in planes:
                z_vec = z_vecs[z]
                for node_xy in sorted(erased):
                    x, y = node_xy % q, node_xy // q
                    node_sw = y * q + z_vec[y]
                    if z_vec[y] != x:
                        z_sw = self._z_sw(x, y, z, z_vec)
                        iC_xy, iC_sw, iU_xy, iU_sw = \
                            self._pair_views(x, y, z_vec)
                        if node_sw not in erased:
                            # type-1: partner data is intact
                            # (recover_type1_erasure, ErasureCodeClay.cc:776-812)
                            self._pft_solve(
                                {iC_sw: C[node_sw][z_sw], iU_xy: U[node_xy][z]},
                                {iC_xy: C[node_xy][z]})
                        elif z_vec[y] < x:
                            # both of the pair erased: coupled from the two
                            # uncoupled (get_coupled_from_uncoupled, :814-840)
                            self._pft_solve(
                                {2: U[node_xy][z], 3: U[node_sw][z_sw]},
                                {0: C[node_xy][z], 1: C[node_sw][z_sw]})
                    else:  # hole-dot: C == U
                        C[node_xy][z] = U[node_xy][z]

        for node in erased_chunks:
            chunks[node][:] = C[node].reshape(-1)

    def _decode_erasures(self, erased: set[int], z: int, z_vec: list[int],
                         C: dict[int, np.ndarray], U: np.ndarray,
                         sc_size: int) -> None:
        """Fill plane z of U for intact nodes, then MDS-solve the erased
        ones (decode_erasures, ErasureCodeClay.cc:741-768)."""
        q, t = self.q, self.t
        for x in range(q):
            for y in range(t):
                node_xy = q * y + x
                node_sw = q * y + z_vec[y]
                if node_xy in erased:
                    continue
                if z_vec[y] < x:
                    self._uncouple_pair(x, y, z, z_vec, C, U, sc_size)
                elif z_vec[y] == x:
                    U[node_xy][z] = C[node_xy][z]
                elif node_sw in erased:
                    self._uncouple_pair(x, y, z, z_vec, C, U, sc_size)
        self._decode_uncoupled(erased, z, U)

    def _uncouple_pair(self, x: int, y: int, z: int, z_vec: list[int],
                       C: dict[int, np.ndarray], U: np.ndarray,
                       sc_size: int) -> None:
        """U values of a pair from its two coupled values
        (get_uncoupled_from_coupled, ErasureCodeClay.cc:842-868)."""
        node_xy = y * self.q + x
        node_sw = y * self.q + z_vec[y]
        z_sw = self._z_sw(x, y, z, z_vec)
        iC_xy, iC_sw, iU_xy, iU_sw = self._pair_views(x, y, z_vec)
        self._pft_solve(
            {iC_xy: C[node_xy][z], iC_sw: C[node_sw][z_sw]},
            {iU_xy: U[node_xy][z], iU_sw: U[node_sw][z_sw]})

    def _decode_uncoupled(self, erased: set[int], z: int,
                          U: np.ndarray) -> None:
        """Per-plane scalar MDS decode of the uncoupled values
        (decode_uncoupled, ErasureCodeClay.cc:770-788)."""
        known = {i: U[i][z] for i in range(self.q * self.t) if i not in erased}
        decoded = {i: U[i][z] for i in range(self.q * self.t)}
        self.mds.decode_chunks(set(erased), known, decoded)

    # -- single-chunk repair (ErasureCodeClay.cc:396-643) -------------------

    def _repair(self, want_to_read: set, chunks: Mapping[int, np.ndarray],
                chunk_size: int) -> dict[int, np.ndarray]:
        q, t, k, m, nu, d = self.q, self.t, self.k, self.m, self.nu, self.d
        assert len(want_to_read) == 1 and len(chunks) == d
        repair_sub_count = self.get_repair_sub_chunk_count(
            {next(iter(want_to_read)) if next(iter(want_to_read)) < k
             else next(iter(want_to_read)) + nu})
        repair_blocksize = len(next(iter(chunks.values())))
        assert repair_blocksize % repair_sub_count == 0
        sc_size = repair_blocksize // repair_sub_count
        assert self.sub_chunk_no * sc_size == chunk_size

        lost = next(iter(want_to_read))
        lost_node = lost if lost < k else lost + nu

        helper: dict[int, np.ndarray] = {}
        aloof: set[int] = set()
        for i in range(k + m):
            node = i if i < k else i + nu
            if i in chunks:
                helper[node] = np.asarray(chunks[i], dtype=np.uint8).reshape(
                    repair_sub_count, sc_size)
            elif i != lost:
                aloof.add(node)
        for i in range(k, k + nu):  # shortened: zero helpers
            helper[i] = np.zeros((repair_sub_count, sc_size), dtype=np.uint8)
        out = np.zeros(chunk_size, dtype=np.uint8)
        recovered = out.reshape(self.sub_chunk_no, sc_size)
        assert len(helper) + len(aloof) + 1 == q * t

        self._repair_one_lost_chunk(lost_node, recovered, aloof, helper,
                                    sc_size)
        return {lost: out}

    def _repair_one_lost_chunk(self, lost: int, recovered: np.ndarray,
                               aloof: set[int], helper: dict[int, np.ndarray],
                               sc_size: int) -> None:
        """(repair_one_lost_chunk, ErasureCodeClay.cc:469-643).  ``helper``
        holds only the repair planes, indexed densely; ``recovered`` is the
        full [sub_chunk_no, sc_size] output."""
        q, t = self.q, self.t
        runs = self.get_repair_subchunks(lost)
        repair_planes = [j for index, count in runs
                         for j in range(index, index + count)]
        plane_ind = {z: i for i, z in enumerate(repair_planes)}

        # order repair planes by intersection score with {lost} | aloof
        ordered: dict[int, list[int]] = {}
        for z in repair_planes:
            z_vec = self._plane_vector(z)
            score = sum(1 for node in ({lost} | aloof)
                        if node % q == z_vec[node // q])
            assert score > 0
            ordered.setdefault(score, []).append(z)

        U = np.zeros((q * t, self.sub_chunk_no, sc_size), dtype=np.uint8)
        erasures = {lost - lost % q + i for i in range(q)} | aloof

        for score in sorted(ordered):
            for z in ordered[score]:
                z_vec = self._plane_vector(z)
                for y in range(t):
                    for x in range(q):
                        node_xy = y * q + x
                        if node_xy in erasures:
                            continue
                        node_sw = y * q + z_vec[y]
                        z_sw = self._z_sw(x, y, z, z_vec)
                        iC_xy, iC_sw, iU_xy, iU_sw = \
                            self._pair_views(x, y, z_vec)
                        if node_sw in aloof:
                            # partner coupled value unknown; use its already
                            # computed uncoupled value (:447-460)
                            self._pft_solve(
                                {iC_xy: helper[node_xy][plane_ind[z]],
                                 iU_sw: U[node_sw][z_sw]},
                                {iU_xy: U[node_xy][z]})
                        elif z_vec[y] != x:
                            self._pft_solve(
                                {iC_xy: helper[node_xy][plane_ind[z]],
                                 iC_sw: helper[node_sw][plane_ind[z_sw]]},
                                {iU_xy: U[node_xy][z]})
                        else:  # dot point
                            U[node_xy][z] = helper[node_xy][plane_ind[z]]
                assert len(erasures) <= self.m
                self._decode_uncoupled(erasures, z, U)
                for i in sorted(erasures):
                    x, y = i % q, i // q
                    node_sw = y * q + z_vec[y]
                    z_sw = self._z_sw(x, y, z, z_vec)
                    if i in aloof:
                        continue
                    iC_xy, iC_sw, iU_xy, iU_sw = self._pair_views(x, y, z_vec)
                    if x == z_vec[y]:  # hole-dot pair (:609-619)
                        recovered[z] = U[i][z]
                    else:
                        # recover the lost chunk's z_sw sub-chunk from this
                        # helper's coupled value + its uncoupled value (:621-637)
                        assert y == lost // q and node_sw == lost
                        self._pft_solve(
                            {iC_xy: helper[i][plane_ind[z]], iU_xy: U[i][z]},
                            {iC_sw: recovered[z_sw]})


class ErasureCodePluginClay(ErasureCodePlugin):
    def factory(self, directory: str,
                profile: ErasureCodeProfile) -> ErasureCodeClay:
        instance = ErasureCodeClay(directory)
        instance.init(dict(profile))
        return instance


def __erasure_code_version__() -> str:
    return __version__


def __erasure_code_init__(name: str, directory: str) -> None:
    ErasureCodePluginRegistry.instance().add(name, ErasureCodePluginClay())
