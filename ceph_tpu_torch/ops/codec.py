"""RSCodec: the device-resident Reed-Solomon codec.

Combines host-side matrix algebra (construction + erasure-signature-cached
inversion, mirroring the isa plugin's table cache,
reference: src/erasure-code/isa/ErasureCodeIsaTableCache.h:35-65) with the
GF(2^8) apply of :mod:`.rs_kernels`.

``device`` is 'cuda' (the hand kernels; the default), 'cpu' (the plain
PyTorch versions on CPU tensors) or 'numpy' (the host reference codec).
The repair legs' products, which have no codec (a chain hop's
scale-accumulate, the regenerating-repair inner products), are module
functions here, each with an exact numpy sibling.
The JAX package's buffer donation has no PyTorch counterpart and is left
out: a launch never aliases its input, and the caller frees it by dropping
the reference.
"""
from __future__ import annotations

import collections
import threading

import numpy as np
import torch

from ..backend import ecutil
from ..gf import matrix as gfm
from ..gf import ref as gfref
from . import rs_kernels

TECHNIQUES = {
    "reed_sol_van": gfm.rs_vandermonde_jerasure,
    "vandermonde": gfm.rs_vandermonde_isa,
    "cauchy": gfm.cauchy1,
}

DEVICES = ("cuda", "cpu", "numpy")

# Matches the isa decode-table LRU capacity, "sufficient up to (12,4)"
# (reference: src/erasure-code/isa/ErasureCodeIsaTableCache.h:46-48).
DECODE_CACHE_SIZE = 2516


def torch_device(device: str) -> torch.device:
    """The torch device of a 'cuda' or 'cpu' codec or plugin.  'cuda' on a
    machine with no CUDA device raises rather than run on the CPU."""
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device=cuda but torch.cuda.is_available() is False")
        return torch.device("cuda", torch.cuda.current_device())
    if device == "cpu":
        return torch.device("cpu")
    raise ValueError(f"device={device} has no torch device")


# -- the repair legs' GF products (no RSCodec) ----------------------------------

def scale_accumulate_device(mat, data, acc=None) -> torch.Tensor:
    """One chain-repair hop's partial-sum update, ``(mat @GF data) ^ acc``:
    ``mat`` [r, 1] decode coefficients, ``data`` [1, N] the hop's local
    chunk stream, ``acc`` [r, N] the running sums (None on the first hop)
    -> [r, N] on the data's device.  A CUDA tensor runs the ``gf_apply``
    kernel, then the XOR on the card; a CPU tensor the plain versions."""
    out = rs_kernels.gf_apply(mat, data)
    if acc is not None:
        out ^= acc
    return out


def scale_accumulate_host(mat: np.ndarray, data: np.ndarray,
                          acc: np.ndarray | None) -> np.ndarray:
    """Exact host sibling of :func:`scale_accumulate_device`."""
    out = gfref.apply_matrix_fast(
        np.ascontiguousarray(mat, dtype=np.uint8),
        np.ascontiguousarray(data, dtype=np.uint8))
    if acc is not None:
        np.bitwise_xor(out, acc, out=out)
    return out


def gf_inner_product_device(mat, data) -> torch.Tensor:
    """The regenerating-repair product ``mat @GF data``: a helper's
    projection row [1, alpha] x its stored chunk's symbol rows [alpha, N],
    or the newcomer's combine matrix [alpha, d] x the stacked helper
    streams [d, N] -> [rows, N] on the data's device (the ``gf_apply``
    kernel on a CUDA tensor, its plain version on a CPU one)."""
    return rs_kernels.gf_apply(mat, data)


def gf_inner_product_host(mat: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Exact host sibling of :func:`gf_inner_product_device`."""
    return gfref.apply_matrix_fast(
        np.ascontiguousarray(mat, dtype=np.uint8),
        np.ascontiguousarray(data, dtype=np.uint8))


class _DecodeTables:
    """One signature's cached decode state: the host matrix, the source
    chunk order, and — uploaded lazily, then pinned for the LRU entry's
    lifetime — the device-resident copy.  The device copy is what keeps
    an LRU *hit* from paying a host->device matrix transfer per call."""

    __slots__ = ("D", "src", "dev")

    def __init__(self, D: np.ndarray, src: list[int]):
        self.D = D
        self.src = src
        self.dev: torch.Tensor | None = None


class RSCodec:
    """Systematic RS(k, m) over GF(2^8), poly 0x11D."""

    def __init__(self, k: int, m: int, technique: str = "reed_sol_van",
                 device: str = "cuda"):
        if k < 2 or m < 1 or k + m > 256:
            raise ValueError(f"bad RS parameters k={k} m={m}")
        if technique not in TECHNIQUES:
            raise ValueError(f"unknown technique {technique!r}")
        if device not in DEVICES:
            raise ValueError(f"device={device} must be one of {DEVICES}")
        if technique == "vandermonde":
            # ISA-L's geometric-progression matrix is only MDS inside this
            # envelope (reference: src/erasure-code/isa/ErasureCodeIsa.cc:323-364).
            if k > 32 or m > 4 or (m == 4 and k > 21):
                raise ValueError(
                    f"technique 'vandermonde' requires k<=32, m<=4 "
                    f"(m=4 => k<=21); got k={k} m={m}")
        self.k, self.m, self.technique = k, m, technique
        self.device = device
        self.parity_mat = TECHNIQUES[technique](k, m)          # [m, k] uint8
        self._parity_dev = None
        self._decode_cache: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()
        # host->device table-transfer counters: an LRU hit must cost ZERO
        # uploads (no decode matrix is re-uploaded per call)
        self.parity_uploads = 0
        self.decode_table_uploads = 0

    # -- device placement ----------------------------------------------------

    @property
    def torch_device(self) -> torch.device:
        """Where this codec's tensors live; a 'cuda' codec on a machine
        with no CUDA device raises rather than run on the CPU."""
        return torch_device(self.device)

    def to_device(self, arr: np.ndarray) -> torch.Tensor:
        """Host uint8 array -> contiguous tensor on this codec's device."""
        t = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.uint8))
        return t.to(self.torch_device)

    # -- encode ------------------------------------------------------------

    def encode(self, data: np.ndarray) -> np.ndarray:
        """data [k, N] (or [B, k, N]) uint8 -> parity [m, N] (or [B, m, N])."""
        data = np.ascontiguousarray(data, dtype=np.uint8)
        if data.ndim == 3:
            b, k, n = data.shape
            out = self.encode(np.swapaxes(data, 0, 1).reshape(k, b * n))
            return np.swapaxes(out.reshape(self.m, b, n), 0, 1)
        if self.device == "numpy":
            return gfref.apply_matrix_fast(self.parity_mat, data)
        return self.encode_device(self.to_device(data)).cpu().numpy()

    def encode_with_crc(self, data: np.ndarray
                        ) -> tuple[np.ndarray, np.ndarray]:
        """Fused encode + checksum: parity [m, N] uint8 and the
        crc32c(0, row) of every row of concat(data, parity) as a [k + m]
        uint32 array.  On the card: the ``gf_apply`` kernel, then the
        ``crc32c`` kernel over the rows the card holds, before either
        comes back.  Seed-free crcs: callers chain them into ceph's
        running HashInfo semantics with ``ecutil.crc32c_zeros`` (see
        ``HashInfo.append_crcs``)."""
        data = np.ascontiguousarray(data, dtype=np.uint8)
        if self.device == "numpy":
            parity = gfref.apply_matrix_fast(self.parity_mat, data)
            crcs = np.array(
                [ecutil.crc32c(0, row)
                 for row in np.concatenate([data, parity], axis=0)],
                dtype=np.uint32)
            return parity, crcs
        parity, crcs = rs_kernels.gf_encode_with_crc(self._upload_parity(),
                                                     self.to_device(data))
        return parity.cpu().numpy(), crcs.cpu().numpy().astype(np.uint32)

    def encode_host(self, data: np.ndarray) -> np.ndarray:
        """Pure-host parity (the exact CPU reference path) REGARDLESS of
        ``self.device``: data [k, N] uint8 -> parity [m, N]."""
        return gfref.apply_matrix_fast(
            self.parity_mat, np.ascontiguousarray(data, dtype=np.uint8))

    def decode_host(self, stack: np.ndarray, erasures: list[int],
                    available: list[int]) -> np.ndarray:
        """Pure-host recovery, device never touched: ``stack`` [k', N]
        survivors already in the ``src`` order ``decode_matrix(erasures,
        available)`` returns -> recovered rows [len(erasures), N]."""
        entry = self._decode_entry(sorted(int(e) for e in erasures),
                                   available=list(available))
        return gfref.apply_matrix_fast(
            entry.D, np.ascontiguousarray(stack, dtype=np.uint8))

    def _upload_parity(self) -> torch.Tensor:
        if self._parity_dev is None:
            self._parity_dev = self.to_device(self.parity_mat)
            self.parity_uploads += 1
        return self._parity_dev

    def parity_matrix_device(self) -> torch.Tensor:
        """The parity matrix [m, k] on this codec's device, uploaded once
        (``parity_uploads`` counts it)."""
        return self._upload_parity()

    def encode_device(self, data: torch.Tensor) -> torch.Tensor:
        """Device-to-device encode (no host transfer): [k, N] -> [m, N]."""
        return rs_kernels.gf_apply(self._upload_parity(), data)

    # -- decode ------------------------------------------------------------

    def _decode_entry(self, erasures, available=None) -> _DecodeTables:
        """Signature-LRU lookup/build of the shared decode state."""
        sig = (tuple(sorted(int(e) for e in erasures)),
               None if available is None else tuple(sorted(int(a) for a in available)))
        with self._lock:
            hit = self._decode_cache.get(sig)
            if hit is not None:
                self._decode_cache.move_to_end(sig)
                return hit
        D, src = gfm.decode_matrix(self.parity_mat, list(erasures), available)
        return self._insert_entry(sig, _DecodeTables(D, src))

    def _insert_entry(self, sig, entry: _DecodeTables) -> _DecodeTables:
        with self._lock:
            entry = self._decode_cache.setdefault(sig, entry)
            self._decode_cache.move_to_end(sig)
            if len(self._decode_cache) > DECODE_CACHE_SIZE:
                self._decode_cache.popitem(last=False)
        return entry

    def decode_matrix(self, erasures, available=None):
        """Signature-LRU-cached (decode matrix, source chunk list)."""
        entry = self._decode_entry(erasures, available)
        return entry.D, entry.src

    def decode_matrix_device(self, erasures, available=None):
        """Like :meth:`decode_matrix` but the matrix is the DEVICE-resident
        copy, uploaded once per LRU entry: an LRU hit costs zero
        host->device transfers (``decode_table_uploads`` counts them)."""
        entry = self._decode_entry(erasures, available)
        return self._entry_device(entry), entry.src

    def _entry_device(self, entry: _DecodeTables) -> torch.Tensor:
        """Pin (lazily uploading) an already-fetched entry's device copy."""
        if entry.dev is None:
            # upload outside the lock, publish under it: two threads racing
            # a fresh signature upload twice but count once
            dev = self.to_device(entry.D)
            with self._lock:
                if entry.dev is None:
                    entry.dev = dev
                    self.decode_table_uploads += 1
        return entry.dev

    def decode(self, chunks: dict[int, np.ndarray],
               erasures: list[int]) -> dict[int, np.ndarray]:
        """Recover the erased chunk indices from surviving chunks.

        chunks: {index: [N] uint8} (>= k survivors), erasures: lost indices.
        """
        erasures = sorted(int(e) for e in erasures)
        if not erasures:
            return {}
        entry = self._decode_entry(erasures, available=list(chunks))
        stack = np.stack([np.asarray(chunks[i], dtype=np.uint8)
                          for i in entry.src])
        if self.device == "numpy":
            rec = gfref.apply_matrix_fast(entry.D, stack)
        else:
            rec = rs_kernels.gf_apply(self._entry_device(entry),
                                      self.to_device(stack)).cpu().numpy()
        return {e: rec[i] for i, e in enumerate(erasures)}

    @staticmethod
    def _src_index_map(src: list[int],
                       src_expected: list[int]) -> list[int] | None:
        """Row gather mapping caller order -> decode_matrix order, or None
        when it is the identity over a prefix (precomputed in O(k) — the
        per-element ``src.index(s)`` scan was O(k^2) per batch)."""
        if src == src_expected:
            return None
        pos = {s: i for i, s in enumerate(src)}
        idx = [pos[s] for s in src_expected]
        if idx == list(range(len(idx))):
            return None          # identity after dropping extras: slice, no gather
        return idx

    def decode_batch(self, stack: np.ndarray, src: list[int],
                     erasures: list[int]) -> np.ndarray:
        """Batched decode with one shared erasure signature.

        stack: [B, k, N] survivors in ``src`` order -> [B, len(erasures), N].
        """
        src = [int(s) for s in src]
        entry = self._decode_entry(erasures, available=src)
        idx = self._src_index_map(src, entry.src)
        if idx is not None:
            stack = stack[:, idx, :]
        elif len(entry.src) != stack.shape[1]:
            stack = stack[:, :len(entry.src), :]     # drop extras: a view
        b, k, n = stack.shape
        folded = np.ascontiguousarray(
            np.swapaxes(stack, 0, 1).reshape(k, b * n), dtype=np.uint8)
        if self.device == "numpy":
            rec = gfref.apply_matrix_fast(entry.D, folded)
        else:
            rec = rs_kernels.gf_apply(self._entry_device(entry),
                                      self.to_device(folded)).cpu().numpy()
        return np.swapaxes(rec.reshape(len(erasures), b, n), 0, 1)

    # -- device-resident decode (no host round-trip) ------------------------

    def decode_device(self, stack: torch.Tensor, erasures: list[int],
                      available: list[int] | None = None) -> torch.Tensor:
        """Device-to-device decode: ``stack`` [k, N] survivors already in
        the sorted-src order ``decode_matrix(erasures, available)``
        returns -> recovered rows [len(erasures), N], still on device.
        The decode matrix rides the signature LRU's device copy."""
        erasures = sorted(int(e) for e in erasures)
        D_dev, src = self.decode_matrix_device(erasures, available)
        if int(stack.shape[0]) != len(src):
            raise ValueError(
                f"stack has {stack.shape[0]} rows for {len(src)} sources")
        return rs_kernels.gf_apply(D_dev, stack)

    def decode_batch_device(self, stack: torch.Tensor, src: list[int],
                            erasures: list[int]) -> torch.Tensor:
        """Device-to-device batched decode: ``stack`` [B, k', N] survivors
        in ``src`` order -> [B, len(erasures), N] on device.  The row
        permutation, fold and unfold all run on the device."""
        src = [int(s) for s in src]
        erasures = sorted(int(e) for e in erasures)
        D_dev, src_expected = self.decode_matrix_device(erasures,
                                                        available=src)
        idx = self._src_index_map(src, src_expected)
        if idx is not None:
            stack = torch.index_select(
                stack, 1, torch.tensor(idx, device=stack.device))
        elif len(src_expected) != int(stack.shape[1]):
            stack = stack[:, :len(src_expected), :]
        b, k, n = (int(s) for s in stack.shape)
        folded = stack.transpose(0, 1).reshape(k, b * n).contiguous()
        rec = rs_kernels.gf_apply(D_dev, folded)
        return rec.reshape(len(erasures), b, n).transpose(0, 1)
