"""The arithmetic of ``csrc/crc32c.cu``, emulated in numpy from the tables
the host builds for it and held bitwise against the JAX package.

The kernel pads each row with zeros on the left to whole warp units of
``CRC_SPAN`` bytes; lane l of a warp runs the 8-byte step
c' = crc32c(c ^ lo, hi) over its ``CRC_RUN`` bytes through the 16
split-nibble tables (``rs_kernels.crc_nibble_tables``), advances its crc
through the runs after it with its lane fold tables
(``rs_kernels.crc_lane_tables``), and the warp XORs the lanes.  Units are
split into one contiguous chunk per warp; a warp folds its units by
Horner with Z_SPAN and, at a row's end or its chunk's end, advances the
sum through the units after it with Z_{2^j} (``rs_kernels.crc_zpow_words``)
and XORs it into the row's output.  The emulation below follows those
steps (test code, not a second path of the port) and must give what
``ceph_tpu.ops.rs_kernels.crc32c_rows`` gives on JAX-CPU.  Inputs come
from ``np.random.default_rng(seed)``; integer arithmetic, tolerance 0.
"""
import functools

import numpy as np
import pytest
import torch

from ceph_tpu.ops import rs_kernels as jrk
from ceph_tpu_torch.backend import ecutil
from ceph_tpu_torch.ops import rs_kernels as trk

SPAN, RUN = trk.CRC_SPAN, trk.CRC_RUN
LOG_SPAN = SPAN.bit_length() - 1
GRID_WARPS = 132 * 16          # one 512-thread block per SM of an H100


def _apply(op, v: int) -> int:
    """A 32x32 GF(2) operator (``op[i]`` = image of bit i) on one word."""
    out = 0
    for i in range(32):
        if (v >> i) & 1:
            out ^= int(op[i])
    return out


def _look8(tables: np.ndarray, x: np.ndarray) -> np.ndarray:
    """XOR over the 8 nibbles t of x of tables[t][nibble t]."""
    c = np.zeros_like(x)
    for t in range(8):
        c ^= tables[t][(x >> np.uint32(4 * t)) & np.uint32(15)]
    return c


def unit_crcs(rows: np.ndarray) -> np.ndarray:
    """crc32c(0, unit) of every warp unit of the left-padded rows, as the
    kernel's lanes and lane fold compute it: uint32 [r, nspan]."""
    r, n = rows.shape
    nspan = -(-n // SPAN)
    padded = np.zeros((r, nspan * SPAN), np.uint8)
    padded[:, nspan * SPAN - n:] = rows
    words = padded.view("<u4").reshape(r, nspan, 32, RUN // 4)
    nib = trk.crc_nibble_tables()
    c = np.zeros((r, nspan, 32), np.uint32)
    for i in range(RUN // 8):
        c = _look8(nib[:8], c ^ words[..., 2 * i]) \
            ^ _look8(nib[8:], words[..., 2 * i + 1])
    lane = trk.crc_lane_tables()                     # [8, 16, 32]
    lanes = np.arange(32)
    y = np.zeros_like(c)
    for i in range(8):
        y ^= lane[i][(c >> np.uint32(4 * i)) & np.uint32(15), lanes]
    return np.bitwise_xor.reduce(y, axis=-1)


def crc_kernel_emulated(rows: np.ndarray, nwarps: int) -> np.ndarray:
    """The kernel's result for ``nwarps`` warps in the grid: int64 [r]."""
    r, n = rows.shape
    nspan = -(-n // SPAN)
    units = unit_crcs(rows)
    zpow = trk.crc_zpow_words()
    total = r * nspan
    out = np.zeros(r, np.int64)
    for w in range(nwarps):
        u0, u1 = total * w // nwarps, total * (w + 1) // nwarps
        acc = 0
        for u in range(u0, u1):
            row, s = divmod(u, nspan)
            acc = _apply(zpow[LOG_SPAN], acc) ^ int(units[row, s])
            if s == nspan - 1 or u + 1 == u1:
                d, j = nspan - 1 - s, LOG_SPAN
                while d:
                    if d & 1:
                        acc = _apply(zpow[j], acc)
                    j, d = j + 1, d >> 1
                out[row] ^= acc
                acc = 0
    return out


@functools.lru_cache(maxsize=None)
def _case(r: int, n: int):
    rng = np.random.default_rng(1000 * r + n % 997)
    rows = rng.integers(0, 256, size=(r, n), dtype=np.uint8)
    return rows, np.asarray(jrk.crc32c_rows(rows)).astype(np.int64)


@pytest.mark.parametrize("nwarps", [5, GRID_WARPS])
@pytest.mark.parametrize("n", [1, 5, SPAN - 1, SPAN, SPAN + 1,
                               (1 << 20) + 5])
@pytest.mark.parametrize("r", [1, 2, 12])
def test_crc_kernel_emulation_matches_jax(r, n, nwarps):
    rows, want = _case(r, n)
    assert np.array_equal(crc_kernel_emulated(rows, nwarps), want)


def test_crc_nibble_tables_give_the_eight_byte_step():
    """XOR of the 16 lookups of (c ^ lo, hi) is crc32c(c, 8 bytes)."""
    rng = np.random.default_rng(11)
    nib = trk.crc_nibble_tables()
    assert nib.shape == (16, 16) and nib.dtype == np.uint32
    for _ in range(20):
        c = int(rng.integers(0, 2**32))
        data = rng.integers(0, 256, size=8, dtype=np.uint8)
        lo, hi = (np.array([int(w)], np.uint32)
                  for w in data.view("<u4"))
        got = _look8(nib[:8], np.uint32(c) ^ lo) ^ _look8(nib[8:], hi)
        assert int(got[0]) == ecutil.crc32c(c, data)


def test_crc_lane_tables_advance_each_lane_through_the_runs_after_it():
    lane = trk.crc_lane_tables()
    assert lane.shape == (8, 16, 32) and lane.dtype == np.uint32
    rng = np.random.default_rng(12)
    for l in (0, 7, 30, 31):
        op = ecutil.crc32c_zeros_op((31 - l) * RUN)
        for v in rng.integers(0, 2**32, size=4):
            got = 0
            for i in range(8):
                got ^= int(lane[i, (int(v) >> (4 * i)) & 15, l])
            assert got == _apply(op, int(v))


def test_crc_rows_into_checks_its_output():
    rows = torch.zeros((3, 10), dtype=torch.uint8)
    for bad in (torch.zeros(3, dtype=torch.int32),
                torch.zeros(4, dtype=torch.int64),
                torch.zeros(6, dtype=torch.int64)[::2]):
        with pytest.raises(ValueError):
            trk.crc32c_rows_into(rows, bad)
