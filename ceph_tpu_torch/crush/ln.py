"""crush_ln: fixed-point 2^44*log2(x+1) over the straw2 draw domain.

The reference computes this with two Intel-generated lookup tables and
fixed-point arithmetic (reference: src/crush/mapper.c:248-290,
src/crush/crush_ln_table.h).  Its only call site is the straw2 draw, whose
input is always masked to 16 bits (mapper.c:334-347), so the entire function
is a 65536-entry u64 LUT.  We ship exactly that: the packaged
``data/crush_ln16.npy`` holds crush_ln(u) for u in [0, 0xffff], generated by
running the reference implementation (tools/golden/gen_golden.py) — bit-exact
by construction, and on the card a single gather instead of table
arithmetic (csrc/crush_straw2.cu reads it from device memory; at 512 KiB
it stays in L2).
"""
from __future__ import annotations

import os

import numpy as np

_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                     "crush_ln16.npy")
LN_TABLE = np.load(_DATA)                     # uint64 [65536]
assert LN_TABLE.shape == (65536,)

# As int64 for draw math: ln is used as (crush_ln(u) - 0x1000000000000),
# always negative or zero (mapper.c:352-359).
LN_TABLE_S64 = LN_TABLE.astype(np.int64)


def crush_ln(x: int) -> int:
    """Scalar crush_ln for u in [0, 0xffff]."""
    return int(LN_TABLE[x & 0xFFFF])


def crush_ln_np(x) -> np.ndarray:
    """Vectorized crush_ln over numpy arrays (inputs masked to 16 bits)."""
    return LN_TABLE[np.asarray(x).astype(np.int64) & 0xFFFF]
