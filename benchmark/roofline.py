"""The card's peaks and the bytes a kernel must move: the yardstick of
every ``*_roofline_pct`` metric, frozen here so that a change to the
program cannot move it.
"""
from __future__ import annotations

#: NVIDIA H100 SXM5 80 GB (data sheet): HBM3 bandwidth, bytes/s
HBM_BYTES_S = 3.35e12


def gf_apply_bytes(key) -> int:
    """Bytes one ``gf_apply`` launch must move, from its launch-ledger key
    ``(kernel, (r, k), rows, cols)``: the data [S * k, N] read once and
    the output [S * r, N] written once, S * (k + r) * N."""
    _kernel, (r, k), rows, cols = key
    stripes = rows // k
    return stripes * (k + r) * cols
