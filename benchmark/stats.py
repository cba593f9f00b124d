"""The percentile rule of every latency the benchmark reports.

A frozen copy of ``ceph_tpu_torch/common/percentile.py``'s nearest rank,
so that a change to the program cannot move the yardstick.
"""
from __future__ import annotations

import math


def nearest_rank(sorted_vals, q: float) -> float:
    """Nearest-rank percentile of a sorted sequence, q in [0, 100]: the
    value at rank ceil(q / 100 * n), 1-based; 0.0 for no values."""
    if not sorted_vals:
        return 0.0
    rank = max(1, math.ceil(q / 100.0 * len(sorted_vals)))
    return sorted_vals[min(rank, len(sorted_vals)) - 1]
