"""Sweep the GF-apply kernel variants on the attached CUDA card.

    python -m ceph_tpu_torch.tools.kernel_sweep [--quick]

The counterpart of the JAX package's ``tools/kernel_sweep.py``, at its
size: Cauchy RS(8,4), data [8, 8 Mi] = 64 MiB made from
``np.random.default_rng(0)`` on the card.  Side by side on one card: the
bit-plane product on the tensor cores in int8 and bf16 (``make_v1``),
block-diagonal stacking of 2 or 4 column tiles (``make_bd``), a
pure-stream copy that reads the [k, N] data and writes [r, N], the
bandwidth ceiling (``make_copy``), and the plain bitslice matmul and the
table-lookup kernel the main path runs (``gf_apply``).  Each line is
``<name> <MiB/s>`` over the 64 MiB of data, after a ``device=`` header
with the card's ``nvidia-smi`` name and power limit.

Timing: :func:`chain_time` records CUDA events around back-to-back
launches on one stream, and :func:`per_op` keeps the reference's
difference between chains of 2 and 18 launches, best of 4 rounds.  The
reference chains each apply into the next through an XOR carry because
XLA would otherwise drop or merge repeats of a pure function inside one
jitted loop; PyTorch launches eagerly, so no repeat is eliminated, and
one stream runs the launches in order, so no carry is needed.

Without a CUDA device :func:`main` exits 2: the sweep never runs on the
CPU.
"""
from __future__ import annotations

import argparse
import subprocess
import sys

import numpy as np
import torch

from ..gf.matrix import cauchy1
from ..ops import rs_kernels, sweep_kernels
from ..ops.rs_kernels import expand_bits_plane_major

K, M = 8, 4
N = 64 * 1024 * 1024 // K            # 64 MiB of data, like bench.py


def chain_time(apply_fn, mat, data, reps=18, rounds=4) -> float:
    """Best seconds over ``rounds`` of ``reps`` back-to-back launches."""
    apply_fn(mat, data)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            apply_fn(mat, data)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best


def per_op(apply_fn, mat, data, reps=18) -> float:
    t2 = chain_time(apply_fn, mat, data, 2)
    tb = chain_time(apply_fn, mat, data, reps)
    return max((tb - t2) / (reps - 2), 1e-9)


# -- variants -----------------------------------------------------------------

def make_v1(mat, tile_n, acc_dtype):
    """One [8r, 8k] x [8k, T] bit-plane product per column tile."""
    r, k = mat.shape
    bmat = expand_bits_plane_major(mat)

    def apply_fn(_m, data):
        return sweep_kernels.bitplane_apply(bmat, data, r, k, acc_dtype,
                                            tile_n)
    return apply_fn


def make_bd(mat, tile_n, acc_dtype, groups):
    """Block-diagonal: ``groups`` column tiles in one product."""
    r, k = mat.shape
    bmat = torch.block_diag(*[expand_bits_plane_major(mat)] * groups)

    def apply_fn(_m, data):
        return sweep_kernels.bitplane_apply_bd(bmat, data, r, k, groups,
                                               acc_dtype, tile_n)
    return apply_fn


def make_copy(mat, tile_n):
    """Bandwidth ceiling: read [k, T], write [r, T], zero compute."""
    r, _k = mat.shape

    def apply_fn(_m, data):
        return sweep_kernels.copy_rows(data, r, tile_n)
    return apply_fn


def nvidia_smi_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def sweep(quick: bool = False, out=print) -> dict:
    """Run every row on ``cuda:0``; returns {row name: MiB/s, or None
    where the row failed}."""
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    data = torch.from_numpy(
        rng.integers(0, 256, size=(K, N), dtype=np.uint8)).to(dev)
    mat = torch.from_numpy(cauchy1(K, M)).to(dev)
    mib = K * N / 2**20
    out(f"device={torch.cuda.get_device_name(dev)}  gpu={nvidia_smi_line()}  "
        f"data {K}x{N} = {mib:.0f} MiB")
    rows = {}

    def report(name, fn):
        try:
            t = per_op(fn, mat, data)
        except Exception as e:       # one failed row must not end the sweep
            out(f"{name:34s} FAILED: {str(e)[:120]}")
            rows[name] = None
            return
        out(f"{name:34s} {mib / t:10.0f} MiB/s")
        rows[name] = mib / t

    tiles = [4096, 8192] if quick else [2048, 4096, 8192, 16384, 32768]
    report("copy-ceiling t=8192", make_copy(mat, 8192))
    report("copy-ceiling t=32768", make_copy(mat, 32768))
    for t in tiles:
        report(f"v1 bf16 t={t}", make_v1(mat, t, "bf16"))
    for t in tiles:
        report(f"v1 int8 t={t}", make_v1(mat, t, "int8"))
    for groups in (2, 4):
        for t in ([4096, 8192] if quick else [2048, 4096, 8192]):
            report(f"bd{groups} int8 t={t}", make_bd(mat, t, "int8", groups))
    report("bd4 bf16 t=4096", make_bd(mat, 4096, "bf16", 4))
    # what the main path runs, and the plain matmul beside it
    report("torch bitslice", rs_kernels.gf_apply_bitslice)
    report("gf_apply", rs_kernels.gf_apply)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kernel_sweep")
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_sweep: torch.cuda.is_available() is False; the sweep "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    rows = sweep(args.quick)
    return 0 if all(v is not None for v in rows.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
