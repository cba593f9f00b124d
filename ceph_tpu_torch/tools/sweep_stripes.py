"""Sweep the launch variants of the ``gf_apply.cu`` kernel on the card.

    python -m ceph_tpu_torch.tools.sweep_stripes [--quick] [--stripes S]
        [--stripe-bytes B]

The counterpart of the JAX package's ``tools/sweep_stripes.py``, at its
shape: Cauchy RS(8,4), ``--stripes`` (64) stripes of ``--stripe-bytes``
(1 MiB) in the vertical layout [S*k, B/k] made from ``np.random.default_rng(0)`` on the card,
encode with the parity matrix and decode with the matrix of erasures
{0, 9}.  The JAX tool sweeps the TPU kernel's ``(groups, tile_n)``; the
CUDA kernel has neither, so this one sweeps its own launch variants: the
cp.async ring depth (``stages``), 16-byte column runs per thread
(``runs``) and blocks per SM.  They are reachable only through the
kernel's sweep-only C entry ``gf_apply_variant_launch``, never from
``rs_kernels.gf_apply``.  Each line is
``stages=<s> runs=<u> blocks/sm=<b>: encode <MiB/s> decode <MiB/s> MiB/s``,
after a ``device=`` header with the card's ``nvidia-smi`` name and power
limit and a ``default`` line for what ``gf_apply_stripes`` launches.
Each variant's output is first held bitwise against ``gf_apply_stripes``.

Timing is bench.py's chain difference: CUDA events around chains of 4 and
52 back-to-back launches, best of 7 rounds each.  Without a CUDA device
:func:`main` exits 2.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..ops import cuda_build, rs_kernels
from ..ops.codec import RSCodec
from .kernel_sweep import chain_time, nvidia_smi_line

K, M, ERASURES = 8, 4, [0, 9]
STRIPE_BYTES = 1024 * 1024
# (stages, runs, blocks per SM): the (stages, runs) pairs the kernel is
# built for, at each block count whose shared memory fits an SM at r <= 4,
# k = 8 (ring stages*runs*16 KiB + 32 KiB of tables per block)
VARIANTS = [(2, 1, 1), (2, 1, 2), (2, 1, 3), (3, 1, 1), (3, 1, 2),
            (4, 1, 1), (4, 1, 2), (6, 1, 1), (2, 2, 1), (2, 2, 2),
            (3, 2, 1), (4, 2, 1)]
QUICK_VARIANTS = [(2, 1, 2), (4, 1, 2), (2, 2, 2)]

launches = {"gf_apply_variant": 0}


def apply_variant(mat: torch.Tensor, data: torch.Tensor, stripes: int,
                  stages: int, runs: int, blocks_per_sm: int) -> torch.Tensor:
    """``rs_kernels.gf_apply_stripes`` in one launch variant; CUDA tensors
    only (the sweep never runs on the CPU)."""
    if not (mat.is_cuda and data.is_cuda):
        raise ValueError("apply_variant runs on cuda tensors only")
    if not (mat.is_contiguous() and data.is_contiguous()):
        raise ValueError("mat and data must be contiguous")
    if (stages, runs) not in {v[:2] for v in VARIANTS}:
        raise ValueError(f"(stages, runs) must be one of "
                         f"{sorted({v[:2] for v in VARIANTS})}")
    r, k = mat.shape
    n = int(data.shape[1])
    if data.shape[0] != stripes * k:
        raise ValueError(f"{data.shape[0]} rows != {stripes} stripes x {k}")
    out = torch.empty((stripes * r, n), dtype=torch.uint8, device=data.device)
    lib = cuda_build.load("gf_apply")
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = lib.gf_apply_variant_launch(
            mat.data_ptr(), rs_kernels._mul_table(data.device).data_ptr(),
            data.data_ptr(), out.data_ptr(), int(r), int(k), n, int(stripes),
            int(stages), int(runs), int(blocks_per_sm), stream)
    if err != 0:
        raise RuntimeError(f"gf_apply_variant failed: cudaError_t {err}")
    launches["gf_apply_variant"] += 1
    return out


def per_op_seconds(apply_fn, mat, data, lo: int = 4, hi: int = 52) -> float:
    """Per-launch seconds from the (hi - lo) chain difference, as bench.py;
    the hi-chain mean where noise swallows the difference."""
    for _ in range(2):
        t_lo = chain_time(apply_fn, mat, data, lo, rounds=7)
        t_hi = chain_time(apply_fn, mat, data, hi, rounds=7)
        if t_hi > t_lo * 1.05:
            return (t_hi - t_lo) / (hi - lo)
    return t_hi / hi


def sweep(stripes: int = 64, quick: bool = False, out=print,
          stripe_bytes: int = STRIPE_BYTES) -> dict:
    """Every variant on ``cuda:0``: {label: (encode MiB/s, decode MiB/s)}."""
    dev = torch.device("cuda", 0)
    n = stripe_bytes // K
    rng = np.random.default_rng(0)
    data = torch.from_numpy(rng.integers(0, 256, size=(stripes * K, n),
                                         dtype=np.uint8)).to(dev)
    codec = RSCodec(K, M, technique="cauchy", device="cpu")
    pmat = torch.from_numpy(codec.parity_mat).to(dev)
    D, _src = codec.decode_matrix(ERASURES)
    dmat = torch.from_numpy(np.ascontiguousarray(D)).to(dev)
    mib = stripes * K * n / 2**20
    out(f"device={torch.cuda.get_device_name(dev)}  gpu={nvidia_smi_line()}  "
        f"{stripes} x {K * n} B stripes, RS({K},{M}) cauchy, "
        f"erasures {ERASURES}")
    rows = {}

    want = {id(m): rs_kernels.gf_apply_stripes(m, data, stripes)
            for m in (pmat, dmat)}

    def report(label, fn):
        for m in (pmat, dmat):       # every variant computes the same bytes
            if not torch.equal(fn(m, data), want[id(m)]):
                raise AssertionError(f"{label} differs from gf_apply_stripes")
        enc = mib / per_op_seconds(fn, pmat, data)
        dec = mib / per_op_seconds(fn, dmat, data)
        out(f"{label}: encode {enc:8.0f} decode {dec:8.0f} MiB/s")
        rows[label] = (enc, dec)

    report("default", lambda m, d: rs_kernels.gf_apply_stripes(m, d, stripes))
    for stages, runs, bps in (QUICK_VARIANTS if quick else VARIANTS):
        report(f"stages={stages} runs={runs} blocks/sm={bps}",
               lambda m, d, s=stages, u=runs, b=bps:
               apply_variant(m, d, stripes, s, u, b))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sweep_stripes")
    ap.add_argument("--quick", action="store_true",
                    help="three variants instead of twelve")
    ap.add_argument("--stripes", type=int, default=64,
                    help="stripes of 1 MiB (default 64, bench.py's batch)")
    ap.add_argument("--stripe-bytes", type=int, default=STRIPE_BYTES,
                    help="bytes per stripe, a multiple of 8 (default 1 MiB)")
    args = ap.parse_args(argv)
    if args.stripes < 1:
        ap.error("--stripes must be at least 1")
    if args.stripe_bytes < K or args.stripe_bytes % K:
        ap.error(f"--stripe-bytes must be a positive multiple of {K}")
    if not torch.cuda.is_available():
        print("sweep_stripes: torch.cuda.is_available() is False; the sweep "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    sweep(args.stripes, args.quick, stripe_bytes=args.stripe_bytes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
