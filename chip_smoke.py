"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels of ``ceph_tpu_torch/ops/csrc`` with
``nvcc``, holds each against its plain PyTorch version on the card, then
drives the port end to end:

1. build     -- nvcc build time, card name and power limit;
2. kernels   -- every kernel against its plain version, bitwise, over a
                grid of (r, k), ragged widths and stripe counts;
3. ecutil    -- the torch_rs plugin through the port's registry (k=8, m=4,
                reed_sol_van, 4 KiB stripe unit) under ecutil.encode_many,
                hinfo_append and decode_many over 64 objects of 4 MiB,
                checked against the port's numpy path;
4. headline  -- rs_kernels.gf_apply_stripes over 64 x 1 MiB stripes
                (Cauchy RS(8,4), erasures {0, 9}) in the vertical layout,
                timed with CUDA events;
5. ec_bench  -- the ceph_erasure_code_benchmark CLI, encode and decode.

Each phase prints one JSON line; any failure raises and the script exits
non-zero.  Before the last line it prints the kernel table as one JSON
object and the card's ``nvidia-smi`` name and power limit; the last line
is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the package beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM device-memory rate (NVIDIA data sheet), for the bytes bound
HBM_BYTES_PER_S = 3.35e12
MIB = 1 << 20


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn`` over ``iters`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int16) - b.to(torch.int16)).abs().max().item())


def bytes_bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def rand_u8(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8,
                         device=device)


# -- phases ---------------------------------------------------------------------

def phase_build(cuda_build) -> dict:
    t0 = time.perf_counter()
    info = cuda_build.build_all()
    for name, v in info.items():
        print(f"# nvcc {name}.cu:\n{v['log']}", file=sys.stderr)
    return {"seconds": time.perf_counter() - t0,
            "per_source": {n: v["seconds"] for n, v in info.items()}}


def phase_kernels(K, dev) -> dict:
    """Each kernel against its plain version, bitwise, over the grid."""
    gen = torch.Generator(device=dev).manual_seed(1)
    shapes = [(r, k) for r in (1, 2, 4) for k in (2, 8, 20)]
    shapes += [(64, 128), (8, 200)]          # > 48 KB tables; k sliced
    worst = {"gf_apply": 0, "gf_apply_stripes": 0}
    cases = 0
    for r, k in shapes:
        mat = rand_u8(gen, (r, k), dev)
        for n in (1, 127, 1000, 131072):
            data = rand_u8(gen, (k, n), dev)
            err = max_abs_err(K.gf_apply(mat, data), K.gf_apply_plain(mat, data))
            worst["gf_apply"] = max(worst["gf_apply"], err)
            cases += 1
            for stripes in (1, 3, 64):
                if r * k > 100 and stripes * n > 3 * 131072:
                    continue                 # the plain version's memory
                vert = rand_u8(gen, (stripes * k, n), dev)
                err = max_abs_err(K.gf_apply_stripes(mat, vert, stripes),
                                  K.gf_apply_stripes_plain(mat, vert, stripes))
                worst["gf_apply_stripes"] = max(worst["gf_apply_stripes"], err)
                cases += 1
    # a contiguous view that is not 16-byte aligned takes the byte path
    base = rand_u8(gen, (8 * 4096 + 3,), dev)
    view = base[3:].view(8, 4096)
    mat = rand_u8(gen, (4, 8), dev)
    worst["gf_apply"] = max(worst["gf_apply"], max_abs_err(
        K.gf_apply(mat, view), K.gf_apply_plain(mat, view)))
    torch.cuda.synchronize()
    if any(worst.values()):
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{worst}")
    return {"cases": cases + 1, "max_abs_err": worst,
            "launches": dict(K.launches)}


def phase_ecutil(K, ecutil, registry_cls, dev, objects: int = 64,
                 obj_bytes: int = 4 * MIB) -> tuple[dict, dict]:
    """torch_rs -> ecutil.encode_many / hinfo_append / decode_many."""
    k, m, unit = 8, 4, 4096
    profile = {"k": str(k), "m": str(m), "technique": "reed_sol_van"}
    registry = registry_cls.instance()
    ec = registry.factory("torch_rs", "", profile | {"device": "cuda"})
    host = registry.factory("torch_rs", "", profile | {"device": "numpy"})
    sinfo = ecutil.StripeInfo(k, ec.get_chunk_size(k * unit))
    assert sinfo.chunk_size == unit, sinfo.chunk_size
    rng = np.random.default_rng(0)
    bufs = [rng.integers(0, 256, obj_bytes, dtype=np.uint8)
            for _ in range(objects)]
    lost_sets = ([0, 9], [1, 3, 8, 11])

    # the path proper, counted: warm the codec's tables first so the
    # counted run is the steady state a serving process sees
    ecutil.encode_many(sinfo, ec, bufs[:1])
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    shards = ecutil.encode_many(sinfo, ec, bufs)
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    hinfos = []
    for obj in shards:
        h = ecutil.HashInfo(k + m)
        ecutil.hinfo_append(h, 0, obj, ec)
        hinfos.append(h)
    t_crc = time.perf_counter() - t0
    decoded, t_dec = {}, {}
    for lost in lost_sets:
        batches = [{c: v for c, v in obj.items() if c not in lost}
                   for obj in shards]
        t0 = time.perf_counter()
        decoded[tuple(lost)] = ecutil.decode_many(sinfo, ec, batches)
        t_dec[str(lost)] = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = dict(K.launches)
    if launches["gf_apply"] < 1 + len(lost_sets):
        raise AssertionError(f"main path did not launch gf_apply: {launches}")

    # checks: round trip, and shards/HashInfo equal to the numpy path
    for lost, outs in decoded.items():
        for buf, out in zip(bufs, outs):
            if out != buf.tobytes():
                raise AssertionError(f"decode_many lost bytes for {lost}")
    want = ecutil.encode_many(sinfo, host, bufs)
    for got_obj, want_obj in zip(shards, want):
        for c in range(k + m):
            if not np.array_equal(got_obj[c], want_obj[c]):
                raise AssertionError(f"shard {c} differs from numpy path")
    for obj, h in zip(shards, hinfos):
        hh = ecutil.HashInfo(k + m)
        ecutil.hinfo_append(hh, 0, obj, host)
        if hh.to_dict() != h.to_dict():
            raise AssertionError("HashInfo differs from numpy path")

    # pieces of the encode call, timed alone: the host->card copy of the
    # packed [k, S*c] stream, the card->host copy of the parity, and one
    # object's crc32c rows on the card
    n = objects * obj_bytes // k
    packed = np.ascontiguousarray(rng.integers(0, 256, (k, n), np.uint8))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    data = ec.codec.to_device(packed)
    torch.cuda.synchronize()
    t_h2d = time.perf_counter() - t0
    mat = ec.codec.to_device(ec.codec.parity_mat)
    parity = K.gf_apply(mat, data)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    parity.cpu()
    t_d2h = time.perf_counter() - t0
    rows = ec.codec.to_device(np.stack([shards[0][c] for c in range(k + m)]))
    crc_ms = cuda_ms(lambda: K.crc32c_rows(rows), 5, warmup=1)

    total = objects * obj_bytes
    report = {
        "objects": objects, "object_bytes": obj_bytes,
        "stripe_unit": unit, "launches": launches,
        "encode_many_s": t_enc, "hinfo_append_s": t_crc,
        "decode_many_s": t_dec,
        "encode_many_MiBps": total / MIB / t_enc,
        "h2d_packed_s": t_h2d, "d2h_parity_s": t_d2h,
        "crc32c_rows_one_object_ms": crc_ms,
        "round_trip": True, "matches_numpy_path": True,
    }

    # the gf_apply kernel at the shape this path gives it: [k, S*c]
    err = max_abs_err(K.gf_apply(mat, data), K.gf_apply_plain(mat, data))
    if err:
        raise AssertionError(f"gf_apply disagrees at [{k}, {n}]: {err}")
    ms = cuda_ms(lambda: K.gf_apply(mat, data), 20)
    plain_ms = cuda_ms(lambda: K.gf_apply_plain(mat, data), 3, warmup=1)
    row = {"name": "gf_apply", "route": "cuda",
           "source": "ceph_tpu_torch/ops/csrc/gf_apply.cu",
           "replaces": "ceph_tpu/ops/pallas_kernels.py:156",
           "path": "ecutil", "shape": [m, k, n],
           "launches": launches["gf_apply"], "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bytes_bound_ms((k + m) * n), "bound_by": "bytes",
           "library_ms": None}
    del data, parity, rows
    torch.cuda.empty_cache()
    return report, row


def phase_headline(K, codec_cls, gfref, dev, batch: int = 64,
                   stripe_bytes: int = MIB) -> tuple[dict, dict]:
    """bench.py's shape: Cauchy RS(8,4), 64 x 1 MiB stripes, vertical
    layout [64*k, 128 KiB], encode and decode of erasures {0, 9}."""
    k, m, erasures = 8, 4, [0, 9]
    n = stripe_bytes // k
    rng = np.random.default_rng(0)
    host = rng.integers(0, 256, size=(batch * k, n), dtype=np.uint8)
    codec = codec_cls(k, m, technique="cauchy", device="cuda")
    data = codec.to_device(host)
    pmat = codec.to_device(codec.parity_mat)
    D, src = codec.decode_matrix(erasures)
    dmat = codec.to_device(D)
    torch.cuda.synchronize()

    K.reset_launches()
    parity = K.gf_apply_stripes(pmat, data, batch)
    # decode for real: survivors in src order, per stripe, vertical layout
    full = torch.cat([data.view(batch, k, n), parity.view(batch, m, n)], 1)
    survivors = full[:, src, :].reshape(batch * k, n).contiguous()
    rec = K.gf_apply_stripes(dmat, survivors, batch)
    torch.cuda.synchronize()
    launches = dict(K.launches)
    if launches["gf_apply_stripes"] < 2:
        raise AssertionError(f"headline did not launch the kernel: "
                             f"{launches}")
    want = full[:, erasures, :].reshape(batch * len(erasures), n)
    if not torch.equal(rec, want):
        raise AssertionError("headline decode did not recover {0, 9}")
    # the host reference on a few stripes
    par_h = parity.cpu().numpy()
    for s in sorted({0, batch // 2, batch - 1}):
        if not np.array_equal(par_h[s * m:(s + 1) * m],
                              gfref.apply_matrix(codec.parity_mat,
                                                 host[s * k:(s + 1) * k])):
            raise AssertionError(f"headline parity differs at stripe {s}")

    err = max(max_abs_err(parity, K.gf_apply_stripes_plain(pmat, data, batch)),
              max_abs_err(rec, K.gf_apply_stripes_plain(dmat, survivors,
                                                        batch)))
    if err:
        raise AssertionError(f"gf_apply_stripes disagrees: {err}")
    iters = 50
    enc_ms = cuda_ms(lambda: K.gf_apply_stripes(pmat, data, batch), iters)
    dec_ms = cuda_ms(lambda: K.gf_apply_stripes(dmat, data, batch), iters)
    plain_ms = cuda_ms(lambda: K.gf_apply_stripes_plain(pmat, data, batch),
                       3, warmup=1)
    payload_mib = batch * k * n / MIB
    enc_mibs = payload_mib / (enc_ms / 1e3)
    dec_mibs = payload_mib / (dec_ms / 1e3)
    enc_bound = bytes_bound_ms(batch * (k + m) * n)
    dec_bound = bytes_bound_ms(batch * (k + len(erasures)) * n)
    report = {
        "stripes": batch, "stripe_bytes": stripe_bytes, "k": k, "m": m,
        "erasures": erasures, "launches": launches,
        "encode_ms": enc_ms, "decode_ms": dec_ms,
        "encode_MiBps": enc_mibs, "decode_MiBps": dec_mibs,
        "combined_MiBps": 2.0 / (1.0 / enc_mibs + 1.0 / dec_mibs),
        "encode_bound_share": enc_bound / enc_ms,
        "decode_bound_share": dec_bound / dec_ms,
        "plain_encode_ms": plain_ms,
        "library": "no PyTorch call computes a GF(2^8) matrix apply",
    }
    row = {"name": "gf_apply_stripes", "route": "cuda",
           "source": "ceph_tpu_torch/ops/csrc/gf_apply.cu",
           "replaces": "ceph_tpu/ops/pallas_kernels.py:80",
           "path": "headline", "shape": [m, k, n, batch],
           "launches": launches["gf_apply_stripes"], "max_abs_err": err,
           "ms": enc_ms, "plain_ms": plain_ms, "bound_ms": enc_bound,
           "bound_by": "bytes", "library_ms": None}
    return report, row


_BENCH_LINE = re.compile(r"^(\d+\.\d{6})\t(\d+)$")


def phase_ec_bench() -> dict:
    base = [sys.executable, "-m", "ceph_tpu_torch.bench.ec_bench",
            "--plugin", "torch_rs", "--size", "1048576", "-P", "k=8",
            "-P", "m=4", "--batch", "64", "--device-resident",
            "--iterations", "5"]
    out = {}
    for workload, extra in (("encode", []),
                            ("decode", ["--erased", "0", "--erased", "9"])):
        proc = subprocess.run(base + ["--workload", workload] + extra,
                              cwd=HERE, capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"ec_bench {workload} failed:\n{proc.stderr}")
        lines = proc.stdout.strip().splitlines()
        match = _BENCH_LINE.match(lines[-1]) if lines else None
        if len(lines) != 1 or not match:
            raise AssertionError(f"ec_bench {workload} output: {lines}")
        seconds, kib = float(match.group(1)), int(match.group(2))
        if kib != 5 * 64 * 1024 or seconds <= 0:
            raise AssertionError(f"ec_bench {workload}: {lines[0]!r}")
        out[workload] = {"line": lines[0], "MiBps": kib / 1024 / seconds}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port's "
              "kernels run only on a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import ceph_tpu_torch
    if not os.path.abspath(ceph_tpu_torch.__file__).startswith(HERE + os.sep):
        raise RuntimeError(f"ceph_tpu_torch imported from "
                           f"{ceph_tpu_torch.__file__}, not from {HERE}")
    from ceph_tpu_torch.backend import ecutil
    from ceph_tpu_torch.gf import ref as gfref
    from ceph_tpu_torch.ops import cuda_build
    from ceph_tpu_torch.ops import rs_kernels as K
    from ceph_tpu_torch.ops.codec import RSCodec
    from ceph_tpu_torch.plugins.registry import ErasureCodePluginRegistry

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)

    emit("build", **phase_build(cuda_build), gpu=smi,
         torch=torch.__version__, cuda=torch.version.cuda)
    emit("kernels", **phase_kernels(K, dev))
    ecu, row_apply = phase_ecutil(K, ecutil, ErasureCodePluginRegistry, dev)
    emit("ecutil", **ecu, gpu=smi)
    head, row_stripes = phase_headline(K, RSCodec, gfref, dev)
    emit("headline", **head, gpu=smi)
    emit("ec_bench", **phase_ec_bench(), gpu=smi)

    print(json.dumps({"kernels": [row_apply, row_stripes]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
