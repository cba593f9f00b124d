"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels of ``ceph_tpu_torch/ops/csrc`` with
``nvcc``, holds each against its plain PyTorch version on the card, then
drives the port end to end:

1. build     -- nvcc build time of every source, card name and power
                limit;
2. kernels   -- every kernel against its plain version, bitwise, over a
                grid of shapes (output rows past 4, k past 128, the
                repair path's k = 1 and alpha x d), ragged widths, stripe
                counts and unaligned views; xor_apply in the density
                rule's form and in both forms named; crc32c_rows (r 0, 1,
                12; ragged n up to 1 MiB + 5; an unaligned and a strided
                row view); then the crc and bit-plane kernels at the
                edges of their work split (rows of one warp unit and one
                byte either side, shorter than a lane's run, more units
                than the grid has warps, unaligned strided views; G*r and
                G*round_up(k, 4) at their limits, ragged N);
3. ecutil    -- the torch_rs plugin through the port's registry (k=8, m=4,
                reed_sol_van, 4 KiB stripe unit) under ecutil.encode_many,
                hinfo_append (one crc32c kernel launch each) and
                decode_many over 64 objects of 4 MiB, checked against the
                port's numpy path; the fused encode + checksum on the
                packed [8, 32 Mi] stream against gf_apply and the host
                crc32c; crc32c_rows of one object and of all 64 in one
                call, host-paced, as device time (torch.profiler and a
                CUDA graph replay) and as the whole call;
4. repair    -- the repair path on the same codec and 64 objects of 4 MiB:
                (a) recovery waves (decode_shards_many, want {3} and
                {0, 9}, the k survivors minimum_to_decode picks) through a
                depth-4 CodecPipeline and with none, every rebuilt shard
                against the encode's and its crc32c against the stored
                HashInfo on the card; (b) chain repair, eight hops of
                partial_sum_accumulate over the 32 MiB shard streams
                for one and two lost shards, each hop through the pipeline
                and again called with its defaults (synchronous, on the
                card), each against the host hop; (c) pm_regen k=3 m=2 d=4, MBR and
                MSR, every object's chunk 0 rebuilt from four helpers'
                regen_project and the newcomer's regen_combine through the
                pipeline; (d) clay k=8 m=4 d=11 (torch_rs) and lrc k=8 m=4
                l=6 on 8 objects: encode and repair of shard 1 against the
                numpy path;
5. serving   -- the serving path at RBD-on-EC size: ServingEngine (option
                defaults: depth-4 CUDA codec pipeline, 64-op batches, 2 ms
                deadline, 64 MiB throttle) over torch_rs k=8 m=4 with no
                device key, 4 KiB stripe unit, 4 MiB objects, closed_loop
                at concurrency 16: (a) 256 encodes and 256 degraded reads
                ({0, 9} lost), every op checked, gf_apply launches equal
                to the device batches, no pipeline error; (b) pipeline
                depth 0 (synchronous) against depth 4; (c) 4 KiB ops,
                k=4 m=2, batched against unbatched (bench.py's serving
                comparison), 8192 ops an arm, three times, every 16th op
                checked;
6. headline  -- rs_kernels.gf_apply_stripes over 64 x 1 MiB stripes
                (Cauchy RS(8,4), erasures {0, 9}) in the vertical layout,
                timed with CUDA events;
7. jerasure  -- the jerasure plugin on the xor_apply kernel under
                ecutil.encode_many, hinfo_append and decode_many over 64
                objects of 4 MiB, for liber8tion k=8 and reed_sol_van k=8
                m=4 w=16, checked against the port's numpy path; then the
                isa and shec plugins on the gf_apply kernel over 8 objects;
8. shapes    -- gf_apply, gf_apply_stripes, xor_apply and crc32c_rows at
                every shape phases 3-7 launch them at, and the sweep's
                five bit-plane variants (ceph_tpu_torch/tools/
                path_shapes.py): bitwise against the plain version, CUDA
                events, device time where the tools give it, bound, and
                the copy ceiling moving the same bytes;
9. ec_bench  -- the ceph_erasure_code_benchmark CLI: torch_rs encode and
                decode, the default invocation, a liber8tion encode;
10. sweep    -- the kernel sweep (ceph_tpu_torch.tools.kernel_sweep) in
                process at full size, Cauchy RS(8,4) over [8, 8 Mi]: copy
                ceiling, tensor-core bit-plane apply in int8 and bf16,
                block-diagonal stacks of 2 and 4 tiles, bitslice and
                gf_apply; every row must be a number.  Then the same tool
                once as a subprocess with --quick, the gf_apply launch
                variants once (ceph_tpu_torch.tools.sweep_stripes
                --quick), and the three sweep kernels timed at [4, 8] x
                [8, 8 Mi];
11. placement -- CRUSH bulk placement on a 1024-OSD straw2 map (8 racks x
                8 hosts x 16 OSDs, optimal tunables) with pools rep3
                (chooseleaf firstn host, size 3) and ec84 (chooseleaf
                indep 12 host) of 2^20 PGs each: (a) every straw2 golden
                run of the reference C through the crush_straw2 kernel;
                (b) the kernel against its plain version, bitwise, at
                2^20 x's for both pools, plain, with reweights (5% out,
                10% at half) and with a one-position compat weight set,
                and its CUDA-event ms; then at 2^20 random x's a map with
                weights of 2^32, 2^40 and 2^48 + 1 (the rep3 rule) and
                chooseleaf indep and firstn rules of 20 hosts (past
                the kernel's shared-memory state); (c) 4096 x's of each
                pool against the host interpreter and 256 PGs against the
                scalar OSDMap chain; (d) BulkPGMapper.map_pool of each
                pool (pps, map, post-chain seconds) and
                osdmaptool.test_map_pgs over both; (e) calc_weight_set and
                calc_pg_upmaps on rep3 at 2^15 PGs; (f) the kernel's bound
                from the plain version's draw count at the least issue
                time of a draw's instructions (path_shapes.py), and the
                kernel's draw loop recounted from cuobjdump -sass: the
                phase fails if the build needs less than that bound.
                Sub-phases print placement.<name> lines.

Each phase prints one JSON line; any failure raises and the script exits
non-zero.  Before the last line it prints the kernel table as one JSON
object and the card's ``nvidia-smi`` name and power limit; the last line
is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the package beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM device-memory rate and dense tensor-core peaks (NVIDIA data
# sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12
TENSOR_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12}
MIB = 1 << 20
NO_LIBRARY = ("no PyTorch call computes a GF(2^8) matrix apply or a GF(2) "
              "XOR matmul")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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
    wide = torch.int64 if a.dtype == torch.int64 else torch.int16
    return int((a.to(wide) - b.to(wide)).abs().max().item())


def bytes_bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def rand_u8(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8,
                         device=device)


# -- phases -------------------------------------------------------------------

def phase_build(cuda_build) -> dict:
    t0 = time.perf_counter()
    info = cuda_build.build_all()
    for name, v in info.items():
        print(f"# nvcc {name}.cu:\n{v['log']}", file=sys.stderr)
    return {"seconds": time.perf_counter() - t0,
            "per_source": {n: v["seconds"] for n, v in info.items()}}


def sweep_kernel_grid(SK, K, dev, gen) -> tuple[dict, int]:
    """The sweep kernels against their plain versions, bitwise: (r, k) x N
    x tile_n x acc x groups, the copy, and an unaligned view each."""
    worst = {"bitplane_apply": 0, "bitplane_apply_bd": 0, "copy_rows": 0}
    cases = 0

    def check(name, got, want):
        nonlocal cases
        worst[name] = max(worst[name], max_abs_err(got, want))
        cases += 1

    for r, k in ((1, 2), (2, 6), (4, 8), (8, 16)):
        bmat = K.expand_bits_plane_major(rand_u8(gen, (r, k), dev))
        bds = {g: torch.block_diag(*[bmat] * g) for g in (2, 4)}
        for n in (1, 127, 1000, 131072, 8192 * 4 * 3):
            data = rand_u8(gen, (k, n), dev)
            want = SK.bitplane_apply_plain(bmat, data, r, k)
            for tile in (2048, 8192):
                for acc in ("int8", "bf16"):
                    check("bitplane_apply",
                          SK.bitplane_apply(bmat, data, r, k, acc, tile), want)
                    for g, bd in bds.items():
                        check("bitplane_apply_bd",
                              SK.bitplane_apply_bd(bd, data, r, k, g, acc,
                                                   tile),
                              SK.bitplane_apply_bd_plain(bd, data, r, k, g,
                                                         tile))
                check("copy_rows", SK.copy_rows(data, r, tile),
                      SK.copy_rows_plain(data, r))
    # a contiguous view that is not 16-byte aligned takes the byte paths
    base = rand_u8(gen, (8 * 4096 + 3,), dev)
    view = base[3:].view(8, 4096)
    bmat = K.expand_bits_plane_major(rand_u8(gen, (4, 8), dev))
    bd = torch.block_diag(*[bmat] * 4)
    for acc in ("int8", "bf16"):
        check("bitplane_apply", SK.bitplane_apply(bmat, view, 4, 8, acc, 2048),
              SK.bitplane_apply_plain(bmat, view, 4, 8))
        check("bitplane_apply_bd",
              SK.bitplane_apply_bd(bd, view, 4, 8, 4, acc, 256),
              SK.bitplane_apply_bd_plain(bd, view, 4, 8, 4, 256))
    check("copy_rows", SK.copy_rows(view, 4, 2048), SK.copy_rows_plain(view, 4))
    return worst, cases


def phase_kernels(K, SK, dev, decode_bitmatrices) -> dict:
    """Each kernel against its plain version, bitwise, over the grid."""
    gen = torch.Generator(device=dev).manual_seed(1)
    shapes = [(r, k) for r in (1, 2, 4) for k in (2, 8, 20)]
    shapes += [(64, 128), (8, 200)]          # > 48 KB tables; k sliced
    # the packed tables' row groups past 4 rows, and sliced tables at k > 128
    shapes += [(5, 8), (8, 20), (4, 252)]
    # the repair path's narrow matrices: a chain hop [r, 1], the regen legs
    # [1, alpha] and [alpha, d]
    shapes += [(1, 1), (2, 1), (4, 1), (1, 2), (2, 4), (1, 4), (4, 4)]
    worst = {"gf_apply": 0, "gf_apply_stripes": 0, "xor_apply": 0,
             "xor_apply_direct": 0, "xor_apply_tables": 0,
             "crc32c_rows": 0}
    cases = 0

    def check(name, got, want):
        nonlocal cases
        worst[name] = max(worst[name], max_abs_err(got, want))
        cases += 1

    # xor_apply: random 0/1 W from RAID-6 w=2..w=32 widths, and the dense
    # decode matrices of the jerasure phase's profiles; every W in the
    # density rule's form and in both forms named
    bitmats = [torch.randint(0, 2, rk, generator=gen, dtype=torch.uint8,
                             device=dev)
               for rk in ((2, 6), (14, 28), (16, 64), (64, 128), (128, 256))]
    bitmats += [torch.from_numpy(D).to(dev) for D in decode_bitmatrices]
    # two passes of 128 output rows; no input rows
    bitmats += [torch.randint(0, 2, rk, generator=gen, dtype=torch.uint8,
                              device=dev) for rk in ((200, 40), (3, 0))]
    for i, W in enumerate(bitmats):
        for p in (1, 127, 1000, 131072) + ((512 * 7 + 16,) if i >= 5 else ()):
            packets = rand_u8(gen, (W.shape[1], p), dev)
            want = K.xor_apply_plain(W, packets)
            check("xor_apply", K.xor_apply(W, packets), want)
            for form in ("direct", "tables"):
                check(f"xor_apply_{form}",
                      K.xor_apply_form(W, packets, form), want)
    base = rand_u8(gen, (64 * 4096 + 5,), dev)
    view = base[5:].view(64, 4096)           # 16-byte loads not legal
    want = K.xor_apply_plain(bitmats[2], view)
    check("xor_apply", K.xor_apply(bitmats[2], view), want)
    for form in ("direct", "tables"):
        check(f"xor_apply_{form}", K.xor_apply_form(bitmats[2], view, form),
              want)
    for r, k in shapes:
        mat = rand_u8(gen, (r, k), dev)
        for n in (1, 127, 1000, 131072):
            data = rand_u8(gen, (k, n), dev)
            check("gf_apply", K.gf_apply(mat, data),
                  K.gf_apply_plain(mat, data))
            for stripes in (1, 3, 64):
                if r * k > 100 and stripes * n > 3 * 131072:
                    continue                 # the plain version's memory
                vert = rand_u8(gen, (stripes * k, n), dev)
                check("gf_apply_stripes", K.gf_apply_stripes(mat, vert,
                                                             stripes),
                      K.gf_apply_stripes_plain(mat, vert, stripes))
    # a contiguous view that is not 16-byte aligned takes the byte path
    base = rand_u8(gen, (8 * 4096 + 3,), dev)
    view = base[3:].view(8, 4096)
    for r in (4, 6):
        mat = rand_u8(gen, (r, 8), dev)
        check("gf_apply", K.gf_apply(mat, view), K.gf_apply_plain(mat, view))
    # crc32c rows: no rows, one, one object's twelve; ragged widths, a row
    # view that is not 16-byte aligned and every other row of a block
    for r in (0, 1, 12):
        for n in (1, 7, 127, 4096, 4099, 512 * 1024, MIB + 5):
            rows = rand_u8(gen, (r, n), dev)
            check("crc32c_rows", K.crc32c_rows(rows),
                  K.crc32c_rows_plain(rows))
    check("crc32c_rows", K.crc32c_rows(view), K.crc32c_rows_plain(view))
    block = rand_u8(gen, (24, 4096), dev)
    check("crc32c_rows", K.crc32c_rows(block[::2]),
          K.crc32c_rows_plain(block[::2]))
    sweep_worst, sweep_cases = sweep_kernel_grid(SK, K, dev, gen)
    worst |= sweep_worst
    edge_worst, edge_cases = boundary_cases(K, SK, dev, gen)
    for name, err in edge_worst.items():
        worst[name] = max(worst[name], err)
    torch.cuda.synchronize()
    if any(worst.values()):
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{worst}")
    return {"cases": cases + sweep_cases + edge_cases,
            "boundary_cases": edge_cases, "max_abs_err": worst,
            "launches": dict(K.launches) | dict(SK.launches)}


def boundary_cases(K, SK, dev, gen) -> tuple[dict, int]:
    """The crc and bit-plane kernels at the edges of their work split,
    bitwise against their plain versions: crc rows of one warp unit, one
    less and one more byte, shorter than a lane's run, more units than the
    persistent grid has warps, unaligned and strided views; bit-plane
    stacks with G*r and G*round_up(k, 4) at their limits, ragged N."""
    worst = {"crc32c_rows": 0, "bitplane_apply": 0, "bitplane_apply_bd": 0}
    cases = 0

    def check(name, got, want):
        nonlocal cases
        worst[name] = max(worst[name], max_abs_err(got, want))
        cases += 1

    span = K.CRC_SPAN
    for r, n in [(r, n) for r in (1, 2, 12)
                 for n in (span - 1, span, span + 1, 100, K.CRC_RUN + 2)]:
        rows = rand_u8(gen, (r, n), dev)
        check("crc32c_rows", K.crc32c_rows(rows), K.crc32c_rows_plain(rows))
    for r, n in ((3000, span + 1), (2200, 1)):    # more units than warps
        rows = rand_u8(gen, (r, n), dev)
        check("crc32c_rows", K.crc32c_rows(rows), K.crc32c_rows_plain(rows))
    flat = rand_u8(gen, (12 * 2001 + 1,), dev)
    for view in (flat[1:].view(12, 2001)[:, :2000],    # unaligned, strided
                 flat[:12 * 2001].view(12, 2001)[:, 3:],
                 flat[5:5 + 3 * span].view(3, span)):
        check("crc32c_rows", K.crc32c_rows(view), K.crc32c_rows_plain(view))
    for r, k, g in ((32, 5, 1), (1, 64, 1), (16, 13, 2), (3, 13, 4),
                    (8, 16, 4)):
        bmat = K.expand_bits_plane_major(rand_u8(gen, (r, k), dev))
        bd = torch.block_diag(*[bmat] * g)
        for n in (8192 * 3 + 77, 64 * 5 + 1):
            data = rand_u8(gen, (k, n), dev)
            for acc in ("int8", "bf16"):
                for tile in (256, 8192):
                    if g == 1:
                        check("bitplane_apply",
                              SK.bitplane_apply(bmat, data, r, k, acc, tile),
                              SK.bitplane_apply_plain(bmat, data, r, k))
                    else:
                        check("bitplane_apply_bd",
                              SK.bitplane_apply_bd(bd, data, r, k, g, acc,
                                                   tile),
                              SK.bitplane_apply_bd_plain(bd, data, r, k, g,
                                                         tile))
    return worst, cases


def _run_stripe_path(K, ecutil, ec, host, sinfo, bufs, lost_sets,
                     kernel: str) -> dict:
    """encode_many, hinfo_append and decode_many through ``ec`` with the
    launch counts zeroed just before and read just after; then the round
    trip and shards/HashInfo against the ``host`` (numpy) plugin.  Returns
    the report and the shards."""
    n = ec.get_chunk_count()
    # warm the plugin's matrices on the card first, so the counted run is
    # the steady state a serving process sees
    ecutil.encode_many(sinfo, ec, bufs[:1])
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    shards = ecutil.encode_many(sinfo, ec, bufs)
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    hinfos = []
    for obj in shards:
        h = ecutil.HashInfo(n)
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
    if launches[kernel] < 1 + len(lost_sets):
        raise AssertionError(f"{ec.get_profile()} did not launch {kernel} "
                             f"on every call: {launches}")
    # one crc32c kernel launch per hinfo_append where the plugin has a
    # tensor codec (the jerasure bitmatrix and shec codes checksum on the
    # host, as in the JAX package)
    crc_calls = len(shards) if hasattr(ec, "device_codec") else 0
    if launches["crc32c_rows"] != crc_calls:
        raise AssertionError(f"{launches['crc32c_rows']} crc32c_rows "
                             f"launches for {crc_calls} hinfo_append calls")
    for lost, outs in decoded.items():
        for buf, out in zip(bufs, outs):
            if out != buf.tobytes():
                raise AssertionError(f"decode_many lost bytes for {lost}")
    want = ecutil.encode_many(sinfo, host, bufs)
    for got_obj, want_obj in zip(shards, want):
        for c in range(n):
            if not np.array_equal(got_obj[c], want_obj[c]):
                raise AssertionError(f"shard {c} differs from numpy path")
    for obj, h in zip(shards, hinfos):
        hh = ecutil.HashInfo(n)
        ecutil.hinfo_append(hh, 0, obj, host)
        if hh.to_dict() != h.to_dict():
            raise AssertionError("HashInfo differs from numpy path")
    total = sum(len(b) for b in bufs)
    return {"objects": len(bufs), "chunk_size": sinfo.chunk_size,
            "launches": launches, "encode_many_s": t_enc,
            "hinfo_append_s": t_crc, "decode_many_s": t_dec,
            "encode_many_MiBps": total / MIB / t_enc,
            "round_trip": True, "matches_numpy_path": True}, shards


def phase_ecutil(K, ecutil, registry_cls, objects: int = 64,
                 obj_bytes: int = 4 * MIB) -> tuple[dict, int]:
    """torch_rs -> ecutil.encode_many / hinfo_append / decode_many; the
    report and the gf_apply launches of the path."""
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
    stripe, shards = _run_stripe_path(K, ecutil, ec, host, sinfo, bufs,
                                      ([0, 9], [1, 3, 8, 11]), "gf_apply")
    launches = stripe["launches"]

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
    # one object's crcs three ways: the launch alone, host-paced (20 back
    # to back into an output allocated once); its device time (under
    # torch.profiler, and 20 launches replayed from a CUDA graph); the
    # whole crc32c_rows call (output allocation, launch)
    from ceph_tpu_torch.tools.path_shapes import device_ms
    words = torch.empty(k + m, dtype=torch.int64, device=rows.device)
    launch = lambda: K.crc32c_rows_into(rows, words)     # noqa: E731
    crc_ms = cuda_ms(launch, 20)
    crc_device = device_ms(launch, "crc32c_rows_kernel")
    crc_wrapper_ms = cuda_ms(lambda: K.crc32c_rows(rows), 20)
    crc_plain_ms = cuda_ms(lambda: K.crc32c_rows_plain(rows), 3, warmup=1)
    # every object's rows in one call: the kernel at a size where the
    # launch does not dominate
    all_rows = rows.repeat(objects, 1)
    all_words = torch.empty(all_rows.shape[0], dtype=torch.int64,
                            device=rows.device)
    crc_all_ms = cuda_ms(lambda: K.crc32c_rows(all_rows), 10)
    crc_all_device = device_ms(
        lambda: K.crc32c_rows_into(all_rows, all_words), "crc32c_rows_kernel",
        10)

    # the fused encode + checksum on the packed stream: parity and the
    # 12 row crcs against gf_apply and the host crc32c
    fused_parity, crcs = K.gf_encode_with_crc(mat, data)
    if not torch.equal(fused_parity, parity):
        raise AssertionError("gf_encode_with_crc parity != gf_apply")
    par_h = parity.cpu().numpy()
    host = [ecutil.crc32c(0, row) for row in (*packed, *par_h)]
    if crcs.cpu().tolist() != host:
        raise AssertionError("gf_encode_with_crc crcs != host crc32c")
    fused_ms = cuda_ms(lambda: K.gf_encode_with_crc(mat, data), 10)
    apply_ms = cuda_ms(lambda: K.gf_apply(mat, data), 10)
    codec_parity, codec_crcs = ec.codec.encode_with_crc(packed[:, :MIB])
    if not (np.array_equal(codec_parity, par_h[:, :MIB])
            and [int(c) for c in codec_crcs] == [
                ecutil.crc32c(0, row) for row in (*packed[:, :MIB],
                                                  *par_h[:, :MIB])]):
        raise AssertionError("RSCodec.encode_with_crc disagrees")

    report = {**stripe, "object_bytes": obj_bytes, "stripe_unit": unit,
              "h2d_packed_s": t_h2d, "d2h_parity_s": t_d2h,
              "crc32c_rows_one_object_ms": crc_ms,
              "crc32c_rows_one_object_device": crc_device,
              "crc32c_rows_one_object_wrapper_ms": crc_wrapper_ms,
              "crc32c_rows_plain_one_object_ms": crc_plain_ms,
              "crc32c_rows_all_objects_one_call_ms": crc_all_ms,
              "crc32c_rows_all_objects_device": crc_all_device,
              "crc32c_rows_all_objects_shape": list(all_rows.shape),
              "crc32c_rows_bytes_bound_ms": {
                  "one_object": bytes_bound_ms(rows.numel() + 8 * (k + m)),
                  "all_objects": bytes_bound_ms(all_rows.numel()
                                                + 8 * all_rows.shape[0])},
              "encode_with_crc": {"shape": [k + m, n], "ms": fused_ms,
                                  "gf_apply_ms": apply_ms,
                                  "matches_gf_apply_and_host_crc": True}}
    del data, parity, rows, words, fused_parity, all_rows, all_words
    torch.cuda.empty_cache()
    return report, launches["gf_apply"], launches["crc32c_rows"]


# -- phase repair ---------------------------------------------------------------

def _wave(ecutil, sinfo, ec, shards, hinfos, want, pipeline) -> dict:
    """(a) one recovery wave: every object offers the k survivors
    ``minimum_to_decode`` picks and asks for ``want``; through
    ``pipeline`` (or None: the plugin's synchronous decode) with every
    rebuilt shard held against the encode's.  The pipeline's result is
    also checksummed on the card (``hinfo_append`` over the rebuilt
    shards) against each object's stored HashInfo."""
    n = ec.get_chunk_count()
    avail = sorted(ec.minimum_to_decode(set(want), set(range(n)) - want))
    batches = [({c: obj[c] for c in avail}, set(want)) for obj in shards]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec = ecutil.decode_shards_many(sinfo, ec, batches, pipeline=pipeline)
    elapsed = time.perf_counter() - t0
    for obj, got in zip(shards, rec):
        if sorted(got) != sorted(want) or any(
                not np.array_equal(got[c], obj[c]) for c in want):
            raise AssertionError(f"recovery wave {sorted(want)} differs")
    out = {"want": sorted(want), "sources": avail, "seconds": elapsed,
           "rebuilt_MiBps": sum(got[c].nbytes for got in rec for c in want)
           / MIB / elapsed}
    if pipeline is not None:
        t0 = time.perf_counter()
        for got, stored in zip(rec, hinfos):
            h = ecutil.HashInfo(n)
            ecutil.hinfo_append(h, 0, got, ec)
            if any(h.get_chunk_hash(c) != stored.get_chunk_hash(c)
                   for c in want):
                raise AssertionError("rebuilt shard's crc32c != HashInfo")
        out["hash_check_s"] = time.perf_counter() - t0
    return out


def _chain(K, ecutil, ec, shards, lost, pipeline) -> dict:
    """(b) one chain repair: eight hops of ``partial_sum_accumulate`` over
    the objects' concatenated shard streams, each a dispatch through the
    pipeline on the card, then the same hop called with no pipeline (the
    default: synchronous, on the card), each held against the host hop;
    the last hop's sums must be the lost shards."""
    n = ec.get_chunk_count()
    sources = sorted(set(range(n)) - lost)[:ec.get_data_chunk_count()]
    coeffs, rows = ec.partial_sum_coefficients(lost, sources)
    streams = {c: np.concatenate([obj[c] for obj in shards])
               for c in sources}
    acc = sync_acc = host_acc = None
    hops, sync_hops, launched = [], [], K.launches["gf_apply"]
    for src in sources:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc = ecutil.partial_sum_accumulate(coeffs[src], streams[src], acc,
                                            pipeline=pipeline)
        hops.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        sync_acc = ecutil.partial_sum_accumulate(coeffs[src], streams[src],
                                                 sync_acc)
        sync_hops.append(time.perf_counter() - t0)
        host_acc = ecutil.partial_sum_accumulate(coeffs[src], streams[src],
                                                 host_acc, device="numpy")
        if acc != host_acc or sync_acc != host_acc:
            raise AssertionError(f"chain hop {src} differs from the host")
    for r, e in enumerate(rows):
        if acc[r] != np.concatenate([obj[e] for obj in shards]).tobytes():
            raise AssertionError(f"chain repair of {e} differs")
    return {"lost": sorted(lost), "hops": len(hops),
            "hop_bytes": int(streams[sources[0]].nbytes),
            "seconds_per_hop": hops, "mean_hop_s": sum(hops) / len(hops),
            "sync_seconds_per_hop": sync_hops,
            "sync_mean_hop_s": sum(sync_hops) / len(sync_hops),
            "gf_apply_launches": K.launches["gf_apply"] - launched,
            "launch_shape": [len(rows), 1, int(streams[sources[0]].nbytes)]}


def _regen(ecutil, registry, mode, bufs, pipeline) -> dict:
    """(c) regenerating repair on pm_regen k=3 m=2 d=4: encode every object
    on the card, then rebuild chunk 0 of each from four helpers' projections
    and the newcomer's combine, each a dispatch through the pipeline."""
    profile = {"k": "3", "m": "2", "d": "4", "mode": mode}
    ec = registry.factory("pm_regen", "", profile | {"device": "cuda"})
    host = registry.factory("pm_regen", "", profile | {"device": "numpy"})
    n, alpha = ec.get_chunk_count(), ec.get_sub_chunk_count()
    t0 = time.perf_counter()
    encoded = [ec.encode(set(range(n)), buf) for buf in bufs]
    t_enc = time.perf_counter() - t0
    for buf, enc in zip(bufs[:2], encoded):
        want = host.encode(set(range(n)), buf)
        if any(not np.array_equal(enc[c], want[c]) for c in range(n)):
            raise AssertionError(f"pm_regen {mode} encode != numpy")
    lost = 0
    helpers = ec.minimum_to_repair(lost, ec.d, {c: 1 for c in range(1, n)})
    proj = ec.repair_projection(lost).tobytes()
    comb = ec.repair_combine(lost, helpers).tobytes()
    wire = repaired = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for enc in encoded:
        betas = [ecutil.regen_project(proj, enc[h], alpha, pipeline=pipeline)
                 for h in helpers]
        out = ecutil.regen_combine(comb, betas, alpha, pipeline=pipeline)
        if out != enc[lost].tobytes():
            raise AssertionError(f"pm_regen {mode} repair differs")
        wire += sum(len(b) for b in betas)
        repaired += len(out)
    t_rep = time.perf_counter() - t0
    return {"mode": mode, "profile": profile, "alpha": alpha,
            "stored_chunk_bytes": int(encoded[0][0].nbytes),
            "encode_s": t_enc, "repair_s": t_rep,
            "repaired_MiBps": repaired / MIB / t_rep,
            "wire_bytes_per_repaired_byte": wire / repaired,
            "helpers": helpers}


def _sub_repair(ecutil, ec, host, bufs, lost: int, fractional: bool
                ) -> dict:
    """(d) clay or lrc: encode each object on the card and on the numpy
    path, then repair data shard ``lost`` from what ``minimum_to_decode``
    asks for (clay: sub-chunk runs of d helpers), bitwise against the
    numpy path's repair and the stored shard."""
    n = ec.get_chunk_count()
    t0 = time.perf_counter()
    encoded = [ec.encode(set(range(n)), buf) for buf in bufs]
    t_enc = time.perf_counter() - t0
    t_rep = 0.0
    for buf, enc in zip(bufs, encoded):
        want = host.encode(set(range(n)), buf)
        if any(not np.array_equal(enc[c], want[c]) for c in range(n)):
            raise AssertionError(f"{ec.get_profile()} encode != numpy")
        minimum = ec.minimum_to_decode({lost}, set(range(n)) - {lost})
        chunk = len(enc[lost])
        sub = ec.get_sub_chunk_count()
        reads = {c: np.concatenate([enc[c].reshape(sub, -1)[o:o + k]
                                    for o, k in runs]).reshape(-1)
                 for c, runs in minimum.items()}
        size = chunk if fractional else 0
        t0 = time.perf_counter()
        got = ecutil.decode_shards(None, ec, reads, {lost}, size)
        t_rep += time.perf_counter() - t0
        ref = ecutil.decode_shards(None, host, reads, {lost}, size)
        if not (np.array_equal(got[lost], enc[lost])
                and np.array_equal(got[lost], ref[lost])):
            raise AssertionError(f"{ec.get_profile()} repair differs")
    read = sum(v.nbytes for v in reads.values())
    return {"objects": len(bufs), "chunk_bytes": chunk, "lost": lost,
            "helpers": len(reads), "encode_s": t_enc, "repair_s": t_rep,
            "read_bytes_per_repaired_byte": read / chunk}


def phase_repair(K, ecutil, registry_cls, pipeline_cls, objects: int = 64,
                 obj_bytes: int = 4 * MIB) -> tuple[dict, int, int]:
    """The repair path at RBD object size: torch_rs RS(8,4) reed_sol_van,
    4 KiB stripe unit, 64 objects of 4 MiB.  (a) recovery waves, (b) chain
    repair, (c) pm_regen regenerating repair, (d) clay and lrc; launch
    counts zeroed after the objects are encoded and read at the end.
    Returns the report and the gf_apply and crc32c_rows launches."""
    k, m, unit = 8, 4, 4096
    registry = registry_cls.instance()
    profile = {"k": str(k), "m": str(m), "technique": "reed_sol_van"}
    ec = registry.factory("torch_rs", "", profile | {"device": "cuda"})
    sinfo = ecutil.StripeInfo(k, ec.get_chunk_size(k * unit))
    rng = np.random.default_rng(6)
    bufs = [rng.integers(0, 256, obj_bytes, dtype=np.uint8)
            for _ in range(objects)]
    shards = ecutil.encode_many(sinfo, ec, bufs)
    hinfos = []
    for obj in shards:
        h = ecutil.HashInfo(k + m)
        ecutil.hinfo_append(h, 0, obj, ec)
        hinfos.append(h)
    pipeline = pipeline_cls(depth=4, name="smoke.repair")
    torch.cuda.synchronize()
    K.reset_launches()
    try:
        waves = []
        for want in ({3}, {0, 9}):
            # in turns: depth 4, none, none, depth 4 (the first wave also
            # pays the first pinned allocations of its size)
            turns = [_wave(ecutil, sinfo, ec, shards, hinfos, want, pl)
                     for pl in (pipeline, None, None, pipeline)]
            waves.append({"order": "depth 4, none, none, depth 4",
                          "pipeline_depth_4": [turns[0], turns[3]],
                          "no_pipeline": [turns[1], turns[2]]})
        chains = [_chain(K, ecutil, ec, shards, lost, pipeline)
                  for lost in ({3}, {0, 9})]
        regen = [_regen(ecutil, registry, mode, bufs, pipeline)
                 for mode in ("mbr", "msr")]
        before = dict(K.launches)
        sub = {}
        for name, prof, fractional in (
                ("clay", {"k": "8", "m": "4", "d": "11",
                          "scalar_mds": "torch_rs"}, True),
                ("lrc", {"k": "8", "m": "4", "l": "6"}, False)):
            at = K.launches["gf_apply"]
            card = registry.factory(name, "", prof | {"device": "cuda"})
            host = registry.factory(name, "", prof | {"device": "numpy"})
            sub[name] = {**_sub_repair(ecutil, card, host, bufs[:8], 1,
                                       fractional),
                         "profile": prof,
                         "gf_apply_launches": K.launches["gf_apply"] - at}
        torch.cuda.synchronize()
        pipe = pipeline.perf.dump()
    finally:
        pipeline.close()
    launches = dict(K.launches)
    if pipe["errors"] or pipe["completed"] != pipe["submitted"]:
        raise AssertionError(f"repair: errors on the card: {pipe}")
    if any(c["gf_apply_launches"] != 2 * c["hops"] for c in chains):
        raise AssertionError(f"chain hops did not each launch gf_apply: "
                             f"{chains}")
    if launches["crc32c_rows"] != 4 * objects:
        raise AssertionError(f"{launches['crc32c_rows']} crc launches for "
                             f"{4 * objects} rebuilt-shard hash checks")
    report = {"objects": objects, "object_bytes": obj_bytes,
              "stripe_unit": unit, "chunk_size": sinfo.chunk_size,
              "waves": waves, "chains": chains, "regen": regen,
              "clay_lrc": sub, "launches": launches,
              "launches_before_clay_lrc": before,
              "pipeline": {key: pipe[key] for key in
                           ("submitted", "completed", "errors")}}
    del bufs, shards
    torch.cuda.empty_cache()
    return report, launches["gf_apply"], launches["crc32c_rows"]


def phase_headline(K, codec_cls, gfref, batch: int = 64,
                   stripe_bytes: int = MIB) -> tuple[dict, int]:
    """bench.py's shape: Cauchy RS(8,4), 64 x 1 MiB stripes, vertical
    layout [64*k, 128 KiB], encode and decode of erasures {0, 9}; the
    report and the gf_apply_stripes launches."""
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

    iters = 50
    enc_ms = cuda_ms(lambda: K.gf_apply_stripes(pmat, data, batch), iters)
    dec_ms = cuda_ms(lambda: K.gf_apply_stripes(dmat, data, batch), iters)
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
        "library": NO_LIBRARY,
    }
    return report, launches["gf_apply_stripes"]


# the jerasure phase's two profiles: (a) the widest RAID-6 bitmatrix code,
# (b) a wide-word code; each with the erasure sets its decode runs
JERASURE_PROFILES = {
    "liber8tion": ({"technique": "liber8tion", "k": "8"},
                   ([0, 9], [3, 5])),
    "reed_sol_van_w16": ({"technique": "reed_sol_van", "k": "8", "m": "4",
                          "w": "16"},
                         ([0, 9], [1, 3, 8, 11])),
}


def jerasure_decode_bitmatrices(registry_cls, bm) -> list[np.ndarray]:
    """Dense decode matrices of the jerasure phase's profiles: liber8tion
    {0, 1} lost [16, 64], reed_sol_van w=16 {1, 3, 8, 11} lost [64, 128]."""
    out = []
    for (profile, _), lost in zip(JERASURE_PROFILES.values(),
                                  ([0, 1], [1, 3, 8, 11])):
        ec = registry_cls().factory("jerasure", "",
                                    profile | {"device": "numpy"})
        out.append(bm.decode_bitmatrix(ec.coding, ec.k, ec.w, lost)[0])
    return out


def phase_jerasure(K, ecutil, registry_cls, objects: int = 64,
                   obj_bytes: int = 4 * MIB) -> tuple[dict, int]:
    """jerasure bitmatrix codes (xor_apply) and the isa and shec plugins
    (gf_apply) through the port's registry and ecutil; the report and the
    xor_apply launches of the two jerasure profiles."""
    unit = 4096
    rng = np.random.default_rng(2)
    bufs = [rng.integers(0, 256, obj_bytes, dtype=np.uint8)
            for _ in range(objects)]
    report = {}
    launches = 0
    for name, (profile, lost_sets) in JERASURE_PROFILES.items():
        registry = registry_cls.instance()
        ec = registry.factory("jerasure", "", profile | {"device": "cuda"})
        host = registry.factory("jerasure", "", profile | {"device": "numpy"})
        k = ec.get_data_chunk_count()
        # the 4 KiB stripe unit rounds up to the plugin's w*packetsize
        sinfo = ecutil.StripeInfo(k, ec.get_chunk_size(k * unit))
        assert sinfo.chunk_size == max(unit, ec.get_alignment())
        report[name], _ = _run_stripe_path(K, ecutil, ec, host, sinfo,
                                           bufs, lost_sets, "xor_apply")
        launches += report[name]["launches"]["xor_apply"]
        del host
    for name, profile, lost in (
            ("isa", {"k": "8", "m": "4", "technique": "reed_sol_van"},
             [0, 9]),
            ("shec", {"k": "8", "m": "4", "c": "3"}, [0, 9])):
        registry = registry_cls.instance()
        ec = registry.factory(name, "", profile | {"device": "cuda"})
        host = registry.factory(name, "", profile | {"device": "numpy"})
        sinfo = ecutil.StripeInfo(8, ec.get_chunk_size(8 * unit))
        report[name], _ = _run_stripe_path(K, ecutil, ec, host, sinfo,
                                           bufs[:8], [lost], "gf_apply")
    return report, launches


def phase_shapes(PS, dev) -> list[dict]:
    """Every redesigned kernel at every shape its path launches it at, and
    the sweep's bit-plane variants (ceph_tpu_torch/tools/path_shapes.py):
    bitwise against its plain version, CUDA-event time, device time,
    bound, and the copy ceiling moving the same bytes in this run."""
    pkg = PS.load_package(HERE)
    rows = [PS.measure(pkg, shape, dev)
            for shape in PS.launch_shapes(pkg) + PS.sweep_shapes(pkg)]
    bad = [r for r in rows if r["max_abs_err"]]
    if bad:
        raise AssertionError(f"kernel disagrees at a path shape: {bad}")
    return rows


def kernel_row(name: str, source: str, replaces: str, path: str,
               launches: int, shape_rows: list[dict]) -> dict:
    """One kernel's line from its path's shape rows; the first (the
    encode) gives the row's own numbers, every shape is under "shapes"."""
    first = shape_rows[0]
    return {"name": name, "route": "cuda",
            "source": f"ceph_tpu_torch/ops/csrc/{source}",
            "replaces": replaces, "path": path, "shape": first["shape"],
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in shape_rows),
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": None, "library": NO_LIBRARY,
            **({"device_ms": first["device_ms"]} if "device_ms" in first
               else {}),
            "shapes": shape_rows}


_BENCH_LINE = re.compile(r"^(\d+\.\d{6})\t(\d+)$")


def phase_ec_bench() -> dict:
    cli = [sys.executable, "-m", "ceph_tpu_torch.bench.ec_bench",
           "--size", "1048576", "--iterations", "5"]
    batched = cli + ["--plugin", "torch_rs", "-P", "k=8", "-P", "m=4",
                     "--batch", "64", "--device-resident"]
    runs = {
        "encode": (batched + ["--workload", "encode"], 64),
        "decode": (batched + ["--workload", "decode", "--erased", "0",
                              "--erased", "9"], 64),
        # no --plugin: jerasure reed_sol_van k=7 m=3 on the card
        "default": (cli, 1),
        "liber8tion_encode": (cli + ["--plugin", "jerasure", "-P",
                                     "technique=liber8tion", "-P", "k=8"],
                              1),
    }
    out = {}
    for name, (argv, stripes) in runs.items():
        proc = subprocess.run(argv, cwd=HERE, capture_output=True,
                              text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"ec_bench {name} failed:\n{proc.stderr}")
        lines = proc.stdout.strip().splitlines()
        match = _BENCH_LINE.match(lines[-1]) if lines else None
        if len(lines) != 1 or not match:
            raise AssertionError(f"ec_bench {name} output: {lines}")
        seconds, kib = float(match.group(1)), int(match.group(2))
        if kib != 5 * stripes * 1024 or seconds <= 0:
            raise AssertionError(f"ec_bench {name}: {lines[0]!r}")
        out[name] = {"line": lines[0], "MiBps": kib / 1024 / seconds}
    return out


_SWEEP_LINE = re.compile(r"^(\S.{33}) +(\d+) MiB/s$")
SWEEP_SOURCE = "ceph_tpu_torch/ops/csrc/sweep_kernels.cu"


def sweep_quick_subprocess() -> dict:
    """``python -m ceph_tpu_torch.tools.kernel_sweep --quick`` once; every
    row must print a rate."""
    proc = subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.tools.kernel_sweep",
         "--quick"], cwd=HERE, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"kernel_sweep --quick failed:\n{proc.stdout}"
                           f"{proc.stderr}")
    lines = proc.stdout.strip().splitlines()
    if not lines or not lines[0].startswith("device="):
        raise AssertionError(f"kernel_sweep --quick header: {lines[:1]}")
    rows = {}
    for line in lines[1:]:
        match = _SWEEP_LINE.match(line)
        if not match:
            raise AssertionError(f"kernel_sweep --quick row: {line!r}")
        rows[match.group(1).strip()] = int(match.group(2))
    if len(rows) != 13 or min(rows.values()) <= 0:
        raise AssertionError(f"kernel_sweep --quick rows: {rows}")
    return rows


_STRIPES_LINE = re.compile(r"^(default|stages=\d+ runs=\d+ blocks/sm=\d+): "
                           r"encode +(\d+) decode +(\d+) MiB/s$")


def sweep_stripes_subprocess() -> dict:
    """``python -m ceph_tpu_torch.tools.sweep_stripes --quick`` once: the
    gf_apply kernel's launch variants at the headline shape; every line
    must print both rates."""
    proc = subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.tools.sweep_stripes",
         "--quick"], cwd=HERE, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"sweep_stripes --quick failed:\n{proc.stdout}"
                           f"{proc.stderr}")
    lines = proc.stdout.strip().splitlines()
    if not lines or not lines[0].startswith("device="):
        raise AssertionError(f"sweep_stripes --quick header: {lines[:1]}")
    rows = {}
    for line in lines[1:]:
        match = _STRIPES_LINE.match(line)
        if not match:
            raise AssertionError(f"sweep_stripes --quick row: {line!r}")
        rows[match.group(1)] = [int(match.group(2)), int(match.group(3))]
    if len(rows) != 4 or min(min(v) for v in rows.values()) <= 0:
        raise AssertionError(f"sweep_stripes --quick rows: {rows}")
    return rows


def copy_rows_sass_loads(cuda_build) -> dict | None:
    """Global loads in the SASS of each copy_rows_kernel instantiation, or
    None where the toolkit has no cuobjdump."""
    tool = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass",
                           cuda_build.library_path("sweep_kernels")],
                          capture_output=True, text=True, timeout=120).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
        elif name and "copy_rows_kernel" in name and "LDG" in line:
            counts[name] = counts.get(name, 0) + 1
    return counts


def phase_sweep(K, SK, KS, cuda_build, dev) -> tuple[dict, list]:
    """The kernel sweep at full size with the counts zeroed before and read
    after, the --quick CLI once, then the three sweep kernels timed at the
    sweep's shape against their plain versions and bounds."""
    SK.reset_launches()
    K.reset_launches()
    lines = []
    rates = KS.sweep(quick=False, out=lines.append)
    torch.cuda.synchronize()
    launches = dict(SK.launches)
    bad = [n for n, v in rates.items() if v is None or not math.isfinite(v)]
    if bad:
        raise AssertionError(f"sweep rows without a number: {bad}\n"
                             + "\n".join(lines))
    if min(launches.values()) < 1 or K.launches["gf_apply"] < 1:
        raise AssertionError(f"sweep did not launch every kernel: "
                             f"{launches}, {dict(K.launches)}")
    quick = sweep_quick_subprocess()
    stripes_quick = sweep_stripes_subprocess()

    r, k, n = KS.M, KS.K, KS.N
    rng = np.random.default_rng(0)
    data = torch.from_numpy(rng.integers(0, 256, size=(k, n),
                                         dtype=np.uint8)).to(dev)
    mat = torch.from_numpy(KS.cauchy1(k, r)).to(dev)
    bmat = K.expand_bits_plane_major(mat)
    bytes_ms = bytes_bound_ms((k + r) * n)

    def variant(fn, plain_out, acc=None, groups=1, **labels):
        """Bitwise check, CUDA-event time and bound of one launch; ``acc``
        None is the copy, which does no operations."""
        err = max_abs_err(fn(), plain_out)
        ops_ms = 0.0
        if acc:     # the [G*8r, G*8k] x [G*8k, N/G] product
            ops_ms = (2 * groups * 8 * r * groups * 8 * k * (n // groups)
                      / TENSOR_OPS_PER_S[acc] * 1e3)
            labels |= {"acc": acc, "groups": groups}
        bound = max(bytes_ms, ops_ms)
        ms = cuda_ms(fn, 20)
        return {**labels, "max_abs_err": err, "ms": ms,
                "bytes_ms": bytes_ms, "ops_ms": ops_ms, "bound_ms": bound,
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "bound_share": bound / ms}

    def row(name, replaces, variants, plain_ms):
        err = max(v["max_abs_err"] for v in variants)
        if err:
            raise AssertionError(f"{name} disagrees at the sweep's shape: "
                                 f"{variants}")
        first = variants[0]
        return {"name": name, "route": "cuda", "source": SWEEP_SOURCE,
                "replaces": replaces, "path": "sweep", "shape": [r, k, n],
                "launches": launches[name], "max_abs_err": err,
                "ms": first["ms"], "plain_ms": plain_ms,
                "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
                "library_ms": None, "library": NO_LIBRARY,
                "variants": variants}

    want = SK.bitplane_apply_plain(bmat, data, r, k)
    plain_v1 = cuda_ms(lambda: SK.bitplane_apply_plain(bmat, data, r, k), 3,
                       warmup=1)
    row_v1 = row("bitplane_apply", "tools/kernel_sweep.py:84", [
        variant(lambda: SK.bitplane_apply(bmat, data, r, k, acc, 8192), want,
                acc, tile_n=8192) for acc in ("int8", "bf16")], plain_v1)
    bds = {g: torch.block_diag(*[bmat] * g) for g in (2, 4)}
    plain_bd = cuda_ms(lambda: SK.bitplane_apply_bd_plain(
        bds[4], data, r, k, 4, 8192), 3, warmup=1)
    row_bd = row("bitplane_apply_bd", "tools/kernel_sweep.py:142", [
        variant(lambda: SK.bitplane_apply_bd(bds[g], data, r, k, g, acc, t),
                want, acc, g, tile_n=t)
        for g, acc, t in ((4, "int8", 8192), (2, "int8", 8192),
                          (4, "bf16", 4096))], plain_bd)
    del want

    row_copy = row("copy_rows", "tools/kernel_sweep.py:164", [
        variant(lambda: SK.copy_rows(data, r, t), data[:r], tile_n=t)
        for t in (8192, 32768)],
        cuda_ms(lambda: SK.copy_rows_plain(data, r), 20))
    # the loads of rows r..k-1 stay: the time grows with k at fixed r
    k4_ms = cuda_ms(lambda: SK.copy_rows(data[:r], r, 8192), 20)
    row_copy["library_ms"] = cuda_ms(lambda: data[:r].clone(), 20)
    row_copy["library"] = (f"data[:{r}].clone(): the same result, its "
                           f"own traffic 2*r*N bytes")
    ceiling_ms = row_copy["ms"]
    gf_ms = cuda_ms(lambda: K.gf_apply(mat, data), 20)
    report = {
        "shape": [r, k, n], "rows": rates, "lines": lines,
        "launches": launches, "quick_rows": quick,
        "sweep_stripes_quick_MiBps": stripes_quick,
        "copy_k_scaling": {"k8_ms": ceiling_ms, "k4_ms": k4_ms,
                           "ratio": ceiling_ms / k4_ms,
                           "bytes_ratio": (k + r) / (r + r)},
        "copy_rows_sass_ldg": copy_rows_sass_loads(cuda_build),
        "copy_ceiling_TBps": (k + r) * n / (ceiling_ms / 1e3) / 1e12,
        "copy_ceiling_share_of_datasheet": bytes_ms / ceiling_ms,
        "gf_apply_ms": gf_ms,
        "gf_apply_share_of_datasheet": bytes_ms / gf_ms,
        "gf_apply_share_of_copy_ceiling": ceiling_ms / gf_ms,
    }
    del data, bds
    torch.cuda.empty_cache()
    return report, [row_copy, row_v1, row_bd]


# -- phase serving ------------------------------------------------------------

def event_wait_releases_gil(ms: float = 50.0) -> dict:
    """Does ``torch.cuda.Event.synchronize`` let other Python threads run?
    A spinning thread counts while the main thread waits on an event
    behind ``ms`` of ``torch.cuda._sleep`` on a side stream; if the wait
    held the GIL the count could not move."""
    cycles = int(ms * 1e-3 * 1.98e9)        # the H100's boost clock
    count, stop = [0], threading.Event()

    def spin():
        while not stop.is_set():
            count[0] += 1
    th = threading.Thread(target=spin, daemon=True)
    th.start()
    time.sleep(0.01)
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        torch.cuda._sleep(cycles)
        event = torch.cuda.Event()
        event.record(stream)
    before = count[0]
    t0 = time.perf_counter()
    event.synchronize()
    waited = time.perf_counter() - t0
    during = count[0] - before
    t0 = time.perf_counter()
    before = count[0]
    time.sleep(waited)
    asleep = count[0] - before
    stop.set()
    th.join()
    return {"waited_ms": waited * 1e3, "other_thread_steps": during,
            "steps_in_same_sleep": asleep,
            "releases_gil": during > 0.1 * asleep}


def _perf_delta(before: dict, after: dict, keys) -> dict:
    out = {}
    for key in keys:
        a, b = after[key], before.get(key)
        if isinstance(a, dict) and "avgcount" in a:
            n = a["avgcount"] - b["avgcount"]
            total = a["sum"] - b["sum"]
            out[key] = {"count": n, "sum_s": total,
                        "mean_ms": total / n * 1e3 if n else None}
        elif isinstance(a, dict):
            out[key] = {k: a["buckets"][k] - b["buckets"][k]
                        for k in a["buckets"]}
        else:
            out[key] = a - b
    return out


PIPE_KEYS = ("submitted", "completed", "errors", "pack_time",
             "dispatch_time", "complete_time", "inflight_depth")
ENGINE_KEYS = ("batches", "ops_coalesced", "ops_failed", "queue_wait_time")


def serve_run(K, workload, eng, kind: str, n_ops: int, concurrency: int,
              payloads: list, check) -> dict:
    """One closed loop of ``n_ops`` through ``eng`` with the launch counts
    zeroed just before and read just after; every op's result goes
    through ``check(payload_index, op_number, result)`` on the finisher
    thread as it completes (nothing is kept, as a server sends chunks on
    and drops them).  Fails on a wrong result, a failed op, a pipeline
    error or a launch count that is not the device batches."""
    index = {id(p): i for i, p in enumerate(payloads)}
    submit = eng.submit_encode if kind == "encode" else eng.submit_decode
    lock = threading.Lock()
    state = {"n": 0, "checked": 0, "bad": [], "check_s": 0.0}

    def verify(i, n):
        def cb(fut):
            t0 = time.perf_counter()
            try:
                check(i, n, fut.result(0))
                bad = None
            except Exception as e:         # noqa: BLE001 — reported below
                bad = f"op {n}: {e!r}"
            with lock:
                state["checked"] += bad is None
                if bad is not None:
                    state["bad"].append(bad)
                state["check_s"] += time.perf_counter() - t0
        return cb

    def recording(payload, **kw):
        with lock:
            n = state["n"]
            state["n"] += 1
        fut = submit(payload, **kw)
        fut.add_done_callback(verify(index[id(payload)], n))
        return fut

    setattr(eng, f"submit_{kind}", recording)
    pipe0 = eng.pipeline.perf.dump()
    eng0 = eng.perf.dump()
    torch.cuda.synchronize()
    K.reset_launches()
    try:
        res = workload.closed_loop(eng, n_ops, concurrency, payloads,
                                   kind=kind, timeout=600.0)
    finally:
        del eng.__dict__[f"submit_{kind}"]
    eng.flush()
    torch.cuda.synchronize()
    launches = K.launches["gf_apply"]
    report = {**res, "MiBps": n_ops * res["op_bytes"] / MIB
              / res["elapsed_s"],
              "engine": _perf_delta(eng0, eng.perf.dump(), ENGINE_KEYS),
              "gf_apply_launches": launches, "checked": state["checked"],
              "check_s_on_finisher": state["check_s"]}
    pipe = _perf_delta(pipe0, eng.pipeline.perf.dump(), PIPE_KEYS)
    report["pipeline"] = pipe
    device_batches = pipe["submitted"]
    if pipe["errors"] or pipe["completed"] != device_batches:
        raise AssertionError(f"serving {kind}: errors on the card: {pipe}")
    if state["bad"] or state["checked"] != n_ops \
            or report["engine"]["ops_failed"]:
        raise AssertionError(f"serving {kind}: {state['checked']} of "
                             f"{n_ops} checked, {state['bad'][:3]}")
    if launches != device_batches:
        raise AssertionError(f"serving {kind}: {launches} gf_apply "
                             f"launches for {device_batches} device "
                             f"batches")
    return report


def batch_copy_ms(k: int, m: int, n: int) -> dict:
    """The pinned copies of one full batch alone, CUDA events: [k, n] to
    the card and [m, n] back."""
    pin_in = torch.empty((k, n), dtype=torch.uint8, pin_memory=True)
    card = torch.empty((k, n), dtype=torch.uint8, device="cuda")
    pin_out = torch.empty((m, n), dtype=torch.uint8, pin_memory=True)
    return {"h2d_bytes": k * n, "d2h_bytes": m * n,
            "h2d_ms": cuda_ms(lambda: card.copy_(pin_in, non_blocking=True),
                              5),
            "d2h_ms": cuda_ms(lambda: pin_out.copy_(card[:m],
                                                    non_blocking=True), 5)}


def small_op_serving(K, ecutil, registry, engine_cls, context_cls,
                     workload, n_ops: int = 8192, reps: int = 3) -> dict:
    """(c) bench.py's serving_section on the card: 4 KiB ops, torch_rs
    k=4 m=2 with no device key, concurrency 64, batched against one op
    per dispatch through ``compare_batched_unbatched``, ``n_ops`` an arm
    (a window of seconds) ``reps`` times for the spread.  Every 16th op's
    chunks are held against the numpy codec; launches must equal the
    device batches of each repetition."""
    small = registry.factory("torch_rs", "", {"k": "4", "m": "2",
                                              "technique": "reed_sol_van"})
    host = registry.factory("torch_rs", "", {"k": "4", "m": "2",
                                             "technique": "reed_sol_van",
                                             "device": "numpy"})
    sinfo = ecutil.StripeInfo(4, 1024)
    pays = workload.make_payloads(4096)     # what the comparison submits
    want = {p.tobytes(): w for p, w in
            zip(pays, ecutil.encode_many(sinfo, host, pays))}
    lock = threading.Lock()
    seen = {"n": 0, "checked": 0, "bad": []}

    class CheckedEngine(engine_cls):
        def submit_encode(self, buf, **kw):
            fut = super().submit_encode(buf, **kw)
            with lock:
                seen["n"] += 1
                n = seen["n"]
            if n % 16 == 0:
                ref = want[np.asarray(buf).tobytes()]

                def check(f):
                    try:
                        got = f.result(0)
                        ok = all(np.array_equal(got[c], ref[c])
                                 for c in range(6))
                    except Exception:         # noqa: BLE001 — counted
                        ok = False
                    with lock:
                        seen["checked"] += ok
                        if not ok:
                            seen["bad"].append(n)
                fut.add_done_callback(check)
            return fut

    runs = []
    workload.ServingEngine = CheckedEngine
    try:
        for _ in range(reps):
            cct, captured = context_cls(), {}
            add = cct.perf.add

            def capture(pc, _add=add, _captured=captured):
                _captured[pc.name] = pc
                _add(pc)
            cct.perf.add = capture
            torch.cuda.synchronize()
            K.reset_launches()
            cmp = workload.compare_batched_unbatched(
                small, sinfo, n_ops=n_ops, concurrency=64, op_bytes=4096,
                warmup_ops=64, cct=cct, timeout=240.0)
            torch.cuda.synchronize()
            labels = ("batched", "unbatched")
            pipes = [captured[f"bench.{label}.pipeline"] for label in labels]
            engines = [captured[f"bench.{label}"] for label in labels]
            dispatched = sum(p.get("submitted") for p in pipes)
            if any(p.get("errors") for p in pipes) or \
                    any(e.get("ops_failed") for e in engines):
                raise AssertionError("small-op serving failed on the card")
            if K.launches["gf_apply"] != dispatched:
                raise AssertionError(
                    f"small ops: {K.launches['gf_apply']} launches for "
                    f"{dispatched} device batches")
            runs.append({"batched": cmp["batched"],
                         "unbatched": cmp["unbatched"],
                         "speedup": cmp["speedup"],
                         "gf_apply_launches": K.launches["gf_apply"],
                         "device_batches": dispatched})
    finally:
        workload.ServingEngine = engine_cls
    if seen["bad"] or seen["checked"] != seen["n"] // 16:
        raise AssertionError(f"small ops: {seen['checked']} of "
                             f"{seen['n'] // 16} checked, {seen['bad'][:3]}")
    speedups = sorted(r["speedup"] for r in runs)
    ops_s = {label: sorted(r[label]["ops_s"] for r in runs)
             for label in ("batched", "unbatched")}
    mid = len(runs) // 2
    return {"n_ops": n_ops, "reps": reps, "runs": runs,
            "ops_checked": seen["checked"],
            "speedup": {"min": speedups[0], "median": speedups[mid],
                        "max": speedups[-1],
                        "spread": (speedups[-1] - speedups[0])
                        / speedups[mid]},
            "ops_s": {label: {"min": v[0], "median": v[mid], "max": v[-1]}
                      for label, v in ops_s.items()}}


def phase_serving(K, ecutil, registry_cls, ops: int = 256,
                  concurrency: int = 16, obj_bytes: int = 4 * MIB
                  ) -> tuple[dict, int]:
    """The serving path at RBD-on-EC size: torch_rs k=8 m=4 reed_sol_van
    with no device key (the card), 4 KiB stripe unit, 4 MiB objects, a
    ServingEngine with the option defaults under closed_loop at
    concurrency 16; (a) 256 encodes and 256 degraded reads ({0, 9} lost)
    at pipeline depth 4, (b) depth 0 (the synchronous pipeline) against
    depth 4, (c) bench.py's
    small-op serving comparison on the card.  Returns the report and the
    gf_apply launches of (a)."""
    from ceph_tpu_torch.common import Context
    from ceph_tpu_torch.exec import ServingEngine, workload
    # the pipeline's completion boundary waits in Event.synchronize; the
    # coalescer packs meanwhile only if that wait releases the GIL
    gil = event_wait_releases_gil()
    if not gil["releases_gil"]:
        raise AssertionError(f"Event.synchronize holds the GIL: {gil}")
    k, m, unit = 8, 4, 4096
    profile = {"k": str(k), "m": str(m), "technique": "reed_sol_van"}
    registry = registry_cls.instance()
    ec = registry.factory("torch_rs", "", dict(profile))
    if ec.get_profile()["device"] != "cuda":
        raise AssertionError(f"default device {ec.get_profile()['device']}")
    host = registry.factory("torch_rs", "", profile | {"device": "numpy"})
    sinfo = ecutil.StripeInfo(k, ec.get_chunk_size(k * unit))
    assert sinfo.chunk_size == unit, sinfo.chunk_size
    pays = workload.make_payloads(obj_bytes, 8, seed=0)
    want = ecutil.encode_many(sinfo, ec, pays)
    host_want = ecutil.encode_many(sinfo, host, pays)
    for w, h in zip(want, host_want):
        if any(not np.array_equal(w[c], h[c]) for c in range(k + m)):
            raise AssertionError("encode_many on the card != numpy codec")
    lost = {0, 9}
    src = sorted(ec.minimum_to_decode(set(range(k)),
                                      set(range(k + m)) - lost))
    assert len(src) == k, src
    reads = [{c: w[c] for c in src} for w in want]
    logical = [p.tobytes() for p in pays]

    def same(a, b) -> bool:                  # bitwise, 8 bytes a lane
        return a.shape == b.shape and bool(
            (a.view(np.uint64) == b.view(np.uint64)).all())

    def check_encode(i, n, chunks):
        for c in range(k + m):
            if not same(chunks[c], want[i][c]):
                raise AssertionError(f"chunk {c} != encode_many")
            if n % 16 == 0 and not same(chunks[c], host_want[i][c]):
                raise AssertionError(f"chunk {c} != numpy codec")

    def check_decode(i, n, data):
        if data != logical[i]:
            raise AssertionError("decoded bytes differ")

    def run_pair(depth: int, tag: str) -> dict:
        eng = ServingEngine(cct=Context(), ec_impl=ec, sinfo=sinfo,
                            name=f"rbd.{tag}", pipeline_depth=depth).start()
        try:
            if eng.batch_max_ops != 64 or eng.byte_throttle.max != 64 * MIB:
                raise AssertionError("option defaults changed")
            for kind, payloads in (("encode", pays), ("decode", reads)):
                workload.closed_loop(eng, 2 * concurrency, concurrency,
                                     payloads, kind=kind)      # warm up
            enc = serve_run(K, workload, eng, "encode", ops, concurrency,
                            pays, check_encode)
            dec = serve_run(K, workload, eng, "decode", ops, concurrency,
                            reads, check_decode)
        finally:
            eng.stop()
        return {"depth": depth, "encode": enc, "decode": dec}

    rbd = run_pair(4, "a")                           # (a), counted
    arms = [run_pair(0, "b0"), run_pair(4, "b4"), run_pair(0, "b0b")]
    ratio = {kind: [a[kind]["MiBps"] for a in (rbd, *arms)]
             for kind in ("encode", "decode")}
    depth_cmp = {
        "order": "depth 4 (a), 0, 4, 0",
        "MiBps": ratio,
        "depth4_over_depth0": {
            kind: (v[0] + v[2]) / (v[1] + v[3]) for kind, v in ratio.items()},
        "arms": [{"depth": a["depth"],
                  "encode_p99_ms": a["encode"]["p99_ms"],
                  "decode_p99_ms": a["decode"]["p99_ms"]} for a in arms]}

    copies = batch_copy_ms(k, m, concurrency * obj_bytes // k)

    small_ops = small_op_serving(K, ecutil, registry, ServingEngine,
                                 Context, workload)
    n_serving = rbd["encode"]["gf_apply_launches"] + \
        rbd["decode"]["gf_apply_launches"]
    return {"event_synchronize": gil,
            "object_bytes": obj_bytes, "stripe_unit": unit,
            "concurrency": concurrency, "ops": ops,
            "rbd": rbd, "depth_0_vs_4": depth_cmp,
            "batch_copies": copies, "small_ops": small_ops}, n_serving


# -- phase placement ----------------------------------------------------------

# BASELINE.json's "1M-PG osdmaptool --test-map-pgs": 2^20 PGs a pool (the
# phase's map, pools, variants and the kernel's bound are
# ceph_tpu_torch/tools/path_shapes.py's, which times the same launches)
# Ceph's ~100 PGs per OSD x 1024 OSDs / 3 replicas, to a power of two
BALANCER_PGS = 1 << 15
NO_CRUSH_LIBRARY = "no PyTorch call computes CRUSH"


def placement_edge_maps(PS, pkg):
    """The kernel's edge cases on the phase's topology, as (name, crush
    map, [(rule number, result_max)]): "heavy" gives host0's first two
    OSDs the weights 2^32 and 2^48 + 1 and rack0's host0 2^40 (quotients
    of 0 and 1, weights past 32 bits); "wide" adds chooseleaf indep and
    firstn rules of 20 hosts, past the kernel's STATE_CAP positions of
    shared-memory state."""
    heavy = PS.placement_cluster(pkg, 1).crush
    host0 = heavy.buckets[heavy.item_id("host0")]
    host0.item_weights[:2] = [1 << 32, (1 << 48) + 1]
    heavy.buckets[heavy.item_id("rack0")].item_weights[0] = 1 << 40
    wide = PS.placement_cluster(pkg, 1).crush
    rules = [(wide.add_simple_rule(f"wide_{mode}", "default", "host",
                                   mode=mode, num_rep=20), 20)
             for mode in ("indep", "firstn")]
    # the rep3 rule, as the pool calls it
    return [("heavy", heavy, [(0, 3)]), ("wide", wide, rules)]


def placement_edge_checks(PS, pkg, dev, n: int) -> list[dict]:
    """Each rule of :func:`placement_edge_maps` over ``n`` random x's: the
    kernel against its plain version, bitwise."""
    CK, BulkMapper = pkg.crush_kernels, pkg.torch_mapper.BulkMapper
    xs = torch.from_numpy(np.random.default_rng(4).integers(
        0, 1 << 32, size=n, dtype=np.int64)).to(dev)
    rows = []
    for name, cmap, rules in placement_edge_maps(PS, pkg):
        bm = BulkMapper(cmap, device=dev.type)
        rw = torch.full((cmap.max_devices,), 0x10000, dtype=torch.int64,
                        device=dev)
        tables = bm.tables(None)
        for ruleno, result_max in rules:
            shape = bm.rule_shape(ruleno, result_max)
            got = CK.straw2_map(xs, tables, rw, shape)
            want = CK.straw2_map_plain(xs, tables, rw, shape)
            err = max(max_abs_err(got[0], want[0]),
                      max_abs_err(got[1], want[1]))
            if err:
                raise AssertionError(f"crush_straw2 disagrees with its plain "
                                     f"version: {name} rule {ruleno}")
            rows.append({"map": name, "rule": ruleno,
                         "shape": [n, shape.out_size], "max_abs_err": err,
                         "max_weight": int(tables.ws.max()),
                         "mean_placed": float(got[1].float().mean())})
    return rows


def placement_golden(BulkMapper, CrushMap, none: int) -> dict:
    """Every straw2 golden run of the reference C (the filter of
    tests/test_jax_mapper.py) through the kernel."""
    with open(os.path.join(HERE, "tests", "golden", "crush_golden.json")) as f:
        golden = json.load(f)
    runs = xs = 0
    for g in golden["groups"]:
        cmap = CrushMap.from_dict(g["map"])
        if any(b.alg != 5 for b in cmap.buckets.values()) or \
                cmap.tunables["choose_local_tries"]:
            continue
        bm = BulkMapper(cmap, device="cuda")
        for run in g["runs"]:
            if len(cmap.rules[run["ruleno"]].steps) != 3:
                continue
            nx = len(run["results"])
            out, _ = bm.map_rule(run["ruleno"], np.arange(nx),
                                 reweights=run["weights"],
                                 result_max=run["result_max"])
            for x, want in enumerate(run["results"]):
                want = (want + [none] * out.shape[1])[:out.shape[1]]
                if out[x].tolist() != want:
                    raise AssertionError(f"golden {run['name']} x={x}: "
                                         f"{out[x].tolist()} != {want}")
            runs += 1
            xs += nx
    if runs < 10:
        raise AssertionError(f"only {runs} golden straw2 runs")
    return {"runs": runs, "xs": xs}


def placement_interpreter(m, pms: dict, crush_do_rule, PG, none: int,
                          sample: int = 4096) -> dict:
    """(c) sampled x's of each pool: the kernel's raw CRUSH rows against the
    port's host interpreter, and the mapped PG's up and acting sets
    against the scalar OSDMap chain."""
    rng = np.random.default_rng(3)
    checked = {}
    for pid, (pm, raw, placed) in pms.items():
        pool = m.pools[pid]
        pss = rng.choice(pool.pg_num, size=min(sample, pool.pg_num),
                         replace=False)
        for ps in pss.tolist():
            want = crush_do_rule(m.crush, pool.crush_rule, int(pm.pps[ps]),
                                 pool.size, list(m.osd_weight))
            got = raw[ps][:placed[ps]].tolist()
            if got != want:
                raise AssertionError(f"{pool.name} ps {ps}: kernel {got} != "
                                     f"interpreter {want}")
        for ps in pss[:256].tolist():
            up, upp, act, actp = m.pg_to_up_acting_osds(PG(pid, ps))
            if pm.up[ps][:len(up)].tolist() != up or \
                    int(pm.up_primary[ps]) != upp or \
                    pm.acting[ps][:len(act)].tolist() != act or \
                    int(pm.acting_primary[ps]) != actp or \
                    (pm.up[ps][len(up):] != none).any():
                raise AssertionError(f"{pool.name} ps {ps}: map_pool "
                                     f"disagrees with the scalar chain")
        checked[pool.name] = len(pss)
    return checked


def placement_balancer(mgr, CK, tracer, m) -> dict:
    """(e) the balancer on rep3 at BALANCER_PGS: calc_weight_set (6
    iterations) and calc_pg_upmaps (8, max_deviation 1.0); seconds an
    iteration split into the map calls (kernel and copies, the
    crush.bulk_map spans) and the host's share, the kernel's own share
    from its launches at this shape, and what each found."""
    bm = m.clone()
    bm.pools[1].pg_num = bm.pools[1].pgp_num = BALANCER_PGS
    out = {"pg_num": BALANCER_PGS}
    for name, call in (
            ("calc_weight_set",
             lambda: mgr.calc_weight_set(bm, max_iterations=6, pools=[1])),
            ("calc_pg_upmaps",
             lambda: mgr.calc_pg_upmaps(bm, max_iterations=8,
                                        max_deviation=1.0, pools=[1]))):
        before = tracer.histograms().get("crush.bulk_map", {"sum": 0.0})
        n0 = CK.launches["crush_straw2"]
        t0 = time.perf_counter()
        res = call()
        seconds = time.perf_counter() - t0
        launches = CK.launches["crush_straw2"] - n0
        map_s = tracer.histograms()["crush.bulk_map"]["sum"] - before["sum"]
        # calc_weight_set maps once before its loop
        iters = launches - 1 if name == "calc_weight_set" else launches
        found = (0 if res is None else len(res)) \
            if name == "calc_weight_set" else len(res.new_pg_upmap_items)
        out[name] = {"seconds": seconds, "iterations": iters,
                     "launches": launches,
                     "seconds_per_iteration": seconds / max(iters, 1),
                     "map_seconds": map_s, "host_seconds": seconds - map_s,
                     "found": found}
    return out


def phase_placement(PS, cuda_build, dev, sample: int = 4096
                    ) -> tuple[dict, int, list]:
    """CRUSH bulk placement on a 1024-OSD map with rep3 and ec84 at
    ``PS.PLACEMENT_PGS`` PGs each: (a) the golden runs, (b) the kernel
    against its plain version, and at the edges of its design (weights
    past 2^32, rules past STATE_CAP positions), (c) a sample against the
    host interpreter, (d) the main path timed (BulkPGMapper.map_pool,
    osdmaptool.test_map_pgs), (e) the balancer, (f) the bound and the
    instruction counts of the kernel's draw loop it rests on.  Returns
    (the sub-phases' lines, the main path's launches, the kernel rows)."""
    import io
    from ceph_tpu_torch import mgr
    from ceph_tpu_torch.common.tracer import default_tracer
    from ceph_tpu_torch.crush import CRUSH_ITEM_NONE, CrushMap, crush_do_rule
    from ceph_tpu_torch.crush.torch_mapper import BulkMapper
    from ceph_tpu_torch.ops import crush_kernels as CK
    from ceph_tpu_torch.osdmap import PG, BulkPGMapper
    from ceph_tpu_torch.tools import osdmaptool
    lines = {"golden": placement_golden(BulkMapper, CrushMap,
                                        CRUSH_ITEM_NONE)}
    pkg = PS.load_package(HERE)
    t0 = time.perf_counter()
    m = PS.placement_cluster(pkg, PS.PLACEMENT_PGS)
    mapper = BulkPGMapper(m)
    build_s = time.perf_counter() - t0
    # (b) both pools x the three variants (path_shapes.py's rows: bitwise
    # against the plain version, which counts the draws, CUDA-event ms,
    # the plain version's ms, the bound)
    rows = [PS.measure(pkg, shape, dev)
            for shape in PS.straw2_shapes(pkg, (m, mapper))]
    if any(r["max_abs_err"] for r in rows):
        raise AssertionError(f"crush_straw2 disagrees with its plain "
                             f"version: {rows}")
    lines["kernel"] = {"rows": rows, "build_map_s": build_s}
    lines["edges"] = {"rows": placement_edge_checks(PS, pkg, dev,
                                                    PS.PLACEMENT_PGS)}

    # the main path, from zero launches: map_pool of both pools,
    # test_map_pgs over both, the balancer
    tracer = default_tracer()
    CK.reset_launches()
    timings, pms = {}, {}
    for pid in sorted(m.pools):
        pool = m.pools[pid]
        before = dict(mapper.times)
        t0 = time.perf_counter()
        pm = mapper.map_pool(pid)
        seconds = time.perf_counter() - t0
        stage = {k: mapper.times[k] - before[k] for k in before}
        timings[pool.name] = {"map_pool_s": seconds, **stage,
                              "pgs_per_s": pool.pg_num / seconds}
        pms[pid] = pm
    n_map = CK.launches["crush_straw2"]
    report = io.StringIO()
    t0 = time.perf_counter()
    stats = osdmaptool.test_map_pgs(m, out=report)
    timings["test_map_pgs_s"] = time.perf_counter() - t0
    placed = sum(int((pm.acting != CRUSH_ITEM_NONE).sum())
                 for pm in pms.values())
    if stats["total"] != placed or stats["in"] != m.max_osd:
        raise AssertionError(f"test_map_pgs counted {stats['total']} of "
                             f"{placed} placements over {stats['in']} OSDs")
    timings["report"] = report.getvalue().splitlines()[-5:]
    lines["balancer"] = placement_balancer(mgr, CK, tracer, m)
    launches = CK.launches["crush_straw2"]
    timings["launches"] = {"map_pool": n_map, "total": launches}
    if n_map != len(m.pools) or launches <= n_map:
        raise AssertionError(f"the main path's launches: {timings}")

    # (c) the raw CRUSH rows of each pool, outside the counted window
    raws = {pid: (pms[pid], *mapper.bulk.map_rule(
        m.pools[pid].crush_rule, pms[pid].pps, reweights=m.osd_weight,
        result_max=m.pools[pid].size)) for pid in pms}
    lines["interpreter"] = placement_interpreter(m, raws, crush_do_rule, PG,
                                                 CRUSH_ITEM_NONE, sample)
    lines["timings"] = timings
    base = [r for r in rows if r["variant"] == "base"]
    sass = PS.straw2_sass_counts(cuda_build.library_path("crush_straw2"),
                                 cuda_build._nvcc())
    PS.check_straw2_floor(sass)
    lines["bound"] = {"draw_work": PS.STRAW2_DRAW_WORK,
                      "clocks_per_draw": PS.STRAW2_CLOCKS_PER_DRAW,
                      "draws_per_s": PS.STRAW2_DRAWS_PER_S, "sass": sass,
                      "rows": [{k: r[k] for k in (
                          "pool", "draws", "draws_per_x", "ms", "bound_ms",
                          "bound_by", "ops_bound_ms", "bytes_bound_ms",
                          "share_of_bound")} for r in base]}
    return lines, launches, rows


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
    from ceph_tpu_torch.gf import bitmatrix as bm
    from ceph_tpu_torch.gf import ref as gfref
    from ceph_tpu_torch.ops import cuda_build
    from ceph_tpu_torch.ops import rs_kernels as K
    from ceph_tpu_torch.ops import sweep_kernels as SK
    from ceph_tpu_torch.ops.codec import RSCodec
    from ceph_tpu_torch.ops.pipeline import CodecPipeline
    from ceph_tpu_torch.plugins.registry import ErasureCodePluginRegistry
    from ceph_tpu_torch.tools import kernel_sweep as KS
    from ceph_tpu_torch.tools import path_shapes as PS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = KS.nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)

    emit("build", **phase_build(cuda_build), gpu=smi,
         torch=torch.__version__, cuda=torch.version.cuda)
    emit("kernels", **phase_kernels(
        K, SK, dev, jerasure_decode_bitmatrices(ErasureCodePluginRegistry,
                                                bm)))
    ecu, n_apply, n_crc = phase_ecutil(K, ecutil, ErasureCodePluginRegistry)
    emit("ecutil", **ecu, gpu=smi)
    rep, n_repair, n_repair_crc = phase_repair(
        K, ecutil, ErasureCodePluginRegistry, CodecPipeline)
    emit("repair", **rep, gpu=smi)
    serving, n_serving = phase_serving(K, ecutil, ErasureCodePluginRegistry)
    emit("serving", **serving, gpu=smi)
    head, n_stripes = phase_headline(K, RSCodec, gfref)
    emit("headline", **head, gpu=smi)
    jer, n_xor = phase_jerasure(K, ecutil, ErasureCodePluginRegistry)
    emit("jerasure", **jer, gpu=smi)
    shapes = phase_shapes(PS, dev)
    emit("shapes", rows=shapes, gpu=smi)
    emit("ec_bench", **phase_ec_bench(), gpu=smi)
    sweep, rows_sweep = phase_sweep(K, SK, KS, cuda_build, dev)
    emit("sweep", **sweep, gpu=smi)
    placement, n_place, rows_place = phase_placement(PS, cuda_build, dev)
    for name, line in placement.items():
        emit(f"placement.{name}", **line, gpu=smi)

    def on(kernel):
        return [r for r in shapes if r["kernel"] == kernel]

    print(json.dumps({"kernels": [
        kernel_row("gf_apply", "gf_apply.cu",
                   "ceph_tpu/ops/pallas_kernels.py:156",
                   "ecutil", n_apply, on("gf_apply"))
        | {"launches_by_path": {"ecutil": n_apply, "serving": n_serving,
                                "repair": n_repair}},
        kernel_row("gf_apply_stripes", "gf_apply.cu",
                   "ceph_tpu/ops/pallas_kernels.py:80",
                   "headline", n_stripes, on("gf_apply_stripes")),
        kernel_row("xor_apply", "xor_apply.cu",
                   "ceph_tpu/ops/pallas_kernels.py:207",
                   "jerasure", n_xor, on("xor_apply")),
        *rows_sweep,
        kernel_row("crc32c_rows", "crc32c.cu",
                   "ceph_tpu/ops/rs_kernels.py:302", "ecutil", n_crc,
                   on("crc32c_rows"))
        | {"launches_by_path": {"ecutil": n_crc, "repair": n_repair_crc},
           "library": "no PyTorch call computes crc32c"},
        {"name": "crush_straw2", "route": "cuda",
         "source": "ceph_tpu_torch/ops/csrc/crush_straw2.cu",
         "replaces": "ceph_tpu/crush/jax_mapper.py:180",
         "path": "placement", "shape": rows_place[0]["shape"],
         "launches": n_place,
         "max_abs_err": max(r["max_abs_err"] for r in rows_place),
         "ms": rows_place[0]["ms"], "plain_ms": rows_place[0]["plain_ms"],
         "bound_ms": rows_place[0]["bound_ms"],
         "bound_by": rows_place[0]["bound_by"], "library_ms": None,
         "library": NO_CRUSH_LIBRARY, "shapes": rows_place}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
