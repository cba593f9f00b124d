"""Time the hand kernels at every shape the port's paths launch them at.

    python ceph_tpu_torch/tools/path_shapes.py [--root DIR] [--only KERNEL]

For each launch of ``chip_smoke.py``'s main paths, on ``cuda:0``:

- ecutil: ``torch_rs`` RS(8,4) reed_sol_van over 64 objects of 4 MiB,
  ``gf_apply`` on [8, 32 Mi]: encode [4, 8], decode of {0, 9} [2, 8] and
  of {1, 3, 8, 11} [4, 8];
- serving: the same codec under the serving engine, one full batch of
  16 ops of 4 MiB (the 64 MiB throttle at concurrency 16), ``gf_apply``
  on [8, 8 Mi]: encode [4, 8], the degraded read of {0, 9} from chunks
  1-8 [1, 8];
- headline: Cauchy RS(8,4), 64 stripes of 1 MiB, ``gf_apply_stripes`` on
  [64*8, 128 Ki]: encode [4, 8], decode of {0, 9} [2, 8];
- jerasure: ``xor_apply`` on the packets of 64 objects of 4 MiB,
  liber8tion k=8 (W [16, 64], packets [64, 4 Mi]; decodes {0, 9} and
  {3, 5}) and reed_sol_van k=8 m=4 w=16 (W [64, 128], packets
  [128, 2 Mi]; decodes {0, 9} and {1, 3, 8, 11});
- repair: the same torch_rs codec over the 64 objects' shard streams
  [8, 32 Mi]: the recovery waves of want {3} and {0, 9} ([4, 8]: every
  missing row is rebuilt), the chain-repair hops of one and two lost
  shards ([1, 1] and [2, 1] x [1, 32 Mi]); pm_regen k=3 m=2 d=4 at
  4 MiB objects, MBR and MSR: encode, a helper's projection [1, alpha]
  and the newcomer's combine [alpha, 4]; clay k=8 m=4 d=11 (torch_rs):
  a plane's decode [4, 8] and a pairwise solve [2, 2] x [., 8 Ki]; lrc
  k=8 m=4 l=6: the global encode [4, 8] and a local repair [1, 6] x
  [., 512 Ki];
- ``crc32c_rows``: one object's shards under ``hinfo_append`` [12, 512 Ki],
  the fused encode + checksum's data and parity rows [8, 32 Mi] and
  [4, 32 Mi], and the rebuilt shards' hash check of a recovery wave
  [2, 512 Ki];
- sweep: the kernel sweep's bit-plane variants at Cauchy RS(8,4) over
  [8, 8 Mi]: ``bitplane_apply`` int8 and bf16, ``bitplane_apply_bd`` int8
  at G = 4 and 2 and bf16 at G = 4, bound by bytes or tensor-core
  operations, whichever is larger;
- placement: ``crush_straw2`` on phase placement's 1024-OSD straw2 map
  at 2^20 x's (the pools' placement seeds), rep3 (chooseleaf firstn 3
  host) and ec84 (chooseleaf indep 12 host), each plain, with reweights
  and with a compat weight set; bound by the straw2 draws the plain
  version counts at the least issue time of a draw's instructions
  (``STRAW2_DRAWS_PER_S``) or the bytes, whichever is larger.

Each shape gets the kernel's time (CUDA events, the best of 3 means over
20 launches, after 2; 10 for ``crush_straw2``), its bitwise difference
from the plain version and the plain version's time (3 calls after 1;
for ``crush_straw2`` the one call that checks it), the bytes bound at
3.35 TB/s (and for ``xor_apply`` the XOR bound), the copy ceiling
(``sweep_kernels.copy_rows`` moving the same bytes, in the same run; none
where the apply writes more rows than it reads, or for the crc, which
writes no rows) and the kernel's shares of both.  For the crc and the
bit-plane kernel the device time apart from the host's launch pace is
``device_ms`` (``torch.profiler``'s kernel time) and ``graph_ms`` (a CUDA
graph replay of the 20 launches); for the crc ``ms`` is the launch alone,
host-paced, and the whole ``crc32c_rows`` call is ``wrapper_ms``.  Where the package has
``rs_kernels.xor_apply_form``, both ``xor_apply`` forms are timed too.
One JSON line per shape.

``--root DIR`` times the ``ceph_tpu_torch`` package found in DIR (for
example an unpacked earlier commit) with this file's shapes and clock, so
two versions of the kernels can be compared on one card in one run.
Run it as a file, not with ``-m``, so that the package is imported from
the root named.  ``--only KERNEL`` (repeatable) times that kernel's
shapes alone.  Without a CUDA device it exits 2.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import re
import subprocess
import sys
import time
import types

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
MIB = 1 << 20
OBJECTS, OBJ_BYTES = 64, 4 * MIB   # the ecutil and jerasure paths
SERVING_BATCH = 16                 # ops of OBJ_BYTES per serving batch
STRIPES, STRIPE_BYTES = 64, MIB    # the headline
JERASURE = {
    "liber8tion": ({"technique": "liber8tion", "k": "8"}, ([0, 9], [3, 5])),
    "reed_sol_van_w16": ({"technique": "reed_sol_van", "k": "8", "m": "4",
                          "w": "16"}, ([0, 9], [1, 3, 8, 11])),
}


def load_package(root: str | None = None) -> types.SimpleNamespace:
    """The modules this tool uses, from the ``ceph_tpu_torch`` in ``root``
    (default: the checkout holding this file)."""
    root = root or os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, os.path.abspath(root))
    names = {"rs_kernels": "ops.rs_kernels", "sweep_kernels":
             "ops.sweep_kernels", "codec": "ops.codec", "registry":
             "plugins.registry", "bitmatrix": "gf.bitmatrix",
             "crush_kernels": "ops.crush_kernels", "cuda_build":
             "ops.cuda_build", "crush": "crush", "torch_mapper":
             "crush.torch_mapper", "osdmap": "osdmap"}
    return types.SimpleNamespace(**{
        key: importlib.import_module(f"ceph_tpu_torch.{mod}")
        for key, mod in names.items()})


def launch_shapes(pkg) -> list[dict]:
    """Every kernel launch of the paths: kernel, path, label, matrix (numpy),
    data rows and columns, stripes."""
    out = []
    registry = pkg.registry.ErasureCodePluginRegistry()
    ec = registry.factory("torch_rs", "", {"k": "8", "m": "4",
                                           "technique": "reed_sol_van",
                                           "device": "numpy"})
    n = OBJECTS * OBJ_BYTES // 8
    out.append(dict(kernel="gf_apply", path="ecutil", label="encode",
                    mat=ec.codec.parity_mat, rows=8, cols=n, stripes=1))
    for lost in ([0, 9], [1, 3, 8, 11]):
        out.append(dict(kernel="gf_apply", path="ecutil",
                        label=f"decode {lost}",
                        mat=ec.codec.decode_matrix(lost)[0], rows=8, cols=n,
                        stripes=1))
    n = SERVING_BATCH * OBJ_BYTES // 8
    out.append(dict(kernel="gf_apply", path="serving", label="encode",
                    mat=ec.codec.parity_mat, rows=8, cols=n, stripes=1))
    out.append(dict(kernel="gf_apply", path="serving",
                    label="decode [0, 9] from 1-8",
                    mat=ec.codec.decode_matrix([0], list(range(1, 9)))[0],
                    rows=8, cols=n, stripes=1))
    codec = pkg.codec.RSCodec(8, 4, technique="cauchy", device="numpy")
    for label, mat in (("encode", codec.parity_mat),
                       ("decode [0, 9]", codec.decode_matrix([0, 9])[0])):
        out.append(dict(kernel="gf_apply_stripes", path="headline",
                        label=label, mat=mat, rows=STRIPES * 8,
                        cols=STRIPE_BYTES // 8, stripes=STRIPES))
    for name, (profile, lost_sets) in JERASURE.items():
        ec = registry.factory("jerasure", "", profile | {"device": "numpy"})
        k, n_chunks = ec.get_data_chunk_count(), ec.get_chunk_count()
        p = OBJECTS * OBJ_BYTES // (k * ec.w)
        out.append(dict(kernel="xor_apply", path=f"jerasure {name}",
                        label="encode", mat=ec.coding, rows=k * ec.w,
                        cols=p, stripes=1))
        for lost in lost_sets:
            avail = [c for c in range(n_chunks) if c not in lost]
            D = pkg.bitmatrix.decode_bitmatrix(ec.coding, k, ec.w, lost,
                                               available=avail)[0]
            out.append(dict(kernel="xor_apply", path=f"jerasure {name}",
                            label=f"decode {lost}", mat=D, rows=k * ec.w,
                            cols=p, stripes=1))
    out += repair_shapes(pkg, registry)
    for s in out:
        s["mat"] = np.ascontiguousarray(s["mat"], dtype=np.uint8)
    return out


def repair_shapes(pkg, registry) -> list[dict]:
    """The launches of ``chip_smoke.py``'s phase ``repair``, and the crc
    kernel's."""
    out = []
    ec = registry.factory("torch_rs", "", {"k": "8", "m": "4",
                                           "technique": "reed_sol_van",
                                           "device": "numpy"})
    n = OBJECTS * OBJ_BYTES // 8
    for want in ([3], [0, 9]):
        avail = sorted(ec.minimum_to_decode(set(want),
                                            set(range(12)) - set(want)))
        lost = [c for c in range(12) if c not in avail]
        out.append(dict(kernel="gf_apply", path="repair",
                        label=f"wave want {want}",
                        mat=ec.codec.decode_matrix(lost, avail)[0], rows=8,
                        cols=n, stripes=1))
    for lost in ({3}, {0, 9}):
        sources = sorted(set(range(12)) - lost)[:8]
        coeffs, _rows = ec.partial_sum_coefficients(lost, sources)
        out.append(dict(kernel="gf_apply", path="repair",
                        label=f"chain hop {sorted(lost)}",
                        mat=np.array(coeffs[sources[0]],
                                     np.uint8).reshape(-1, 1),
                        rows=1, cols=n, stripes=1))
    for mode in ("mbr", "msr"):
        pm = registry.factory("pm_regen", "", {
            "k": "3", "m": "2", "d": "4", "mode": mode, "device": "numpy"})
        alpha, k = pm.get_sub_chunk_count(), pm.k
        cols = pm.get_stored_chunk_size(pm.get_chunk_size(OBJ_BYTES)) \
            // alpha
        enc = pm._enc if mode == "mbr" else pm._enc[k * alpha:]
        helpers = [1, 2, 3, 4]
        for label, mat in (("encode", enc),
                           ("project", pm.repair_projection(0)),
                           ("combine", pm.repair_combine(0, helpers))):
            out.append(dict(kernel="gf_apply", path="repair",
                            label=f"pm_regen {mode} {label}", mat=mat,
                            rows=mat.shape[1], cols=cols, stripes=1))
    codec = pkg.codec.RSCodec(2, 2, device="numpy")
    sc = OBJ_BYTES // 8 // 64                # clay k=8 d=11: 64 planes
    out.append(dict(kernel="gf_apply", path="repair",
                    label="clay plane decode",
                    mat=ec.codec.decode_matrix([8, 9, 10, 11])[0], rows=8,
                    cols=sc, stripes=1))
    out.append(dict(kernel="gf_apply", path="repair",
                    label="clay pairwise solve",
                    mat=codec.decode_matrix([0, 1])[0], rows=2, cols=sc,
                    stripes=1))
    lrc_local = pkg.codec.RSCodec(6, 1, device="numpy")
    out.append(dict(kernel="gf_apply", path="repair", label="lrc encode",
                    mat=ec.codec.parity_mat, rows=8, cols=OBJ_BYTES // 8,
                    stripes=1))
    out.append(dict(kernel="gf_apply", path="repair",
                    label="lrc local repair",
                    mat=lrc_local.decode_matrix([0])[0], rows=6,
                    cols=OBJ_BYTES // 8, stripes=1))
    empty = np.zeros((0, 0), np.uint8)
    for path, label, rows, cols in (
            ("ecutil", "hinfo_append one object", 12, OBJ_BYTES // 8),
            ("ecutil", "encode_with_crc data", 8, n),
            ("ecutil", "encode_with_crc parity", 4, n),
            ("repair", "wave hash check [0, 9]", 2, OBJ_BYTES // 8)):
        out.append(dict(kernel="crc32c_rows", path=path, label=label,
                        mat=empty, rows=rows, cols=cols, stripes=1))
    return out


SWEEP_ROWS = 8 * MIB               # the kernel sweep's [8, 8 Mi] data
# the sweep's bit-plane variants: (kernel, acc, groups, tile_n)
BITPLANE_VARIANTS = (("bitplane_apply", "int8", 1, 8192),
                     ("bitplane_apply", "bf16", 1, 8192),
                     ("bitplane_apply_bd", "int8", 4, 8192),
                     ("bitplane_apply_bd", "int8", 2, 8192),
                     ("bitplane_apply_bd", "bf16", 4, 4096))
TENSOR_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12}   # dense peaks


def sweep_shapes(pkg) -> list[dict]:
    """The kernel sweep's bit-plane launches: Cauchy RS(8,4) [4, 8] over
    [8, 8 Mi], each variant of phase ``sweep``."""
    mat = np.ascontiguousarray(pkg.codec.RSCodec(
        8, 4, technique="cauchy", device="numpy").parity_mat, np.uint8)
    return [dict(kernel=kernel, path="sweep",
                 label=f"{acc} groups={g} tile_n={t}", mat=mat, rows=8,
                 cols=SWEEP_ROWS, stripes=1, acc=acc, groups=g, tile_n=t)
            for kernel, acc, g, t in BITPLANE_VARIANTS]


def cuda_ms(fn, iters: int = 20, warmup: int = 2, rounds: int = 3) -> float:
    """Milliseconds of ``fn``: the best of ``rounds`` means over ``iters``
    calls, CUDA events (the best, so that a stray slow round does not
    count against one kernel and not the other)."""
    for _ in range(warmup):
        fn()
    best = float("inf")
    for _ in range(rounds):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def _device_us(evt) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        value = getattr(evt, attr, None)
        if value:
            return float(value)
    return 0.0


def device_ms(fn, kernel_name: str, iters: int = 20) -> dict:
    """The kernel's own time, apart from the host's launch pace:
    ``profiler_ms``, the mean device time of the kernels whose name holds
    ``kernel_name`` under ``torch.profiler`` over ``iters`` calls, and
    ``graph_ms``, CUDA events around the replay of one CUDA graph holding
    ``iters`` calls (best of 3), over ``iters``.  Where the card's tools
    refuse one, it is None and ``<name>_error`` says why."""
    out = {}
    fn()
    torch.cuda.synchronize()
    try:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evts = [e for e in prof.key_averages() if kernel_name in e.key]
        total = sum(_device_us(e) for e in evts)
        count = sum(e.count for e in evts)
        out["profiler_ms"] = total / count / 1e3 if count and total else None
        out["profiler_launches"] = count
    except Exception as exc:          # noqa: BLE001 - reported, not hidden
        out["profiler_ms"], out["profiler_error"] = None, repr(exc)
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
        out["graph_ms"] = cuda_ms(graph.replay, iters=1, warmup=1) / iters
    except Exception as exc:          # noqa: BLE001 - reported, not hidden
        out["graph_ms"], out["graph_error"] = None, repr(exc)
    torch.cuda.synchronize()
    return out


def xor_ops_ms(byte_xors: int, sms: int, clock_mhz: float) -> float:
    """Byte-XORs at the card's int32 logic rate: per SM 64 int32 lanes of 4
    bytes each, two XORs per LOP3, at the maximum SM clock."""
    return byte_xors / (sms * 64 * 4 * 2 * clock_mhz * 1e6) * 1e3


def sm_clock_max_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.strip().splitlines()[0])


def measure(pkg, shape: dict, dev, seed: int = 3) -> dict:
    """Time one launch shape; the kernel's output is held against its plain
    version first."""
    if shape["kernel"] == "crush_straw2":
        return _measure_straw2(pkg, shape, dev)
    K, SK = pkg.rs_kernels, pkg.sweep_kernels
    gen = torch.Generator(device=dev).manual_seed(seed)
    data = torch.randint(0, 256, (shape["rows"], shape["cols"]),
                         generator=gen, dtype=torch.uint8, device=dev)
    if shape["kernel"] == "crc32c_rows":
        return _measure_crc(K, shape, data)
    if shape["kernel"].startswith("bitplane"):
        return _measure_bitplane(K, SK, shape, data, dev)
    mat = torch.from_numpy(shape["mat"]).to(dev)
    r, k = mat.shape
    s = shape["stripes"]
    if shape["kernel"] == "gf_apply":
        run = lambda: K.gf_apply(mat, data)                   # noqa: E731
        plain = lambda: K.gf_apply_plain(mat, data)           # noqa: E731
    elif shape["kernel"] == "gf_apply_stripes":
        run = lambda: K.gf_apply_stripes(mat, data, s)        # noqa: E731
        plain = lambda: K.gf_apply_stripes_plain(mat, data, s)  # noqa: E731
    else:
        run = lambda: K.xor_apply(mat, data)                  # noqa: E731
        plain = lambda: K.xor_apply_plain(mat, data)          # noqa: E731
    got, want = run(), plain()
    err = int((got.to(torch.int16) - want.to(torch.int16)).abs().max())
    del got, want
    rows_out = s * r
    ms = cuda_ms(run)
    plain_ms = cuda_ms(plain, 3, warmup=1, rounds=1)
    # the copy moving the same bytes: [S*k, N] read as [k, S*N], r rows out
    # (none where r > k: the copy writes at most the rows it reads)
    flat = data.view(k, -1)
    copy_ms = cuda_ms(lambda: SK.copy_rows(flat, r, 8192)) if r <= k \
        else None
    n = shape["cols"]
    bytes_ms = (shape["rows"] + rows_out) * n / HBM_BYTES_PER_S * 1e3
    row = {"kernel": shape["kernel"], "path": shape["path"],
           "label": shape["label"], "shape": [r, k, n] + ([s] if s > 1
                                                         else []),
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bytes_ms": bytes_ms,
           "bound_ms": bytes_ms, "bound_by": "bytes", "copy_ms": copy_ms}
    if shape["kernel"] == "xor_apply":
        props = torch.cuda.get_device_properties(dev)
        nnz = int(mat.sum())
        ops_ms = xor_ops_ms(nnz * n, props.multi_processor_count,
                            sm_clock_max_mhz())
        row |= {"nnz": nnz, "ops_ms": ops_ms,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
        if hasattr(K, "xor_apply_form"):
            row["form"] = K.xor_form(shape["mat"])
            for form in ("direct", "tables"):
                row[f"{form}_ms"] = cuda_ms(
                    lambda f=form: K.xor_apply_form(mat, data, f))
    row["share_of_bound"] = row["bound_ms"] / ms
    row["share_of_copy"] = None if copy_ms is None else copy_ms / ms
    del data
    torch.cuda.empty_cache()
    return row


def _measure_crc(K, shape: dict, rows: torch.Tensor) -> dict:
    """One crc32c_rows shape: bitwise against crc32c_rows_plain, times,
    and the bound: r*n bytes read and 8 bytes a row written.  ``ms`` is
    the kernel's launch alone, host-paced (``crc32c_rows_into`` 20 times
    back to back into a buffer allocated once; in a package whose kernel
    XORs into zeroed int32 words, those words' values are not the crcs);
    ``device_ms`` is its device time under ``torch.profiler`` and
    ``graph_ms`` the same 20 launches replayed from a CUDA graph;
    ``wrapper_ms`` is the whole ``crc32c_rows`` call."""
    r, n = rows.shape
    got, want = K.crc32c_rows(rows), K.crc32c_rows_plain(rows)
    err = int((got - want).abs().max()) if r else 0
    del got, want
    one_launch = hasattr(K, "CRC_SPAN")     # writes int64; else XORs int32
    words = torch.zeros(r, dtype=torch.int64 if one_launch else torch.int32,
                        device=rows.device)
    launch = lambda: K.crc32c_rows_into(rows, words)     # noqa: E731
    ms = cuda_ms(launch)
    dev = device_ms(launch, "crc32c_rows_kernel")
    wrapper_ms = cuda_ms(lambda: K.crc32c_rows(rows))
    plain_ms = cuda_ms(lambda: K.crc32c_rows_plain(rows), 3, warmup=1,
                       rounds=1)
    bound = (r * n + 8 * r) / HBM_BYTES_PER_S * 1e3
    del rows
    torch.cuda.empty_cache()
    device = dev.get("profiler_ms")
    return {"kernel": "crc32c_rows", "path": shape["path"],
            "label": shape["label"], "shape": [r, n], "max_abs_err": err,
            "ms": ms, "device_ms": device, "graph_ms": dev.get("graph_ms"),
            "device_timing": dev, "wrapper_ms": wrapper_ms,
            "plain_ms": plain_ms, "bytes_ms": bound,
            "bound_ms": bound, "bound_by": "bytes", "copy_ms": None,
            "share_of_bound": bound / ms,
            "device_share_of_bound": bound / device if device else None,
            "share_of_copy": None}


def _measure_bitplane(K, SK, shape: dict, data: torch.Tensor, dev) -> dict:
    """One bit-plane variant of the kernel sweep: bitwise against its plain
    version, host-paced and device times, and the bound: the larger of
    (k + r) * N bytes and the [G*8r, G*8k] x [G*8k, N/G] product at the
    tensor cores' dense peak for ``acc``."""
    mat = torch.from_numpy(shape["mat"]).to(dev)
    r, k = mat.shape
    n, g, acc, t = shape["cols"], shape["groups"], shape["acc"], \
        shape["tile_n"]
    bmat = K.expand_bits_plane_major(mat)
    if g == 1:
        run = lambda: SK.bitplane_apply(bmat, data, r, k, acc, t)  # noqa
        plain = lambda: SK.bitplane_apply_plain(bmat, data, r, k)  # noqa
    else:
        bmat = torch.block_diag(*[bmat] * g)
        run = lambda: SK.bitplane_apply_bd(bmat, data, r, k, g, acc, t)  # noqa
        plain = lambda: SK.bitplane_apply_bd_plain(  # noqa: E731
            bmat, data, r, k, g, t)
    got, want = run(), plain()
    err = int((got.to(torch.int16) - want.to(torch.int16)).abs().max())
    del got, want
    ms = cuda_ms(run)
    timing = device_ms(run, "bitplane")
    plain_ms = cuda_ms(plain, 3, warmup=1, rounds=1)
    bytes_ms = (k + r) * n / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * (g * 8 * r) * (g * 8 * k) * (n // g) \
        / TENSOR_OPS_PER_S[acc] * 1e3
    bound = max(bytes_ms, ops_ms)
    device = timing.get("profiler_ms")
    del data
    torch.cuda.empty_cache()
    return {"kernel": shape["kernel"], "path": shape["path"],
            "label": shape["label"], "shape": [r, k, n], "acc": acc,
            "groups": g, "tile_n": t, "max_abs_err": err, "ms": ms,
            "device_ms": device, "graph_ms": timing.get("graph_ms"),
            "device_timing": timing, "plain_ms": plain_ms,
            "bytes_ms": bytes_ms, "ops_ms": ops_ms, "bound_ms": bound,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "copy_ms": None, "share_of_bound": bound / ms,
            "device_share_of_bound": bound / device if device else None,
            "share_of_copy": None}


# -- crush_straw2: chip_smoke.py's phase placement ---------------------------

PLACEMENT_PGS = 1 << 20            # BASELINE.json's 1M-PG test-map-pgs
# The straw2 draw's bound: the least SM-clocks the card must spend issuing
# one draw's instructions.  An SM issues 128 lanes a clock (4 schedulers x
# 32); the integer ALU pipe takes 64 of them, the FMA pipe's IMAD another
# 64 (132 SMs, 1,980 MHz: H100 SXM).  The instructions of a draw, from
# the work and from the draw loop of csrc/crush_straw2.cu as ptxas emits
# it for sm_90a (cuobjdump -sass), by the pipes that can execute them:
#   - ALU only, 60: the 3-word rjenkins hash's 45 XORs and one to seed it
#     (SEED ^ x ^ r is the same for every slot of a choice); the ln
#     index's mask and the reciprocal word's multiplier mask (LOP3 2); the
#     dead-slot test, the 64-bit compare with the best quotient and the
#     loop's tests (ISETP 8); the best's update (SEL 3, PLOP3 1);
#   - either pipe at one instruction, 63: the hash's 45 shifts (SHF, or
#     IMAD.SHL / IMAD.HI by a power of two) and the loop's other 18
#     (two-input adds and carries, the quotient's shifts, pointer steps);
#   - either pipe at one ALU or two FMA instructions, 45: the hash's
#     subtract pairs, one IADD3 of three inputs on the ALU, but two
#     IMAD.IADD on the FMA pipe (an IMAD adds one input);
#   - FMA only, 4: the 64-bit high multiply (IMAD.WIDE.U32 3, .X 1);
#   - neither, 3: the loads of the reciprocal word, the hash id and ln[u].
# Branch and convergence instructions are left out.  :func:`issue_floor`
# gives the pipes their least share of these: 35/24 = 1.458 SM-clocks a
# draw, where this build's own split (146 of its 176 on the ALU pipe)
# takes 2.28.  Phase placement recounts the build's loop
# (:func:`straw2_sass_counts`) and fails if it needs fewer SM-clocks than
# this: the bound would no longer be a floor.
STRAW2_DRAW_WORK = {"alu": 60, "either": 63, "pairs": 45, "fma": 4,
                    "other": 3}
ISSUE_LANES, PIPE_LANES = 128, 64


def issue_floor(alu: float, either: float, pairs: float, fma: float,
                other: float) -> float:
    """The least SM-clocks that issue ``alu`` ALU-only, ``fma`` FMA-only
    and ``other`` instructions of neither pipe, ``either`` that go to
    either pipe as one instruction, and ``pairs`` that take one ALU or two
    FMA instructions: ALU work moves to the FMA pipe, the one-for-one
    kind first, until the ALU pipe no longer takes longest."""
    a, f, n = alu + either + pairs, fma, alu + either + pairs + fma + other

    def clocks(a, f, n):
        return max(a / PIPE_LANES, f / PIPE_LANES, n / ISSUE_LANES)

    x = min(either, max(0.0, (a - f) / 2))
    a, f = a - x, f + x
    # a moved pair frees one ALU slot and costs two FMA slots and one issue
    y = min(pairs, max(0.0, min((a - f) / 3, (2 * a - n) / 3)))
    return clocks(a - y, f + 2 * y, n + y)


STRAW2_CLOCKS_PER_DRAW = issue_floor(**STRAW2_DRAW_WORK)
STRAW2_DRAWS_PER_S = 132 * 1.98e9 / STRAW2_CLOCKS_PER_DRAW
ALU_ONLY = ("LOP3", "ISETP", "SEL", "PLOP3", "IMNMX", "PRMT")
NEITHER = ("LDG", "LDS", "LDL", "STG", "STS", "STL", "SHFL")
CONTROL_OPCODES = ("BRA", "BSSY", "BSYNC", "WARPSYNC", "NOP")


def placement_cluster(pkg, pg_num: int, seed: int = 0):
    """Phase placement's OSDMap: 1024 OSDs, straw2 throughout, root -> 8
    racks -> 8 hosts each -> 16 OSDs each, device weights of {1, 2, 4, 8}
    TiB in 16.16 units, optimal (jewel) tunables; pool 1 rep3
    (replicated_rule: chooseleaf firstn 0 type host, size 3) and pool 2
    ec84 (create_rule's shape: chooseleaf indep 12 type host, k=8 m=4),
    pg_num each."""
    C, O = pkg.crush, pkg.osdmap
    rng = np.random.default_rng(seed)
    cm = C.CrushMap()
    for t, name in ((1, "host"), (2, "rack"), (3, "root")):
        cm.set_type_name(t, name)
    osd, racks = 0, []
    for r in range(8):
        hosts = []
        for h in range(8):
            w = [int(v) * 0x10000 for v in rng.choice([1, 2, 4, 8], size=16)]
            hid = cm.add_bucket(C.CRUSH_BUCKET_STRAW2, 1,
                                list(range(osd, osd + 16)), w)
            cm.set_item_name(hid, f"host{8 * r + h}")
            hosts.append(hid)
            osd += 16
        rid = cm.add_bucket(C.CRUSH_BUCKET_STRAW2, 2, hosts,
                            [sum(cm.buckets[h].item_weights) for h in hosts])
        cm.set_item_name(rid, f"rack{r}")
        racks.append(rid)
    root = cm.add_bucket(C.CRUSH_BUCKET_STRAW2, 3, racks,
                         [sum(cm.buckets[r].item_weights) for r in racks])
    cm.set_item_name(root, "default")
    cm.finalize()
    rep_rule = cm.add_simple_rule("replicated_rule", "default", "host")
    ec_rule = cm.add_simple_rule("ec84", "default", "host", mode="indep",
                                 num_rep=12)
    m = O.OSDMap(crush=cm)
    for o in range(osd):
        m.create_osd(o)
    m.add_pool(O.Pool(pool_id=1, type=O.POOL_TYPE_REPLICATED, size=3,
                      pg_num=pg_num, crush_rule=rep_rule,
                      flags=O.FLAG_HASHPSPOOL, name="rep3"))
    m.add_pool(O.Pool(pool_id=2, type=O.POOL_TYPE_ERASURE, size=12,
                      min_size=9, pg_num=pg_num, crush_rule=ec_rule,
                      flags=O.FLAG_HASHPSPOOL, name="ec84",
                      erasure_code_profile="k=8 m=4"))
    return m


def placement_variants(m, seed: int = 1) -> dict:
    """(reweights, choose_args) of the kernel's cases: none; 5% of OSDs
    out and 10% at half weight (forces retries); a one-position compat
    weight set scaling every item by 0.5-1.5."""
    rng = np.random.default_rng(seed)
    n = m.max_osd
    rw = np.full(n, 0x10000, dtype=np.int64)
    pick = rng.permutation(n)
    rw[pick[:n // 20]] = 0
    rw[pick[n // 20:n // 20 + n // 10]] = 0x8000
    compat = {bid: {"weight_set": [[int(w * f) for w, f in zip(
        b.item_weights, rng.choice([0.5, 0.75, 1.0, 1.25, 1.5],
                                   size=b.size))]]}
              for bid, b in m.crush.buckets.items()}
    base = np.asarray(m.osd_weight, dtype=np.int64)
    return {"base": (base, None), "reweights": (rw, None),
            "choose_args": (base, compat)}


def straw2_bound(draws: int, n: int, out_size: int, tables, rw) -> dict:
    """The least time the card could take: the draws at
    STRAW2_DRAWS_PER_S, or the bytes (xs in, out and placed out, every
    table read once) at 3.35 TB/s, whichever is larger."""
    ops_ms = draws / STRAW2_DRAWS_PER_S * 1e3
    nbytes = 4 * n * (2 + out_size) + rw.numel() * 8 + sum(
        getattr(tables, f).numel() * getattr(tables, f).element_size()
        for f in ("items", "hash_ids", "sizes", "types", "row_of_id", "ln",
                  # the kernel reads one table of weights or reciprocals
                  "ws"))
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"draws": draws, "bound_ms": max(ops_ms, b_ms),
            "bound_by": "operations" if ops_ms >= b_ms else "bytes",
            "ops_bound_ms": ops_ms, "bytes_bound_ms": b_ms}


def straw2_shapes(pkg, cluster=None) -> list[dict]:
    """Phase placement's kernel launches: both pools of
    :func:`placement_cluster` at PLACEMENT_PGS x's, each variant of
    :func:`placement_variants`; ``cluster`` is the (OSDMap,
    BulkPGMapper) to use, built here once when not given."""
    if cluster is None:
        m = placement_cluster(pkg, PLACEMENT_PGS)
        cluster = (m, pkg.osdmap.BulkPGMapper(m))
    m, mapper = cluster
    return [dict(kernel="crush_straw2", path="placement",
                 label=f"{m.pools[pid].name} {variant}", pool=pid,
                 variant=variant, cluster=cluster)
            for pid in sorted(m.pools) for variant in placement_variants(m)]


def _measure_straw2(pkg, shape: dict, dev) -> dict:
    """One placement launch: bitwise against straw2_map_plain (which
    counts the draws, and whose one checking call is timed on the host's
    clock), CUDA-event ms, the bound."""
    CK = pkg.crush_kernels
    m, mapper = shape["cluster"]
    pool = m.pools[shape["pool"]]
    xs = torch.from_numpy(mapper.pool_pps(pool).astype(np.int64)).to(dev)
    rule = mapper.bulk.rule_shape(pool.crush_rule, pool.size)
    rw_np, ca = placement_variants(m)[shape["variant"]]
    tables = mapper.bulk.tables(ca)
    rw = torch.from_numpy(rw_np).to(dev)
    run = lambda: CK.straw2_map(xs, tables, rw, rule)      # noqa: E731
    got = run()
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = CK.straw2_map_plain(xs, tables, rw, rule, stats=stats)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(int((got[0].long() - want[0].long()).abs().max()),
              int((got[1].long() - want[1].long()).abs().max()))
    mean_placed = float(got[1].float().mean())
    del got, want
    ms = cuda_ms(run, iters=10)
    bound = straw2_bound(stats["draws"], xs.numel(), rule.out_size, tables,
                         rw)
    return {"kernel": "crush_straw2", "path": "placement",
            "label": shape["label"], "pool": pool.name,
            "variant": shape["variant"], "shape": [xs.numel(), rule.out_size],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bound,
            "share_of_bound": bound["bound_ms"] / ms,
            "draws_per_x": stats["draws"] / xs.numel(),
            "mean_placed": mean_placed, "copy_ms": None,
            "share_of_copy": None}


def straw2_sass_counts(library: str, nvcc: str) -> dict | None:
    """:func:`draw_loop_counts` of the straw2 library at ``library``; None
    where the toolkit has no cuobjdump."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.exists(tool):
        return None
    return draw_loop_counts(subprocess.run(
        [tool, "-sass", library], capture_output=True, text=True,
        timeout=120).stdout)


def pipe_class(instruction: str) -> str:
    """The :data:`STRAW2_DRAW_WORK` class of one SASS instruction (its
    text without the address): control, alu, fma, either, pairs (an
    IADD3 of three non-zero inputs) or other.  An opcode not listed goes
    to ``either``, which can only lower a floor."""
    words = instruction.replace(",", " ").split()
    if words[0].startswith("@"):
        words = words[1:]
    op = words[0].split(".")[0]
    if op in CONTROL_OPCODES:
        return "control"
    if op in ALU_ONLY:
        return "alu"
    if op in NEITHER or op.startswith("U"):
        return "other"
    if words[0].startswith(("IMAD.WIDE", "IMAD.HI")):
        return "fma"
    if op == "IADD3":
        # destination, then carry-out predicates, then three inputs
        inputs = [w for w in words[2:] if not re.fullmatch(r"!?U?P[0-9T]", w)]
        if sum(w not in ("RZ", "URZ", "0x0") for w in inputs[:3]) == 3:
            return "pairs"
    return "either"


def draw_loop_counts(sass: str) -> dict:
    """Per kernel of ``cuobjdump -sass`` output: the instructions of its
    draw loop (the innermost loop holding a 64-bit high multiply,
    IMAD.WIDE.U32.X) per draw by opcode and by :func:`pipe_class`, and
    the :func:`issue_floor` of those, in SM-clocks a draw."""
    kernels: dict[str, list] = {}
    name = None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            kernels[name] = []
            continue
        hit = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if name and hit:
            kernels[name].append((int(hit.group(1), 16), hit.group(2)))
    out = {}
    for name, ins in kernels.items():
        loops = []
        for addr, text in ins:
            back = re.search(r"\bBRA\b.*0x([0-9a-f]+)\s*$", text)
            if back and int(back.group(1), 16) <= addr:
                loops.append((int(back.group(1), 16), addr))
        out[name] = None
        for lo, hi in sorted(loops, key=lambda p: p[1] - p[0]):
            body = [text for addr, text in ins if lo <= addr <= hi]
            muls = sum("IMAD.WIDE.U32.X" in text for text in body)
            if not muls:
                continue
            ops: dict[str, int] = {}
            work = dict.fromkeys(STRAW2_DRAW_WORK, 0)
            for text in body:
                words = text.split()
                op = words[1] if words[0].startswith("@") else words[0]
                ops[op.split(".")[0]] = ops.get(op.split(".")[0], 0) + 1
                kind = pipe_class(text)
                if kind != "control":
                    work[kind] += 1
            work = {k: v / muls for k, v in work.items()}
            out[name] = {"multiplies": muls, "opcodes": ops, "work": work,
                         "instructions_per_draw": sum(work.values()),
                         "clocks_per_draw": issue_floor(**work)}
            break
    return out


def check_straw2_floor(counts: dict | None) -> None:
    """Raise when there is no recount, or when a recounted draw loop
    (:func:`draw_loop_counts`) needs fewer SM-clocks than
    STRAW2_CLOCKS_PER_DRAW: the bound would no longer be a floor of that
    build's work."""
    if not counts:
        raise AssertionError("no straw2 kernel recounted (no cuobjdump?)")
    for name, loop in counts.items():
        if loop is None:
            raise AssertionError(f"no draw loop found in {name}")
        if loop["clocks_per_draw"] < STRAW2_CLOCKS_PER_DRAW - 1e-9:
            raise AssertionError(
                f"{name}: the draw loop needs {loop['clocks_per_draw']} "
                f"SM-clocks a draw, under STRAW2_CLOCKS_PER_DRAW = "
                f"{STRAW2_CLOCKS_PER_DRAW}: {loop}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="path_shapes")
    ap.add_argument("--root", default=None,
                    help="directory holding the ceph_tpu_torch package to "
                         "time (default: this checkout)")
    ap.add_argument("--only", action="append", default=None,
                    metavar="KERNEL",
                    help="time only the shapes of this kernel (repeatable; "
                         "e.g. crc32c_rows, bitplane_apply)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("path_shapes: torch.cuda.is_available() is False; the kernels "
              "run only on a CUDA card", file=sys.stderr)
        return 2
    pkg = load_package(args.root)
    dev = torch.device("cuda", 0)
    bad = []
    shapes = launch_shapes(pkg) + sweep_shapes(pkg)
    if not args.only or "crush_straw2" in args.only:
        shapes += straw2_shapes(pkg)
    for shape in shapes:
        if args.only and shape["kernel"] not in args.only:
            continue
        row = measure(pkg, shape, dev)
        bad += [row] if row["max_abs_err"] else []
        print(json.dumps(row), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
