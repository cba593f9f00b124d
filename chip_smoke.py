"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels of ``ceph_tpu_torch/ops/csrc`` with
``nvcc``, holds each against its plain PyTorch version on the card, then
drives the port end to end:

1. build     -- nvcc build time of every source and, beside them, make of
                the native runtime (native/ into ceph_tpu_torch/native/
                build): its seconds, the host's CPU and SIMD level, card
                name and power limit;
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
5. backend   -- the OSD's EC backend (ceph_tpu_torch.backend.make_cluster:
                the primary and 11 OSDShards on one MessageBus) over
                torch_rs k=8 m=4 with no device key, 4 KiB stripe unit,
                64 objects of 4 MiB: (a) submit_transaction + deliver_all
                per object, every shard's bytes against the numpy encode
                and every HashInfo against the host crc32c, one gf_apply
                and one crc32c_rows launch an op; (b) every object read
                back, then again with shards 1 and 9 down (a gf_apply
                decode an op); (c) shard 3's disk replaced and repaired by
                recovery waves (decode_shards_many) through a depth-4
                CodecPipeline and with none, every rebuilt chunk against
                the encode and its crc32c against the HashInfo, wire bytes
                per repaired byte from the bus's wire accounting; (d) the
                same by chain repair (osd_recovery_chain_enable); (e)
                pm_regen k=3 m=2 d=4, MBR and MSR, 64 objects written and
                shard 1 rebuilt from the helpers' ECRegenRead legs; (f)
                (a) and (b) again through a ServingEngine (option
                defaults), no pipeline error.  Shard repair runs
                through the port's RecoveryScheduler (one wave of every
                object).  Each sub-phase prints a backend.<name> line
                with its host time by function, and backend.timing
                splits the phase's wall time into set-up, timed runs and
                checks;
5b. cluster  -- a Ceph user's main path through the port's MiniCluster:
                12 OSDs on 4 hosts, enable_recovery_scheduler() with the
                option defaults, an EC pool torch_rs k=8 m=4
                reed_sol_van with no device key and pg_num 32 (rule
                chooseleaf_indep 12 type 0: every OSD holds a shard of
                every PG), 4 KiB stripe unit, 64 objects of 4 MiB:
                (a) put each, every OSD's chunk against the numpy encode
                and every HashInfo against the host crc32c, one gf_apply
                and one crc32c_rows launch a put; (b) get each, then each
                with the OSDs of its PG's chunks 1 and 9 down (a down
                primary serves nothing until a monitor re-peers, so the
                OSDs are taken down PG by PG), one gf_apply decode a get;
                (c) osd.3 (primary of no PG) down, every object
                overwritten (11 of 12 shards; an overwrite clears the
                chunk hashes: one gf_apply and no crc32c_rows), osd.3 up:
                the scheduler's waves repair it centrally, its chunks
                against the numpy encode, every object read back, wire
                bytes per repaired byte, the scheduler drained; (d) the
                same by chains; (e) a pm_regen k=3 m=2 d=4 MBR pool on a
                cluster of its own, 16 objects, the same cycle by regen
                legs; (f) a replicated pool of size 3 (16 objects, no
                kernel), then 16 EC writes and degraded reads through
                enable_serving(), no pipeline error.  cluster.<name>
                lines: host seconds by function, launches, wire bytes;
5c. durable  -- a Ceph user's durable deployment (vstart with BlueStore,
                rados put/get, ceph osd down, a daemon restart) at phase
                cluster's widths on stores under a temporary directory:
                (a) MiniCluster(data_dir=..., store_backend="bluestore"),
                attach_monitor(n_mons=3), 64 IoCtx.write_full through
                client.rados and 64 reads, every HashInfo against the
                host crc32c; (b) the heartbeat mesh on a VirtualClock stops
                hearing osd.3 (primary of no PG) and the quorum commits
                it down, 64 overwrites, osd.3 answers again, boots and
                the recovery scheduler repairs it on the card (its chunks
                against the numpy encode, wire bytes per repaired byte);
                (c) shutdown() and MiniCluster.load (boot peering and
                repair), every object read back bitwise, every chunk
                against the numpy encode and every HashInfo crc present
                against the host crc32c; (d) (a) and (c) on FileStore
                (16 objects);
                (e) a writeback cache tier (replicated, size 3, pg_num 8)
                over the reloaded EC pool: 16 writes, one agent pass
                flushing all 16 (an encode and a crc each), evictions,
                proxied reads and promotes; (f) degraded gets (chunks 1
                and 9 down) under a seeded StoreFaults read-EIO plan:
                every get returns its bytes or the injected EIO, no
                acked write is lost.  durable.<name> lines: ms per op,
                launches, host seconds by function (the stores' host
                crc32c among them), wire bytes; every gf_apply and
                crc32c_rows call of the phase must equal
                path_shapes.durable_shapes (durable.shapes);
5d. net      -- a Ceph user's networked deployment (vstart with BlueStore
                and cephx, rados --connect put/get) at phase cluster's
                widths: the BlueStore cluster (12 OSDs, recovery
                scheduler, torch_rs k=8 m=4 with no device key, pg_num
                32) served by net.ClusterServer on a loopback port;
                (a) a TcpRados client from the server's keyring (cephx,
                then HMAC frames) puts 64 objects of 4 MiB, every chunk
                against the numpy encode and every HashInfo against the
                host crc32c, gets each, then gets each with the OSDs of
                chunks 1 and 9 down (one gf_apply a degraded get), ms
                per op split into the client's send (encode + HMAC), the
                server's dispatch (the cluster call) and the rest;
                (b) 16 puts and gets through the mux client with
                ms_zero_copy off, then on: copies per payload byte from
                the copy ledger; (c) the mux client's closed loop, 256
                sessions over 8 connections, each one 64 KiB put and a
                get of it (goodput, p50/p99), then the overload arm (a
                second server, dispatch queue 64, one worker): 2,000
                pings while the cluster is busy shed with EBUSY and all
                complete after their retries; (d) 32 puts through 8 mux
                sessions over 2 connections under the seeded transport
                plan (resets, black holes, truncated frames, delays):
                every put acked and applied once, read back, every
                fault kind fired, none in the handshake, re-dials; (e)
                the OSD's EC backend on MessageBus(wire=True), crc and
                secure frames, 16 writes each against a plain bus's
                shards, a corrupted frame refused, the frames' host crc
                and HMAC seconds; (f) a ShardedFrontend over 12
                ServingEngines (one per OSD) routing by the acting
                primary: 16 striped encodes against the numpy encode,
                launches equal to the engines' device batches, a tier
                bound with frontend= admitting its hits and shedding one
                on a clamped, busy shard; (g) rados_cli serve as a
                process, rados_cli --connect mkpool/put/get/ls/stat of a
                4 MiB file, a client process that never initialises
                CUDA, rados_bench write and seq (launches equal to the
                writes).  net.<name> lines; every gf_apply and
                crc32c_rows call but (f)'s engine batches must equal
                path_shapes.net_shapes (net.shapes);
6. serving   -- the serving path at RBD-on-EC size: ServingEngine (option
                defaults: depth-4 CUDA codec pipeline, 64-op batches, 2 ms
                deadline, 64 MiB throttle) over torch_rs k=8 m=4 with no
                device key, 4 KiB stripe unit, 4 MiB objects, closed_loop
                at concurrency 16: (a) 256 encodes and 256 degraded reads
                ({0, 9} lost), every op checked, gf_apply launches equal
                to the device batches, no pipeline error; (b) pipeline
                depth 0 (synchronous) against depth 4; (c) 4 KiB ops,
                k=4 m=2, batched against unbatched (bench.py's serving
                comparison), 8192 ops an arm, three times, every 16th op
                checked; serving.rados_bench: the serving load generator
                (ceph_tpu_torch.tools.rados_bench) in process, --compare
                at 256 ops of 4 MiB (k=8 m=4, 4 KiB chunk) and
                concurrency 16, and --mode mux at 512 sessions x 2 RPCs
                over 8 connections: ops/s and p50/p99 of each arm, every
                op completed, no JAX loaded;
7. headline  -- rs_kernels.gf_apply_stripes over 64 x 1 MiB stripes
                (Cauchy RS(8,4), erasures {0, 9}) in the vertical layout,
                timed with CUDA events;
8. jerasure  -- the jerasure plugin on the xor_apply kernel under
                ecutil.encode_many, hinfo_append and decode_many over 64
                objects of 4 MiB, for liber8tion k=8 and reed_sol_van k=8
                m=4 w=16, checked against the port's numpy path; then the
                isa and shec plugins on the gf_apply kernel over 8 objects;
9. shapes    -- gf_apply, gf_apply_stripes, xor_apply and crc32c_rows at
                every shape phases 3-8 launch them at, and the sweep's
                five bit-plane variants (ceph_tpu_torch/tools/
                path_shapes.py): bitwise against the plain version, CUDA
                events, device time where the tools give it, bound, and
                the copy ceiling moving the same bytes;
10. ec_bench -- the ceph_erasure_code_benchmark CLI: torch_rs encode and
                decode, the default invocation, a liber8tion encode;
10b. native  -- the native runtime on the card's host: (a) the library
                loaded from the port's build at a SIMD level the CPU
                supports; (b) the registry's dlopen contract (cpp_rs
                loads twice, badver/failinit/noreg/noentry refused); (c)
                cpp_rs against torch_rs on the card, k=8 m=4 1 MiB, three
                techniques, encode and decode of {0, 9}, bitwise; (d) the
                north star, ec_bench --plugin cpp_rs against torch_rs,
                encode and decode, MiB/s; (e) the BatchQueue curve
                (max_batch 1-256, 1,024 stripes of [8, 4 KiB] each) into
                gf_apply_stripes, every parity against the host codec,
                launches = ledger = dispatches; (f) host crc32c of 4 MiB
                and apply of 1 MiB, native against plain, MB/s;
11. sweep    -- the kernel sweep (ceph_tpu_torch.tools.kernel_sweep) in
                process at full size, Cauchy RS(8,4) over [8, 8 Mi]: copy
                ceiling, tensor-core bit-plane apply in int8 and bf16,
                block-diagonal stacks of 2 and 4 tiles, bitslice and
                gf_apply; every row must be a number.  Then the same tool
                once as a subprocess with --quick, the gf_apply launch
                variants once (ceph_tpu_torch.tools.sweep_stripes
                --quick), and the three sweep kernels timed at [4, 8] x
                [8, 8 Mi];
12. placement -- CRUSH bulk placement on a 1024-OSD straw2 map (8 racks x
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
                phase fails if the build needs less than that bound;
                (g) MiniCluster's EC rule, chooseleaf_indep 12 type 0 on
                4 hosts x 3 OSDs with osd.3 at reweight 0x8000 and osd.7
                at 0x4000: the kernel against its plain version and both
                against the host interpreter at 256 PGs (every PG, and
                map_pool against the scalar chain) and at 2^20 PGs
                (every PG against the plain version, 256 against the
                interpreter).  Sub-phases print placement.<name> lines;
12b. mesh    -- the device mesh of ceph_tpu_torch/parallel/mesh.py over
                the distinct cards (two or more), else 4 shards (dp 2,
                sp 2) on the one card, `cards` and `shards` on every
                line: (a) sharded_encode_step and
                sharded_batch_encode_step on RS(8,4) Cauchy,
                [64, 8, 1 Mi], parity bitwise against one
                gf_apply_stripes, checksum (int64) and rotated against
                their plain recomputation; (b) sharded_decode_step of
                erasures {0, 9} of that batch, [2, 8] x [8, 64 Mi],
                against the lost rows; (c) sharded_placement_step on
                phase placement's ec84 pool at 2^20 x's, out against one
                map_rule and hist against the bincount of the valid
                entries; (d) a ServingEngine whose codec pipeline carries
                the mesh: 64 encodes of 4 MiB and 64 degraded reads
                ({1, 9} lost) at concurrency 16, every op against the
                single-card encode_many and the objects' bytes, every
                device batch a mesh dispatch through the same steps
                (encode: gf_apply_stripes, decode: gf_apply, once a
                shard a batch).  Each step's gf_apply /
                gf_apply_stripes / crush_straw2 launches per shard
                (equal to the launch ledger's) and CUDA-event ms beside
                the single card's.  mesh.<name> lines;
13. lint     -- ceph-lint over the checkout's ceph_tpu_torch/
                (ceph_tpu_torch.tools.ceph_lint.lint_summary with the
                package's baseline): new, baselined and stale findings
                and the count by rule; any new finding fails the run;
14. chaos    -- the seeded chaos campaign (ceph_tpu_torch.tools.chaos_run,
                seed 13, 12 ops) twice on the card: a durable 9-OSD
                MiniCluster served by ClusterServer (cephx) with its EC
                pool torch_rs k=2 m=1 device=cuda, TcpRados traffic
                under transport, bus and store faults, the SLO burn, a
                flapping OSD, the pipeline breaker opened by injected
                dispatch failures and re-closed by a gf_apply probe whose
                parity is the plain version's, the drain and the cache
                tier.  Both reports ok, every acked write verified over
                TCP and locally, equal event digests, OSD_FLAPPING and
                DEVICE_DEGRADED raised (and cleared), the breaker opened
                and closed, gf_apply and crc32c_rows launches in each
                campaign by the launch ledger (equal to the wrappers'
                counters); each campaign's seconds, ms per put and get
                (host clock), launches by kernel and events by plane.
                chaos.tracer: the default tracer's slow threshold and
                sample rate against the campaign Context's
                osd_op_complaint_time and tracer_sample_rate, after a
                live conf.set of the first to 5.0;
14b. soak    -- the seeded soak campaign (ceph_tpu_torch.tools.
                soak_sweep.soak_campaign, tests/test_soak.py's model) in
                full: 300 steps at seed 113 on a 12-OSD MiniCluster over
                wire-mode buses with reorder and duplicate faults, its EC
                pool torch_rs k=2 m=2 on the card: op vectors with
                xattrs, pool snaps, shard kills and revivals, scrub with
                injected bitrot, deletes; the model held after every
                step, the final scrub clean, HEALTH_OK; steps by action,
                seconds, ms per step, gf_apply and crc32c_rows launches
                (> 0, ledger = counters); then seed 7 on a replicated
                pool, which launches nothing.  Before the EC cluster
                shuts down it gives phase reports a `flight dump` bundle
                and its SLO block (soak.ec, soak.rep lines);
14c. corpus  -- the port's corpus generator (ceph_tpu_torch.tools.
                gen_ec_corpus, torch_rs, jerasure, cpp_rs, xor, shec,
                lrc, clay) on the card into a temporary directory: all
                19 entries' chunk_size and every chunk's SHA-256 against
                tests/golden/ec_corpus.json (a differing digest fails,
                naming the entry and chunk); gf_apply and xor_apply
                launches (> 0, ledger = counters);
14d. reports -- the four post-hoc reports and the perf gate over this
                run's artifacts, in process: (a) roofline.bench_block
                ("gpu") through roofline_report, a row for every key the
                ledger launched on the card, none over 100% of its peak;
                (b) the default context's `trace dump` through
                trace_report, p99 >= p50 on every row, one --trace-id
                tree; (c) phase soak's bundle through ts_report (--log)
                and slo_report; (d) a bench-shaped line of numbers the
                phases hold (headline combined MiB/s, serving's 4 KiB
                batched arm, cluster's wave repair, (a), soak's SLO
                block; every block "gpu") through perf_gate: against
                itself PASS with every present metric compared, against
                the repo's BENCH history PASS with no comparable
                reference, --expect-platform tpu FAIL;
15. instruments -- the port's instrument plane on the card, last: (c) a
                durable BlueStore MiniCluster at phase cluster's widths
                (torch_rs k=8 m=4 with no device key, pg_num 32): 64 puts
                of 4 MiB, 64 gets, osd.3 down and 64 degraded gets, a
                `device profile start` ... `stop` window (torch.profiler)
                around 16 of the puts and 16 of the degraded gets, each
                opened by the backend's primer: the exported trace's
                gf_apply and crc32c kernel events (the primer's apart)
                must equal the launch ledger's launches in the window, the
                card's busy share of the window, the trace's bytes; (d) a
                prometheus scrape that parses (HELP and TYPE once a
                family) with ceph_tpu_device_efficiency rows of gf_apply;
                (e) RECOMPILE_STORM clear, the pg_autoscaler's
                recommendations; (f) `ceph_cli --data-dir D status` as a
                process (its health line equal to the cluster's), `osd
                tree`, `pg dump` and `device roofline` in process.  Then
                (instruments.ledger_overhead) a launch-bound gf_apply
                timed with the ledger on and paused, in turns, and
                (instruments.ledger) (a) the launch ledger's launches of
                every kernel over the whole script against the wrappers'
                counters, its keys per phase (durable's and net's against
                path_shapes; soak's, corpus's and reports' launches by
                kernel against the counters each phase read), (b) every
                key's bytes against the bound's and the main path's
                roofline rows (CUDA-event device ms a launch, bytes,
                share of 3.35 TB/s).

Each phase prints one JSON line, and a ``walls`` line gives every phase's
wall seconds; any failure raises and the script exits non-zero.  Before
the last line it prints the kernel table as one JSON
object and the card's ``nvidia-smi`` name and power limit; the last line
is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the package beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import collections
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
T_START = time.time()

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
    """Mean milliseconds of ``fn`` over ``iters`` calls, CUDA events, with
    the launch ledger paused (it counts the launches, times none)."""
    from ceph_tpu_torch.ops import launch_ledger
    with launch_ledger.paused():
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

def host_cpu() -> tuple[str, bool]:
    """The host's CPU model (cpuinfo's model name, else its vendor, family
    and model numbers: a virtual machine may name it "unknown") and
    whether /proc/cpuinfo lists avx2."""
    with open("/proc/cpuinfo") as f:
        text = f.read()
    avx2 = re.search(r"\bavx2\b", text) is not None
    model = re.search(r"^model name\s*:\s*(.*)$", text, re.M)
    if model and model.group(1).strip() not in ("", "unknown"):
        return model.group(1).strip(), avx2
    fields = [re.search(rf"^{key}\s*:\s*(.*)$", text, re.M)
              for key in ("vendor_id", "cpu family", "model")]
    if not all(fields):
        return "unknown", avx2
    vendor, family, number = (f.group(1).strip() for f in fields)
    return f"{vendor} family {family} model {number}", avx2


def native_status(native) -> dict:
    """``native.status()`` with the host's CPU, failing unless the port's
    own build loaded at a SIMD level the CPU supports."""
    st = native.status()
    cpu, avx2 = host_cpu()
    if not st["loaded"]:
        raise AssertionError(f"native: library not loaded: {st['error']}")
    if st["simd_level"] == 0 and avx2:
        raise AssertionError("native: scalar SIMD level on an avx2 host")
    if not st["path"].startswith(os.path.realpath(native.BUILD_DIR)):
        raise AssertionError(f"native: loaded from {st['path']}")
    return st | {"host_cpu": cpu, "avx2": avx2}


def phase_build(cuda_build, native) -> dict:
    """nvcc of every source and make of the native runtime, all at once;
    fails if the native library did not load (:func:`native_status`)."""
    t0 = time.perf_counter()
    # host_lib keeps a failed make's error for status()
    maker = threading.Thread(target=native.host_lib, name="native-make")
    maker.start()
    info = cuda_build.build_all()
    maker.join()
    for name, v in info.items():
        print(f"# nvcc {name}.cu:\n{v['log']}", file=sys.stderr)
    st = native_status(native)
    return {"seconds": time.perf_counter() - t0,
            "per_source": {n: v["seconds"] for n, v in info.items()},
            "native": {"make_seconds": native.build_info["seconds"],
                       "host_cpu": st["host_cpu"],
                       "simd_level": st["simd_level"], "simd": st["simd"],
                       "path": st["path"]}}


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


NATIVE_REFUSED = {"badver": "does not match host",
                  "failinit": "init of failinit failed",
                  "noreg": "did not register plugin noreg",
                  "noentry": "lacks __erasure_code_init"}
# cpp_rs's technique names and torch_rs's for the same matrices
NATIVE_TECHNIQUES = {"reed_sol_van": "reed_sol_van", "cauchy": "cauchy",
                     "vandermonde_isa": "vandermonde"}


def _bench_line(argv: list[str]) -> dict:
    """One in-process ec_bench run: its line and MiB/s."""
    import contextlib
    import io

    from ceph_tpu_torch.bench import ec_bench
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = ec_bench.main(argv)
    line = buf.getvalue().strip()
    match = _BENCH_LINE.match(line)
    if rc != 0 or not match:
        raise AssertionError(f"ec_bench {argv}: rc {rc}, {line!r}")
    seconds, kib = float(match.group(1)), int(match.group(2))
    return {"line": line, "MiBps": kib / 1024 / seconds}


def _best_s(fn, reps: int) -> float:
    best = math.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def phase_native(K, LL, ecutil, gfref, registry_cls, native,
                 device: str = "cuda", stripes: int = 1024
                 ) -> tuple[dict, int]:
    """The native runtime on the card's host: (a) the library phase build
    made, at a SIMD level the host's CPU supports; (b) the registry's
    dlopen contract; (c) cpp_rs against torch_rs on the card, bitwise;
    (d) the north-star pair through ec_bench; (e) the BatchQueue curve
    into gf_apply_stripes, launches equal to dispatches; (f) the host
    crc32c and apply, native against plain.  ``device="cpu"`` (the CPU
    tests) runs torch_rs and the queue's callback on the plain versions,
    booked in the ledger's cpu route and launching nothing."""
    from ceph_tpu_torch.tools import baseline_matrix as BM
    out = {}
    # (a)
    st = out["status"] = native_status(native)
    cpu = st["host_cpu"]
    # (b)
    reg = native.NativeRegistry.instance()
    reg.load("cpp_rs")
    count = reg.count()
    reg.load("cpp_rs")
    if reg.count() != count or count < 1:
        raise AssertionError(f"native: reload changed the count {count}")
    refused = {}
    for name, text in NATIVE_REFUSED.items():
        try:
            reg.load(name)
        except IOError as e:
            if text not in str(e):
                raise AssertionError(f"native: {name} refused with {e}")
            refused[name] = str(e.args[-1])
        else:
            raise AssertionError(f"native: {name} loaded")
    if reg.count() != count:
        raise AssertionError("native: a refused plugin registered")
    out["registry"] = {"count": count, "refused": refused}
    # (c)
    registry = registry_cls.instance()
    data = np.random.default_rng(15).integers(0, 256, MIB,
                                              dtype=np.uint8).tobytes()
    lost = (0, 9)
    compared = {}
    for tech, torch_tech in NATIVE_TECHNIQUES.items():
        cpp = registry.factory("cpp_rs", "", {"k": "8", "m": "4",
                                              "technique": tech})
        card = registry.factory("torch_rs", "", {"k": "8", "m": "4",
                                                 "technique": torch_tech,
                                                 "device": device})
        a = cpp.encode(set(range(12)), data)
        b = card.encode(set(range(12)), data)
        bad = [i for i in range(12) if not np.array_equal(a[i], b[i])]
        avail = {i: v for i, v in a.items() if i not in lost}
        da = cpp.decode(set(lost), avail, a[0].nbytes)
        db = card.decode(set(lost), avail, a[0].nbytes)
        bad += [f"decode {i}" for i in lost
                if not (np.array_equal(da[i], a[i])
                        and np.array_equal(db[i], a[i]))]
        if bad:
            raise AssertionError(f"native: cpp_rs {tech} != torch_rs: {bad}")
        compared[tech] = "bitwise"
    out["cpp_rs_vs_torch_rs"] = compared
    # (d)
    pair = {}
    for plugin in ("cpp_rs", "torch_rs"):
        argv = ["--plugin", plugin, "-P", "k=8", "-P", "m=4", "--size",
                str(MIB), "--iterations", "50"]
        if plugin == "torch_rs":
            argv += ["-P", f"device={device}"]
        pair[plugin] = {
            "encode": _bench_line(argv + ["--workload", "encode"]),
            "decode": _bench_line(argv + ["--workload", "decode",
                                          "--erased", "0",
                                          "--erased", "9"])}
    out["north_star"] = {
        "k": 8, "m": 4, "bytes": MIB, "host_cpu": cpu,
        "simd": st["simd"], **{f"{p}_{w}_MiBps": pair[p][w]["MiBps"]
                               for p in pair for w in ("encode", "decode")},
        "lines": {p: {w: v["line"] for w, v in r.items()}
                  for p, r in pair.items()}}
    # (e)
    route = "cuda" if device == "cuda" else "cpu"
    K.reset_launches()
    keys_before = LL.counts(route)
    curve = BM.config3_batch_queue(False, device, stripes)
    launches = K.launches["gf_apply_stripes"]
    ledger = sum(v for key, v in (LL.counts(route) - keys_before).items()
                 if key[0] == "gf_apply_stripes")
    dispatches = sum(p["dispatches"] for p in curve["curve"])
    if ledger != dispatches or launches != (ledger if route == "cuda"
                                            else 0):
        raise AssertionError(f"native: batch queue launches {launches}, "
                             f"ledger {ledger}, dispatches {dispatches}")
    out["batch_queue"] = curve | {"stripes_each": stripes,
                                  "launches": launches,
                                  "ledger_launches": ledger}
    # (f)
    buf = np.random.default_rng(16).integers(0, 256, 4 * MIB,
                                             dtype=np.uint8)
    before = dict(native.plain_calls)
    crc = ecutil.crc32c(0xFFFFFFFF, buf)
    if crc != ecutil.crc32c_plain(0xFFFFFFFF, buf):
        raise AssertionError("native: crc32c differs from its plain version")
    crc_s = _best_s(lambda: ecutil.crc32c(0xFFFFFFFF, buf), 20)
    crc_plain_s = _best_s(lambda: ecutil.crc32c_plain(0xFFFFFFFF, buf), 3)
    mat = registry.factory("torch_rs", "", {"k": "8", "m": "4",
                                            "device": device}).codec \
        .parity_mat
    rows = buf[:MIB].reshape(8, MIB // 8)
    if not np.array_equal(gfref.apply_matrix_fast(mat, rows),
                          gfref.apply_matrix(mat, rows)):
        raise AssertionError("native: apply differs from its plain version")
    apply_s = _best_s(lambda: gfref.apply_matrix_fast(mat, rows), 20)
    apply_plain_s = _best_s(lambda: gfref.apply_matrix(mat, rows), 3)
    if native.plain_calls != before:
        raise AssertionError(f"native: plain paths ran {native.plain_calls}")
    out["host"] = {"crc32c_4MiB_MBps": 4 * MIB / crc_s / 1e6,
                   "crc32c_4MiB_plain_MBps": 4 * MIB / crc_plain_s / 1e6,
                   "apply_k8m4_1MiB_MBps": MIB / apply_s / 1e6,
                   "apply_k8m4_1MiB_plain_MBps": MIB / apply_plain_s / 1e6,
                   "bitwise": True, "host_cpu": cpu,
                   "plain_calls": native.plain_calls}
    return out, launches


_SWEEP_LINE = re.compile(r"^(\S.{33}) +(\d+) MiB/s$")
SWEEP_SOURCE = "ceph_tpu_torch/ops/csrc/sweep_kernels.cu"
# copy_rows at [8, 8 Mi] over [4, 8 Mi], r = 4: the bytes ratio is 1.5
COPY_K_RATIO_MIN = 1.25


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


def copy_rows_sass(cuda_build) -> dict:
    """Global loads (LDG) and bulk copies (UBLKCP: cp.async.bulk) in the
    SASS of each copy_rows kernel (the toolkit's cuobjdump).  The ring
    must show bulk copies."""
    tool = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass",
                           cuda_build.library_path("sweep_kernels")],
                          capture_output=True, text=True, timeout=120).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
        elif name and "copy_rows" in name:
            row = counts.setdefault(name, {"LDG": 0, "UBLKCP": 0})
            for op in row:
                row[op] += op in line
    ring = [v for n, v in counts.items() if "copy_rows_ring" in n]
    if not ring or min(v["UBLKCP"] for v in ring) < 1:
        raise AssertionError(f"no bulk copies in the copy ring's SASS: "
                             f"{counts}")
    return counts


# copy_rows against its plain version, bitwise: (r, k, N, tile_n)
COPY_GRID = (
    (16, 64, 1 << 20, 8192), (64, 128, 1 << 20, 8192),  # xor yardsticks
    (16, 64, (1 << 20) + 4096, 256), (64, 128, (1 << 20) + 4096, 32768),
    (8, 8, 1 << 20, 8192), (1, 8, 1 << 20, 8192),       # r = k, r = 1
    (4, 8, (8 << 20) + 48, 8192),       # ragged, a multiple of 16
    (4, 8, 1000003, 8192),              # not a multiple of 16: byte path
    (3, 5, 40000, 256), (2500, 3000, 4096, 256),       # row blocks
)


def copy_rows_grid(SK, dev, gen) -> dict:
    """copy_rows at COPY_GRID and on an offset view: max abs error."""
    worst, cases = 0, 0
    for r, k, n, tile in COPY_GRID:
        data = rand_u8(gen, (k, n), dev)
        worst = max(worst, max_abs_err(SK.copy_rows(data, r, tile),
                                       SK.copy_rows_plain(data, r)))
        cases += 1
    base = rand_u8(gen, (8 * 65536 + 3,), dev)
    view = base[3:].view(8, 65536)          # contiguous, not 16-aligned
    worst = max(worst, max_abs_err(SK.copy_rows(view, 4, 8192),
                                   SK.copy_rows_plain(view, 4)))
    if worst:
        raise AssertionError(f"copy_rows disagrees on the grid: {worst}")
    return {"cases": cases + 1, "max_abs_err": worst}


def phase_sweep(K, SK, KS, PS, cuda_build, dev) -> tuple[dict, list]:
    """The kernel sweep at full size with the counts zeroed before and read
    after, the --quick CLI once, then the three sweep kernels timed at the
    sweep's shape against their plain versions and bounds; the copy also
    as device time beside the clone's, its k = 8 / k = 4 device-time
    ratio, its grid of shapes bitwise and the bulk copies in its SASS."""
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

    # the plain version is data[:r].clone(), the library call: one timing
    row_copy = row("copy_rows", "tools/kernel_sweep.py:164", [
        variant(lambda: SK.copy_rows(data, r, t), data[:r], tile_n=t)
        for t in (8192, 32768)],
        cuda_ms(lambda: SK.copy_rows_plain(data, r), 20))
    row_copy["library_ms"] = row_copy["plain_ms"]
    row_copy["library"] = (f"data[:{r}].clone(): the same result, its "
                           f"own traffic 2*r*N bytes")
    ceiling_ms = row_copy["ms"]
    # the kernel's own time (the profiler's; graph replay where it has
    # none), apart from the wrapper's host pace, which is about as long;
    # the clone, a memcpy, by graph replay
    device = {name: PS.device_ms(fn, kernel) for name, fn, kernel in (
        ("k8", lambda: SK.copy_rows(data, r, 8192), "copy_rows"),
        ("k4", lambda: SK.copy_rows(data[:r], r, 8192), "copy_rows"),
        ("clone", lambda: data[:r].clone(), "Memcpy"))}
    dev_ms = {name: t.get("profiler_ms") or t.get("graph_ms")
              for name, t in device.items()}
    dev_ms["clone"] = device["clone"].get("graph_ms")
    if not dev_ms["k8"] or not dev_ms["k4"]:
        raise AssertionError(f"no device time for copy_rows: {device}")
    row_copy |= {"device_ms": dev_ms["k8"], "device_timing": device["k8"],
                 "library_graph_ms": dev_ms["clone"]}
    # the loads of rows r..k-1 stay: the time grows with k at fixed r
    scaling = {"k8_device_ms": dev_ms["k8"], "k4_device_ms": dev_ms["k4"],
               "ratio": dev_ms["k8"] / dev_ms["k4"],
               "bytes_ratio": (k + r) / (r + r)}
    if scaling["ratio"] < COPY_K_RATIO_MIN:
        raise AssertionError(f"copy_rows at k = {k} is not "
                             f"{COPY_K_RATIO_MIN}x its time at k = {r}: "
                             f"rows {r}..{k - 1} are not read: {scaling}")
    gen = torch.Generator(device=dev).manual_seed(19)
    gf_ms = cuda_ms(lambda: K.gf_apply(mat, data), 20)
    report = {
        "shape": [r, k, n], "rows": rates, "lines": lines,
        "launches": launches, "quick_rows": quick,
        "sweep_stripes_quick_MiBps": stripes_quick,
        "copy_k_scaling": scaling,
        "copy_rows_grid": copy_rows_grid(SK, dev, gen),
        "copy_rows_sass": copy_rows_sass(cuda_build),
        "copy_ceiling_TBps": (k + r) * n / (ceiling_ms / 1e3) / 1e12,
        "clone_TBps": 2 * r * n / (row_copy["library_ms"] / 1e3) / 1e12,
        "copy_ceiling_device_TBps": (k + r) * n / dev_ms["k8"] / 1e9,
        "clone_graph_TBps": (2 * r * n / dev_ms["clone"] / 1e9
                             if dev_ms["clone"] else None),
        "copy_ceiling_device_share_of_datasheet": bytes_ms / dev_ms["k8"],
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


PIPE_KEYS = ("submitted", "completed", "errors", "mesh_dispatches",
             "pack_time", "dispatch_time", "complete_time", "inflight_depth")
ENGINE_KEYS = ("batches", "ops_coalesced", "ops_failed", "queue_wait_time")


def serve_run(K, workload, eng, kind: str, n_ops: int, concurrency: int,
              payloads: list, check, per_batch: int = 1,
              kernel: str = "gf_apply") -> dict:
    """One closed loop of ``n_ops`` through ``eng`` with the launch counts
    zeroed just before and read just after; every op's result goes
    through ``check(payload_index, op_number, result)`` on the finisher
    thread as it completes (nothing is kept, as a server sends chunks on
    and drops them).  Fails on a wrong result, a failed op, a pipeline
    error or a count of ``kernel`` launches that is not ``per_batch`` a
    device batch (a mesh pipeline launches once a shard, its encode
    gf_apply_stripes)."""
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
    launches = K.launches[kernel]
    report = {**res, "MiBps": n_ops * res["op_bytes"] / MIB
              / res["elapsed_s"],
              "engine": _perf_delta(eng0, eng.perf.dump(), ENGINE_KEYS),
              f"{kernel}_launches": launches, "checked": state["checked"],
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
    if launches != per_batch * device_batches:
        raise AssertionError(f"serving {kind}: {launches} {kernel} "
                             f"launches for {device_batches} device "
                             f"batches, {per_batch} a batch")
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


def rbd_workload(ecutil, registry, workload, obj_bytes: int, lost: set,
                 n_payloads: int = 8) -> tuple:
    """The RBD-on-EC serving workload: torch_rs k=8 m=4 reed_sol_van with
    no device key (the card), 4 KiB stripe unit, ``n_payloads`` objects
    of ``obj_bytes``, their chunks by the single-card ``encode_many``
    (checked against the numpy codec), the degraded reads with ``lost``
    down, and the checks ``serve_run`` calls on each op's result: an
    encode against ``encode_many`` (every 16th also against the numpy
    codec), a decode against the object's bytes.  Returns (ec, sinfo,
    payloads, reads, check_encode, check_decode)."""
    k, m, unit = 8, 4, 4096
    profile = {"k": str(k), "m": str(m), "technique": "reed_sol_van"}
    ec = registry.factory("torch_rs", "", dict(profile))
    if ec.get_profile()["device"] != "cuda":
        raise AssertionError(f"default device {ec.get_profile()['device']}")
    host = registry.factory("torch_rs", "", profile | {"device": "numpy"})
    sinfo = ecutil.StripeInfo(k, ec.get_chunk_size(k * unit))
    assert sinfo.chunk_size == unit, sinfo.chunk_size
    pays = workload.make_payloads(obj_bytes, n_payloads, seed=0)
    want = ecutil.encode_many(sinfo, ec, pays)
    host_want = ecutil.encode_many(sinfo, host, pays)
    for w, h in zip(want, host_want):
        if any(not np.array_equal(w[c], h[c]) for c in range(k + m)):
            raise AssertionError("encode_many on the card != numpy codec")
    src = sorted(ec.minimum_to_decode(set(range(k)),
                                      set(range(k + m)) - set(lost)))
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

    return ec, sinfo, pays, reads, check_encode, check_decode


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
    registry = registry_cls.instance()
    ec, sinfo, pays, reads, check_encode, check_decode = rbd_workload(
        ecutil, registry, workload, obj_bytes, lost={0, 9})
    k, m, unit = 8, 4, sinfo.chunk_size

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


# -- phase backend ------------------------------------------------------------

class CallTimer:
    """Inclusive host seconds and calls of named functions, by wrapping
    them in place for the ``with`` block (one perf_counter pair a
    call).  With ``role`` (a function naming the calling thread's part),
    each function's time is kept apart by thread as ``name@role``."""

    def __init__(self, targets: dict, role=None):
        self.targets = targets          # name -> (owner, attribute)
        self.role = role
        self.seconds = collections.defaultdict(float)
        self.calls = collections.defaultdict(int)
        self._lock = threading.Lock()
        self._saved = []

    def __enter__(self):
        for name, (owner, attr) in self.targets.items():
            fn = getattr(owner, attr)
            self._saved.append((owner, attr, owner.__dict__[attr]))

            def wrapped(*a, _fn=fn, _name=name, **kw):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **kw)
                finally:
                    dt = time.perf_counter() - t0
                    key = _name if self.role is None \
                        else f"{_name}@{self.role()}"
                    with self._lock:
                        self.seconds[key] += dt
                        self.calls[key] += 1
            setattr(owner, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for owner, attr, orig in reversed(self._saved):
            setattr(owner, attr, orig)
        return False

    def report(self) -> dict:
        return {key: {"s": self.seconds[key], "calls": self.calls[key]}
                for key in sorted(self.calls) if self.calls[key]}


def backend_timer(extra: dict | None = None) -> CallTimer:
    """Where a backend op's host time goes: the codec calls (card encode,
    crc, decode, repair legs), the host crc32c, the store's transaction
    apply and the rollback capture, the transaction generation, the
    shards' message handling and the bus's whole delivery loop
    (inclusive times; nested calls count in both); ``extra`` names more
    (name -> (owner, attribute))."""
    from ceph_tpu_torch.backend import ec_backend as ecb, ecutil as eu
    from ceph_tpu_torch.backend import memstore as ms, pg_backend as pgb
    from ceph_tpu_torch.backend.messages import MessageBus
    return CallTimer({
        "deliver_all": (MessageBus, "deliver_all"),
        "generate_transactions": (ecb.ECBackend, "_generate_transactions"),
        "encode": (eu, "encode"), "hinfo_append": (eu, "hinfo_append"),
        "decode": (eu, "decode"),
        "decode_shards_many": (eu, "decode_shards_many"),
        "partial_sum_accumulate": (eu, "partial_sum_accumulate"),
        "regen_project": (eu, "regen_project"),
        "regen_combine": (eu, "regen_combine"),
        "host_crc32c": (eu, "crc32c"), "host_crc32c_ec": (ecb, "crc32c"),
        "shard_handle_message": (pgb.OSDShard, "handle_message"),
        "store_apply": (ms.MemStore, "queue_transaction"),
        "rollback_capture": (pgb.OSDShard, "_capture_rollback"),
        **(extra or {})})


def _host_crcs(host_enc) -> list[list[int]]:
    """The host crc32c of every chunk of every object, once for the
    phase's write and repair checks."""
    from ceph_tpu_torch.backend import ecutil as eu
    return [[eu.crc32c(0xFFFFFFFF, want[c]) for c in range(len(want))]
            for want in host_enc]


def _backend_write(K, be, bus, bufs, host_enc, crcs, name) -> dict:
    """(a) one submit_transaction + deliver_all per object, timed and
    launch-counted; then every shard's bytes against ``host_enc`` and
    every shard's HashInfo against ``crcs``, the host crc32c of its
    chunks."""
    from ceph_tpu_torch.backend import GObject, PGTransaction
    from ceph_tpu_torch.backend import ecutil as eu
    from ceph_tpu_torch.backend.pg_backend import shard_store
    n = be.ec_impl.get_chunk_count()
    torch.cuda.synchronize()
    before = dict(K.launches)
    with backend_timer() as timer:
        t0 = time.perf_counter()
        for i, buf in enumerate(bufs):
            done = []
            be.submit_transaction(
                PGTransaction().write(f"{name}{i}", 0, buf.tobytes()),
                on_commit=done.append)
            bus.deliver_all()
            if not done:
                raise AssertionError(f"write {name}{i} did not commit")
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    launches = {key: K.launches[key] - before[key] for key in K.launches}
    t0 = time.perf_counter()
    for i, want in enumerate(host_enc):
        oid = f"{name}{i}"
        for c in range(n):
            store = shard_store(bus, c)
            if store.read(GObject(oid, c)) != want[c].tobytes():
                raise AssertionError(f"{oid} shard {c} != numpy encode")
            h = store.getattr(GObject(oid, c), eu.HINFO_KEY)
            if list(h["cumulative_shard_hashes"]) != crcs[i]:
                raise AssertionError(f"{oid} shard {c} HashInfo != crc32c")
    check_s = time.perf_counter() - t0
    nbytes = sum(b.nbytes for b in bufs)
    return {"objects": len(bufs), "object_bytes": int(bufs[0].nbytes),
            "seconds": elapsed, "MiBps": nbytes / MIB / elapsed,
            "ms_per_op": elapsed / len(bufs) * 1e3,
            "launches": launches,
            "one_of_each_per_op": launches["gf_apply"] == len(bufs)
            and launches["crc32c_rows"] == len(bufs),
            "host_breakdown": timer.report(), "check_s": check_s}


def _backend_reads(K, be, bus, bufs, name, lost=()) -> dict:
    """(b) one objects_read_and_reconstruct + deliver_all per object, every
    byte checked; with ``lost`` shards marked down first (degraded)."""
    for s in lost:
        bus.mark_down(s)
    torch.cuda.synchronize()
    before = dict(K.launches)
    bad = []
    with backend_timer() as timer:
        t0 = time.perf_counter()
        for i, buf in enumerate(bufs):
            out = {}
            be.objects_read_and_reconstruct(
                {f"{name}{i}": [(0, buf.nbytes)]},
                lambda result, errors: out.update(result=result,
                                                  errors=errors))
            bus.deliver_all()
            if out.get("errors") or \
                    out["result"][f"{name}{i}"][0][2] != buf.tobytes():
                bad.append(i)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    for s in lost:
        bus.mark_up(s)
    bus.deliver_all()
    if bad or be.stale:
        raise AssertionError(f"reads lost={sorted(lost)}: objects {bad[:4]} "
                             f"differ, stale {be.stale}")
    launches = {key: K.launches[key] - before[key] for key in K.launches}
    return {"lost": sorted(lost), "objects": len(bufs),
            "seconds": elapsed,
            "MiBps": sum(b.nbytes for b in bufs) / MIB / elapsed,
            "ms_per_op": elapsed / len(bufs) * 1e3, "launches": launches,
            "host_breakdown": timer.report()}


def _backend_repair(K, be, bus, wire, host_enc, crcs, name, victim: int,
                    label: str) -> dict:
    """Replace ``victim``'s disk and let its repair run to completion
    through the backend's recovery scheduler; every rebuilt chunk against
    ``host_enc`` (so its crc32c is the one in ``crcs``) and that crc
    against the stored HashInfo."""
    from ceph_tpu_torch.backend import GObject
    from ceph_tpu_torch.backend import ecutil as eu
    from ceph_tpu_torch.backend import OSDShard
    from ceph_tpu_torch.backend.pg_backend import shard_store
    perf0 = {key: be.perf.get(key) for key in (
        "recoveries", "recovery_bytes", "chain_objects", "chain_fallbacks",
        "regen_objects", "regen_fallbacks")}
    tx0 = wire.totals()["tx_bytes"]
    types0 = wire.per_type()
    torch.cuda.synchronize()
    before = dict(K.launches)
    waves0 = be.recovery_scheduler.perf.get("waves")
    with backend_timer() as timer:
        t0 = time.perf_counter()
        # the disk is replaced: the OSD comes back empty, with an empty
        # PG log, and its revival starts the repair
        bus.mark_down(victim)
        OSDShard(victim, bus)
        bus.mark_up(victim)
        rop = be.shard_repairs.get(victim)
        bus.deliver_all()
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    state = getattr(rop, "state", None)
    if rop is None or state.value != "COMPLETE" or be.stale:
        raise AssertionError(f"{label}: repair of {victim} ended {state}")
    launches = {key: K.launches[key] - before[key] for key in K.launches}
    store = shard_store(bus, victim)
    t0 = time.perf_counter()
    repaired = 0
    for i, want in enumerate(host_enc):
        obj = GObject(f"{name}{i}", victim)
        got = store.read(obj)
        if got != want[victim].tobytes():
            raise AssertionError(f"{label}: {name}{i} rebuilt chunk differs")
        h = store.getattr(obj, eu.HINFO_KEY)
        if crcs[i][victim] != h["cumulative_shard_hashes"][victim]:
            raise AssertionError(f"{label}: {name}{i} crc != HashInfo")
        repaired += len(got)
    check_s = time.perf_counter() - t0
    perf = {key: be.perf.get(key) - v for key, v in perf0.items()}
    tx = wire.totals()["tx_bytes"] - tx0
    types = {t: v["tx_bytes"] - types0.get(t, {}).get("tx_bytes", 0)
             for t, v in wire.per_type().items()
             if v["tx_bytes"] != types0.get(t, {}).get("tx_bytes", 0)}
    return {"victim": victim, "plan": rop.plan,
            "objects_repaired": rop.objects_repaired,
            "waves": be.recovery_scheduler.perf.get("waves") - waves0,
            "seconds": elapsed, "rebuilt_MiBps": repaired / MIB / elapsed,
            "rebuilt_bytes": repaired, "wire_tx_bytes": tx,
            "wire_bytes_per_repaired_byte": tx / repaired,
            "wire_tx_bytes_by_type": types, "perf": perf,
            "launches": launches, "host_breakdown": timer.report(),
            "check_s": check_s}


def attach_scheduler(be, bus, wave: int):
    """The recovery scheduler over one backend of make_cluster, as
    MiniCluster.enable_recovery_scheduler attaches it: its waves of
    ``wave`` objects (osd_recovery_max_active) queue on the primary's OSD
    daemon, which runs before every bus delivery."""
    from ceph_tpu_torch.osd.osd_daemon import OSDDaemon
    from ceph_tpu_torch.osdmap import PG
    from ceph_tpu_torch.recovery import RecoveryScheduler
    daemon = OSDDaemon(be.whoami)
    bus.pre_deliver_hooks.append(daemon.drain)
    be.cct.conf.set("osd_recovery_max_active", wave)
    sched = RecoveryScheduler(cct=be.cct)
    sched.attach_backend(be, pgid=PG(1, 0), daemon=daemon)
    return sched


def phase_backend(K, ecutil, registry_cls, pipeline_cls, objects: int = 64,
                  obj_bytes: int = 4 * MIB, regen_objects: int = 16,
                  serving_objects: int = 16) -> tuple[dict, int, int]:
    """The OSD's EC backend at RBD object size: make_cluster over torch_rs
    k=8 m=4 reed_sol_van with no device key (the card), 4 KiB stripe
    unit, the primary and 11 OSDShards on one MessageBus.  (a) writes,
    (b) reads and degraded reads, (c) centralized wave repair with a
    depth-4 CodecPipeline and with none, (d) chain repair, (e) pm_regen
    MBR and MSR regenerating repair, (f) (a) and (b) through a
    ServingEngine.  The launch counts are zeroed after the payloads, their
    numpy encodes and the encodes' host crc32c are made, and read at the
    end; the ``timing`` line splits the phase's wall time into that
    set-up, the sub-phases' timed runs and their byte and crc checks.
    Returns the sub-phase lines and the gf_apply and crc32c_rows
    launches."""
    from ceph_tpu_torch.backend import make_cluster
    from ceph_tpu_torch.common import Context
    from ceph_tpu_torch.common.wire_accounting import WireAccounting
    from ceph_tpu_torch.exec import ServingEngine
    t_phase = time.perf_counter()
    registry = registry_cls.instance()
    k, m, unit = 8, 4, 4096
    profile = {"k": str(k), "m": str(m), "technique": "reed_sol_van"}
    ec = registry.factory("torch_rs", "", profile)
    host = registry.factory("torch_rs", "", profile | {"device": "numpy"})
    chunk = ec.get_chunk_size(k * unit)
    rng = np.random.default_rng(10)
    bufs = [rng.integers(0, 256, obj_bytes, dtype=np.uint8)
            for _ in range(objects)]
    sinfo = ecutil.StripeInfo(k, chunk)
    host_enc = ecutil.encode_many(sinfo, host, bufs)
    crcs = _host_crcs(host_enc)
    setup_s = time.perf_counter() - t_phase
    cct = Context({"osd_recovery_chain_enable": False})
    be, bus = make_cluster(ec, chunk_size=chunk, cct=cct)
    if ec.get_profile()["device"] != "cuda" or len(bus.handlers) != k + m:
        raise AssertionError("backend: not torch_rs on the card over "
                             "12 shards")
    sched = attach_scheduler(be, bus, objects)
    wire = WireAccounting(cct, name="backend")
    bus.wire_stats = wire
    lines = {}
    torch.cuda.synchronize()
    K.reset_launches()
    lines["write"] = _backend_write(K, be, bus, bufs, host_enc, crcs, "rbd")
    lines["reads"] = {"healthy": _backend_reads(K, be, bus, bufs,
                                                "rbd"),
                      "degraded": _backend_reads(K, be, bus, bufs,
                                                 "rbd", lost=(1, 9))}
    if lines["reads"]["degraded"]["launches"]["gf_apply"] != objects:
        raise AssertionError(f"degraded reads: "
                             f"{lines['reads']['degraded']['launches']}")
    # (c) centralized waves: the wave reconstruct through a depth-4
    # pipeline (the scheduler's shared one, on the backend and on every
    # shard handler), then with none
    pipeline = pipeline_cls(depth=4, name="smoke.backend", cct=cct)
    turns = []
    try:
        for pl in (pipeline, None):
            be.recovery_pipeline = pl
            for h in bus.handlers.values():
                getattr(h, "local_shard", h).recovery_pipeline = pl
            turns.append(_backend_repair(K, be, bus, wire, host_enc, crcs,
                                         "rbd", 3, "wave")
                         | {"pipeline_depth": 4 if pl else None})
        pipe = pipeline.perf.dump()
    finally:
        pipeline.close()
    if pipe["errors"] or pipe["completed"] != pipe["submitted"]:
        raise AssertionError(f"backend waves: errors on the card: {pipe}")
    lines["repair_wave"] = {"turns": turns,
                            "pipeline": {key: pipe[key] for key in
                                         ("submitted", "completed",
                                          "errors")}}
    # (d) chain repair: the same backend, chains on, no pipeline (each hop
    # synchronous on the card)
    be.recovery_pipeline = None
    for h in bus.handlers.values():
        getattr(h, "local_shard", h).recovery_pipeline = None
    cct.conf.set("osd_recovery_chain_enable", True)
    lines["repair_chain"] = _backend_repair(K, be, bus, wire, host_enc, crcs,
                                            "rbd", 3, "chain")
    if lines["repair_chain"]["perf"]["chain_objects"] != objects:
        raise AssertionError(f"chain: {lines['repair_chain']['perf']}")
    # (f) the same writes and reads through a ServingEngine (defaults)
    eng = ServingEngine(cct=cct, name="smoke.backend").start()
    try:
        be.attach_serving(eng)
        eng0 = eng.perf.dump()
        pipe0 = eng.pipeline.perf.dump()
        served = bufs[:serving_objects]
        sw = _backend_write(K, be, bus, served, host_enc[:serving_objects],
                            crcs, "srv")
        sh = _backend_reads(K, be, bus, served, "srv")
        sr = _backend_reads(K, be, bus, served, "srv", lost=(1, 9))
        eng.flush()
        torch.cuda.synchronize()
        engine = _perf_delta(eng0, eng.perf.dump(), ENGINE_KEYS)
        epipe = _perf_delta(pipe0, eng.pipeline.perf.dump(), PIPE_KEYS)
    finally:
        be.attach_serving(None)
        eng.stop()
    if epipe["errors"] or engine["ops_failed"] or \
            epipe["completed"] != epipe["submitted"]:
        raise AssertionError(f"backend serving: {engine} {epipe}")
    lines["serving"] = {"write": sw, "reads": sh, "degraded_reads": sr,
                        "ops": 3 * len(served),
                        "batches": engine["batches"],
                        "engine": engine, "pipeline": epipe}
    # (e) regenerating repair on pm_regen k=3 m=2 d=4, each mode its own
    # cluster on the card
    regen = []
    for mode in ("mbr", "msr"):
        prof = {"k": "3", "m": "2", "d": "4", "mode": mode}
        pm = registry.factory("pm_regen", "", prof)
        pm_host = registry.factory("pm_regen", "", prof | {"device": "numpy"})
        rcct = Context({"osd_recovery_regen_enable": True})
        rchunk = pm.get_chunk_size(3 * unit)
        rbe, rbus = make_cluster(pm, chunk_size=rchunk, cct=rcct)
        rsched = attach_scheduler(rbe, rbus, regen_objects)
        rwire = WireAccounting(rcct, name=f"backend.{mode}")
        rbus.wire_stats = rwire
        rbufs = bufs[:regen_objects]
        rsinfo = ecutil.StripeInfo(3, rchunk)
        rsinfo.stored_chunk_size = pm.get_stored_chunk_size(rchunk)
        pad = -obj_bytes % rsinfo.stripe_width   # the write's zero tail
        t0 = time.perf_counter()
        renc = [ecutil.encode(rsinfo, pm_host, np.concatenate(
            [b, np.zeros(pad, np.uint8)])) for b in rbufs]
        rcrcs = _host_crcs(renc)
        setup_s += time.perf_counter() - t0
        w = _backend_write(K, rbe, rbus, rbufs, renc, rcrcs, mode)
        rep = _backend_repair(K, rbe, rbus, rwire, renc, rcrcs, mode, 1,
                              f"regen {mode}")
        if rep["perf"]["regen_objects"] != len(rbufs):
            raise AssertionError(f"regen {mode}: {rep['perf']}")
        alpha, d = pm.get_sub_chunk_count(), 4
        regen.append({"mode": mode, "profile": prof, "chunk_size": rchunk,
                      "stored_chunk_bytes": int(renc[0][0].nbytes),
                      "alpha": alpha, "d": d,
                      "code_wire_per_repaired_byte": d / alpha,
                      "write": w, "repair": rep})
        rwire.close()
        rsched.close()
    lines["repair_regen"] = regen
    torch.cuda.synchronize()
    launches = dict(K.launches)
    for key in ("gf_apply", "crc32c_rows"):
        if not launches[key]:
            raise AssertionError(f"backend path launched no {key}")
    lines["launches"] = launches
    wire.close()
    sched.close()
    del bufs, host_enc
    torch.cuda.empty_cache()
    runs = [lines["write"], *lines["reads"].values(), *turns,
            lines["repair_chain"], sw, sh, sr,
            *(r[key] for r in regen for key in ("write", "repair"))]
    lines["timing"] = {
        "seconds": time.perf_counter() - t_phase, "setup_s": setup_s,
        "timed_s": sum(r["seconds"] for r in runs),
        "checks_s": sum(r.get("check_s", 0.0) for r in runs)}
    return lines, launches["gf_apply"], launches["crc32c_rows"]


# -- phase cluster ------------------------------------------------------------

def cluster_timer() -> CallTimer:
    """backend_timer's functions and the cluster's own: the client entry
    points, the daemons' op-queue drains and the scheduler's waves."""
    from ceph_tpu_torch import cluster as cl
    from ceph_tpu_torch.osd import osd_daemon as od
    from ceph_tpu_torch.recovery import scheduler as rs
    return backend_timer({
        "put": (cl.MiniCluster, "put"), "get": (cl.MiniCluster, "get"),
        "daemon_drain": (od.OSDDaemon, "drain"),
        "scheduler_wave": (rs.RecoveryScheduler, "_run_wave")})


def _sync() -> None:
    """Wait for the card (phase durable's sequence also runs on the CPU,
    in tests/test_torch_durable.py)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class ClusterRun:
    """One timed, launch-counted and wire-counted sub-phase of the
    cluster and durable phases: ``with ClusterRun(K, c) as run: ...``
    then ``run.line(**fields)``; ``timer`` makes the host-time
    breakdown's CallTimer."""

    def __init__(self, K, c, timer=cluster_timer):
        self.K, self.c, self.make_timer = K, c, timer

    def __enter__(self):
        _sync()
        self.launches0 = dict(self.K.launches)
        self.wire0 = (self.c.wire.totals(), self.c.wire.class_bytes())
        self.timer = self.make_timer().__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync()
        self.seconds = time.perf_counter() - self.t0
        self.timer.__exit__(*exc)
        self.launches = {k: self.K.launches[k] - self.launches0[k]
                         for k in self.K.launches}
        tot, cls = self.c.wire.totals(), self.c.wire.class_bytes()
        self.wire = {"tx_bytes": tot["tx_bytes"] - self.wire0[0]["tx_bytes"],
                     "tx_msgs": tot["tx_msgs"] - self.wire0[0]["tx_msgs"],
                     "class_bytes": {k: v - self.wire0[1][k]
                                     for k, v in cls.items()
                                     if v != self.wire0[1][k]}}
        return False

    def line(self, **fields) -> dict:
        return {"seconds": self.seconds, "launches": self.launches,
                "wire": self.wire, "host_breakdown": self.timer.report(),
                **fields}


def _cluster_check_chunks(c, pid, oids, encs, crcs, osds=None,
                          hashes: bool = True) -> int:
    """Every chunk of ``oids`` on the OSDs of its PG's acting set (or only
    ``osds``) against ``encs`` (the numpy encodes); each HashInfo against
    ``crcs`` (the host crc32c of each chunk) with ``hashes``, else (the
    chunk hashes an overwrite clears) against the primary's HashInfo.
    Returns the bytes checked."""
    from ceph_tpu_torch.backend import GObject
    from ceph_tpu_torch.backend.ecutil import HINFO_KEY
    from ceph_tpu_torch.backend.pg_backend import shard_store
    checked = 0
    for oid, want, crc in zip(oids, encs, crcs):
        g = c.pg_group(pid, oid)
        prim = shard_store(g.bus, g.acting[0]).getattr(
            GObject(oid, g.acting[0]), HINFO_KEY)
        for chunk, osd in enumerate(g.acting):
            if osds is not None and osd not in osds:
                continue
            store = shard_store(g.bus, osd)
            got = store.read(GObject(oid, osd))
            if got != want[chunk].tobytes():
                raise AssertionError(f"cluster: {oid} chunk {chunk} on "
                                     f"osd.{osd} != numpy encode")
            h = store.getattr(GObject(oid, osd), HINFO_KEY)
            if hashes and h["cumulative_shard_hashes"][chunk] != crc[chunk]:
                raise AssertionError(f"cluster: {oid} chunk {chunk} "
                                     f"HashInfo != host crc32c")
            if not hashes and h != prim:
                raise AssertionError(f"cluster: {oid} osd.{osd} HashInfo "
                                     f"!= the primary's")
            checked += len(got)
    return checked


def _cluster_degraded_gets(c, pid, data: dict, chunks=(1, 9)) -> list:
    """Every object of ``data`` read with the OSDs of its PG's ``chunks``
    down (one PG at a time: a down OSD is down for every PG it serves,
    and a down primary serves nothing); returns the objects that
    differ."""
    by_pg: dict = {}
    for oid in data:
        by_pg.setdefault(c.object_pg(pid, oid), []).append(oid)
    bad = []
    for ps, oids in sorted(by_pg.items()):
        g = c.pools[pid]["pgs"][ps]
        down = [g.acting[i] for i in chunks]
        for o in down:
            c.bus.mark_down(o)
        for oid in oids:
            if c.get(pid, oid, len(data[oid])) != data[oid]:
                bad.append(oid)
        for o in down:
            c.bus.mark_up(o)
        c.deliver_all()
    return bad


def _cluster_down_overwrite_up(K, c, pid, victim, data: dict, new: dict
                               ) -> tuple[dict, dict]:
    """``victim`` goes down, every object of ``new`` is overwritten
    (degraded writes: its PGs run one shard short), ``victim`` comes
    back and the scheduler's waves repair it; the scheduler must drain.
    Returns the overwrite's and the repair's runs' fields."""
    if any(g.backend.whoami == victim
           for g in c.pools[pid]["pgs"].values()):
        raise AssertionError(f"cluster: osd.{victim} is a primary")
    c.bus.mark_down(victim)
    with ClusterRun(K, c) as w:
        for oid, d in new.items():
            c.put(pid, oid, d)
    states = c.status()["pgmap"]["pgs_by_state"]
    data.update(new)
    perf0 = _cluster_perf(c, pid)
    with ClusterRun(K, c) as r:
        c.bus.mark_up(victim)
        c.deliver_all()
    perf = {k: v - perf0[k] for k, v in _cluster_perf(c, pid).items()}
    summary = c.recovery.summary()
    if c.recovery.jobs or summary["reservations"]["granted"] or any(
            g.backend.stale for g in c.pools[pid]["pgs"].values()):
        raise AssertionError(f"cluster: scheduler did not drain: "
                             f"{c.recovery.dump()}")
    return (w.line(objects=len(new), pgs_by_state=states,
                   ms_per_op=w.seconds / len(new) * 1e3),
            r.line(victim=victim, perf=perf, recovery=summary,
                   waves=c.recovery.perf.get("waves")))


def _cluster_perf(c, pid) -> dict:
    keys = ("recoveries", "recovery_bytes", "chain_objects",
            "chain_fallbacks", "regen_objects", "regen_fallbacks",
            "log_repair_objects")
    out = dict.fromkeys(keys, 0)
    for g in c.pools[pid]["pgs"].values():
        for k in keys:
            out[k] += g.backend.perf.get(k)
    return out


def phase_cluster(K, ecutil, registry_cls, objects: int = 64,
                  obj_bytes: int = 4 * MIB, regen_objects: int = 16,
                  small_objects: int = 16) -> tuple[dict, int, int]:
    """A Ceph user's main path through the port's MiniCluster: 12 OSDs on
    4 hosts, the recovery scheduler with the option defaults, an EC pool
    torch_rs k=8 m=4 reed_sol_van with no device key (the card), pg_num
    32 (osd_pool_default_pg_num), whose rule is chooseleaf_indep 12 type
    0 (every OSD holds one shard of every PG), 4 KiB stripe unit,
    ``objects`` objects of 4 MiB (the RBD object size).  (a) put each
    object; (b) get each, then each with the OSDs of its chunks 1 and 9
    down; (c) osd.3 (primary of no PG) down, every object overwritten,
    osd.3 up: the scheduler's waves repair it centrally, (d) the same by
    chains; (e) a pm_regen k=3 m=2 d=4 MBR pool on a cluster of its own,
    the same cycle; (f) a replicated pool of size 3, then EC writes and
    degraded reads through ``enable_serving()``.  The launch counts are
    zeroed after the payloads and their numpy encodes are made and read
    at the end.  Returns the sub-phase lines and the gf_apply and
    crc32c_rows launches."""
    from ceph_tpu_torch.cluster import MiniCluster
    from ceph_tpu_torch.common import Context
    t_phase = time.perf_counter()
    registry = registry_cls.instance()
    k, m, unit, victim = 8, 4, 4096, 3
    profile = {"k": str(k), "m": str(m), "technique": "reed_sol_van"}
    host = registry.factory("torch_rs", "", profile | {"device": "numpy"})
    chunk = host.get_chunk_size(k * unit)
    rng = np.random.default_rng(12)
    bufs = [rng.integers(0, 256, obj_bytes, dtype=np.uint8)
            for _ in range(objects)]
    host_enc = ecutil.encode_many(ecutil.StripeInfo(k, chunk), host, bufs)
    crcs = _host_crcs(host_enc)
    oids = [f"rbd_data.{i:04x}" for i in range(objects)]
    setup_s = time.perf_counter() - t_phase
    c = MiniCluster(n_osds=12, osds_per_host=3, chunk_size=unit,
                    cct=Context())
    lines = {}
    try:
        c.enable_recovery_scheduler()
        pid = c.create_ec_pool("rbd", dict(profile), pg_num=32)
        ec = c.pools[pid]["ec"]
        steps = c.osdmap.crush.rules[c.pools[pid]["pool"].crush_rule].steps
        if ec.get_profile()["device"] != "cuda" or steps[1][1:] != (12, 0):
            raise AssertionError(f"cluster: not torch_rs on the card over "
                                 f"chooseleaf_indep 12 type 0: {steps}")
        torch.cuda.synchronize()
        K.reset_launches()
        # (a) writes
        with ClusterRun(K, c) as run:
            for oid, buf in zip(oids, bufs):
                c.put(pid, oid, buf.tobytes())
        t0 = time.perf_counter()
        checked = _cluster_check_chunks(c, pid, oids, host_enc, crcs)
        check_s = time.perf_counter() - t0
        if run.launches["gf_apply"] != objects or \
                run.launches["crc32c_rows"] != objects:
            raise AssertionError(f"cluster writes: {run.launches}")
        lines["write"] = run.line(objects=objects, checked_bytes=checked,
                                  ms_per_op=run.seconds / objects * 1e3,
                                  MiBps=objects * obj_bytes / MIB /
                                  run.seconds, check_s=check_s)
        # (b) reads, then degraded reads
        data = {oid: buf.tobytes() for oid, buf in zip(oids, bufs)}
        with ClusterRun(K, c) as run:
            bad = [oid for oid, d in data.items()
                   if c.get(pid, oid, len(d)) != d]
        healthy = run.line(objects=objects,
                           ms_per_op=run.seconds / objects * 1e3)
        with ClusterRun(K, c) as run:
            bad += _cluster_degraded_gets(c, pid, data)
        if bad or run.launches["gf_apply"] != objects or \
                healthy["launches"]["gf_apply"]:
            raise AssertionError(f"cluster reads: {bad[:4]} "
                                 f"{healthy['launches']} {run.launches}")
        lines["read"] = {"healthy": healthy, "degraded": run.line(
            objects=objects, lost_chunks=[1, 9],
            ms_per_op=run.seconds / objects * 1e3)}
        # (c) centralized repair, (d) chain repair: each overwrite moves
        # every object to another payload (object i takes payload i + s)
        for s, chain in ((1, False), (2, True)):
            c.cct.conf.set("osd_recovery_chain_enable", chain)
            order = [(i + s) % objects for i in range(objects)]
            new = {oid: bufs[j].tobytes() for oid, j in zip(oids, order)}
            w, r = _cluster_down_overwrite_up(K, c, pid, victim, data, new)
            t0 = time.perf_counter()
            repaired = _cluster_check_chunks(
                c, pid, oids, [host_enc[j] for j in order],
                [crcs[j] for j in order], osds={victim}, hashes=False)
            bad = [oid for oid, d in data.items()
                   if c.get(pid, oid, len(d)) != d]
            check_s = time.perf_counter() - t0
            # a wave of one object takes the per-object path (nothing to
            # fuse), so chains carry the objects of multi-object waves
            if bad or r["perf"]["recoveries"] != objects or \
                    (chain and not r["perf"]["chain_objects"]):
                raise AssertionError(f"cluster repair: {bad[:4]} "
                                     f"{r['perf']}")
            lines["repair_chain" if chain else "repair_wave"] = {
                "overwrite": w, "repair": r | {
                    "repaired_bytes": repaired,
                    "rebuilt_MiBps": repaired / MIB / r["seconds"],
                    "wire_bytes_per_repaired_byte":
                        r["wire"]["class_bytes"].get("recovery", 0.0)
                        / repaired, "check_s": check_s}}
        # (f) a replicated pool (no kernel), then serving
        rep = c.create_replicated_pool("rep", size=3, pg_num=32)
        small = {f"rep.{i}": bufs[i].tobytes()
                 for i in range(small_objects)}
        with ClusterRun(K, c) as run:
            for oid, d in small.items():
                c.put(rep, oid, d)
            bad = [oid for oid, d in small.items()
                   if c.get(rep, oid, len(d)) != d]
        if bad or any(run.launches.values()):
            raise AssertionError(f"replicated pool: {bad} {run.launches}")
        lines["replicated"] = run.line(objects=small_objects)
        eng = c.enable_serving()
        eng0, pipe0 = eng.perf.dump(), eng.pipeline.perf.dump()
        served = {f"srv.{i}": bufs[-1 - i].tobytes()
                  for i in range(small_objects)}
        with ClusterRun(K, c) as run:
            for oid, d in served.items():
                c.put(pid, oid, d)
            bad = _cluster_degraded_gets(c, pid, served)
            eng.flush()
        engine = _perf_delta(eng0, eng.perf.dump(), ENGINE_KEYS)
        epipe = _perf_delta(pipe0, eng.pipeline.perf.dump(), PIPE_KEYS)
        if bad or epipe["errors"] or engine["ops_failed"] or \
                epipe["completed"] != epipe["submitted"] or \
                not engine["batches"]:
            raise AssertionError(f"cluster serving: {bad} {engine} {epipe}")
        lines["serving"] = run.line(objects=small_objects, engine=engine,
                                    pipeline=epipe)
        launches = dict(K.launches)
        lines["status"] = c.status()["pgmap"]
        lines["health"] = c.health()
    finally:
        c.shutdown()
    # (e) regenerating repair: pm_regen k=3 m=2 d=4 MBR on a cluster whose
    # chunk size fits the code (its own, as the reference's tests build)
    prof = {"plugin": "pm_regen", "k": "3", "m": "2", "d": "4",
            "mode": "mbr"}
    pm_host = registry.factory("pm_regen", "", prof | {"device": "numpy"})
    rchunk = pm_host.get_chunk_size(3 * unit)
    rsinfo = ecutil.StripeInfo(3, rchunk)
    rsinfo.stored_chunk_size = pm_host.get_stored_chunk_size(rchunk)
    pad = -obj_bytes % rsinfo.stripe_width
    t0 = time.perf_counter()
    rbufs = [np.concatenate([b, np.zeros(pad, np.uint8)])
             for b in bufs[:regen_objects + 1]]
    renc = [ecutil.encode(rsinfo, pm_host, b) for b in rbufs]
    setup_s += time.perf_counter() - t0
    rc = MiniCluster(n_osds=12, osds_per_host=3, chunk_size=rchunk,
                     cct=Context())
    try:
        rc.enable_recovery_scheduler()
        rpid = rc.create_ec_pool("regen", dict(prof), pg_num=32)
        roids = [f"regen.{i}" for i in range(regen_objects)]
        K.reset_launches()
        rdata = {}
        with ClusterRun(K, rc) as run:
            for oid, b in zip(roids, rbufs):
                rdata[oid] = b[:obj_bytes].tobytes()
                rc.put(rpid, oid, rdata[oid])
        rw = run.line(objects=regen_objects)
        pgs = rc.pools[rpid]["pgs"]
        prim = {g.backend.whoami for g in pgs.values()}
        load: dict = {}
        for oid in roids:
            for o in rc.pg_group(rpid, oid).acting[1:]:
                if o not in prim:
                    load[o] = load.get(o, 0) + 1
        rvictim = min(load, key=lambda o: (-load[o], o))
        new = {oid: rbufs[i + 1][:obj_bytes].tobytes()
               for i, oid in enumerate(roids)}
        w, r = _cluster_down_overwrite_up(K, rc, rpid, rvictim, rdata, new)
        repaired = _cluster_check_chunks(
            rc, rpid, roids, renc[1:], [None] * regen_objects,
            osds={rvictim}, hashes=False)
        bad = [oid for oid, d in rdata.items()
               if rc.get(rpid, oid, len(d)) != d]
        if bad or r["perf"]["regen_objects"] != load[rvictim]:
            raise AssertionError(f"cluster regen: {bad[:4]} {r['perf']} "
                                 f"{load[rvictim]}")
        lines["repair_regen"] = {
            "profile": prof, "chunk_size": rchunk, "write": rw,
            "overwrite": w, "repair": r | {
                "repaired_bytes": repaired,
                "wire_bytes_per_repaired_byte":
                    r["wire"]["class_bytes"].get("recovery", 0.0)
                    / repaired}}
        for key in launches:
            launches[key] += K.launches[key]
    finally:
        rc.shutdown()
    del bufs, host_enc, rbufs, renc
    torch.cuda.empty_cache()
    lines["launches"] = launches
    lines["timing"] = {"seconds": time.perf_counter() - t_phase,
                       "setup_s": setup_s}
    return lines, launches["gf_apply"], launches["crc32c_rows"]


def cluster_launch_shapes(PS, registry_cls, seen) -> dict:
    """Phase cluster's kernel calls by (kernel, matrix shape, data rows,
    columns), as recorded, against ``path_shapes.cluster_shapes``, whose
    rows phase ``shapes`` times: every call must be at a shape timed
    there, as often as the rows say."""
    want = PS.shape_counts(PS.cluster_shapes(registry_cls.instance()))
    if dict(seen) != dict(want):
        raise AssertionError(f"cluster: launches by shape {dict(seen)} != "
                             f"path_shapes.cluster_shapes {dict(want)}")
    return {"checked": [[kernel, list(mat), rows, cols, n] for
                        (kernel, mat, rows, cols), n in sorted(seen.items())]}


# -- phase durable ------------------------------------------------------------

# phase durable's store fault campaign (f): one seed, a read-EIO rate a
# shard read (path_shapes.DURABLE_FAULT_DECODES counts its decodes)
DURABLE_FAULT_SEED = 7
DURABLE_EIO_READ = 0.02


def durable_timer() -> CallTimer:
    """cluster_timer's functions and the durable path's: the stores' host
    crc32c (every BlueStore blob written and read, every FileStore WAL
    record), their transaction apply, blob reads and checkpoints, the
    client's IoCtx calls and the tier's flush, evict and promote."""
    from ceph_tpu_torch.backend import bluestore as bls, filestore as fls
    from ceph_tpu_torch.client import rados as rd
    from ceph_tpu_torch.tier import service as ts
    return CallTimer({
        **cluster_timer().targets,
        "store_crc32c_bluestore": (bls, "crc32c"),
        "store_crc32c_filestore": (fls, "crc32c"),
        "bluestore_apply": (bls.BlueStoreLite, "queue_transaction"),
        "bluestore_read": (bls.BlueStoreLite, "read"),
        "bluestore_checkpoint": (bls.BlueStoreLite, "checkpoint"),
        "filestore_apply": (fls.FileStore, "queue_transaction"),
        "filestore_checkpoint": (fls.FileStore, "checkpoint"),
        "ioctx_write_full": (rd.IoCtx, "write_full"),
        "ioctx_read": (rd.IoCtx, "read"),
        "tier_write": (ts.TierService, "write"),
        "tier_read": (ts.TierService, "read"),
        "tier_flush": (ts.TierService, "flush"),
        "tier_evict": (ts.TierService, "evict")})


def _durable_check_hinfo(c, pid, oids, crcs, required: bool) -> int:
    """Every HashInfo of ``oids`` on its PG's acting set: where its chunk
    hashes are present (an overwrite clears them), each against the host
    crc32c of the chunk; ``required``: every one must be present.  Reads
    attributes only (no blob).  Returns the crcs checked."""
    from ceph_tpu_torch.backend import GObject
    from ceph_tpu_torch.backend.ecutil import HINFO_KEY
    from ceph_tpu_torch.backend.pg_backend import shard_store
    checked = 0
    for oid, crc in zip(oids, crcs):
        g = c.pg_group(pid, oid)
        for chunk, osd in enumerate(g.acting):
            h = shard_store(g.bus, osd).getattr(GObject(oid, osd), HINFO_KEY)
            hashes = h["cumulative_shard_hashes"]
            if not hashes and required:
                raise AssertionError(f"durable: {oid} osd.{osd} HashInfo "
                                     f"has no chunk hashes")
            if hashes and hashes[chunk] != crc[chunk]:
                raise AssertionError(f"durable: {oid} chunk {chunk} "
                                     f"HashInfo != host crc32c")
            checked += bool(hashes)
    return checked


def _durable_writes_reads(K, c, pid, oids, payloads, crcs,
                          on_card: bool) -> dict:
    """``rados put`` then ``rados get`` of every object through
    ``client.rados`` (Rados -> IoCtx -> Objecter -> the OSDs), every
    HashInfo against the host crc32c (the chunks' bytes are held against
    the numpy encode after the reload); on the card one gf_apply and one
    crc32c_rows launch a write, none a read."""
    from ceph_tpu_torch.client.rados import Rados
    r = Rados(c)
    io = r.open_ioctx("rbd")
    n = len(oids)
    with ClusterRun(K, c, durable_timer) as w:
        for oid, d in zip(oids, payloads):
            io.write_full(oid, d)
    t0 = time.perf_counter()
    checked = _durable_check_hinfo(c, pid, oids, crcs, required=True)
    check_s = time.perf_counter() - t0
    with ClusterRun(K, c, durable_timer) as rd:
        bad = [oid for oid, d in zip(oids, payloads) if io.read(oid) != d]
    r.shutdown()
    if bad or (on_card and (w.launches["gf_apply"] != n or
                            w.launches["crc32c_rows"] != n or
                            rd.launches["gf_apply"])):
        raise AssertionError(f"durable writes/reads: {bad[:4]} "
                             f"{w.launches} {rd.launches}")
    return {"write": w.line(objects=n, hashinfo_crcs_checked=checked,
                            check_s=check_s, ms_per_op=w.seconds / n * 1e3,
                            MiBps=sum(map(len, payloads)) / MIB / w.seconds),
            "read": rd.line(objects=n, ms_per_op=rd.seconds / n * 1e3)}


def _durable_reload(K, MiniCluster, Context, d, pid, oids, payloads,
                    host_enc, crcs) -> tuple:
    """``MiniCluster.load`` of ``d`` (boot peering, boot repair), then
    every object read back bitwise and every chunk against the numpy
    encode; a HashInfo whose chunk hashes are present is held against the
    host crc32c, one an overwrite cleared against the primary's.  Returns
    the reopened cluster and the run's fields."""
    from ceph_tpu_torch.client.rados import Rados
    _sync()
    t0 = time.perf_counter()
    launches0 = dict(K.launches)
    c = MiniCluster.load(d, cct=Context())
    _sync()
    load_s = time.perf_counter() - t0
    boot = {k: K.launches[k] - launches0[k] for k in K.launches}
    r = Rados(c)
    io = r.open_ioctx("rbd")
    with ClusterRun(K, c, durable_timer) as rd:
        bad = [oid for oid, d0 in zip(oids, payloads) if io.read(oid) != d0]
    r.shutdown()
    t0 = time.perf_counter()
    hashed = _durable_check_hinfo(c, pid, oids, crcs, required=False)
    checked = _cluster_check_chunks(c, pid, oids, host_enc, crcs,
                                    hashes=False)
    check_s = time.perf_counter() - t0
    if bad or set(c.objects.get(pid, ())) < set(oids):
        raise AssertionError(f"durable reload: {bad[:4]}")
    return c, {"load_s": load_s, "boot_launches": boot,
               "read": rd.line(objects=len(oids),
                               ms_per_op=rd.seconds / len(oids) * 1e3),
               "checked_bytes": checked, "hashinfo_crcs_checked": hashed,
               "check_s": check_s}


def _durable_monitor_cycle(K, c, mon, pid, victim, oids, payloads,
                           host_enc) -> dict:
    """``ceph osd down`` the way a cluster does it: the heartbeat mesh on
    a virtual clock stops hearing ``victim``, its peers report it and the
    monitor quorum commits it down; every object is overwritten through
    the client (11 of 12 shards); ``victim`` answers again, boots, the
    commit marks it up and the recovery scheduler repairs it on the card.
    Its chunks are then held against the numpy encode."""
    from ceph_tpu_torch.client.rados import Rados
    from ceph_tpu_torch.mon.heartbeat import (VirtualClock,
                                              build_heartbeat_mesh)
    if any(g.backend.whoami == victim for g in c.pools[pid]["pgs"].values()):
        raise AssertionError(f"durable: osd.{victim} is a primary")
    clock = VirtualClock()
    agents = build_heartbeat_mesh(mon, clock, c.n_osds)
    net = agents[0].network
    interval = c.cct.conf.get("osd_heartbeat_interval")

    def beat(until, limit: int = 20) -> int:
        for n in range(1, limit + 1):
            clock.advance(interval)
            for o, a in sorted(agents.items()):
                if net.get(o) is not None:
                    a.tick()
            mon.tick(clock.now())
            c.deliver_all()
            if until():
                return n
        raise AssertionError(f"durable: the monitor did not commit osd."
                             f"{victim} after {limit} heartbeats")
    beat(lambda: True, 2)                    # every peer heard once
    epoch0 = mon.osdmap.epoch
    net[victim] = None
    with ClusterRun(K, c, durable_timer) as dn:
        beats_down = beat(lambda: mon.osdmap.is_down(victim))
    if victim not in c.bus.down:
        raise AssertionError("durable: the commit did not reach the PGs")
    r = Rados(c)
    io = r.open_ioctx("rbd")
    with ClusterRun(K, c, durable_timer) as w:
        for oid, d in zip(oids, payloads):
            io.write_full(oid, d)
    r.shutdown()
    perf0 = _cluster_perf(c, pid)
    net[victim] = agents[victim]
    with ClusterRun(K, c, durable_timer) as rep:
        beats_up = beat(lambda: mon.osdmap.is_up(victim))
        c.deliver_all()
    perf = {k: v - perf0[k] for k, v in _cluster_perf(c, pid).items()}
    summary = c.recovery.summary()
    if c.recovery.jobs or summary["reservations"]["granted"] or any(
            g.backend.stale for g in c.pools[pid]["pgs"].values()):
        raise AssertionError(f"durable: scheduler did not drain: "
                             f"{c.recovery.dump()}")
    t0 = time.perf_counter()
    repaired = _cluster_check_chunks(c, pid, oids, host_enc,
                                     [None] * len(oids), osds={victim},
                                     hashes=False)
    check_s = time.perf_counter() - t0
    if perf["recoveries"] != len(oids):
        raise AssertionError(f"durable repair: {perf}")
    n = len(oids)
    return {"down": dn.line(beats=beats_down, epochs=mon.osdmap.epoch - epoch0,
                            quorum=sorted(mon.quorum_ranks())),
            "overwrite": w.line(objects=n, ms_per_op=w.seconds / n * 1e3),
            "repair": rep.line(
                victim=victim, beats=beats_up, perf=perf, recovery=summary,
                waves=c.recovery.perf.get("waves"), repaired_bytes=repaired,
                rebuilt_MiBps=repaired / MIB / rep.seconds,
                wire_bytes_per_repaired_byte=rep.wire["class_bytes"].get(
                    "recovery", 0.0) / repaired, check_s=check_s),
            "epoch": mon.osdmap.epoch,
            "clusterlog": [e["message"] for e in c.clusterlog.last(500)
                           if e["channel"] == "mon"][-4:]}


def _durable_tier(K, c, pid, bufs, host_enc, crcs, objects: int) -> dict:
    """A writeback cache tier (a replicated pool, size 3, pg_num 8) over
    the EC pool: ``objects`` writes absorbed by the tier (no kernel), one
    agent pass flushing them all into the EC pool (an encode and a crc
    each, every chunk against the numpy encode), then every object
    evicted and read through the tier: a proxied read of the EC pool
    and a promote."""
    conf = c.cct.conf
    for key, value in (("tier_target_max_objects", 2 * objects),
                       ("tier_dirty_ratio_high", 0.25),
                       ("tier_dirty_ratio_low", 0.0),
                       ("tier_agent_max_ops", objects),
                       ("tier_promote_min_recency", 1)):
        conf.set(key, value)
    cache = c.create_replicated_pool(
        "cache", size=3, pg_num=8,
        params={"hit_set_count": "2", "hit_set_period": "8"})
    svc = c.create_tier(cache, pid)
    oids = [f"tier.{i:04x}" for i in range(objects)]
    data = {oid: bufs[i].tobytes() for i, oid in enumerate(oids)}
    with ClusterRun(K, c, durable_timer) as w:
        for oid, d in data.items():
            svc.write(oid, d)
    with ClusterRun(K, c, durable_timer) as fl:
        agent = svc.agent.tick()
    checked = _cluster_check_chunks(c, pid, oids, host_enc[:objects],
                                    crcs[:objects])
    with ClusterRun(K, c, durable_timer) as ev:
        for oid in oids:
            svc.evict(oid)
    with ClusterRun(K, c, durable_timer) as pr:
        bad = [oid for oid, d in data.items() if svc.read(oid) != d]
    stats = svc.stats()
    ctr = stats["counters"]
    if bad or agent["flushes"] != objects or any(svc.is_dirty(o)
                                                 for o in oids) or \
            (ctr["evict"], ctr["proxy_read"], ctr["promote"]) != \
            (objects, objects, objects) or any(w.launches.values()):
        raise AssertionError(f"durable tier: {bad[:4]} {agent} {ctr} "
                             f"{w.launches}")
    return {"write": w.line(objects=objects,
                            ms_per_op=w.seconds / objects * 1e3),
            "flush": fl.line(objects=objects, agent=agent,
                             checked_bytes=checked,
                             ms_per_op=fl.seconds / objects * 1e3),
            "evict": ev.line(objects=objects),
            "proxy_promote": pr.line(objects=objects,
                                     ms_per_op=pr.seconds / objects * 1e3),
            "stats": stats}


def _durable_faults(K, c, pid, oids, payloads) -> dict:
    """Degraded gets (the OSDs of chunks 1 and 9 down, PG by PG) under a
    seeded StoreFaults read-EIO rate on every shard store: a get returns
    its bytes or raises the injected EIO; any other error, or an EIO the
    injector did not log, fails the phase.  Disarmed, every object reads
    back bitwise: no acked write is lost."""
    import errno
    from ceph_tpu_torch.failure import FaultPlan, StoreFaults
    data = dict(zip(oids, payloads))
    inj = c.inject_faults(FaultPlan(seed=DURABLE_FAULT_SEED,
                                    store=StoreFaults(
                                        eio_read_prob=DURABLE_EIO_READ)))
    outcome = {"ok": 0, "injected_eio": 0, "drain_eio": 0}

    def injected(e) -> bool:
        return getattr(e, "errno", None) == errno.EIO and \
            str(e).startswith("injected EIO")

    def drain():
        for _ in range(64):
            try:
                c.deliver_all()
                return
            except IOError as e:
                if not injected(e):
                    raise
                outcome["drain_eio"] += 1
        raise AssertionError("durable faults: the bus did not drain")
    by_pg: dict = {}
    for oid in oids:
        by_pg.setdefault(c.object_pg(pid, oid), []).append(oid)
    with ClusterRun(K, c, durable_timer) as run:
        for ps, pg_oids in sorted(by_pg.items()):
            g = c.pools[pid]["pgs"][ps]
            down = [g.acting[i] for i in (1, 9)]
            for o in down:
                c.bus.mark_down(o)
            for oid in pg_oids:
                try:
                    got = c.get(pid, oid, len(data[oid]))
                except IOError as e:
                    if not injected(e):
                        raise
                    outcome["injected_eio"] += 1
                    drain()
                    continue
                if got != data[oid]:
                    raise AssertionError(f"durable faults: {oid} differs")
                outcome["ok"] += 1
            for o in down:
                c.bus.mark_up(o)
            drain()
    events = inj.summary()
    c.inject_faults(None)
    c.deliver_all()
    bad = [oid for oid, d in data.items() if c.get(pid, oid, len(d)) != d]
    eio = events["planes"].get("store", {}).get("eio_read", 0)
    if bad or not eio or \
            outcome["injected_eio"] + outcome["drain_eio"] > eio:
        raise AssertionError(f"durable faults: {bad[:4]} {outcome} {events}")
    return run.line(objects=len(oids), outcome=outcome, injected=events,
                    seed=DURABLE_FAULT_SEED, eio_read_prob=DURABLE_EIO_READ,
                    digest=inj.event_digest(), lost_acked_writes=len(bad),
                    ms_per_op=run.seconds / len(oids) * 1e3)


def phase_durable(K, ecutil, registry_cls, objects: int = 64,
                  obj_bytes: int = 4 * MIB, device: str | None = None
                  ) -> tuple[dict, int, int]:
    """A Ceph user's durable deployment through the port: ``vstart`` with
    BlueStore, ``rados put/get``, ``ceph osd down``, a daemon restart.
    Phase cluster's widths (12 OSDs on 4 hosts, torch_rs k=8 m=4
    reed_sol_van with no device key, pg_num 32, 4 KiB stripe unit,
    ``objects`` of 4 MiB) on durable stores in a temporary directory:
    (a) a BlueStore cluster with the recovery scheduler and a 3-monitor
    quorum, every object written and read through ``client.rados``;
    (b) osd.3 reported by the heartbeat mesh and committed down, every
    object overwritten, osd.3 booted and repaired on the card;
    (c) shutdown, ``MiniCluster.load`` (boot peering and repair), every
    object read back and every chunk and HashInfo checked; (d) (a) and
    (c) on FileStore (``path_shapes.DURABLE_FILE`` objects: cut from 64
    to keep the script's time, PERF.md §4); (e) a writeback cache tier
    over the reloaded EC pool, ``DURABLE_TIER`` writes, one agent flush
    pass, evictions, proxied reads and promotes; (f) degraded gets under
    a seeded store read-EIO plan.  ``device`` None runs the pool on the
    card (tests run the sequence with "cpu").  Returns the sub-phase
    lines and the gf_apply and crc32c_rows launches."""
    import shutil
    import tempfile
    from pathlib import Path
    from ceph_tpu_torch.cluster import MiniCluster
    from ceph_tpu_torch.common import Context
    from ceph_tpu_torch.tools.path_shapes import (DURABLE_FILE,
                                                  DURABLE_TIER)
    t_phase = time.perf_counter()
    on_card = device is None
    registry = registry_cls.instance()
    k, m, unit, victim = 8, 4, 4096, 3
    profile = {"k": str(k), "m": str(m), "technique": "reed_sol_van"}
    if device is not None:
        profile["device"] = device
    host = registry.factory("torch_rs", "", profile | {"device": "numpy"})
    chunk = host.get_chunk_size(k * unit)
    rng = np.random.default_rng(12)
    bufs = [rng.integers(0, 256, obj_bytes, dtype=np.uint8)
            for _ in range(objects)]
    sinfo = ecutil.StripeInfo(k, chunk)
    host_enc = ecutil.encode_many(sinfo, host, bufs)
    crcs = _host_crcs(host_enc)
    oids = [f"rbd_data.{i:04x}" for i in range(objects)]
    payloads = [b.tobytes() for b in bufs]
    # (b)'s overwrite: object i takes payload i + 1
    order = [(i + 1) % objects for i in range(objects)]
    setup_s = time.perf_counter() - t_phase
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_durable."))
    lines: dict = {}
    launches = dict.fromkeys(K.launches, 0)
    _sync()
    K.reset_launches()
    c = None
    try:
        # (a) BlueStore: vstart, rados put/get
        c = MiniCluster(n_osds=12, osds_per_host=3, chunk_size=unit,
                        cct=Context(), data_dir=root / "blue",
                        store_backend="bluestore")
        c.enable_recovery_scheduler()
        pid = c.create_ec_pool("rbd", dict(profile), pg_num=32)
        if c.pools[pid]["ec"].get_profile()["device"] != (device or "cuda"):
            raise AssertionError("durable: the pool is not on the card")
        mon = c.attach_monitor(n_mons=3)
        lines["bluestore"] = _durable_writes_reads(
            K, c, pid, oids, payloads, crcs, on_card)
        # (b) down and up through the monitor
        lines["monitor"] = _durable_monitor_cycle(
            K, c, mon, pid, victim, oids, [payloads[j] for j in order],
            [host_enc[j] for j in order])
        # (c) restart
        t0 = time.perf_counter()
        c.shutdown()
        shutdown_s = time.perf_counter() - t0
        c = None
        c, reload = _durable_reload(
            K, MiniCluster, Context, root / "blue", pid, oids,
            [payloads[j] for j in order], [host_enc[j] for j in order],
            [crcs[j] for j in order])
        lines["bluestore_reload"] = reload | {"shutdown_s": shutdown_s}
        # (e) cache tier over the reloaded EC pool
        lines["tier"] = _durable_tier(K, c, pid, bufs, host_enc, crcs,
                                      DURABLE_TIER)
        # (f) store faults during degraded gets
        lines["faults"] = _durable_faults(K, c, pid, oids,
                                          [payloads[j] for j in order])
        lines["status"] = c.status()["pgmap"]
        c.shutdown()
        c = None
        # (d) FileStore: the same as (a) and (c)
        fo = oids[:DURABLE_FILE]
        c = MiniCluster(n_osds=12, osds_per_host=3, chunk_size=unit,
                        cct=Context(), data_dir=root / "file",
                        store_backend="file")
        c.enable_recovery_scheduler()
        fpid = c.create_ec_pool("rbd", dict(profile), pg_num=32)
        lines["filestore"] = _durable_writes_reads(
            K, c, fpid, fo, payloads[:DURABLE_FILE], crcs[:DURABLE_FILE],
            on_card)
        t0 = time.perf_counter()
        c.shutdown()
        shutdown_s = time.perf_counter() - t0
        c = None
        c, reload = _durable_reload(
            K, MiniCluster, Context, root / "file", fpid, fo,
            payloads[:DURABLE_FILE], host_enc[:DURABLE_FILE],
            crcs[:DURABLE_FILE])
        lines["filestore_reload"] = reload | {"shutdown_s": shutdown_s}
        launches = dict(K.launches)
        disk = sum(f.stat().st_size for f in root.rglob("*") if f.is_file())
    finally:
        if c is not None:
            c.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    lines["launches"] = launches
    lines["timing"] = {"seconds": time.perf_counter() - t_phase,
                       "setup_s": setup_s, "disk_bytes": disk}
    return lines, launches["gf_apply"], launches["crc32c_rows"]


def durable_launch_shapes(PS, registry_cls, seen) -> dict:
    """Phase durable's kernel calls by (kernel, matrix shape, data rows,
    columns), as recorded, against ``path_shapes.durable_shapes``."""
    want = PS.shape_counts(PS.durable_shapes(registry_cls.instance()))
    if dict(seen) != dict(want):
        raise AssertionError(f"durable: launches by shape {dict(seen)} != "
                             f"path_shapes.durable_shapes {dict(want)}")
    return {"checked": [[kernel, list(mat), rows, cols, n] for
                        (kernel, mat, rows, cols), n in sorted(seen.items())]}


# -- phase net ----------------------------------------------------------------

NET_FAULT_SEED = 11
NET_FAULTS = {"reset_prob": 0.05, "blackhole_prob": 0.02,
              "truncate_prob": 0.02, "delay_prob": 0.05, "delay_ms": 5.0}
# the mux client's options under transport faults (tests/
# test_async_faults.py's): short attempts, fast reconnects
NET_FAULT_CONF = {"ms_rpc_timeout": 6.0, "ms_rpc_retry_attempts": 8,
                  "ms_reconnect_backoff_base": 0.01,
                  "ms_reconnect_backoff_cap": 0.05}
# the closed loop's client: one attempt a call may wait out the queue of
# every session ahead of it (all the sessions' puts on one cluster lock)
NET_MUX_CONF = {"ms_rpc_timeout": 600.0, "ms_rpc_retry_attempts": 2}
NET_MUX_CONNS = 8
NET_OVERLOAD = {"ms_async_dispatch_queue_max": 64, "ms_async_op_threads": 1}


def _thread_role() -> str:
    """The calling thread's part in the TCP path: the caller (the client
    application), the client's reactor, the mux sender, the server's
    reactor or one of its dispatch workers."""
    name = threading.current_thread().name
    if name == "reactor.client":
        return "client_reactor"
    if name.startswith("reactor."):
        return "server_reactor"
    if ".dispatch." in name:
        return "server_dispatch"
    if name.endswith(".sender"):
        return "mux_sender"
    return "caller"


def net_timer() -> CallTimer:
    """durable_timer's functions and the TCP path's, each split by the
    thread that ran it (``name@role``): a connection's send (encode,
    HMAC, write-queue enqueue), the stream parser's feed (frame parse,
    HMAC check), the server's RPC dispatch and the cluster call inside
    it, and the host crc32c of crc-mode frames."""
    from ceph_tpu_torch import cluster as cl, net
    from ceph_tpu_torch.backend import wire
    from ceph_tpu_torch.msg import connection, parser
    return CallTimer({
        **durable_timer().targets,
        "send": (connection.AsyncConnection, "send"),
        "parse": (parser.StreamParser, "feed"),
        "dispatch": (net.ClusterServer, "_dispatch"),
        "cluster_operate": (cl.MiniCluster, "operate"),
        "frame_crc": (wire, "_crc"), "stream_crc": (parser, "_crc")},
        role=_thread_role)


class NetRun(ClusterRun):
    """ClusterRun over the served cluster, with the bytes on its sockets
    (the server's wire accounting) and the per-op split of the caller's
    time: the client's send (encode + HMAC), the server's dispatch (the
    cluster call) and the rest (sockets, frame parsing, reply)."""

    def __init__(self, K, c, server, ops: int):
        super().__init__(K, c, net_timer)
        self.server, self.ops = server, ops

    def __enter__(self):
        self.tcp0 = self.server.wire.totals()
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        tcp = self.server.wire.totals()
        self.tcp = {k: tcp[k] - self.tcp0[k]
                    for k in ("tx_bytes", "rx_bytes", "tx_msgs", "rx_msgs")}
        return False

    def split_ms(self) -> dict:
        s = self.timer.seconds
        n = max(1, self.ops)
        total = self.seconds / n * 1e3
        send = s.get("send@caller", 0.0) / n * 1e3
        dispatch = s.get("dispatch@server_dispatch", 0.0) / n * 1e3
        return {"ms_per_op": total, "client_send_ms": send,
                "server_dispatch_ms": dispatch,
                "cluster_call_ms": s.get("cluster_operate@server_dispatch",
                                         0.0) / n * 1e3,
                "rest_ms": total - send - dispatch}

    def line(self, **fields) -> dict:
        return super().line(ops=self.ops, tcp=self.tcp, **self.split_ms(),
                            **fields)


def _net_degraded_gets(server, r, c, pid, data: dict, chunks=(1, 9)
                       ) -> list:
    """``_cluster_degraded_gets`` through the client: the OSDs of each
    PG's ``chunks`` go down (under the server's cluster lock: no RPC is
    in flight), then every object of the PG is read over TCP."""
    by_pg: dict = {}
    for oid in data:
        by_pg.setdefault(c.object_pg(pid, oid), []).append(oid)
    bad = []
    for ps, oids in sorted(by_pg.items()):
        with server.lock:
            g = c.pools[pid]["pgs"][ps]
            down = [g.acting[i] for i in chunks]
            for o in down:
                c.bus.mark_down(o)
        for oid in oids:
            if r.get("rbd", oid) != data[oid]:
                bad.append(oid)
        with server.lock:
            for o in down:
                c.bus.mark_up(o)
            c.deliver_all()
    return bad


def _net_serve(K, c, server, r, pid, oids, payloads, host_enc, crcs,
               on_card: bool) -> dict:
    """(a) ``rados put`` / ``get`` over TCP: every object put, every chunk
    against the numpy encode and every HashInfo against the host crc32c,
    every object read back, then read with the OSDs of chunks 1 and 9
    down; on the card one gf_apply and one crc32c_rows launch a put,
    none a healthy get, one gf_apply a degraded get."""
    n = len(oids)
    data = dict(zip(oids, payloads))
    with NetRun(K, c, server, n) as w:
        for oid, d in data.items():
            if r.put("rbd", oid, d) != len(d):
                raise AssertionError(f"net: put {oid} short")
    t0 = time.perf_counter()
    with server.lock:
        checked = _cluster_check_chunks(c, pid, oids, host_enc, crcs)
    check_s = time.perf_counter() - t0
    with NetRun(K, c, server, n) as rd:
        bad = [oid for oid, d in data.items() if r.get("rbd", oid) != d]
    with NetRun(K, c, server, n) as dg:
        bad += _net_degraded_gets(server, r, c, pid, data)
    if bad or (on_card and ((w.launches["gf_apply"],
                             w.launches["crc32c_rows"]) != (n, n) or
                            any(rd.launches.values()) or
                            (dg.launches["gf_apply"],
                             dg.launches["crc32c_rows"]) != (n, 0))):
        raise AssertionError(f"net serve: {bad[:4]} {w.launches} "
                             f"{rd.launches} {dg.launches}")
    return {"put": w.line(checked_bytes=checked, check_s=check_s,
                          MiBps=sum(map(len, payloads)) / MIB / w.seconds),
            "get": rd.line(), "degraded_get": dg.line(chunks_down=[1, 9])}


def _net_zero_copy(K, c, server, keyring, payloads) -> dict:
    """(b) the same puts and gets through one mux session with
    ``ms_zero_copy`` off, then on (the switch is process-wide: the
    server's config and the client's both set it): the bytes come back
    equal in both arms; the copy ledger's copies per payload byte served
    (requests counted where the server dispatches them, replies where
    the client completes them), by source."""
    from ceph_tpu_torch.common import Context, copy_ledger
    from ceph_tpu_torch.msg import MuxClient
    led = copy_ledger.ledger()
    conf = c.cct.conf
    out = {}
    try:
        for arm in (False, True):
            conf.set("ms_zero_copy", arm)
            mux = MuxClient("127.0.0.1", server.port, keyring,
                            cct=Context({"ms_zero_copy": arm}), n_conns=1)
            try:
                mux.connect()
                s = mux.session()
                led.reset()
                with NetRun(K, c, server, 2 * len(payloads)) as run:
                    bad = []
                    for i, d in enumerate(payloads):
                        oid = f"zc.{int(arm)}.{i:04x}"
                        s.call("put", {"pool": "rbd", "oid": oid,
                                       "data": d})
                        if s.call("get", {"pool": "rbd", "oid": oid}) != d:
                            bad.append(oid)
                snap = led.snapshot()
            finally:
                mux.close()
            if bad:
                raise AssertionError(f"net zero copy {arm}: {bad[:4]}")
            out["on" if arm else "off"] = run.line(
                objects=len(payloads),
                copies_per_byte=snap["copies_per_byte"],
                copied=snap["copied"], served=snap["served"])
    finally:
        conf.set("ms_zero_copy", True)
    return out


def _net_mux(K, c, server, keyring, sessions: int, obj_bytes: int,
             on_card: bool) -> dict:
    """(c) ``sessions`` MuxSessions over NET_MUX_CONNS connections, each
    a closed loop of one put of ``obj_bytes`` into the EC pool and then a
    get of it; every get must equal its put, and on the card the puts'
    gf_apply and crc32c_rows launches equal the sessions."""
    from ceph_tpu_torch.common import Context
    from ceph_tpu_torch.msg import MuxClient
    rng = np.random.default_rng(13)
    payloads = [rng.integers(0, 256, obj_bytes, dtype=np.uint8).tobytes()
                for _ in range(sessions)]
    mux = MuxClient("127.0.0.1", server.port, keyring,
                    cct=Context(dict(NET_MUX_CONF)), n_conns=NET_MUX_CONNS)
    lock = threading.Lock()
    state = {"done": 0, "bad": [], "lat": {"put": [], "get": []}}
    finished = threading.Event()

    def complete(i, kind, call):
        now = time.monotonic()
        try:
            value = call.value()
            ok = value == len(payloads[i]) if kind == "put" \
                else value == payloads[i]
            err = None if ok else f"{kind} {i}: wrong result"
        except (IOError, ConnectionError, TimeoutError) as e:
            err = f"{kind} {i}: {e!r}"
        with lock:
            state["lat"][kind].append(now - call.t_submit)
            if err is not None:
                state["bad"].append(err)
        if kind == "put" and err is None:
            mux_sessions[i].call_async(
                "get", {"pool": "rbd", "oid": f"mux.{i:05x}"},
                cb=lambda g, i=i: complete(i, "get", g))
            return
        with lock:
            state["done"] += 1
            if state["done"] == sessions:
                finished.set()

    try:
        mux.connect()
        mux_sessions = [mux.session() for _ in range(sessions)]
        with NetRun(K, c, server, 2 * sessions) as run:
            for i, s in enumerate(mux_sessions):
                s.call_async("put", {"pool": "rbd", "oid": f"mux.{i:05x}",
                                     "data": payloads[i]},
                             cb=lambda p, i=i: complete(i, "put", p))
            if not finished.wait(900):
                raise AssertionError(f"net mux: {state['done']} of "
                                     f"{sessions} sessions finished")
        stats = mux.stats()
    finally:
        mux.close()
    lat = {k: np.asarray(v) * 1e3 for k, v in state["lat"].items()}
    if state["bad"] or (on_card and (run.launches["gf_apply"],
                                     run.launches["crc32c_rows"]) !=
                        (sessions, sessions)):
        raise AssertionError(f"net mux: {state['bad'][:4]} {run.launches}")
    return run.line(
        sessions=sessions, connections=NET_MUX_CONNS, object_bytes=obj_bytes,
        goodput_ops_s=2 * sessions / run.seconds,
        p50_ms={k: float(np.percentile(v, 50)) for k, v in lat.items()},
        p99_ms={k: float(np.percentile(v, 99)) for k, v in lat.items()},
        client=stats)


def _net_overload(c, keyring, sessions: int) -> dict:
    """(c) the overload arm: a second server on the same cluster with
    NET_OVERLOAD's options, ``sessions`` sessions of one ping each
    submitted while the cluster is busy (its lock held, as by a long
    op): the full dispatch queue sheds with EBUSY, then every refused
    ping is sent again until all complete."""
    from ceph_tpu_torch.common import Context
    from ceph_tpu_torch.msg import EBUSY, MuxClient
    from ceph_tpu_torch.net import ClusterServer
    conf = c.cct.conf
    saved = {k: conf.get(k) for k in NET_OVERLOAD}
    for k, v in NET_OVERLOAD.items():
        conf.set(k, v)
    try:
        server = ClusterServer(c)
        server.start()              # the transport reads the options here
    finally:
        for k, v in saved.items():
            conf.set(k, v)
    mux = MuxClient("127.0.0.1", server.port, keyring,
                    cct=Context(dict(NET_MUX_CONF)), n_conns=2)
    t0 = time.perf_counter()
    try:
        mux.connect()
        ss = [mux.session() for _ in range(sessions)]
        with server.lock:
            calls = [s.call_async("ping", {"payload": i})
                     for i, s in enumerate(ss)]
            deadline = time.monotonic() + 60
            while mux.stats()["sheds_seen"] == 0 and \
                    time.monotonic() < deadline:
                time.sleep(0.01)
        pending = dict(enumerate(calls))
        rounds = sheds = 0
        while pending and rounds < 200:
            rounds += 1
            retry = {}
            for i, call in pending.items():
                if not call.event.wait(120):
                    raise AssertionError(f"net overload: ping {i} hung")
                try:
                    if call.value() != i:
                        raise AssertionError(f"net overload: ping {i}")
                except IOError as e:
                    if e.errno != EBUSY:
                        raise
                    sheds += 1
                    retry[i] = ss[i].call_async("ping", {"payload": i})
            pending = retry
        shed = server._transport.shed.snapshot()
        stats = mux.stats()
    finally:
        mux.close()
        server.stop()
    if pending or not sheds or sheds != stats["sheds_seen"]:
        raise AssertionError(f"net overload: {len(pending)} pending, "
                             f"{sheds} sheds, {stats}")
    return {"sessions": sessions, "seconds": time.perf_counter() - t0,
            "retry_rounds": rounds, "sheds": sheds, "shed": shed,
            "options": NET_OVERLOAD, "client": stats}


def _net_faults(K, c, server, keyring, pid, payloads, on_card: bool
                ) -> dict:
    """(d) puts through the mux client (8 sessions over 2 connections)
    with the seeded transport plan armed on the server: every put acked
    and applied once (one PG-log entry an object, resends answered from
    the reqid cache), every object read back bitwise with the faults
    still armed, then pings until every fault kind has fired; the
    handshake is never faulted and at least one connection re-dials."""
    from ceph_tpu_torch.common import Context
    from ceph_tpu_torch.failure import FaultPlan, TransportFaults
    from ceph_tpu_torch.msg import MuxClient
    with server.lock:
        inj = c.inject_faults(FaultPlan(
            seed=NET_FAULT_SEED, transport=TransportFaults(**NET_FAULTS)))
    server.inject_faults(inj)
    dedup0 = server.rpc_dedup_hits
    mux = MuxClient("127.0.0.1", server.port, keyring,
                    cct=Context(dict(NET_FAULT_CONF)), n_conns=2)
    oids = [f"fault.{i:04x}" for i in range(len(payloads))]
    kinds = ("delay", "truncate", "reset", "blackhole", "recv_reset")

    def fired() -> dict:
        return inj.summary()["planes"].get("transport", {})

    def call(s, method, args, tries: int = 8):
        for _ in range(tries):
            try:
                return s.call(method, args)
            except (ConnectionError, TimeoutError):
                continue
        raise AssertionError(f"net faults: {method} {args.get('oid')} "
                             f"never completed")
    try:
        mux.connect()
        dials = mux.stats()["reconnects"]
        sessions = [mux.session() for _ in range(8)]
        with NetRun(K, c, server, len(oids)) as w:
            for i, (oid, d) in enumerate(zip(oids, payloads)):
                # one attempt budget a put: an unacked put fails the phase
                if sessions[i % 8].call("put", {"pool": "rbd", "oid": oid,
                                                "data": d}) != len(d):
                    raise AssertionError(f"net faults: put {oid} short")
        with NetRun(K, c, server, len(oids)) as rd:
            bad = [oid for i, (oid, d) in enumerate(zip(oids, payloads))
                   if call(sessions[i % 8], "get",
                           {"pool": "rbd", "oid": oid}) != d]
        pings = 0
        while any(not fired().get(k) for k in kinds) and pings < 400:
            if call(sessions[pings % 8], "ping", {"payload": pings}) \
                    != pings:
                raise AssertionError("net faults: ping echo")
            pings += 1
        stats = mux.stats()
    finally:
        mux.close()
        server.inject_faults(None)
        with server.lock:
            c.inject_faults(None)
    with server.lock:
        entries = {oid: sum(e.oid == oid for e in
                            c.pg_group(pid, oid).backend.pg_log.entries)
                   for oid in oids}
    events = inj.summary()
    handshake = [e for e in inj.events if e["target"].startswith("Cephx")]
    if bad or any(n != 1 for n in entries.values()) or \
            any(not fired().get(k) for k in kinds) or handshake or \
            not stats["reconnects"] > dials or \
            (on_card and (w.launches["gf_apply"], w.launches["crc32c_rows"])
             != (len(oids), len(oids))):
        raise AssertionError(f"net faults: {bad[:4]} {entries} {events} "
                             f"{handshake[:2]} {stats} {w.launches}")
    return {"put": w.line(objects=len(oids)), "get": rd.line(),
            "pings": pings, "injected": events,
            "digest": inj.event_digest(), "seed": NET_FAULT_SEED,
            "faults": NET_FAULTS, "client": stats,
            "redials": stats["reconnects"] - dials,
            "rpc_dedup_hits": server.rpc_dedup_hits - dedup0,
            "pg_log_entries_per_object": 1, "lost_acked_writes": 0}


def _net_wire_bus(K, ecutil, registry, profile, unit, bufs, host_enc,
                  crcs) -> dict:
    """(e) the OSD's EC backend (the primary and 11 OSDShards, one PG) on
    three buses: plain, ``MessageBus(wire=True)`` (crc frames) and with
    a ``wire_secret`` (HMAC frames), ``len(bufs)`` writes each; every
    shard's bytes equal the plain bus's and the numpy encode, every
    HashInfo the host crc32c.  Then one write whose sub-write frame is
    corrupted in flight: delivery raises WireError and the shard never
    applies it.  The frames' host crc32c and HMAC seconds by bus."""
    from ceph_tpu_torch.backend import (ECBackend, GObject, OSDShard,
                                        PGTransaction, wire)
    from ceph_tpu_torch.backend.ecutil import HINFO_KEY
    from ceph_tpu_torch.backend.messages import MessageBus
    from ceph_tpu_torch.backend.pg_backend import shard_store
    from ceph_tpu_torch.common import Context
    ec = registry.factory("torch_rs", "", dict(profile))
    n = ec.get_chunk_count()
    sinfo = ecutil.StripeInfo(ec.get_data_chunk_count(),
                              ec.get_chunk_size(8 * unit))
    secret = bytes(range(32))

    def cluster(**kw):
        bus = MessageBus(**kw)
        be = ECBackend(ec, sinfo, bus, acting=list(range(n)), whoami=0,
                       cct=Context())
        for s in range(1, n):
            OSDShard(s, bus)
        return be, bus
    out, seen = {}, {}
    for mode, kw in (("plain", {}), ("crc", {"wire": True}),
                     ("secure", {"wire": True, "wire_secret": secret})):
        be, bus = cluster(**kw)
        timer = CallTimer({"frame_crc": (wire, "_crc"),
                           "frame_encode": (wire, "frame_encode"),
                           "frame_parse": (wire.FrameParser, "feed"),
                           "deliver_all": (MessageBus, "deliver_all")})
        _sync()
        l0 = dict(K.launches)
        with timer:
            t0 = time.perf_counter()
            for i, buf in enumerate(bufs):
                done = []
                be.submit_transaction(
                    PGTransaction().write(f"rbd{i}", 0, buf.tobytes()),
                    on_commit=done.append)
                bus.deliver_all()
                if not done:
                    raise AssertionError(f"net bus {mode}: rbd{i}")
            _sync()
            seconds = time.perf_counter() - t0
        launches = {k: K.launches[k] - l0[k] for k in K.launches}
        shards = {}
        for i, want in enumerate(host_enc):
            for s in range(n):
                st = shard_store(bus, s)
                got = st.read(GObject(f"rbd{i}", s))
                h = st.getattr(GObject(f"rbd{i}", s), HINFO_KEY)
                if got != want[s].tobytes() or \
                        list(h["cumulative_shard_hashes"]) != crcs[i]:
                    raise AssertionError(f"net bus {mode}: rbd{i} shard "
                                         f"{s} != the numpy encode")
                shards[(i, s)] = got
        seen[mode] = shards
        out[mode] = {"writes": len(bufs), "seconds": seconds,
                     "ms_per_op": seconds / len(bufs) * 1e3,
                     "launches": launches, "delivered": bus.delivered,
                     "host_breakdown": timer.report()}
    if seen["crc"] != seen["plain"] or seen["secure"] != seen["plain"]:
        raise AssertionError("net bus: wire-mode shards differ")
    # a corrupted sub-write frame: detected at delivery, never applied
    be, bus = cluster(wire=True)
    be.submit_transaction(PGTransaction().write("bad", 0,
                                                bufs[0].tobytes()),
                          on_commit=lambda *_: None)
    victim = 5
    env = bus.queues[victim][0]
    frame = bytearray(env.frame)
    frame[len(frame) // 2] ^= 0x01
    env.frame = bytes(frame)
    try:
        bus.deliver_all()
    except wire.WireError as e:
        detected = str(e)
    else:
        raise AssertionError("net bus: a corrupted frame was delivered")
    if shard_store(bus, victim).exists(GObject("bad", victim)):
        raise AssertionError("net bus: the corrupted sub-write applied")
    out["corrupted_frame"] = {"shard": victim, "error": detected}
    return out


def _net_frontend(K, ecutil, c, pid, registry, profile, unit, bufs,
                  on_card: bool, seen=None) -> dict:
    """(f) a ShardedFrontend over 12 ServingEngines (one per OSD, option
    defaults) routing by the acting primary of the object's PG: every
    object's striped encode (the striper's default layout: 64 KiB units,
    4 objects a set, 1 MiB objects), each piece's chunks against the
    numpy encode; then a writeback tier bound with ``frontend=``: every
    hit admitted through the owning shard's shed ladder, and a shard
    whose ladder is clamped to one op while its engine has a burst
    queued sheds a hit with FrontendBusy.  On the card the gf_apply
    launches equal the engines' device batches.  ``seen`` (the phase's
    recorded launches) drops the engines' batches, whose widths follow
    arrival (net_shapes counts none of them)."""
    from ceph_tpu_torch.exec import ServingEngine
    from ceph_tpu_torch.msg import FrontendBusy, ShardedFrontend, ShedPolicy
    host = registry.factory("torch_rs", "", dict(profile) | {
        "device": "numpy"})
    ec = c.pools[pid]["ec"]
    sinfo = ecutil.StripeInfo(8, ec.get_chunk_size(8 * unit))
    engines = {osd: ServingEngine(cct=c.cct, ec_impl=ec, sinfo=sinfo,
                                  name=f"net.fe.osd{osd}")
               for osd in sorted(c.osds)}
    fe = ShardedFrontend(engines,
                         locate=lambda name: c.pg_group(pid, name).acting[0])
    before = collections.Counter(seen) if seen is not None else None
    pipe0 = {o: e.pipeline.perf.dump() for o, e in engines.items()}
    data = {f"fe.{i:04x}": b.tobytes() for i, b in enumerate(bufs)}
    _sync()
    l0 = dict(K.launches)
    fe.start()
    try:
        with ClusterRun(K, c) as run:
            routed = {oid: fe.submit_striped_encode(oid, d)
                      for oid, d in data.items()}
            results = {oid: [(p, sid, fut.result(600))
                             for p, sid, fut in pieces]
                       for oid, pieces in routed.items()}
            fe.flush()
        pieces = checked = 0
        for oid, d in data.items():
            for (pname, _sid, extents), (p2, _s2, chunks) in zip(
                    fe.stripe_routes(oid, len(d)), results[oid]):
                buf = bytearray()
                for p_off, l_off, n in extents:
                    if len(buf) < p_off + n:
                        buf.extend(b"\0" * (p_off + n - len(buf)))
                    buf[p_off:p_off + n] = d[l_off:l_off + n]
                want = ecutil.encode_many(sinfo, host, [np.frombuffer(
                    bytes(buf), np.uint8)])[0]
                if pname != p2 or any(
                        np.asarray(chunks[ch]).tobytes() !=
                        want[ch].tobytes() for ch in want):
                    raise AssertionError(f"net frontend: {pname} parity")
                pieces += 1
                checked += sum(v.nbytes for v in want.values())
        routes = fe.stats()["routed"]
        # the tier: every hit through the ladder, then a shed
        cache = c.create_replicated_pool(
            "fe.cache", size=3, pg_num=8,
            params={"hit_set_count": "2", "hit_set_period": "8"})
        svc = c.create_tier(cache, pid, frontend=fe)
        tier = {f"tier.fe.{i:04x}": d for i, d in enumerate(data.values())}
        with ClusterRun(K, c) as tw:
            for oid, d in tier.items():
                svc.write(oid, d)
        admitted0 = sum(p.snapshot()["admitted"] for p in fe.shed.values())
        with ClusterRun(K, c) as tr:
            bad = [oid for oid, d in tier.items() if svc.read(oid) != d]
        admitted = sum(p.snapshot()["admitted"]
                       for p in fe.shed.values()) - admitted0
        victim = next(iter(tier))
        sid = fe.shard_for(victim)
        fe.shed[sid] = ShedPolicy(1)
        shed = None
        for attempt in range(20):
            burst = [engines[sid].submit_encode(b) for b in bufs[:8]]
            try:
                svc.read(victim)
            except FrontendBusy as e:
                shed = {"shard": e.shard, "errno": e.errno,
                        "op_class": e.op_class, "attempts": attempt + 1}
            for f in burst:
                f.result(600)
            if shed is not None:
                break
        fe.flush()
        _sync()
        launches = {k: K.launches[k] - l0[k] for k in K.launches}
        pipe = {o: _perf_delta(pipe0[o], e.pipeline.perf.dump(), PIPE_KEYS)
                for o, e in engines.items()}
    finally:
        fe.stop()
    batches = sum(p["submitted"] for p in pipe.values())
    errors = sum(p["errors"] for p in pipe.values())
    fe_shapes, batch_keys = {}, []
    if seen is not None:
        delta = seen - before
        fe_shapes = {f"{k[0]} {list(k[1])} x [{k[2]}, {k[3]}]": v
                     for k, v in sorted(delta.items())}
        seen.subtract(delta)
        seen += collections.Counter()       # drop the zeroed keys
        batch_keys = [[k[0], list(k[1]), k[2], k[3], v]
                      for k, v in sorted(delta.items())]
    if bad or errors or shed is None or admitted != len(tier) or \
            any(tw.launches.values()) or any(tr.launches.values()) or \
            (on_card and (launches["gf_apply"] != batches or
                          launches["crc32c_rows"])):
        raise AssertionError(f"net frontend: {bad[:4]} {errors} {shed} "
                             f"{admitted} {launches} {batches}")
    return {"encode": run.line(objects=len(data), pieces=pieces,
                               checked_bytes=checked, routed=routes),
            "launches": launches, "device_batches": batches,
            "pipeline_errors": errors, "batch_shapes": fe_shapes,
            "batch_keys": batch_keys,
            "tier_write": tw.line(objects=len(tier)),
            "tier_read": tr.line(objects=len(tier), admitted=admitted),
            "shed": shed}


def _net_clis(root, payload: bytes, device: str | None,
              bench_seconds: float, bench_size: str) -> dict:
    """(g) the CLIs, each a fresh interpreter: ``rados_cli serve`` over a
    BlueStore data dir (12 OSDs), then ``rados_cli --connect`` mkpool
    (k=8 m=4), put, get, ls and stat of a file, which comes back equal; a
    client process that puts and gets through ``TcpRados`` and reports
    whether it loaded JAX or initialised CUDA (it must do neither); then
    ``rados_bench write`` and ``seq`` (k=8 m=4, pg_num 32, 4 KiB chunks,
    concurrency 16), each output block parsed and its kernel launches
    equal to the writes it made (on the card)."""
    import selectors
    env = dict(os.environ, PYTHONPATH=HERE)
    d = os.path.join(root, "cli")
    mod = "ceph_tpu_torch.tools.rados_cli"
    t0 = time.perf_counter()
    serve = subprocess.Popen(
        [sys.executable, "-m", mod, "--data-dir", d, "--store-backend",
         "bluestore", "--n-osds", "12", "serve", "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=HERE, env=env)
    out = {}
    try:
        sel = selectors.DefaultSelector()
        sel.register(serve.stdout, selectors.EVENT_READ)
        deadline, line = time.monotonic() + 300, ""
        while not line and time.monotonic() < deadline:
            if sel.select(timeout=1.0):
                line = serve.stdout.readline()
            if serve.poll() is not None:
                raise AssertionError(f"rados_cli serve exited "
                                     f"{serve.returncode}: "
                                     f"{serve.stderr.read()}")
        sel.close()
        if "serving on" not in line:
            raise AssertionError(f"rados_cli serve: {line!r}")
        port = int(line.rsplit(":", 1)[1])
        keyring = os.path.join(d, "client.admin.keyring")
        out["serve_ready_s"] = time.perf_counter() - t0
        src, dst = os.path.join(root, "in.bin"), os.path.join(root,
                                                               "out.bin")
        with open(src, "wb") as f:
            f.write(payload)
        profile = ["k=8", "m=4", "technique=reed_sol_van"] + (
            [f"device={device}"] if device else [])
        verbs = {"mkpool": ["mkpool", "rbd", *profile],
                 "put": ["put", "rbd", "obj", src],
                 "get": ["get", "rbd", "obj", dst], "ls": ["ls", "rbd"],
                 "stat": ["stat", "rbd", "obj"]}
        seconds, stdout = {}, {}
        for verb, argv in verbs.items():
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m", mod, "--connect",
                 f"127.0.0.1:{port}", "--keyring", keyring, *argv],
                capture_output=True, text=True, cwd=HERE, env=env,
                timeout=300)
            seconds[verb] = time.perf_counter() - t0
            if r.returncode:
                raise AssertionError(f"rados --connect {verb}: {r.stderr}")
            stdout[verb] = r.stdout.strip()
        with open(dst, "rb") as f:
            if f.read() != payload:
                raise AssertionError("rados --connect get: file differs")
        if stdout["ls"].split() != ["obj"] or \
                f"size {len(payload)}" not in stdout["stat"]:
            raise AssertionError(f"rados --connect: {stdout}")
        probe = subprocess.run(
            [sys.executable, "-c", NET_CLIENT_PROBE, str(port), keyring],
            capture_output=True, text=True, cwd=HERE, env=env, timeout=300)
        if probe.returncode:
            raise AssertionError(f"net client probe: {probe.stderr}")
        client = json.loads(probe.stdout.strip().splitlines()[-1])
        if client != {"ok": True, "cuda_initialized": False,
                      "loaded": []}:
            raise AssertionError(f"net client probe: {client}")
        out.update(connect_s=seconds, client_process=client)
    finally:
        serve.terminate()
        try:
            serve.wait(timeout=60)
        except subprocess.TimeoutExpired:
            serve.kill()
            serve.wait(timeout=60)
        serve.stdout.close()
        serve.stderr.close()
    bench = [sys.executable, "-m", "ceph_tpu_torch.bench.rados_bench",
             "--seconds", str(bench_seconds), "--k", "8", "--m", "4",
             "--pg-num", "32", "--object-size", bench_size,
             "--chunk-size", "4K", "--concurrency", "16"] + (
        ["--device", device] if device else [])
    for mode in ("write", "seq"):
        t0 = time.perf_counter()
        r = subprocess.run(bench + [mode], capture_output=True, text=True,
                           cwd=HERE, env=env, timeout=600)
        if r.returncode:
            raise AssertionError(f"rados_bench {mode}: {r.stderr}")
        lines = r.stdout.strip().splitlines()
        block = {k.strip(): v.strip() for k, v in
                 (ln.split(":", 1) for ln in lines[:-1])}
        launches = json.loads(lines[-1])["launches"]
        made = int(block.get("Total writes made", 0)) if mode == "write" \
            else max(1, int(bench_seconds * 4))
        if mode == "seq" and int(block["Total reads made"]) != made:
            raise AssertionError(f"rados_bench seq: {block}")
        if device is None and (launches["gf_apply"], launches[
                "crc32c_rows"]) != (made, made):
            raise AssertionError(f"rados_bench {mode}: {launches} "
                                 f"launches for {made} writes")
        out[f"rados_bench_{mode}"] = {"block": block, "launches": launches,
                                      "writes": made,
                                      "seconds": time.perf_counter() - t0}
    return out


NET_CLIENT_PROBE = """
import json, sys
from ceph_tpu_torch.net import TcpRados
r = TcpRados("127.0.0.1", int(sys.argv[1]), sys.argv[2])
data = bytes(range(256)) * 4096
r.put("rbd", "probe", data)
ok = r.get("rbd", "probe") == data
r.close()
import torch
print(json.dumps({"ok": ok, "cuda_initialized": torch.cuda.is_initialized(),
                  "loaded": sorted(m for m in sys.modules if m.split(".")[0]
                                   in ("jax", "jaxlib", "ceph_tpu"))}))
"""


def phase_net(K, ecutil, registry_cls, sizes: dict | None = None,
              device: str | None = None, seen=None
              ) -> tuple[dict, int, int]:
    """A Ceph user's networked deployment through the port: ``vstart``
    with BlueStore and cephx, then ``rados --connect`` puts and gets.
    Phase cluster's widths (12 OSDs on 4 hosts, torch_rs k=8 m=4
    reed_sol_van with no device key, pg_num 32, a 4 KiB stripe unit,
    4 MiB objects) served by ``net.ClusterServer`` on a loopback port:
    (a) a ``TcpRados`` client from the server's keyring (cephx, then
    HMAC frames) puts, gets and degraded-gets every object; (b) the same
    with ``ms_zero_copy`` off, then on, and the copy ledger's copies per
    byte; (c) the mux client's closed loop (sessions of one put and one
    get over 8 connections), then the overload arm on a second server
    (dispatch queue 64, one worker); (d) puts, gets and pings under the
    seeded transport fault plan; (e) the OSD's EC backend on the
    wire-mode bus, crc and secure; (f) the sharded front end over 12
    serving engines and a tier bound to it; (g) the CLIs as processes.
    ``sizes`` overrides ``path_shapes.NET``'s counts and widths;
    ``device`` None runs the pools on the card (tests run the sequence
    with "cpu").  ``seen``, the phase's recorded launches, loses (f)'s
    engine batches (see ``_net_frontend``).  Returns the sub-phase lines
    and the gf_apply and crc32c_rows launches."""
    import shutil
    import tempfile
    from pathlib import Path
    from ceph_tpu_torch.cluster import MiniCluster
    from ceph_tpu_torch.common import Context
    from ceph_tpu_torch.net import KEYRING, ClusterServer, TcpRados
    from ceph_tpu_torch.tools.path_shapes import NET
    sz = dict(NET, **(sizes or {}))
    t_phase = time.perf_counter()
    on_card = device is None
    registry = registry_cls.instance()
    k, m, unit = 8, 4, 4096
    profile = {"k": str(k), "m": str(m), "technique": "reed_sol_van"}
    if device is not None:
        profile["device"] = device
    host = registry.factory("torch_rs", "", profile | {"device": "numpy"})
    chunk = host.get_chunk_size(k * unit)
    objects = sz["objects"]
    rng = np.random.default_rng(14)
    bufs = [rng.integers(0, 256, sz["obj_bytes"], dtype=np.uint8)
            for _ in range(objects)]
    sinfo = ecutil.StripeInfo(k, chunk)
    host_enc = ecutil.encode_many(sinfo, host, bufs)
    crcs = _host_crcs(host_enc)
    oids = [f"rbd_data.{i:04x}" for i in range(objects)]
    payloads = [b.tobytes() for b in bufs]
    setup_s = time.perf_counter() - t_phase
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_net."))
    lines: dict = {}
    walls: dict = {}
    _sync()
    K.reset_launches()
    c = server = r = None

    def lap(name, t0):
        walls[name] = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        c = MiniCluster(n_osds=12, osds_per_host=3, chunk_size=unit,
                        cct=Context(), data_dir=root / "blue",
                        store_backend="bluestore")
        c.enable_recovery_scheduler()
        pid = c.create_ec_pool("rbd", dict(profile), pg_num=32)
        if c.pools[pid]["ec"].get_profile()["device"] != (device or "cuda"):
            raise AssertionError("net: the pool is not on the card")
        server = ClusterServer(c)
        server.start()
        keyring = root / "blue" / KEYRING
        r = TcpRados("127.0.0.1", server.port, keyring)
        if r.ch.secret is None:
            raise AssertionError("net: the client is not in secure mode")
        lines["serve"] = _net_serve(K, c, server, r, pid, oids, payloads,
                                    host_enc, crcs, on_card)
        lap("serve", t0)
        t0 = time.perf_counter()
        lines["zero_copy"] = _net_zero_copy(K, c, server, keyring,
                                            payloads[:sz["zero_copy"]])
        lap("zero_copy", t0)
        t0 = time.perf_counter()
        lines["mux"] = _net_mux(K, c, server, keyring, sz["mux_sessions"],
                                sz["mux_bytes"], on_card)
        lap("mux", t0)
        t0 = time.perf_counter()
        lines["overload"] = _net_overload(c, keyring,
                                          sz["overload_sessions"])
        lap("overload", t0)
        t0 = time.perf_counter()
        lines["faults"] = _net_faults(K, c, server, keyring, pid,
                                      payloads[:sz["fault_puts"]], on_card)
        lap("faults", t0)
        t0 = time.perf_counter()
        lines["wire_bus"] = _net_wire_bus(
            K, ecutil, registry, profile, unit, bufs[:sz["bus_writes"]],
            host_enc[:sz["bus_writes"]], crcs[:sz["bus_writes"]])
        lap("wire_bus", t0)
        t0 = time.perf_counter()
        with server.lock:
            lines["frontend"] = _net_frontend(
                K, ecutil, c, pid, registry, profile, unit,
                bufs[:sz["frontend_objects"]], on_card, seen)
        lap("frontend", t0)
        lines["status"] = r.status()["pgmap"]
        lines["server_wire"] = server.wire.totals()
        r.close()
        r = None
        server.stop()
        server = None
        c.shutdown()
        c = None
        t0 = time.perf_counter()
        lines["clis"] = _net_clis(
            str(root), payloads[0], device,
            sz.get("bench_seconds", 5.0), sz.get("bench_size", "4M"))
        lap("clis", t0)
        launches = dict(K.launches)
        disk = sum(f.stat().st_size for f in root.rglob("*") if f.is_file())
    finally:
        if r is not None:
            r.close()
        if server is not None:
            server.stop()
        if c is not None:
            c.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    lines["launches"] = launches
    lines["timing"] = {"seconds": time.perf_counter() - t_phase,
                       "setup_s": setup_s, "walls": walls,
                       "disk_bytes": disk, "sizes": sz}
    return lines, launches["gf_apply"], launches["crc32c_rows"]


def net_launch_shapes(PS, registry_cls, seen, sizes=None) -> dict:
    """Phase net's kernel calls by (kernel, matrix shape, data rows,
    columns), as recorded less (f)'s engine batches, against
    ``path_shapes.net_shapes``."""
    want = PS.shape_counts(PS.net_shapes(registry_cls.instance(), sizes))
    if dict(seen) != dict(want):
        raise AssertionError(f"net: launches by shape {dict(seen)} != "
                             f"path_shapes.net_shapes {dict(want)}")
    return {"checked": [[kernel, list(mat), rows, cols, n] for
                        (kernel, mat, rows, cols), n in sorted(seen.items())]}


# -- phase instruments --------------------------------------------------------

# On an H100, torch.profiler drops the first device records of a session
# from about a process's third session on, more in a longer-lived process
# (0-15 of a window's first 272 over 32 windows in 257 s, once 89; PERF.md
# §7).  Each capture window therefore opens with the backend's primer
# (profiler_capture.TorchProfiler.prime), which takes that loss; the
# work starts PROFILER_LEAD_S after the window opens.
PROFILER_LEAD_S = 0.25


INSTRUMENT_KERNELS = {"gf_apply": "gf_apply_kernel",
                      "crc32c_rows": "crc32c_rows_kernel"}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def ledger_bytes(key: tuple) -> int | None:
    """The bytes PERF.md's bound column counts for a launch key (each
    input read once, each output written once; a crc as 4 bytes), or
    None for straw2, whose bytes come from its placement rows."""
    kernel, mat, rows, cols = key
    if kernel in ("gf_apply", "gf_apply_stripes"):
        r, k = mat
        return (rows // k) * (k + r) * cols
    if kernel == "xor_apply":
        return (mat[0] + mat[1]) * cols
    if kernel == "crc32c_rows":
        return rows * cols + 4 * rows
    return None


def trace_device_stats(path: str) -> dict:
    """From a ``torch.profiler`` Chrome trace: the device events (kernels,
    copies, sets), the launches of each kernel of INSTRUMENT_KERNELS and
    their mean duration (the kernel alone, where the launch ledger's
    event pair also spans the host's submit on an idle card), and the
    seconds the card was busy (the union of the events' intervals)."""
    from ceph_tpu_torch.common.profiler_capture import PRIMER_SPAN
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    events = [e for e in events if e.get("ph") == "X"]
    # the window's primer (profiler_capture.TorchProfiler.prime) apart:
    # the runtime calls inside its span and their device records
    spans = [(e.get("tid"), float(e["ts"]),
              float(e["ts"]) + float(e["dur"]))
             for e in events if e.get("name") == PRIMER_SPAN]
    runtime = [e for e in events if e.get("cat") == "cuda_runtime"]
    in_primer = [e for e in runtime
                 if any(e.get("tid") == tid and t0 <= float(e["ts"]) <= t1
                        for tid, t0, t1 in spans)]
    primed = {e.get("args", {}).get("correlation")
              for e in in_primer} - {None}
    # those of its runtime calls that put a record on the card
    primer_work = sum(1 for e in in_primer if any(
        w in e.get("name", "") for w in ("LaunchKernel", "Memcpy")))
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    primer = [e for e in dev
              if e.get("args", {}).get("correlation") in primed]
    dev = [e for e in dev
           if e.get("args", {}).get("correlation") not in primed]
    runs = {label: [float(e.get("dur", 0.0)) for e in dev
                    if e["cat"] == "kernel" and name in e.get("name", "")]
            for label, name in INSTRUMENT_KERNELS.items()}
    kernels = {label: len(d) for label, d in runs.items()}
    busy_us, end = 0.0, float("-inf")
    for t0, t1 in sorted((float(e["ts"]), float(e["ts"]) +
                          float(e.get("dur", 0.0))) for e in dev):
        if t1 > end:
            busy_us += t1 - max(t0, end)
            end = t1
    launches = {c: float(e["ts"]) for e in runtime
                if "LaunchKernel" in e.get("name", "")
                and (c := e.get("args", {}).get("correlation"))
                not in primed}
    # a kernel's start less its launch's, by correlation id (both in the
    # device tracer's clock)
    ran = {c: float(e["ts"]) for e in dev if e["cat"] == "kernel"
           and (c := e.get("args", {}).get("correlation")) in launches}
    lags = sorted(ran[c] - launches[c] for c in ran)
    # a runtime call's start less its enclosing operator's, by External
    # id: the device tracer's clock against the host's (>= 0 where they
    # agree)
    ops = {e["args"]["External id"]: float(e["ts"]) for e in events
           if e.get("cat") == "cpu_op" and "External id" in e.get("args", {})}
    offsets = sorted(float(e["ts"]) - ops[x] for e in runtime
                     if (x := e.get("args", {}).get("External id")) in ops)
    opened = [float(e["ts"]) for e in events if e.get("cat") == "Trace"]

    def after_open(ts: list[float]) -> float | None:
        return (min(ts) - opened[0]) / 1e6 if ts and opened else None

    def spread(v: list[float]) -> list[float] | None:
        return [v[0], v[len(v) // 2], v[-1]] if v else None
    return {"device_events": len(dev),
            "by_cat": {c: sum(1 for e in dev if e["cat"] == c)
                       for c in DEVICE_CATS},
            # the primer's device records against its runtime calls
            "primer": [len(primer), primer_work],
            "runtime_launches": len(launches),
            "first_device_s": after_open([float(e["ts"]) for e in dev]),
            "first_launch_s": after_open(list(launches.values())),
            "kernel_lag_us": spread(lags),
            # launches whose kernel is not in the trace: (index in the
            # window, seconds after it opens)
            "unmatched_launches": [
                [i, after_open([ts])] for i, (c, ts) in enumerate(
                    sorted(launches.items(), key=lambda kv: kv[1]))
                if c not in ran],
            "clock_offset_us": spread(offsets),
            "kernels": kernels,
            "kernel_ms": {label: sum(d) / len(d) / 1e3
                          for label, d in runs.items() if d},
            "busy_s": busy_us / 1e6}


class FakeProfiler:
    """A profiler backend for a run without a card: writes a trace with
    no device event."""

    def start_trace(self, path: str) -> None:
        self.path = path

    def stop_trace(self) -> None:
        from ceph_tpu_torch.common.profiler_capture import TRACE_FILE
        with open(os.path.join(self.path, TRACE_FILE), "w") as f:
            json.dump({"traceEvents": []}, f)


def _profiled(c, LL, run, n: int, reason: str, lead_s: float) -> dict:
    """``run(i)`` for i < n inside a ``device profile start`` ... ``stop``
    window on the cluster's admin socket, ``lead_s`` seconds after it
    opens: the exported trace's kernel launches against the ledger's in
    the window, and the card's busy share of the ops' wall time."""
    from ceph_tpu_torch.common.profiler_capture import TRACE_FILE
    sock = c.cct.admin_socket
    info = sock.call("device profile start", reason=reason)
    if "error" in info:
        raise AssertionError(f"instruments: profiler start: {info}")
    time.sleep(lead_s)
    with LL.recording(tuple(INSTRUMENT_KERNELS), route="cuda") as seen:
        _sync()
        t0 = time.perf_counter()
        for i in range(n):
            run(i)
        _sync()
        wall = time.perf_counter() - t0
    info = sock.call("device profile stop")
    if "error" in info:
        raise AssertionError(f"instruments: profiler stop: {info}")
    path = os.path.join(info["path"], TRACE_FILE)
    stats = trace_device_stats(path)
    ledger = {k: sum(v for key, v in seen.items() if key[0] == k)
              for k in INSTRUMENT_KERNELS}
    if stats["kernels"] != ledger:
        raise AssertionError(f"instruments: trace kernels "
                             f"{stats['kernels']} != ledger {ledger} "
                             f"({reason}: {stats}, lead {lead_s} s, ops "
                             f"{wall} s)")
    return {"path": info["path"], "ops": n, "wall_s": wall, "lead_s": lead_s,
            "ledger_launches": ledger,
            **stats, "busy_share": stats["busy_s"] / wall,
            "capture_s": info["duration_s"],
            "trace_bytes": os.path.getsize(path)}


def _scrape(c) -> dict:
    """(d) one ``mgr.prometheus.render``: every family's HELP and TYPE
    once, every sample under a declared family, and the roofline's
    ``ceph_tpu_device_efficiency`` rows of gf_apply."""
    from ceph_tpu_torch.mgr import prometheus
    t0 = time.perf_counter()
    text = prometheus.render(c.cct)
    render_s = time.perf_counter() - t0
    helps, types, samples = collections.Counter(), {}, []
    for line in text.splitlines():
        if line.startswith("# HELP "):
            helps[line.split()[2]] += 1
        elif line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            if name in types:
                raise AssertionError(f"instruments: TYPE {name} twice")
            types[name] = kind
        elif line:
            samples.append(re.match(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)", line)[1])
    if set(helps) != set(types) or any(n != 1 for n in helps.values()):
        raise AssertionError("instruments: HELP/TYPE not once a family")
    undeclared = [m for m in samples if m not in types and not any(
        m == f + sfx and types[f] in ("histogram", "summary")
        for f in types for sfx in ("_bucket", "_sum", "_count")
        if m.startswith(f))]
    eff = [ln for ln in text.splitlines()
           if ln.startswith('ceph_tpu_device_efficiency{executable="gf_apply')]
    if undeclared or not eff:
        raise AssertionError(f"instruments: scrape {undeclared[:3]} "
                             f"{len(eff)} gf_apply efficiency rows")
    return {"render_s": render_s, "bytes": len(text),
            "families": len(types), "samples": len(samples),
            "gf_apply_efficiency_rows": len(eff)}


def _ceph_cli(c_dir, health_line: str, on_card: bool) -> dict:
    """(f) ``ceph_cli --data-dir D status`` as one process (its health
    line against the in-process cluster's), then ``osd tree``, ``pg dump``
    and ``device roofline`` through the CLI's ``main(argv)``."""
    import contextlib
    import io
    from ceph_tpu_torch.tools import ceph_cli
    env = dict(os.environ)
    if not on_card:
        env["CUDA_VISIBLE_DEVICES"] = ""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.tools.ceph_cli",
         "--data-dir", str(c_dir), "status"], cwd=HERE, env=env,
        capture_output=True, text=True, timeout=600)
    status_s = time.perf_counter() - t0
    got = [ln.strip() for ln in proc.stdout.splitlines()
           if ln.strip().startswith("health:")]
    if proc.returncode != 0 or got != [health_line]:
        raise AssertionError(f"instruments: ceph_cli status rc "
                             f"{proc.returncode} {got} != {health_line!r}: "
                             f"{proc.stderr[-2000:]}")
    verbs = {}
    for argv, head in ((["osd", "tree"], "ID    WEIGHT"),
                       (["pg", "dump"], "PG_ID"),
                       (["device", "roofline"], "peaks:")):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = ceph_cli.main(["--data-dir", str(c_dir), *argv])
        text = out.getvalue()
        if rc != 0 or not text.startswith(head):
            raise AssertionError(f"instruments: ceph {' '.join(argv)} rc "
                                 f"{rc}: {text[:300]}")
        verbs[" ".join(argv)] = {"seconds": time.perf_counter() - t0,
                                 "lines": len(text.splitlines())}
    return {"status_process_s": status_s, "health": health_line,
            "verbs": verbs}


def phase_instruments(K, ecutil, registry_cls, objects: int = 64,
                      obj_bytes: int = 4 * MIB, window: int = 16,
                      device: str | None = None, profiler=None) -> dict:
    """(c)-(f) of phase ``instruments`` on a durable BlueStore cluster at
    phase cluster's widths: (c) ``objects`` puts, gets, then osd.3 down
    and degraded gets, a ``device profile start`` ... ``stop`` window
    around ``window`` of the puts and ``window`` of the degraded gets;
    (d) a prometheus scrape; (e) RECOMPILE_STORM clear and the
    pg_autoscaler's recommendations; (f) the ``ceph`` CLI.  ``device``
    None runs the pool on the card and profiles with torch.profiler
    (tests run it with "cpu" and a ``profiler`` backend of their own)."""
    import shutil
    import tempfile
    from pathlib import Path
    from ceph_tpu_torch.cluster import MiniCluster
    from ceph_tpu_torch.common import Context
    from ceph_tpu_torch.mgr.pg_autoscaler import autoscale_recommendations
    from ceph_tpu_torch.ops import launch_ledger as LL
    from ceph_tpu_torch.tools.ceph_cli import _fmt_status
    t_phase = time.perf_counter()
    on_card = device is None
    k, m, unit, victim = 8, 4, 4096, 3
    profile = {"k": str(k), "m": str(m), "technique": "reed_sol_van"}
    if device is not None:
        profile["device"] = device
    rng = np.random.default_rng(14)
    payloads = [rng.integers(0, 256, obj_bytes, dtype=np.uint8).tobytes()
                for _ in range(objects)]
    oids = [f"rbd_data.{i:04x}" for i in range(objects)]
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_instruments."))
    lines: dict = {}
    c = None
    try:
        c = MiniCluster(n_osds=12, osds_per_host=3, chunk_size=unit,
                        cct=Context(), data_dir=root / "blue",
                        store_backend="bluestore")
        if profiler is not None:
            c.profiler._profiler = profiler
        c.enable_recovery_scheduler()
        pid = c.create_ec_pool("rbd", dict(profile), pg_num=32)
        if any(g.backend.whoami == victim
               for g in c.pools[pid]["pgs"].values()):
            raise AssertionError(f"instruments: osd.{victim} is a primary")
        setup_s = time.perf_counter() - t_phase
        # (c) puts, the last `window` of them profiled
        lead = objects - window
        with ClusterRun(K, c) as w:
            for oid, d in zip(oids[:lead], payloads[:lead]):
                c.put(pid, oid, d)
        prof_put = _profiled(c, LL, lambda i: c.put(
            pid, oids[lead + i], payloads[lead + i]), window, "put",
            PROFILER_LEAD_S)
        with ClusterRun(K, c) as rd:
            bad = [oid for oid, d in zip(oids, payloads)
                   if c.get(pid, oid, len(d)) != d]
        c.bus.mark_down(victim)
        got = {}
        prof_get = _profiled(c, LL, lambda i: got.__setitem__(
            oids[i], c.get(pid, oids[i], len(payloads[i]))), window,
            "degraded-get", PROFILER_LEAD_S)
        with ClusterRun(K, c) as dg:
            for oid, d in zip(oids[window:], payloads[window:]):
                got[oid] = c.get(pid, oid, len(d))
        bad += [oid for oid, d in zip(oids, payloads) if got[oid] != d]
        c.bus.mark_up(victim)
        c.deliver_all()
        if bad or (on_card and (
                w.launches["gf_apply"], w.launches["crc32c_rows"],
                prof_put["ledger_launches"]["gf_apply"],
                prof_put["ledger_launches"]["crc32c_rows"],
                rd.launches["gf_apply"]) != (lead, lead, window, window, 0)):
            raise AssertionError(f"instruments: {bad[:4]} {w.launches} "
                                 f"{prof_put['ledger_launches']} "
                                 f"{rd.launches}")
        lines["cluster"] = {
            "put": w.line(objects=lead, ms_per_op=w.seconds / lead * 1e3),
            "put_profiled": prof_put,
            "get": rd.line(objects=objects,
                           ms_per_op=rd.seconds / objects * 1e3),
            "degraded_get_profiled": prof_get,
            "degraded_get": dg.line(objects=objects - window,
                                    ms_per_op=dg.seconds /
                                    (objects - window) * 1e3),
            "captures": len(c.profiler.captures()), "setup_s": setup_s}
        kept = c.profiler.captures()
        if any(p["path"] not in kept for p in (prof_put, prof_get)):
            raise AssertionError(f"instruments: captures {kept}")
        # (d) the scrape
        lines["scrape"] = _scrape(c)
        # (e) health and the autoscaler
        ev = c.health_detail()
        storm = ev["checks"].get("RECOMPILE_STORM")
        if storm is not None:
            raise AssertionError(f"instruments: RECOMPILE_STORM {storm}")
        used = {pid: sum(map(len, payloads))}
        cap = c.n_osds * (1 << 40)
        recs = autoscale_recommendations(c.osdmap, used, cap)
        if [r["pool_id"] for r in recs] != sorted(c.pools):
            raise AssertionError(f"instruments: autoscaler {recs}")
        jit = c.stats.digest()["jit"]
        lines["health"] = {"status": ev["status"],
                           "checks": sorted(ev["checks"]),
                           "jit_window": jit,
                           "autoscaler": [{k2: r[k2] for k2 in (
                               "pool_name", "pg_num_target",
                               "pg_num_final", "would_adjust",
                               "raw_used_rate")} for r in recs]}
        health_line = next(
            ln.strip() for ln in _fmt_status(c.status(), c.health())
            .splitlines() if ln.strip().startswith("health:"))
        c.shutdown()
        c = None
        # (f) the CLI over the stopped cluster's directory
        lines["cli"] = _ceph_cli(root / "blue", health_line, on_card)
    finally:
        if c is not None:
            c.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    lines["timing"] = {"seconds": time.perf_counter() - t_phase}
    return lines


def ledger_checks(K, CK, LL, PS, registry_cls, by_phase: dict,
                  net_batches, rows_place: list, phase_launches: dict
                  ) -> dict:
    """(a) and (b) of phase ``instruments``: the ledger's launches per
    kernel over the whole script against the wrappers' counters; its
    keys per phase, those of phases durable and net against
    ``path_shapes`` (net's front-end batches added) and, for each phase
    of ``phase_launches``, its launches by kernel against the counters
    the phase read; every key's bytes against PERF.md's bound bytes, and
    the roofline's row for each."""
    from ceph_tpu_torch.common import roofline
    totals = LL.totals("cuda")
    counters = K.total_launches()
    crush = sum(v for lab, v in totals.items() if lab.startswith("crush."))
    ledger = {name: totals.get(name, 0) for name in counters}
    if ledger != counters or crush != CK.total_launches()["crush_straw2"]:
        raise AssertionError(f"instruments: ledger {dict(totals)} != "
                             f"counters {counters} "
                             f"{CK.total_launches()}")
    main = ("gf_apply", "crc32c_rows")
    registry = registry_cls.instance()
    want = {"durable": PS.shape_counts(PS.durable_shapes(registry)),
            "net": PS.shape_counts(PS.net_shapes(registry)) + net_batches}
    for phase, expect in want.items():
        got = collections.Counter({k: v for k, v in by_phase[phase].items()
                                   if k[0] in main})
        if got != expect:
            raise AssertionError(f"instruments: {phase} ledger keys "
                                 f"{dict(got)} != {dict(expect)}")
    for phase, counted in phase_launches.items():
        got = collections.Counter()
        for key, n in by_phase[phase].items():
            got[key[0]] += n
        if +got != +collections.Counter(counted):
            raise AssertionError(f"instruments: {phase} ledger launches "
                                 f"{dict(got)} != counters {counted}")
    snap = LL.snapshot()
    if snap["dropped"]:
        raise AssertionError(f"instruments: {snap['dropped']} event pairs "
                             f"dropped")
    place = {(r["ledger_key"][0], tuple(r["ledger_key"][1]),
              *r["ledger_key"][2:]): r["bytes"]
             for r in rows_place if "ledger_key" in r}
    rows = {r["executable"]: r
            for r in roofline.report(limit=1 << 20)["executables"]}
    checked, out = 0, []
    for rec in snap["keys"]:
        if rec["route"] != "cuda":
            continue
        key = (rec["kernel"], tuple(rec["mat"]), rec["rows"], rec["cols"])
        expect = ledger_bytes(key)
        if expect is None:
            expect = place.get(key)
        if expect is not None and expect != rec["bytes_per_call"]:
            raise AssertionError(f"instruments: {key} books "
                                 f"{rec['bytes_per_call']} B, bound "
                                 f"{expect}")
        checked += expect is not None
        eid = roofline.executable_id(key[0], LL._roofline_key(key, "cuda"))
        row = rows.get(eid)
        if rec["booked"] and (row is None or
                              row["bytes_per_call"] != rec["bytes_per_call"]):
            raise AssertionError(f"instruments: no roofline row {eid}")
        if row is not None and any(key in by_phase[p] for p in
                                   ("cluster", "durable", "net",
                                    "instruments")):
            out.append({
                "executable": eid, "launches": rec["launches"],
                "calls": row["calls"],
                "device_ms_per_call": row["est_seconds"] / row["calls"]
                * 1e3,
                "first_launch_ms": row["synced_s"] * 1e3,
                "bytes": row["bytes_per_call"],
                "achieved_bytes_s": row["achieved_bytes_s"],
                "pct_of_3_35_TBps": row["pct_of_peak"],
                "bound_ms": row["bytes_per_call"] / HBM_BYTES_PER_S * 1e3,
                "estimator": row["estimator"]})
    out.sort(key=lambda r: -r["launches"])
    return {"ledger_launches": dict(totals), "counters": counters,
            "crush_straw2": crush,
            "keys_by_phase": {
                p: {lab: [sum(1 for k in c if k[0] == lab),
                          sum(v for k, v in c.items() if k[0] == lab)]
                    for lab in sorted({k[0] for k in c})}
                for p, c in by_phase.items()},
            "keys_checked_bytes": checked, "pending": snap["pending"],
            "roofline_main_path": out,
            "peaks": roofline.lookup_peaks()}


def ledger_overhead(K, LL, dev, iters: int = 400) -> dict:
    """What the ledger costs a launch: host-paced ms of a launch-bound
    gf_apply ([4, 8] x [8, 512 Ki], the cluster put's encode) with the
    ledger timing each launch and paused, in turns (paused, on, on,
    paused), CUDA events around ``iters`` launches."""
    gen = torch.Generator(device=dev).manual_seed(15)
    mat = rand_u8(gen, (4, 8), dev)
    data = rand_u8(gen, (8, 512 << 10), dev)

    def run() -> float:
        K.gf_apply(mat, data)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            K.gf_apply(mat, data)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    out = {"paused": [], "on": []}
    for arm in ("paused", "on", "on", "paused"):
        if arm == "paused":
            with LL.paused():
                out[arm].append(run())
        else:
            out[arm].append(run())
    LL.resolve()
    return {"ms_per_launch": out, "iters": iters,
            "shape": "[4,8]x[8, 512 Ki]"}


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


def placement_type0(PS, dev, sample: int = 256) -> dict:
    """(g) chooseleaf indep over type 0, the rule MiniCluster gives an EC
    pool wider than its hosts: 4 hosts x 3 OSDs, an EC pool of size 12
    on chooseleaf_indep 12 type 0, osd.3 at reweight 0x8000 and osd.7 at
    0x4000.  At 256 PGs the kernel against its plain version on every
    PG, both against the host interpreter on every PG, and map_pool
    against the scalar OSDMap chain (PG 1.0 has osd.7 at position 7);
    at PS.PLACEMENT_PGS PGs with the same reweights, the kernel against
    its plain version on every PG and ``sample`` PGs against the
    interpreter (the interpreter takes about 20 ms an x on this map: 12
    positions, up to 50 tries each).  Returns the sub-phase's line; its
    launches are outside the main path's count."""
    from ceph_tpu_torch.crush import (CRUSH_BUCKET_STRAW2,
                                      CRUSH_RULE_CHOOSELEAF_INDEP,
                                      CRUSH_RULE_EMIT, CRUSH_RULE_TAKE,
                                      CrushMap, crush_do_rule)
    from ceph_tpu_torch.ops import crush_kernels as CK
    from ceph_tpu_torch.osdmap import (PG, POOL_TYPE_ERASURE, BulkPGMapper,
                                       OSDMap, Pool)
    cmap = CrushMap()
    cmap.set_type_name(1, "host")
    cmap.set_type_name(2, "root")
    hosts = [cmap.add_bucket(CRUSH_BUCKET_STRAW2, 1,
                             list(range(3 * h, 3 * h + 3)), [0x10000] * 3)
             for h in range(4)]
    root = cmap.add_bucket(CRUSH_BUCKET_STRAW2, 2, hosts, [0x30000] * 4)
    cmap.finalize()
    ruleno = cmap.add_rule([(CRUSH_RULE_TAKE, root, 0),
                            (CRUSH_RULE_CHOOSELEAF_INDEP, 12, 0),
                            (CRUSH_RULE_EMIT, 0, 0)])
    rows = []
    for pg_num in (256, PS.PLACEMENT_PGS):
        m = OSDMap(crush=cmap)
        for o in range(12):
            m.create_osd(o)
        m.add_pool(Pool(pool_id=1, type=POOL_TYPE_ERASURE, size=12,
                        min_size=9, pg_num=pg_num, crush_rule=ruleno))
        m.osd_weight[3], m.osd_weight[7] = 0x8000, 0x4000
        mapper = BulkPGMapper(m, device=dev.type)
        pool = m.pools[1]
        pps = mapper.pool_pps(pool)
        xs = torch.from_numpy(pps.astype(np.int64)).to(dev)
        shape = mapper.bulk.rule_shape(ruleno, 12)
        if not (shape.indep and shape.leaf and shape.target_type == 0):
            raise AssertionError(f"not chooseleaf indep over type 0: {shape}")
        tables = mapper.bulk.tables(None)
        rw = torch.from_numpy(np.asarray(m.osd_weight,
                                         dtype=np.int64)).to(dev)
        got = CK.straw2_map(xs, tables, rw, shape)
        # the plain version on the card at 2^20 x's; at 256, where its
        # small launches would take ~10 s, on the same inputs on the host
        pdev = dev if pg_num > sample else torch.device("cpu")
        stats = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = CK.straw2_map_plain(xs.to(pdev), mapper.bulk.tables(
            None, device=pdev.type), rw.to(pdev), shape, stats=stats)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max(max_abs_err(got[0], want[0].to(dev)),
                  max_abs_err(got[1], want[1].to(dev)))
        if err:
            raise AssertionError(f"crush_straw2 disagrees with its plain "
                                 f"version on type-0 indep at {pg_num}")
        out = got[0].cpu().numpy()
        pss = np.arange(pg_num) if pg_num <= sample else \
            np.random.default_rng(6).choice(pg_num, sample, replace=False)
        weights = list(m.osd_weight)
        for ps in pss.tolist():
            if out[ps].tolist() != crush_do_rule(cmap, ruleno, int(pps[ps]),
                                                 12, weights):
                raise AssertionError(f"type-0 indep ps {ps}: kernel != "
                                     f"interpreter")
        chain = None
        if pg_num == 256:
            pm = mapper.map_pool(1)
            differ = 0
            for ps in range(pg_num):
                up, upp, act, actp = m.pg_to_up_acting_osds(PG(1, ps))
                differ += (pm.up[ps][:len(up)].tolist() != up or
                           pm.acting[ps][:len(act)].tolist() != act or
                           int(pm.up_primary[ps]) != upp or
                           int(pm.acting_primary[ps]) != actp)
            if differ or pm.acting[0][7] != 7:
                raise AssertionError(f"type-0 indep map_pool: {differ} PGs "
                                     f"differ from the chain, PG 1.0 "
                                     f"{pm.acting[0].tolist()}")
            chain = {"pgs": pg_num, "differ": differ,
                     "pg_1_0": pm.acting[0].tolist()}
        ms = cuda_ms(lambda: CK.straw2_map(xs, tables, rw, shape), 10)
        bound = PS.straw2_bound(stats["draws"], pg_num, shape.out_size,
                                tables, rw)
        rows.append({"kernel": "crush_straw2", "path": "placement",
                     "label": f"ec12 type-0 indep {pg_num}",
                     "pool": "ec12_type0", "variant": "reweights",
                     "shape": [pg_num, shape.out_size], "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms,
                     "plain_device": pdev.type, **bound,
                     "share_of_bound": bound["bound_ms"] / ms,
                     "draws_per_x": stats["draws"] / pg_num,
                     "interpreter_checked": len(pss), "chain": chain,
                     "none_items": int((out == CK.NONE).sum())})
    return {"rows": rows}


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
    # (g) the type-0 chooseleaf indep rule, outside the counted window
    lines["type0"] = placement_type0(PS, dev)
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
    return lines, launches, rows + lines["type0"]["rows"]


def mesh_ms(fn, iters: int, devices: list, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn`` over ``iters`` calls, CUDA events on
    every card of the mesh (the slowest card's span), launch ledger
    paused."""
    from ceph_tpu_torch.ops import launch_ledger
    with launch_ledger.paused():
        for _ in range(warmup):
            fn()
        for d in devices:
            torch.cuda.synchronize(d)
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in devices]
        for d, (start, _end) in zip(devices, pairs):
            start.record(torch.cuda.current_stream(d))
        for _ in range(iters):
            fn()
        for d, (_start, end) in zip(devices, pairs):
            end.record(torch.cuda.current_stream(d))
        for _start, end in pairs:
            end.synchronize()
    return max(start.elapsed_time(end) for start, end in pairs) / iters


def _mesh_counted(K, CK, LL, mesh, fn, label: str) -> tuple:
    """``fn()`` once with the wrappers' counts zeroed just before and read
    just after, and the launch ledger recording: (its result, the
    launches line).  The ledger's count must equal the wrapper's."""
    for d in mesh.devices:
        torch.cuda.synchronize(d)
    K.reset_launches()
    CK.reset_launches()
    with LL.recording(route="cuda") as seen:
        out = fn()
        for d in mesh.devices:
            torch.cuda.synchronize(d)
    n = (CK.launches if label == "crush_straw2" else K.launches)[label]
    ledger = sum(v for key, v in seen.items()
                 if key[0] == label or (label == "crush_straw2"
                                        and key[0].startswith("crush.")))
    if ledger != n:
        raise AssertionError(f"mesh: {label} ledger {ledger} != wrapper {n}")
    shards = mesh.shape["dp"] * mesh.shape["sp"]
    return out, {"kernel": label, "launches": n, "ledger": ledger,
                 "per_shard": n / shards}


def phase_mesh(K, CK, LL, PS, ecutil, registry_cls, devices=None,
               batch: int = 64, n: int = MIB, n_xs: int | None = None,
               obj_bytes: int = 4 * MIB, ops: int = 64
               ) -> tuple[dict, dict]:
    """The device mesh (ceph_tpu_torch/parallel/mesh.py) at full width:
    the distinct cards when there are two or more, else a 4-shard mesh
    (dp 2, sp 2) on the one card.  (a) sharded_encode_step and
    sharded_batch_encode_step on RS(8,4) Cauchy, [64, 8, 1 Mi]: parity
    bitwise against one gf_apply_stripes, checksum and rotated against
    their plain recomputation; (b) sharded_decode_step of erasures {0, 9}
    of that batch, [2, 8] x [8, 64 Mi] survivors, against the lost rows;
    (c) sharded_placement_step on phase placement's ec84 rule at 2^20
    x's against one map_rule, hist against the bincount of the valid
    entries; (d) a ServingEngine whose pipeline carries the mesh: 64
    encodes of 4 MiB and 64 degraded reads ({1, 9} lost) at concurrency
    16, every op against the single-card encode_many and the objects'
    bytes, mesh_dispatches > 0.  Each step's launches per shard (=
    the ledger's) and CUDA-event ms.  Returns (the lines, launches by
    kernel).  ``devices`` and the sizes default to the above."""
    from ceph_tpu_torch.common import Context
    from ceph_tpu_torch.crush.torch_mapper import BulkMapper
    from ceph_tpu_torch.exec import ServingEngine, workload
    from ceph_tpu_torch.gf import matrix as gfm
    from ceph_tpu_torch.parallel import mesh as MM
    cards = torch.cuda.device_count()
    if devices is None and cards >= 2:
        devices = [torch.device("cuda", i)
                   for i in range(1 << (cards.bit_length() - 1))]
    elif devices is None:
        devices = [torch.device("cuda", 0)] * 4
    mesh = MM.make_mesh(len(devices), devices=devices)
    cards_used = mesh.devices
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    head = {"cards": len(cards_used), "shards": dp * sp, "dp": dp, "sp": sp,
            "devices": [str(d) for d in cards_used]}
    home = cards_used[0]
    lines, launches = {}, collections.Counter()

    # (a) the encode steps
    k, m = 8, 4
    n_xs = n_xs or PS.PLACEMENT_PGS
    pm = gfm.cauchy1(k, m)
    gen = torch.Generator(device=home).manual_seed(17)
    data = rand_u8(gen, (batch, k, n), home)
    pmat = torch.from_numpy(pm).to(home)
    want = K.gf_apply_stripes(pmat, data.view(batch * k, n),
                              batch).view(batch, m, n)
    step = MM.sharded_encode_step(mesh, pm)
    (parity, checksum, rotated), enc = _mesh_counted(
        K, CK, LL, mesh, lambda: step(data), "gf_apply_stripes")
    if not torch.equal(parity.full(home), want):
        raise AssertionError("mesh: sharded parity != gf_apply_stripes")
    if not torch.equal(checksum.full(home),
                       want.sum(dim=(1, 2), dtype=torch.int64)):
        raise AssertionError("mesh: checksum != its plain recomputation")
    if not torch.equal(rotated.full(home),
                       torch.roll(want, batch // dp, dims=0)):
        raise AssertionError("mesh: rotated != the dp-ring roll")
    bstep = MM.sharded_batch_encode_step(mesh, pm)
    bparity, benc = _mesh_counted(K, CK, LL, mesh, lambda: bstep(data),
                                  "gf_apply_stripes")
    if not torch.equal(bparity.full(home), want):
        raise AssertionError("mesh: batch parity != gf_apply_stripes")
    launches["gf_apply_stripes"] += enc["launches"] + benc["launches"]
    enc_bytes = batch * (k + m) * n
    lines["encode"] = {**head, "shape": [batch, k, n], "step": enc,
                       "batch_step": benc,
                       "ms": mesh_ms(lambda: step(data), 10, cards_used),
                       "batch_ms": mesh_ms(lambda: bstep(data), 10,
                                           cards_used),
                       "single_card_ms": cuda_ms(
                           lambda: K.gf_apply_stripes(
                               pmat, data.view(batch * k, n), batch), 10),
                       "bound_ms": bytes_bound_ms(enc_bytes)}
    del parity, checksum, rotated, bparity

    # (b) the decode step: the batch's chunks as [n, 64 Mi] streams
    erasures = [0, 9]
    D, src = gfm.decode_matrix(pm, erasures)
    full = torch.cat([data, want], dim=1)                 # [64, 12, 1 Mi]
    survivors = full[:, src, :].transpose(0, 1).reshape(k, batch * n)
    lost = full[:, erasures, :].transpose(0, 1).reshape(2, batch * n)
    del full, want
    dstep = MM.sharded_decode_step(mesh)
    Dt = torch.from_numpy(D).to(home)
    rec, dec = _mesh_counted(K, CK, LL, mesh,
                             lambda: dstep(Dt, survivors), "gf_apply")
    if not torch.equal(rec.full(home), lost):
        raise AssertionError("mesh: decode step did not recover {0, 9}")
    launches["gf_apply"] += dec["launches"]
    lines["decode"] = {**head,
                       "shape": [list(D.shape), list(survivors.shape)],
                       "erasures": erasures, "step": dec,
                       "ms": mesh_ms(lambda: dstep(Dt, survivors), 10,
                                     cards_used),
                       "single_card_ms": cuda_ms(
                           lambda: K.gf_apply(Dt, survivors), 10),
                       "bound_ms": bytes_bound_ms((k + 2) * batch * n)}
    del rec, survivors, lost, data

    # (c) the placement step on phase placement's ec84 pool
    pkg = PS.load_package(HERE)
    omap = PS.placement_cluster(pkg, n_xs)
    pool = omap.pools[2]
    bulk = BulkMapper(omap.crush, device=str(home))
    rw = np.asarray(omap.osd_weight, dtype=np.int64)
    xs = torch.from_numpy(np.random.default_rng(23).integers(
        0, 1 << 32, size=n_xs, dtype=np.int64))
    pstep = MM.sharded_placement_step(mesh, bulk, pool.crush_rule,
                                      omap.max_osd, reweights=rw,
                                      result_max=pool.size)
    ref, _placed = bulk.map_rule(pool.crush_rule, xs.to(home),
                                 reweights=rw, result_max=pool.size,
                                 device=home)
    (out, hist), plc = _mesh_counted(K, CK, LL, mesh, lambda: pstep(xs),
                                     "crush_straw2")
    if not torch.equal(out.full(home), ref):
        raise AssertionError("mesh: sharded placement != map_rule")
    valid = ref[(ref >= 0) & (ref != 0x7FFFFFFF)].to(torch.int64)
    if not torch.equal(hist.full(home).to(torch.int64),
                       torch.bincount(valid, minlength=omap.max_osd)):
        raise AssertionError("mesh: hist != bincount of the placements")
    launches["crush_straw2"] += plc["launches"]
    lines["placement"] = {**head, "pool": pool.name, "xs": n_xs,
                          "n_osds": omap.max_osd, "step": plc,
                          "ms": mesh_ms(lambda: pstep(xs), 3, cards_used),
                          "single_card_ms": cuda_ms(
                              lambda: bulk.map_rule(
                                  pool.crush_rule, xs.to(home),
                                  reweights=rw, result_max=pool.size,
                                  device=home), 3)}

    # (d) the serving engine with the mesh in its pipeline
    registry = registry_cls.instance()
    ec, sinfo, pays, reads, check_encode, check_decode = rbd_workload(
        ecutil, registry, workload, obj_bytes, lost={1, 9})
    eng = ServingEngine(cct=Context(), ec_impl=ec, sinfo=sinfo,
                        name="rbd.mesh", pipeline_depth=4)
    eng.pipeline.mesh = mesh
    eng.start()
    try:
        for kind, payloads in (("encode", pays), ("decode", reads)):
            workload.closed_loop(eng, 32, 16, payloads, kind=kind)
        serve = {kind: serve_run(K, workload, eng, kind, ops, 16, payloads,
                                 check, per_batch=dp * sp, kernel=kernel)
                 for kind, payloads, check, kernel in (
                     ("encode", pays, check_encode, "gf_apply_stripes"),
                     ("decode", reads, check_decode, "gf_apply"))}
    finally:
        eng.stop()
    for kind, r in serve.items():
        pipe = r["pipeline"]
        if pipe["mesh_dispatches"] != pipe["submitted"] or \
                not pipe["mesh_dispatches"]:
            raise AssertionError(f"mesh serving {kind}: {pipe}")
        kernel = "gf_apply_stripes" if kind == "encode" else "gf_apply"
        launches[kernel] += r[f"{kernel}_launches"]
    lines["serving"] = {kind: {key: r[key] for key in (
        "ops", "op_bytes", "ops_s", "MiBps", "p50_ms", "p99_ms",
        f"{kernel}_launches", "pipeline")} for kind, r, kernel in (
            ("encode", serve["encode"], "gf_apply_stripes"),
            ("decode", serve["decode"], "gf_apply"))}
    lines["serving"].update(head, lost=[1, 9])
    return lines, launches


def serving_rados_bench(kind: str, ops: int = 256, op_size: str = "4M",
                        clients: int = 512, device: str = "cuda") -> dict:
    """The serving load generator (ceph_tpu_torch.tools.rados_bench) in
    process on the card: --compare --json at 256 ops of 4 MiB
    (torch_rs k=8 m=4, 4 KiB chunk) and concurrency 16, and --mode mux at
    512 sessions x 2 RPCs over 8 connections; ops/s and p50/p99 of each
    arm, and no JAX in the process.  ``kind``: the card's name."""
    import contextlib
    import io
    from ceph_tpu_torch.tools import rados_bench

    def run(argv) -> dict:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            if rados_bench.main([*argv, "--device", device, "--json"]) != 0:
                raise AssertionError(f"rados_bench {argv} failed")
        return json.loads(buf.getvalue().strip().splitlines()[-1]) | {
            "wall_s": time.perf_counter() - t0}

    cmp = run(["--compare", "--ops", str(ops), "--concurrency", "16",
               "--op-size", op_size, "--k", "8", "--m", "4",
               "--chunk-size", "4K"])
    mux = run(["--mode", "mux", "--clients", str(clients),
               "--ops-per-client", "2", "--conns", "8"])
    for arm in ("batched", "unbatched"):
        if cmp[arm]["ops"] != ops or cmp[arm]["ops_rejected"]:
            raise AssertionError(f"rados_bench --compare: {cmp[arm]}")
    if mux["capacity"]["completed"] != 2 * clients or \
            mux["capacity"]["failed"] or \
            mux["overload"]["completed"] != 2 * clients:
        raise AssertionError(f"rados_bench --mode mux: {mux}")
    if "jax" in sys.modules:
        raise AssertionError("rados_bench loaded jax")
    keep = ("ops_s", "MiBps", "mb_s", "p50_ms", "p99_ms", "mean_batch_size")
    return {"device": kind, "compare": {
                "speedup": cmp["speedup"], "wall_s": cmp["wall_s"],
                **{arm: {key: cmp[arm][key] for key in keep
                         if key in cmp[arm]}
                   for arm in ("batched", "unbatched")}},
            "mux": {"clients": mux["clients"], "wall_s": mux["wall_s"],
                    "ops_s": mux["ops_s"], "p50_ms": mux["p50_ms"],
                    "p99_ms": mux["p99_ms"],
                    "overload": {key: mux["overload"][key] for key in (
                        "ops_s", "p99_ms", "shed_rate")}}}


def phase_lint() -> dict:
    """ceph-lint over the checkout's package, with its baseline."""
    from ceph_tpu_torch.tools import ceph_lint
    t0 = time.perf_counter()
    s = ceph_lint.lint_summary()
    out = {"new": s["new"], "baselined": s["baselined"],
           "stale": s["stale_baseline"], "total": s["total"],
           "rules_run": s["rules_run"], "by_rule": s["by_rule"],
           "seconds": time.perf_counter() - t0}
    if s["new"]:
        raise AssertionError(f"lint: {s['new']} new findings: {s}")
    return out


def phase_chaos(K, smi: str, seed: int = 13, ops: int = 12,
                device: str = "cuda") -> tuple:
    """Two seeded chaos campaigns with the pool on the card, their
    invariants, and the tracer's wiring to the campaign's Context.
    ``device="cpu"`` (the tests) runs the plain versions, which the
    wrappers' counters do not count."""
    from ceph_tpu_torch.common import tracer
    from ceph_tpu_torch.tools import chaos_run
    runs, n_apply, n_crc = [], 0, 0
    for _ in range(2):
        K.reset_launches()
        rep = chaos_run.run_campaign(seed=seed, ops=ops, device=device)
        counters = dict(K.launches)
        n_apply += counters["gf_apply"]
        n_crc += counters["crc32c_rows"]
        led = rep["launches"]
        if not (rep["ok"] and rep["verified"] == rep["acked_writes"] > 0):
            raise AssertionError(f"chaos: report not ok: {rep}")
        if not {"OSD_FLAPPING", "DEVICE_DEGRADED"} <= \
                set(rep["health_seen"]):
            raise AssertionError(f"chaos: health {rep['health_seen']}")
        if rep["breaker"]["opens"] < 1 or \
                rep["breaker"]["state"] != "closed":
            raise AssertionError(f"chaos: breaker {rep['breaker']}")
        if led.get("gf_apply", 0) < 1 or led.get("crc32c_rows", 0) < 1:
            raise AssertionError(f"chaos: ledger launches {led}")
        if device == "cuda" and \
                any(led.get(k, 0) != counters[k] for k in counters):
            raise AssertionError(f"chaos: ledger {led} != counters "
                                 f"{counters}")
        runs.append({
            "seconds": rep["timing"]["seconds"],
            "put_ms": rep["timing"]["put_ms"],
            "get_ms": rep["timing"]["get_ms"],
            "puts": rep["timing"]["puts"], "gets": rep["timing"]["gets"],
            "acked_writes": rep["acked_writes"],
            "verified": rep["verified"],
            "tier_acked": rep["tier"]["acked_writes"],
            "launches": led, "events": rep["events"],
            "event_digest": rep["event_digest"],
            "breaker": rep["breaker"], "phase3": rep["phase3"],
            "health_seen": rep["health_seen"],
            "transport": rep["transport"]})
    if runs[0]["event_digest"] != runs[1]["event_digest"]:
        raise AssertionError("chaos: same seed, different event digests")
    cct = chaos_run._campaign_context()
    tr = tracer.default_tracer()
    cct.conf.set("osd_op_complaint_time", 5.0)
    wiring = {"slow_threshold_s": tr.slow_threshold_s,
              "osd_op_complaint_time": cct.conf.get("osd_op_complaint_time"),
              "sample_rate": tr.sample_rate,
              "tracer_sample_rate": cct.conf.get("tracer_sample_rate")}
    cct.conf.set("osd_op_complaint_time", 30.0)
    if wiring["slow_threshold_s"] != 5.0 or \
            wiring["slow_threshold_s"] != wiring["osd_op_complaint_time"] \
            or wiring["sample_rate"] != wiring["tracer_sample_rate"]:
        raise AssertionError(f"chaos: tracer not wired: {wiring}")
    return ({"seed": seed, "ops": ops, "campaigns": runs,
             "digests_equal": True, "gf_apply_launches": n_apply,
             "crc32c_rows_launches": n_crc, "gpu": smi},
            wiring, n_apply, n_crc)


# -- phases soak, corpus and reports ------------------------------------------

SOAK_SEED, SOAK_REP_SEED = 113, 7


def _launch_delta(K, LL, route: str, before) -> tuple[dict, dict]:
    """The wrappers' counters since ``K.reset_launches()`` and the launch
    ledger's launches by kernel on ``route`` since ``before``."""
    led = LL.totals(route) - before
    return dict(K.launches), {k: led.get(k, 0) for k in K.launches}


def _check_launches(phase: str, kernels, counters: dict, ledger: dict,
                    device: str) -> None:
    """On the card each kernel named launched and the ledger booked
    every launch; on the CPU (the tests) the ledger booked each kernel's
    plain version, which the counters do not count."""
    if device == "cuda":
        ok = counters == ledger and all(counters[k] > 0 for k in kernels)
    else:
        ok = all(ledger[k] > 0 for k in kernels)
    if not ok:
        raise AssertionError(f"{phase}: counters {counters} ledger "
                             f"{ledger}")


def phase_soak(K, LL, device: str = "cuda") -> tuple:
    """The seeded soak campaign (ceph_tpu_torch.tools.soak_sweep) in full:
    300 steps at seed 113 with its EC pool (torch_rs k=2 m=2) on
    ``device``, then seed 7 on the replicated pool, which launches
    nothing.  The EC campaign's cluster hands over, before it shuts down,
    a ``flight dump`` bundle and its SLO block (phase reports' (c) and
    (d)).  Returns the line, those artifacts and the launches."""
    from ceph_tpu_torch.tools import soak_sweep
    route = "cuda" if device == "cuda" else "cpu"
    platform = "gpu" if device == "cuda" else "cpu"
    art: dict = {}

    def settled(c) -> None:
        c.critpath.refresh()
        art["slo"] = c.slo.bench_block(platform)
        c.ts.record(force=True)
        art["bundle"] = c.cct.admin_socket.call("flight dump",
                                                reason="soak")

    K.reset_launches()
    before = LL.totals(route)
    ec = soak_sweep.soak_campaign(SOAK_SEED, "ec", device=device,
                                  on_settled=settled)
    counters, ledger = _launch_delta(K, LL, route, before)
    _check_launches("soak", ("gf_apply", "crc32c_rows"), counters, ledger,
                    device)
    K.reset_launches()
    before = LL.totals(route)
    rep = soak_sweep.soak_campaign(SOAK_REP_SEED, "rep", device=device)
    rep_counters, rep_ledger = _launch_delta(K, LL, route, before)
    if any(rep_counters.values()) or any(rep_ledger.values()):
        raise AssertionError(f"soak: the replicated pool launched "
                             f"{rep_counters} {rep_ledger}")
    line = {name: {key: r[key] for key in (
        "seed", "steps", "seconds", "actions", "objects", "snaps",
        "damaged_restored", "health")} | {
        "ms_per_step": r["seconds"] / r["steps"] * 1e3,
        "model_held": True, "final_scrub_clean": r["final_scrub"] == {}}
        for name, r in (("ec", ec), ("rep", rep))}
    line["ec"] |= {"device": device, "launches": counters,
                   "ledger_launches": ledger}
    return line, art, counters


def phase_corpus(K, LL, device: str = "cuda") -> tuple:
    """The port's corpus generator (ceph_tpu_torch.tools.gen_ec_corpus)
    on ``device`` into a temporary directory: every entry's chunk_size
    and chunk digests against tests/golden/ec_corpus.json."""
    import contextlib
    import io
    import shutil
    import tempfile
    from ceph_tpu_torch.tools import gen_ec_corpus
    route = "cuda" if device == "cuda" else "cpu"
    with open(os.path.join(HERE, "tests", "golden", "ec_corpus.json")) as f:
        golden = json.load(f)["entries"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_corpus.")
    try:
        out = os.path.join(tmp, "ec_corpus.json")
        K.reset_launches()
        before = LL.totals(route)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = gen_ec_corpus.main(["--out", out, "--device", device])
        seconds = time.perf_counter() - t0
        counters, ledger = _launch_delta(K, LL, route, before)
        with open(out) as f:
            got = json.load(f)["entries"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if rc != 0 or sorted(got) != sorted(golden):
        raise AssertionError(f"corpus: rc {rc}, entries {sorted(got)}")
    for name, want in sorted(golden.items()):
        have = got[name]
        if have["chunk_size"] != want["chunk_size"]:
            raise AssertionError(f"corpus: {name} chunk_size "
                                 f"{have['chunk_size']} != "
                                 f"{want['chunk_size']}")
        for chunk, digest in sorted(want["chunk_sha256"].items()):
            if have["chunk_sha256"].get(chunk) != digest:
                raise AssertionError(f"corpus: {name} chunk {chunk} "
                                     f"digest differs")
        if sorted(have["chunk_sha256"]) != sorted(want["chunk_sha256"]):
            raise AssertionError(f"corpus: {name} chunks "
                                 f"{sorted(have['chunk_sha256'])}")
    _check_launches("corpus", ("gf_apply", "xor_apply"), counters, ledger,
                    device)
    return ({"entries": len(got), "digests_equal": True,
             "chunks": sum(len(e["chunk_sha256"]) for e in got.values()),
             "seconds": seconds, "device": device, "launches": counters,
             "ledger_launches": ledger}, counters)


def _tool(mod, argv: list[str]) -> tuple[int, str]:
    """One in-process run of a report tool: exit code and stdout."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    return rc, buf.getvalue()


def phase_reports(LL, soak_art: dict, value: float, serving: dict,
                  recovery: dict, platform: str = "gpu") -> dict:
    """The four post-hoc reports and the perf gate over this run's own
    artifacts: (a) roofline.bench_block(platform) through
    roofline_report, a row for every ledger key launched on the card and
    no share over 100%; (b) the default context's ``trace dump`` through
    trace_report (p99 >= p50 on every row, one --trace-id tree); (c)
    phase soak's flight bundle through ts_report and slo_report; (d) a
    bench-shaped line of numbers the phases measured (``value``: the
    headline's combined MiB/s; ``serving`` and ``recovery``: their bench
    blocks) through perf_gate: against itself PASS with every present
    metric compared, against the repo's BENCH history PASS with no
    comparable reference, and with --expect-platform tpu FAIL."""
    import shutil
    import tempfile
    from ceph_tpu_torch.common import default_context, roofline
    from ceph_tpu_torch.tools import (perf_gate, roofline_report,
                                      slo_report, trace_report, ts_report)
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_reports.")
    out: dict = {}

    def save(name: str, doc) -> str:
        path = os.path.join(tmp, name)
        with open(path, "w") as f:
            json.dump(doc, f, default=str)
        return path

    def run(mod, argv: list[str], want_rc: int = 0) -> str:
        rc, text = _tool(mod, argv)
        if rc != want_rc:
            raise AssertionError(f"reports: {mod.__name__} {argv[1:]} "
                                 f"rc {rc}: {text[-400:]}")
        return text

    try:
        # (a) the roofline
        eff = roofline.bench_block(platform, limit=1 << 20)
        eff_doc = json.loads(run(roofline_report, [
            save("efficiency.json", {"efficiency": eff}), "--json"]))
        rows = {r["executable"]: r for r in eff_doc["executables"]}
        route = "cuda" if platform == "gpu" else "cpu"
        want = {roofline.executable_id(rec["kernel"], LL._roofline_key(
            (rec["kernel"], tuple(rec["mat"]), rec["rows"], rec["cols"]),
            route)) for rec in LL.snapshot()["keys"]
            if rec["route"] == route and rec["booked"]}
        over = [e for e, r in rows.items() if r["pct_of_peak"] > 100.0]
        if eff["device"] != platform or want - set(rows) or over:
            raise AssertionError(f"reports: roofline {eff['device']}, "
                                 f"missing {sorted(want - set(rows))[:4]}, "
                                 f"over 100% {over[:4]}")
        out["roofline"] = {
            "rows": len(rows), "ledger_keys": len(want),
            "max_pct_of_peak": max(r["pct_of_peak"] for r in rows.values()),
            "pct_of_peak": eff["pct_of_peak"],
            "table_lines": len(run(roofline_report, [
                save("efficiency.json", {"efficiency": eff}),
                "--limit", "8"]).splitlines())}
        # (b) the tracer's dump
        trace = save("trace.json", json.loads(
            default_context().admin_socket.call_json("trace dump")))
        spans = json.loads(run(trace_report, [trace, "--json"]))["spans"]
        bad = [s["name"] for s in spans if s["p99_ms"] < s["p50_ms"]]
        listed = run(trace_report, [trace, "--traces"]).splitlines()
        if not spans or bad or len(listed) < 2:
            raise AssertionError(f"reports: trace {len(spans)} rows, p99 < "
                                 f"p50 in {bad[:4]}, {listed[:2]}")
        trace_id = listed[1].split()[0]
        tree = run(trace_report, [trace, "--trace-id", trace_id])
        if not tree.startswith(f"trace {trace_id} ("):
            raise AssertionError(f"reports: trace tree {tree[:200]!r}")
        out["trace"] = {"rows": len(spans), "traces": len(listed) - 1,
                        "top": spans[0]["name"],
                        "tree_lines": len(tree.splitlines())}
        # (c) the soak cluster's flight bundle
        bundle = save("flight-soak.json", soak_art["bundle"])
        ts = json.loads(run(ts_report, [bundle, "--json"]))
        log = run(ts_report, [bundle, "--log"])
        slo = json.loads(run(slo_report, [bundle, "--json"]))
        if not ts["series"] or "# clusterlog" not in log or \
                slo["classes"].get("client", {}).get("ops", 0) < 1:
            raise AssertionError(f"reports: ts {len(ts['series'])} series,"
                                 f" slo {slo['classes'].keys()}")
        out["flight"] = {"ts_series": len(ts["series"]),
                         "ts_points": ts["points"],
                         "slo_classes": sorted(slo["classes"]),
                         "client_p99_ms": slo["classes"]["client"]["p99_ms"]}
        # (d) a bench-shaped line through the gate
        line = {"metric": "chip_smoke", "value": value, "unit": "MiB/s",
                "device": platform, "serving": serving,
                "recovery": recovery, "efficiency": eff,
                "slo": soak_art["slo"]}
        path = save("line.json", line)
        present = perf_gate.extract_metrics(line)
        if any(m["device"] != platform for m in present.values()):
            raise AssertionError(f"reports: line devices {present}")
        self_ = json.loads(run(perf_gate, [path, "--baseline", path,
                                           "--json"]))
        hist = json.loads(run(perf_gate, [path, "--repo-dir", HERE,
                                          "--json"]))
        loud = run(perf_gate, [path, "--repo-dir", HERE, "--expect-platform",
                               "tpu", "--check"], want_rc=1)
        if not (self_["ok"] and len(self_["compared"]) == len(present)) \
                or not hist["ok"] or hist["compared"] or \
                "no comparable reference metrics" not in hist["verdict"] \
                or hist["expected_platform"] is not None or \
                "platform fallback" not in loud:
            raise AssertionError(f"reports: gate {self_['verdict']} | "
                                 f"{hist['verdict']} | {loud.strip()}")
        out["gate"] = {"metrics": sorted(present),
                       "self": self_["verdict"],
                       "history": hist["verdict"],
                       "history_reference": hist["reference"],
                       "expect_tpu": loud.strip()}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    return out


def bench_blocks(serving: dict, clus: dict, platform: str = "gpu"
                 ) -> tuple[dict, dict]:
    """Bench-shaped ``serving`` and ``recovery`` blocks from numbers phases
    serving and cluster measured: the 4 KiB batched arm of the median
    run, and the cluster's wave repair of osd.3 (rebuilt MiB/s, wire
    bytes per repaired byte)."""
    runs = sorted(serving["small_ops"]["runs"],
                  key=lambda r: r["batched"]["ops_s"])
    batched = runs[len(runs) // 2]["batched"]
    wave = clus["repair_wave"]["repair"]
    return ({"device": platform,
             "batched": {"ops_s": batched["ops_s"],
                         "p99_ms": batched["p99_ms"]}},
            {"device": platform,
             "batched": {"mib_s": wave["rebuilt_MiBps"]},
             "wire": {"per_byte_repaired":
                      wave["wire_bytes_per_repaired_byte"]}})


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
    from ceph_tpu_torch import native
    from ceph_tpu_torch.backend import ecutil
    from ceph_tpu_torch.gf import bitmatrix as bm
    from ceph_tpu_torch.gf import ref as gfref
    from ceph_tpu_torch.ops import crush_kernels as CK
    from ceph_tpu_torch.ops import cuda_build
    from ceph_tpu_torch.ops import launch_ledger as LL
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

    walls, mark = {}, [time.perf_counter(), LL.counts("cuda")]
    by_phase = {}

    def lap(name: str) -> None:
        """Wall seconds of the phase just emitted, set-up and checks in,
        and the launch ledger's keys of the phase."""
        now, keys = time.perf_counter(), LL.counts("cuda")
        walls[name], by_phase[name] = now - mark[0], keys - mark[1]
        mark[0], mark[1] = now, keys

    emit("build", **phase_build(cuda_build, native), gpu=smi,
         torch=torch.__version__, cuda=torch.version.cuda)
    lap("build")
    emit("kernels", **phase_kernels(
        K, SK, dev, jerasure_decode_bitmatrices(ErasureCodePluginRegistry,
                                                bm)))
    lap("kernels")
    ecu, n_apply, n_crc = phase_ecutil(K, ecutil, ErasureCodePluginRegistry)
    emit("ecutil", **ecu, gpu=smi)
    lap("ecutil")
    rep, n_repair, n_repair_crc = phase_repair(
        K, ecutil, ErasureCodePluginRegistry, CodecPipeline)
    emit("repair", **rep, gpu=smi)
    lap("repair")
    backend, n_backend, n_backend_crc = phase_backend(
        K, ecutil, ErasureCodePluginRegistry, CodecPipeline)
    for name, line in backend.items():
        emit(f"backend.{name}", **(line if isinstance(line, dict)
                                   else {"runs": line}), gpu=smi)
    lap("backend")
    with PS.recorded_launches(K) as seen:
        clus, n_cluster, n_cluster_crc = phase_cluster(
            K, ecutil, ErasureCodePluginRegistry)
    clus["shapes"] = cluster_launch_shapes(PS, ErasureCodePluginRegistry,
                                           seen)
    for name, line in clus.items():
        emit(f"cluster.{name}", **line, gpu=smi)
    lap("cluster")
    with PS.recorded_launches(K) as seen:
        dur, n_durable, n_durable_crc = phase_durable(
            K, ecutil, ErasureCodePluginRegistry)
    dur["shapes"] = durable_launch_shapes(PS, ErasureCodePluginRegistry,
                                          seen)
    for name, line in dur.items():
        emit(f"durable.{name}", **line, gpu=smi)
    lap("durable")
    with PS.recorded_launches(K) as seen:
        net, n_net, n_net_crc = phase_net(
            K, ecutil, ErasureCodePluginRegistry, seen=seen)
    net["shapes"] = net_launch_shapes(PS, ErasureCodePluginRegistry, seen)
    for name, line in net.items():
        emit(f"net.{name}", **line, gpu=smi)
    lap("net")
    serving, n_serving = phase_serving(K, ecutil, ErasureCodePluginRegistry)
    emit("serving", **serving, gpu=smi)
    emit("serving.rados_bench", **serving_rados_bench(kind), gpu=smi)
    lap("serving")
    head, n_stripes = phase_headline(K, RSCodec, gfref)
    emit("headline", **head, gpu=smi)
    lap("headline")
    jer, n_xor = phase_jerasure(K, ecutil, ErasureCodePluginRegistry)
    emit("jerasure", **jer, gpu=smi)
    lap("jerasure")
    shapes = phase_shapes(PS, dev)
    emit("shapes", rows=shapes, gpu=smi)
    lap("shapes")
    emit("ec_bench", **phase_ec_bench(), gpu=smi)
    lap("ec_bench")
    nat, n_native = phase_native(K, LL, ecutil, gfref,
                                 ErasureCodePluginRegistry, native)
    for name, line in nat.items():
        emit(f"native.{name}", **line, gpu=smi)
    lap("native")
    sweep, rows_sweep = phase_sweep(K, SK, KS, PS, cuda_build, dev)
    emit("sweep", **sweep, gpu=smi)
    lap("sweep")
    placement, n_place, rows_place = phase_placement(PS, cuda_build, dev)
    for name, line in placement.items():
        emit(f"placement.{name}", **line, gpu=smi)
    lap("placement")
    mesh, n_mesh = phase_mesh(K, CK, LL, PS, ecutil,
                              ErasureCodePluginRegistry)
    for name, line in mesh.items():
        emit(f"mesh.{name}", **line, gpu=smi)
    lap("mesh")
    emit("lint", **phase_lint(), gpu=smi)
    lap("lint")
    chaos, wiring, n_chaos, n_chaos_crc = phase_chaos(K, smi)
    emit("chaos", **chaos)
    emit("chaos.tracer", **wiring, gpu=smi)
    lap("chaos")
    soak, soak_art, n_soak = phase_soak(K, LL)
    for name, line in soak.items():
        emit(f"soak.{name}", **line, gpu=smi)
    lap("soak")
    corpus, n_corpus = phase_corpus(K, LL)
    emit("corpus", **corpus, gpu=smi)
    lap("corpus")
    emit("reports", **phase_reports(
        LL, soak_art, head["combined_MiBps"], *bench_blocks(serving, clus)),
        gpu=smi)
    lap("reports")
    inst = phase_instruments(K, ecutil, ErasureCodePluginRegistry)
    for name, line in inst.items():
        emit(f"instruments.{name}", **line, gpu=smi)
    lap("instruments")
    net_batches = collections.Counter({
        (k0, tuple(k1), k2, k3): v
        for k0, k1, k2, k3, v in net["frontend"]["batch_keys"]})
    emit("instruments.ledger_overhead", **ledger_overhead(K, LL, dev),
         gpu=smi)
    emit("instruments.ledger", **ledger_checks(
        K, CK, LL, PS, ErasureCodePluginRegistry, by_phase, net_batches,
        rows_place, {"soak": n_soak, "corpus": n_corpus, "reports": {}}),
        gpu=smi)
    lap("instruments_checks")
    emit("walls", seconds=walls, total=sum(walls.values()), gpu=smi)

    def on(kernel):
        return [r for r in shapes if r["kernel"] == kernel]

    print(json.dumps({"kernels": [
        kernel_row("gf_apply", "gf_apply.cu",
                   "ceph_tpu/ops/pallas_kernels.py:156",
                   "ecutil", n_apply, on("gf_apply"))
        | {"launches_by_path": {"ecutil": n_apply, "serving": n_serving,
                                "repair": n_repair, "backend": n_backend,
                                "cluster": n_cluster,
                                "durable": n_durable, "net": n_net,
                                "chaos": n_chaos,
                                "mesh": n_mesh["gf_apply"],
                                "soak": n_soak["gf_apply"],
                                "corpus": n_corpus["gf_apply"]}},
        kernel_row("gf_apply_stripes", "gf_apply.cu",
                   "ceph_tpu/ops/pallas_kernels.py:80",
                   "headline", n_stripes, on("gf_apply_stripes"))
        | {"launches_by_path": {"headline": n_stripes,
                                "native": n_native,
                                "mesh": n_mesh["gf_apply_stripes"]}},
        kernel_row("xor_apply", "xor_apply.cu",
                   "ceph_tpu/ops/pallas_kernels.py:207",
                   "jerasure", n_xor, on("xor_apply"))
        | {"launches_by_path": {"jerasure": n_xor,
                                "corpus": n_corpus["xor_apply"]}},
        *rows_sweep,
        kernel_row("crc32c_rows", "crc32c.cu",
                   "ceph_tpu/ops/rs_kernels.py:302", "ecutil", n_crc,
                   on("crc32c_rows"))
        | {"launches_by_path": {"ecutil": n_crc, "repair": n_repair_crc,
                                "backend": n_backend_crc,
                                "cluster": n_cluster_crc,
                                "durable": n_durable_crc,
                                "net": n_net_crc, "chaos": n_chaos_crc,
                                "soak": n_soak["crc32c_rows"]},
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
         "library": NO_CRUSH_LIBRARY, "shapes": rows_place,
         "launches_by_path": {"placement": n_place,
                              "mesh": n_mesh["crush_straw2"]}}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
