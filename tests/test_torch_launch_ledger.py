"""The launch ledger (``ceph_tpu_torch.ops.launch_ledger``) on the CPU.

- A plain-version call sequence through the kernel wrappers books each
  call once, by ``tools/path_shapes.launch_key``, with the bytes PERF.md's
  bound column counts (402,653,184 B for gf_apply [4,8]×[8, 32 Mi];
  335,544,320 B for xor_apply [16,64]×[64, 4 Mi]).
- The ``jit`` counters it feeds make the JAX package's and the port's
  ``recompile_storm_check`` fire on the same counts in the same window,
  for the same call sequence (JAX's ``traced_jit`` on JAX-CPU, the
  port's wrappers on CPU tensors), and ``jit dump`` keeps the JAX
  package's record fields.
- The card's branch (CUDA-event pairs, the synchronised first launch,
  the bounded backlog, graph capture) runs here with stand-in events on
  a ``cuda`` device object: no kernel launches, the booking logic does.
- The codec's spans have the JAX codec's names and attributes for the
  same calls.
- ``chip_smoke.phase_instruments`` runs at 64 KiB objects with
  ``device="cpu"``.
"""
from __future__ import annotations

import collections
import importlib.util
import os
import sys
import threading

import numpy as np
import pytest
import torch

import ceph_tpu.common.tracer as jtracer
import ceph_tpu.mgr.health as jhealth
import ceph_tpu.mgr.stats as jstats
import ceph_tpu.ops.rs_kernels as JK
from ceph_tpu.common import Context as JContext
from ceph_tpu.ops.codec import RSCodec as JCodec
from ceph_tpu_torch.common import Context, roofline, tracer
from ceph_tpu_torch.mgr import health, stats
from ceph_tpu_torch.ops import crush_kernels as CK
from ceph_tpu_torch.ops import launch_ledger as LL
from ceph_tpu_torch.ops import rs_kernels as K
from ceph_tpu_torch.ops.codec import RSCodec
from ceph_tpu_torch.tools import path_shapes as PS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def u8(rng, shape) -> torch.Tensor:
    return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))


@pytest.fixture
def fresh():
    LL.reset()
    roofline.reset()
    tracer.jit_reset()
    yield
    LL.reset()
    roofline.reset()


# -- bytes and keys -----------------------------------------------------------

@pytest.mark.parametrize("fn,args,nbytes,bound_ms", [
    (K.apply_bytes, (4, 8, 1, 32 << 20), 402_653_184, 0.1202),
    (K.apply_bytes, (4, 8, 64, 128 << 10), 100_663_296, 0.0300),
    (K.xor_bytes, (16, 64, 4 << 20), 335_544_320, 0.1002),
    (K.crc_bytes, (12, 512 << 10), 6_291_504, 0.00188),
])
def test_launch_bytes_are_the_bound_bytes(fn, args, nbytes, bound_ms):
    assert fn(*args) == nbytes
    assert nbytes / 3.35e12 * 1e3 == pytest.approx(bound_ms, rel=2e-3)


def test_plain_sequence_books_launch_keys(fresh):
    rng = np.random.default_rng(0)
    mat, W = u8(rng, (4, 8)), u8(rng, (16, 64)) & 1
    calls = [
        (lambda: K.gf_apply(mat, u8(rng, (8, 1024))),
         PS.launch_key("gf_apply", 8, 1024, (4, 8)), K.apply_bytes(4, 8, 1,
                                                                  1024)),
        (lambda: K.gf_apply_stripes(mat, u8(rng, (24, 256)), 3),
         LL.launch_key("gf_apply_stripes", 24, 256, (4, 8)),
         K.apply_bytes(4, 8, 3, 256)),
        (lambda: K.xor_apply(W, u8(rng, (64, 512))),
         LL.launch_key("xor_apply", 64, 512, (16, 64)),
         K.xor_bytes(16, 64, 512)),
        (lambda: K.crc32c_rows(u8(rng, (12, 4096))),
         PS.launch_key("crc32c_rows", 12, 4096), K.crc_bytes(12, 4096)),
    ]
    for run, _key, _b in calls:
        run()
        run()
    counts = LL.counts("cpu")
    assert counts == collections.Counter({key: 2 for _r, key, _b in calls})
    assert LL.counts("cuda") == collections.Counter()
    rows = {(r["kernel"], tuple(r["mat"]), r["rows"], r["cols"]): r
            for r in LL.snapshot()["keys"]}
    for _run, key, nbytes in calls:
        assert rows[key]["bytes_per_call"] == nbytes
        assert rows[key]["route"] == "cpu" and rows[key]["booked"]
    rep = roofline.report(limit=10)
    assert {r["executable"] for r in rep["executables"]} == {
        "gf_apply[4x8:uint8,8x1024:uint8,cpu]",
        "gf_apply_stripes[4x8:uint8,24x256:uint8,cpu]",
        "xor_apply[16x64:uint8,64x512:uint8,cpu]",
        "crc32c_rows[12x4096:uint8,cpu]"}
    for r in rep["executables"]:
        assert r["calls"] == 2 and r["synced_calls"] == 1
        assert r["modeled_source"] == "launch_ledger" and r["flops"] == 0


def test_fused_encode_books_both_crc_launches(fresh):
    rng = np.random.default_rng(1)
    parity, crcs = K.gf_encode_with_crc(u8(rng, (4, 8)), u8(rng, (8, 300)))
    assert crcs.shape == (12,)
    assert LL.counts("cpu") == collections.Counter({
        LL.launch_key("gf_apply", 8, 300, (4, 8)): 1,
        LL.launch_key("crc32c_rows", 8, 300): 1,
        LL.launch_key("crc32c_rows", 4, 300): 1})


def test_straw2_books_its_label_and_bytes(fresh):
    from ceph_tpu_torch.crush import (CRUSH_BUCKET_STRAW2, CrushMap)
    from ceph_tpu_torch.crush.torch_mapper import BulkMapper
    cm = CrushMap()
    cm.set_type_name(1, "host")
    cm.set_type_name(2, "root")
    hosts = [cm.add_bucket(CRUSH_BUCKET_STRAW2, 1,
                           list(range(3 * h, 3 * h + 3)), [0x10000] * 3)
             for h in range(4)]
    root = cm.add_bucket(CRUSH_BUCKET_STRAW2, 2, hosts, [0x30000] * 4)
    cm.set_item_name(root, "default")
    rule = cm.add_simple_rule("r", "default", "host")
    cm.finalize()
    bm = BulkMapper(cm, device="cpu")
    bm.map_rule(rule, np.arange(64), result_max=3)
    [(key, n)] = LL.counts("cpu").items()
    tables = bm.tables(None, "cpu")
    rw = torch.full((cm.max_devices,), 0x10000, dtype=torch.int64)
    assert key == LL.launch_key(
        "crush.bulk.firstn", 64, 3,
        (*tables.ws.shape, tables.row_of_id.numel(), rw.numel())) and n == 1
    assert LL.snapshot()["keys"][0]["bytes_per_call"] == \
        CK.straw2_bytes(64, 3, tables, rw)


def test_recorded_launches_reads_the_ledger(fresh):
    """path_shapes.recorded_launches is the ledger's window over gf_apply
    and crc32c_rows, from every thread."""
    rng = np.random.default_rng(2)
    mat, data = u8(rng, (4, 8)), u8(rng, (8, 512))

    def work():
        K.gf_apply(mat, data)
        K.crc32c_rows(data)
        K.xor_apply(u8(rng, (2, 8)) & 1, data)

    with PS.recorded_launches(K) as seen:
        threads = [threading.Thread(target=work) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert seen == collections.Counter({
        PS.launch_key("gf_apply", 8, 512, (4, 8)): 3,
        PS.launch_key("crc32c_rows", 8, 512): 3})
    with LL.recording(route="cuda") as none:
        work()
    assert none == collections.Counter()


def test_paused_counts_but_books_nothing(fresh):
    rng = np.random.default_rng(3)
    with LL.paused():
        K.gf_apply(u8(rng, (4, 8)), u8(rng, (8, 64)))
    assert sum(LL.counts("cpu").values()) == 1
    assert roofline.snapshot()["executables"] == {}
    assert tracer.jit_dump()["num_keys"] == 0


def test_a_failed_launch_books_nothing(fresh):
    key = LL.launch_key("gf_apply", 8, 64, (4, 8))
    with pytest.raises(RuntimeError):
        with LL.launch("gf_apply", key, 100, CPU):
            raise RuntimeError("launch failed")
    assert LL.counts() == collections.Counter()
    with LL.launch("gf_apply", key, 100, CPU):
        pass
    assert tracer.jit_dump()["functions"][0]["compiles"] == 1


def test_launch_counters_keep_totals_across_resets():
    before = K.total_launches()
    K.reset_launches()
    assert K.total_launches() == before
    assert CK.total_launches()["crush_straw2"] >= 0


# -- the card's branch, with stand-in events ----------------------------------

class FakeEvent:
    """A CUDA event stand-in on a fake device clock."""
    clock = [0.0]
    done = [True]
    syncs = [0]

    def __init__(self, enable_timing=True):
        self.t = None

    def record(self, stream=None):
        FakeEvent.clock[0] += 0.5
        self.t = FakeEvent.clock[0]

    def synchronize(self):
        FakeEvent.syncs[0] += 1

    def query(self):
        return FakeEvent.done[0]

    def elapsed_time(self, other):
        return other.t - self.t


@pytest.fixture
def fake_card(monkeypatch, fresh):
    FakeEvent.clock[0], FakeEvent.done[0], FakeEvent.syncs[0] = 0.0, True, 0
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: "s")
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    monkeypatch.setattr(LL, "_free_events", {})
    yield capturing


def test_card_first_launch_is_synced_later_ones_resolve_lazily(fake_card):
    dev = torch.device("cuda", 0)
    key = LL.launch_key("gf_apply", 8, 524288, (4, 8))
    nbytes = K.apply_bytes(4, 8, 1, 524288)
    for _ in range(4):
        with LL.launch("gf_apply", key, nbytes, dev, "gf_apply"):
            FakeEvent.clock[0] += 1.0            # the kernel's ms
    assert FakeEvent.syncs[0] == 1               # the first launch only
    snap = LL.snapshot()                         # resolves the 3 pending
    assert snap["pending"] == 0 and snap["dropped"] == 0
    assert snap["keys"][0]["launches"] == 4
    jit = tracer.jit_dump()
    assert [(e["compiles"], e["calls"]) for e in jit["functions"]] == \
        [(1, 4)]
    row = roofline.snapshot()["executables"][
        "gf_apply[4x8:uint8,8x524288:uint8]"]
    assert row["calls"] == 4 and row["estimator"] == "cuda_event"
    assert row["seconds"] == pytest.approx(4 * 1.5e-3)
    assert row["bytes"] == 4 * nbytes and row["route"] == "cuda"


def test_card_backlog_is_bounded_without_a_sync(fake_card, monkeypatch):
    monkeypatch.setattr(LL, "EVENT_BACKLOG", 4)
    dev = torch.device("cuda", 0)
    key = LL.launch_key("crc32c_rows", 12, 4096)
    with LL.launch("crc32c_rows", key, 10, dev):
        pass
    FakeEvent.done[0] = False                    # the card falls behind
    for _ in range(10):
        with LL.launch("crc32c_rows", key, 10, dev):
            pass
    snap = LL.snapshot()
    assert FakeEvent.syncs[0] == 1
    assert snap["pending"] <= 4 and snap["dropped"] == 7
    assert snap["keys"][0]["launches"] == 11
    FakeEvent.done[0] = True
    assert LL.resolve() == 3 and LL.snapshot()["pending"] == 0


def test_card_event_pairs_stay_on_their_card(fake_card, monkeypatch):
    """A CUDA event records only on streams of the card it first recorded
    on (PyTorch raises "Event device ... does not match"): a mesh that
    launches on cuda:0, then cuda:1, gets a pair of cuda:1's own, and
    every pair returns to its card's pool."""
    class CardEvent(FakeEvent):
        def record(self, stream=None):
            card = getattr(self, "card", stream[1])
            if card != stream[1]:
                raise RuntimeError(f"Event device {card} does not match "
                                   f"recording stream's device {stream[1]}")
            self.card = card
            super().record(stream)
    monkeypatch.setattr(torch.cuda, "Event", CardEvent)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: ("s", d.index))
    key = LL.launch_key("gf_apply", 8, 64, (4, 8))
    for index in (0, 0, 1, 1, 0, 1):
        with LL.launch("gf_apply", key, 10, torch.device("cuda", index)):
            pass
    assert LL.resolve() == 5 and LL.snapshot()["keys"][0]["launches"] == 6
    assert {i: {e.card for pair in pool for e in pair}
            for i, pool in LL._free_events.items()} == {0: {0}, 1: {1}}


def test_card_launch_under_graph_capture_records_nothing(fake_card):
    fake_card[0] = True
    dev = torch.device("cuda", 0)
    key = LL.launch_key("crc32c_rows", 12, 8)
    with LL.recording(route="cuda") as seen:
        for _ in range(3):
            with LL.launch("crc32c_rows", key, 10, dev):
                pass
    assert seen[key] == 3 and FakeEvent.clock[0] == 0.0
    assert FakeEvent.syncs[0] == 0 and LL.snapshot()["pending"] == 0
    assert tracer.jit_dump()["num_keys"] == 0


def test_compile_time_is_the_library_load_once(fake_card, monkeypatch):
    from ceph_tpu_torch.ops import cuda_build
    monkeypatch.setitem(cuda_build.build_info, "gf_apply",
                        {"seconds": 3.0, "load_s": 3.25, "loaded_at": 0.0})
    dev = torch.device("cuda", 0)
    for cols in (64, 128):
        with LL.launch("gf_apply", LL.launch_key("gf_apply", 8, cols,
                                                 (4, 8)), 1, dev,
                       "gf_apply"):
            pass
    got = sorted(e["compile_s"] for e in tracer.jit_dump()["functions"])
    assert got == [0.0, 3.25]
    names = [e["name"] for e in tracer.default_tracer().dump()[
        "traceEvents"] if e.get("name", "").startswith("jit.")]
    assert "jit.compile" in names and "jit.first_dispatch" in names


# -- the jit counters and RECOMPILE_STORM against the JAX package --------------

def _storm(health_mod, stats_mod, ctx, run) -> tuple:
    agg = stats_mod.StatsAggregator(cct=ctx, name="storm")
    try:
        agg.sample(now=0.0)
        run()
        agg.sample(now=30.0)
        res = health_mod.recompile_storm_check(ctx, agg)()
    finally:
        agg.close()
    return None if res is None else (res.count, res.summary)


@pytest.mark.parametrize("n_keys", [7, 8, 12])
def test_recompile_storm_fires_on_the_same_counts(n_keys):
    """The same call sequence (n_keys shapes never seen in the process,
    each called twice) makes both packages' RECOMPILE_STORM agree: the
    JAX package compiles through traced_jit, the port books first
    launches of plain versions."""
    rng = np.random.default_rng(n_keys)
    mat = rng.integers(0, 256, (3, 5), dtype=np.uint8)
    widths = [7919 + 131 * n_keys + 17 * i for i in range(n_keys)]
    datas = [rng.integers(0, 256, (5, w), dtype=np.uint8) for w in widths]

    def jax_run():
        for d in datas:
            for _ in range(2):
                np.asarray(JK.gf_apply(mat, d))

    def port_run():
        for d in datas:
            for _ in range(2):
                K.gf_apply(torch.from_numpy(mat), torch.from_numpy(d))

    want = _storm(jhealth, jstats, JContext(), jax_run)
    got = _storm(health, stats, Context(), port_run)
    assert got == want
    assert (got is not None) == (n_keys >= 8)


def test_jit_dump_keeps_the_jax_record_fields(fresh):
    K.gf_apply(torch.zeros((2, 2), dtype=torch.uint8),
               torch.zeros((2, 16), dtype=torch.uint8))
    jtracer.record_compilation("probe", ("k",), 0.0, 0.0, 0.0)
    port = tracer.jit_dump()
    ref = jtracer.jit_dump()
    assert set(port) == set(ref)
    assert set(port["functions"][0]) == set(ref["functions"][0])
    assert set(port["counters"]) == set(ref["counters"])
    assert port["functions"][0]["key"] == repr(
        LL.launch_key("gf_apply", 2, 16, (2, 2)))


def test_admin_jit_dump_and_flight_source(fresh, tmp_path):
    from ceph_tpu_torch.common.flight_recorder import FlightRecorder
    cct = Context()
    K.crc32c_rows(torch.zeros((3, 64), dtype=torch.uint8))
    assert cct.admin_socket.call("jit dump")["num_keys"] == 1
    fr = FlightRecorder(cct=cct, out_dir=tmp_path)
    try:
        bundle = fr.dump(reason="t", force=True)
    finally:
        fr.close()
    assert bundle["jit"]["num_keys"] == 1
    assert cct.admin_socket.call("jit reset")["success"]
    top = cct.admin_socket.call("device top")
    assert any(e["function"] == "crc32c_rows" for e in top["executables"])


# -- codec spans ------------------------------------------------------------------

def _spans(tracer_mod, run) -> list:
    tr = tracer_mod.default_tracer()
    tr.reset()
    run()
    return [(e["name"], {k: v for k, v in e.get("args", {}).items()
                         if k not in ("trace_id", "span_id",
                                      "parent_span_id", "op_class")})
            for e in tr.dump()["traceEvents"]
            if e.get("ph") == "X" and e["name"].startswith("codec.")]


def _codec_calls(codec):
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, (4, 512), dtype=np.uint8)
    parity = codec.encode(data)
    codec.encode_with_crc(data)
    chunks = {i: data[i] for i in range(1, 4)} | {4: parity[0]}
    codec.decode(chunks, [0])
    codec.decode(chunks, [0])
    codec.decode_batch(np.stack([np.stack([chunks[i] for i in (1, 2, 3, 4)])
                                 ] * 2), [1, 2, 3, 4], [0])
    codec.encode_host(data)
    codec.decode_host(np.stack([chunks[i] for i in (1, 2, 3, 4)]), [0],
                      [1, 2, 3, 4])


@pytest.mark.parametrize("jdev,pdev", [("numpy", "numpy"), ("jax", "cpu")])
def test_codec_spans_match_the_jax_codec(jdev, pdev):
    want = _spans(jtracer, lambda: _codec_calls(JCodec(4, 2, device=jdev)))
    got = _spans(tracer, lambda: _codec_calls(RSCodec(4, 2, device=pdev)))
    names = [n for n, _a in got]
    assert names == [n for n, _a in want]
    assert {"codec.encode", "codec.encode_with_crc", "codec.decode",
            "codec.decode_batch", "codec.decode_matrix_build"} <= set(names)
    if jdev == "numpy":
        assert got == want
    else:
        assert "codec.table_upload" in names
        for (gn, ga), (wn, wa) in zip(got, want):
            assert set(ga) == set(wa), gn
            assert {k: v for k, v in ga.items() if k != "device"} == \
                {k: v for k, v in wa.items() if k != "device"}, gn


def test_codec_marks_device_time(fresh):
    from ceph_tpu_torch.common import device_attribution
    before = device_attribution.snapshot()["classes"].get(
        "client", {}).get("batches", 0)
    codec = RSCodec(4, 2, device="cpu")
    codec.encode(np.ones((4, 256), np.uint8))
    after = device_attribution.snapshot()["classes"]["client"]["batches"]
    assert after == before + 1


# -- phase instruments at a small size -------------------------------------------

def test_phase_instruments_runs_on_the_cpu():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_t", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    sys.path.insert(0, ROOT)
    spec.loader.exec_module(cs)
    from ceph_tpu_torch.backend import ecutil
    from ceph_tpu_torch.plugins.registry import ErasureCodePluginRegistry
    out = cs.phase_instruments(K, ecutil, ErasureCodePluginRegistry,
                               objects=4, obj_bytes=64 << 10, window=2,
                               device="cpu", profiler=cs.FakeProfiler())
    assert out["cluster"]["captures"] == 2
    assert out["cluster"]["put_profiled"]["kernels"] == {
        "gf_apply": 0, "crc32c_rows": 0}
    assert out["scrape"]["gf_apply_efficiency_rows"] > 0
    assert "RECOMPILE_STORM" not in out["health"]["checks"]
    assert out["health"]["autoscaler"][0]["pool_name"] == "rbd"
    assert out["cli"]["health"].startswith("health: HEALTH_")
    assert set(out["cli"]["verbs"]) == {"osd tree", "pg dump",
                                        "device roofline"}
