"""The serving path's stages and threads, timed inside the port.

- ``CodecPipeline.complete`` splits into ``pipeline.wait`` (the wait on
  the batch's events) and ``pipeline.unpack`` (the host split-back),
  with the ``wait_time``, ``unpack_time`` and ``device_time`` counters;
- each batch's device seconds come from the pipeline's own timing
  events (a cpu codec: its run on the host) and are what
  ``device_attribution`` books;
- the engine's coalescer and finisher threads emit ``serving.gather``
  and ``finisher.run``, with ``gather_wait_time`` and
  ``finisher_busy_time``;
- the tracer names its threads and ties its clock to ``time.time_ns()``,
  and a profiler capture takes the program's spans onto its timeline.

No JAX here: the tests marked ``card`` run on the card's machine, which
has no JAX, without the suite's ``conftest.py`` (it imports JAX):

    python -m pytest --noconftest tests/test_torch_stage_timing.py -m card
"""
from __future__ import annotations

import json
import statistics
import threading
import time

import numpy as np
import pytest
import torch

from ceph_tpu_torch.backend import ecutil
from ceph_tpu_torch.common import Context, critpath, device_attribution
from ceph_tpu_torch.common import instruments
from ceph_tpu_torch.common import profiler_capture as pcm
from ceph_tpu_torch.common.tracer import Tracer, default_tracer
from ceph_tpu_torch.exec.engine import ServingEngine
from ceph_tpu_torch.ops import pipeline as pipeline_mod
from ceph_tpu_torch.ops.codec import RSCodec
from ceph_tpu_torch.ops.pipeline import CodecPipeline
from ceph_tpu_torch.plugins.registry import ErasureCodePluginRegistry
from ceph_tpu_torch.tools import ceph_lint

K, M, CHUNK = 4, 2, 1024
NEW_SPANS = ("pipeline.wait", "pipeline.unpack", "serving.gather",
             "finisher.run")


def _ec(device="cpu", k=K, m=M):
    return ErasureCodePluginRegistry().factory(
        "torch_rs", "", {"k": str(k), "m": str(m),
                         "technique": "reed_sol_van", "device": device})


def _payloads(sinfo, n, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, sinfo.stripe_width * 2, dtype=np.uint8)
            for _ in range(n)]


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.fixture
def tracer():
    """The default tracer, emptied, with the instruments on."""
    tr = default_tracer()
    prior = instruments.enabled()
    instruments.set_enabled(True)
    tr.reset()
    yield tr
    instruments.set_enabled(prior)


def _spans(tr, name):
    return [e for e in tr.dump(stitched=False)["traceEvents"]
            if e.get("ph") == "X" and e["name"] == name]


def _encode_batches(pl, n, sinfo=None):
    sinfo = sinfo or ecutil.StripeInfo(K, CHUNK)
    ec = _ec()
    futs = [ecutil.encode_many_pipelined(sinfo, ec, _payloads(sinfo, 3, i),
                                         pl, owner="recovery")
            for i in range(n)]
    pl.flush()
    return [f.result(30) for f in futs]


# -- the completion's two stages ---------------------------------------------

def test_wait_and_unpack_nest_in_complete(tracer):
    pl = CodecPipeline(depth=2, name="t.stage.nest")
    try:
        _encode_batches(pl, 4)
    finally:
        pl.close()
    completes = _spans(tracer, "pipeline.complete")
    waits = _spans(tracer, "pipeline.wait")
    unpacks = _spans(tracer, "pipeline.unpack")
    assert len(completes) == len(waits) == len(unpacks) == 4
    for c in completes:
        inside = [e for e in waits + unpacks if e["tid"] == c["tid"]
                  and c["ts"] <= e["ts"]
                  and e["ts"] + e["dur"] <= c["ts"] + c["dur"]]
        assert sorted(e["name"] for e in inside) == \
            ["pipeline.unpack", "pipeline.wait"]
        assert sum(e["dur"] for e in inside) <= c["dur"]
        wait = next(e for e in inside if e["name"] == "pipeline.wait")
        unpack = next(e for e in inside if e["name"] == "pipeline.unpack")
        assert wait["ts"] + wait["dur"] <= unpack["ts"]
        assert wait["args"]["device_s"] > 0.0
        assert wait["args"]["owner"] == "recovery"


def test_wait_unpack_and_device_time_count_each_completion(tracer):
    pl = CodecPipeline(depth=1, name="t.stage.count")
    try:
        _encode_batches(pl, 5)
        dump = pl.perf.dump()
    finally:
        pl.close()
    for key in ("complete_time", "wait_time", "unpack_time", "device_time"):
        assert dump[key]["avgcount"] == 5, key
    assert dump["device_time"]["sum"] > 0.0
    assert dump["wait_time"]["sum"] + dump["unpack_time"]["sum"] <= \
        dump["complete_time"]["sum"]


def test_counters_and_events_run_with_the_instruments_off(tracer):
    pl = CodecPipeline(depth=1, name="t.stage.off")
    try:
        with instruments.disabled():
            _encode_batches(pl, 2)
        dump = pl.perf.dump()
    finally:
        pl.close()
    assert dump["device_time"]["avgcount"] == 2
    assert dump["device_time"]["sum"] > 0.0
    assert _spans(tracer, "pipeline.wait") == []


# -- the device seconds -------------------------------------------------------

class FakeEvent:
    """A timing event whose elapsed time to another is their stamps'
    difference, in ms."""

    def __init__(self, ms):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.ms - self.ms


def test_batch_seconds_are_the_events_elapsed_time():
    out = torch.zeros(2, 3, dtype=torch.uint8)
    one = pipeline_mod._Dispatched(out, (FakeEvent(7.5),), (),
                                   starts=(FakeEvent(5.0),))
    one.wait()
    assert one.seconds() == pytest.approx(2.5e-3)
    # a mesh batch: the longest of its cards' stream times
    mesh = pipeline_mod._Dispatched(
        out, (FakeEvent(4.0), FakeEvent(9.0)), (), finish=lambda o: o,
        starts=(FakeEvent(1.0), FakeEvent(2.0)))
    mesh.wait()
    assert mesh.seconds() == pytest.approx(7e-3)
    # a cpu run: its host seconds; a dispatch that ran nothing: none
    ran = pipeline_mod.launch(torch.device("cpu"),
                              np.ones((K, 64), np.uint8), lambda t: t ^ 1,
                              range(K), None)
    assert np.array_equal(pipeline_mod.settle(ran), np.zeros((K, 64)))
    assert ran.seconds() == ran.host_s > 0.0
    assert pipeline_mod.stream_seconds(None) == 0.0


def test_attribution_books_the_seconds_the_pipeline_hands_it():
    before = device_attribution.snapshot()
    pc = device_attribution.perf_counters().dump()
    out = np.zeros((M, 8), np.uint8)
    pl = CodecPipeline(depth=1, name="t.stage.attr")
    try:
        for owner, ms in (("scrub", 2.0), ("rebalance", 3.0),
                          ("scrub", 0.5)):
            pl.submit(None, lambda _p, ms=ms: pipeline_mod._Dispatched(
                          torch.from_numpy(out), (FakeEvent(10.0 + ms),),
                          (), starts=(FakeEvent(10.0),)),
                      None, owner=owner).result(5)
        dev = pl.perf.dump()["device_time"]
    finally:
        pl.close()
    after = device_attribution.snapshot()
    pc2 = device_attribution.perf_counters().dump()

    def gained(cls):
        return after["classes"][cls]["device_s"] - \
            before["classes"].get(cls, {}).get("device_s", 0.0)
    assert gained("scrub") == pytest.approx(2.5e-3)
    assert gained("rebalance") == pytest.approx(3e-3)
    assert dev["sum"] == pytest.approx(5.5e-3)
    assert after["busy_s"] - before["busy_s"] == pytest.approx(5.5e-3)
    # the per-class sums are the busy time, in the snapshot and counters
    assert sum(c["device_s"] for c in after["classes"].values()) == \
        pytest.approx(after["busy_s"])
    per_class = sum(pc2[f"{c}_device_time"]["sum"]
                    for c in device_attribution.OWNER_CLASSES)
    assert per_class == pytest.approx(pc2["busy_time"]["sum"])
    assert pc2["busy_time"]["sum"] - pc["busy_time"]["sum"] == \
        pytest.approx(5.5e-3)


def test_busy_time_sums_two_overlapping_pipelines():
    """Two pipelines whose batches cover one stretch of the card each
    book their own stream seconds: busy time is their sum, not their
    union (``device_attribution``'s docstring)."""
    out = torch.from_numpy(np.zeros((M, 8), np.uint8))
    before = device_attribution.snapshot()["busy_s"]
    pls = [CodecPipeline(depth=2, name=f"t.stage.two{i}") for i in (0, 1)]
    try:
        # both stretches are 10 ms to 14 ms on the same stream clock
        futs = [pl.submit(None, lambda _p: pipeline_mod._Dispatched(
                    out, (FakeEvent(14.0),), (), starts=(FakeEvent(10.0),)),
                    None, owner="serving") for pl in pls]
        for f in futs:
            f.result(5)
    finally:
        for pl in pls:
            pl.close()
    gained = device_attribution.snapshot()["busy_s"] - before
    assert gained == pytest.approx(2 * 4e-3)


def test_pipeline_holds_no_host_clock_occupancy():
    assert "_dispatched_at" not in pipeline_mod.PipelineFuture.__slots__
    src = open(pipeline_mod.__file__).read()
    assert "record_interval" not in src and "dispatched_at" not in src


def test_synchronous_codec_calls_keep_their_host_interval():
    """An RSCodec call that blocks on its copy back books its host
    interval, clamped, through ``record_interval``."""
    before = device_attribution.snapshot()["classes"].get(
        "client", {"batches": 0, "device_s": 0.0})
    RSCodec(K, M, device="cpu").encode(np.ones((K, 256), np.uint8))
    after = device_attribution.snapshot()["classes"]["client"]
    assert after["batches"] == before["batches"] + 1
    assert after["device_s"] >= before["device_s"]


# -- the engine's threads ------------------------------------------------------

def test_engine_threads_emit_gather_and_finisher_spans(tracer):
    sinfo = ecutil.StripeInfo(K, CHUNK)
    eng = ServingEngine(cct=Context(), ec_impl=_ec(), sinfo=sinfo,
                        name="t.stage.eng", batch_max_delay_ms=1.0)
    eng.start()
    try:
        futs = [eng.submit_encode(p) for p in _payloads(sinfo, 12)]
        assert all(f.result(30) for f in futs)
        eng.flush(30)
    finally:
        eng.stop()
    dump = eng.perf.dump()
    busy = eng.finisher.perf.dump()["finisher_busy_time"]
    events = tracer.dump(stitched=False)["traceEvents"]
    names = {e["tid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M" and e["name"] == "thread_name"}
    gathers = [e for e in events if e.get("name") == "serving.gather"]
    runs = [e for e in events if e.get("name") == "finisher.run"]
    assert gathers and runs
    assert {names[e["tid"]] for e in gathers} == {"coalescer-t.stage.eng"}
    assert {names[e["tid"]] for e in runs} == {"finisher-t.stage.eng"}
    assert dump["gather_wait_time"]["avgcount"] >= dump["batches"] > 0
    assert busy["avgcount"] == len(runs)
    assert busy["sum"] == pytest.approx(
        sum(e["dur"] for e in runs) * 1e-6, rel=0.05, abs=1e-3)


def test_new_spans_have_phases_and_the_span_phase_lint_passes():
    for name in NEW_SPANS:
        assert critpath.is_declared(name), name
    assert critpath.phase_for("pipeline.wait") == \
        critpath.phase_for("pipeline.unpack") == \
        critpath.phase_for("pipeline.complete")
    assert ceph_lint.main(["--rules", "span-phase"]) == 0


# -- the tracer's clock and threads --------------------------------------------

def test_tracer_names_its_threads_and_ties_its_clock():
    tr = Tracer()
    prior = instruments.enabled()
    instruments.set_enabled(True)
    try:
        wall = time.time_ns()
        with tr.span("main.work"):
            pass

        def work():
            with tr.span("worker.work"):
                pass
        t = threading.Thread(target=work, name="stage-worker")
        t.start()
        t.join(10)
        assert not t.is_alive()
        dump = tr.dump()
    finally:
        instruments.set_enabled(prior)
    meta = {(e["pid"], e["tid"]): e["args"]["name"]
            for e in dump["traceEvents"]
            if e.get("ph") == "M" and e["name"] == "thread_name"}
    spans = {e["name"]: e for e in dump["traceEvents"] if e.get("ph") == "X"}
    assert meta[(spans["worker.work"]["pid"], spans["worker.work"]["tid"])] \
        == "stage-worker"
    assert meta[(spans["main.work"]["pid"], spans["main.work"]["tid"])] \
        == threading.current_thread().name
    assert len(meta) == 2
    sync = dump["clock_sync"]
    assert set(sync) == {"ts_us", "wall_ns"}
    start_ns = sync["wall_ns"] + (spans["main.work"]["ts"] - sync["ts_us"]) \
        * 1e3
    # the arithmetic of the mapping; its precision is the card test's
    assert -1e5 <= start_ns - wall < 20e6
    assert set(tr.threads().values()) >= {
        ("stage-worker", t.native_id)}


class WritingProfiler:
    """A fake backend whose stop writes a trace with a base time."""

    BASE_NS = 1_700_000_000_000_000_000

    def start_trace(self, path):
        self.path = path

    def stop_trace(self):
        events = [{"ph": "X", "cat": "kernel", "name": "k", "pid": 0,
                   "tid": 7, "ts": 1.0, "dur": 2.0}]
        with open(f"{self.path}/{pcm.TRACE_FILE}", "w") as f:
            json.dump({"traceEvents": events,
                       "baseTimeNanoseconds": self.BASE_NS}, f)


def test_capture_stop_merges_the_programs_spans(tmp_path, tracer):
    pc = pcm.ProfilerCapture(cct=Context(), out_dir=tmp_path,
                             profiler=WritingProfiler())
    with tracer.span("before.window"):
        pass
    time.sleep(0.02)
    assert "error" not in pc.start("merge")
    wall = time.time_ns()
    with tracer.span("main.inside"):
        pass

    def work():
        with tracer.span("worker.inside"):
            pass
    t = threading.Thread(target=work, name="merge-worker")
    t.start()
    t.join(10)
    assert not t.is_alive()
    res = pc.stop()
    assert res["program_spans"] == 2
    trace = json.loads((tmp_path / res["path"] / pcm.TRACE_FILE)
                       .read_text())
    events = trace["traceEvents"]
    assert events[0]["name"] == "k"
    merged = {e["name"]: e for e in events if e.get("cat") == "span"}
    assert set(merged) == {"main.inside", "worker.inside"}
    rows = {e["tid"]: e["args"]["name"] for e in events
            if e.get("ph") == "M" and e["name"] == "thread_name"}
    assert rows[merged["worker.inside"]["tid"]] == "merge-worker"
    assert merged["worker.inside"]["tid"] == t.native_id
    assert merged["main.inside"]["tid"] == threading.get_native_id()
    start_ns = merged["main.inside"]["ts"] * 1e3 + WritingProfiler.BASE_NS
    assert -1e5 <= start_ns - wall < 20e6


# -- on the card -----------------------------------------------------------------

def _device_events(prof):
    """(name, start_ns, end_ns) of the copies and kernels the profiler
    saw on the card after the window's primer."""
    out, primer_end = [], 0
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s = int(e.start_ns())
        if name == pcm.PRIMER_SPAN and \
                not str(e.device_type()).endswith("CUDA"):
            primer_end = max(primer_end, s + int(e.duration_ns()))
        if not str(e.device_type()).endswith("CUDA") or \
                e.is_user_annotation() or "Sync" in name or "Wait" in name:
            continue
        out.append((name, s, s + int(e.duration_ns())))
    return [ev for ev in out if ev[1] >= primer_end]


@pytest.mark.card
def test_device_seconds_match_the_profiler_at_the_write_cells_batch(card):
    """16 ops x 4 MiB, RS(8,4): a batch's ``device_s`` is its H2D copy,
    kernel and D2H copy as the profiler times them, within 5%."""
    from torch.profiler import ProfilerActivity, profile
    codec = RSCodec(8, 4, device=card)
    pl = CodecPipeline(depth=1, name="t.stage.card")
    # the encode's block: the data in rows [0, 8), the parity lands in
    # rows [8, 12)
    block = pl.host_block(codec.torch_device, (12, 16 * (4 << 20) // 8))
    block[:] = np.random.default_rng(5).integers(0, 256, block.shape,
                                                 dtype=np.uint8)

    def one():
        return pl.submit(lambda: block,
                         lambda b: pl.dispatch_encode(codec, b, 4096),
                         None).result(60)
    try:
        for _ in range(3):
            one()
        torch.cuda.synchronize()
        readings = []
        for _ in range(3):
            before = pl.perf.dump()["device_time"]["sum"]
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                # the profiler can drop the first device records of a window
                pcm.TorchProfiler().prime()
                one()
                torch.cuda.synchronize()
            device_s = pl.perf.dump()["device_time"]["sum"] - before
            ops = _device_events(prof)
            work = sum(e - s for _n, s, e in ops) / 1e9
            readings.append((device_s, work, [n for n, _s, _e in ops]))
    finally:
        pl.close()
    print(readings)
    for device_s, work, names in readings:
        assert any(n.startswith("Memcpy HtoD") for n in names), names
        assert any(n.startswith("Memcpy DtoH") for n in names), names
        assert abs(device_s - work) <= 0.05 * work, (device_s, work)


@pytest.mark.card
def test_span_and_record_function_land_together_after_the_mapping(
        card, tmp_path):
    """A span and a ``record_function`` range opened back to back start
    within 50 us of each other once the capture merge maps the span."""
    from torch.profiler import ProfilerActivity, profile, record_function
    tr = Tracer()
    prior = instruments.enabled()
    instruments.set_enabled(True)
    torch.ones(1, device=card).add_(1)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time_ns()
            for i in range(8):
                with record_function(f"warm.{i}"):
                    pass
            for i in range(5):
                with tr.span(f"probe.{i}"), record_function(f"rf.{i}"):
                    time.sleep(0.001)
            t1 = time.time_ns()
        path = tmp_path / "trace.json"
        prof.export_chrome_trace(str(path))
        assert pcm.merge_program_spans(path, t0, t1, tracer=tr) == 5
    finally:
        instruments.set_enabled(prior)
    events = json.loads(path.read_text())["traceEvents"]
    ts = {e["name"]: float(e["ts"]) for e in events if e.get("ph") == "X"}
    gaps = [abs(ts[f"rf.{i}"] - ts[f"probe.{i}"]) for i in range(5)]
    print("gaps us", gaps)
    assert statistics.median(gaps) < 50.0, gaps
