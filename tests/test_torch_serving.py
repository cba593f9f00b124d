"""The port's serving path against the JAX package's.

Two halves:

- **Differential**: the same payloads, made with numpy from a seed, go
  through ``ceph_tpu.exec.ServingEngine`` over ``jax_rs`` on JAX-CPU and
  through ``ceph_tpu_torch.exec.ServingEngine`` over ``torch_rs`` with
  ``device=cpu``, at pipeline depth 0, 1 and 4; encoded chunks and
  decoded bytes must be bitwise equal.
- **Copied modules**: the throttle, finisher, coalescing, deadline,
  backpressure, QoS and future scenarios of ``tests/test_serving.py``
  and the dmClock scenarios of ``tests/test_mclock.py``, each one
  parametrised test with a case per package, so the port's copies cannot
  drift from the originals.  Both packages run their ``numpy`` route
  here, as the originals do.
"""
import importlib
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from ceph_tpu.exec import ServingEngine as JaxEngine
from ceph_tpu.plugins import ErasureCodePluginRegistry as JaxRegistry
from ceph_tpu_torch.backend import ecutil
from ceph_tpu_torch.exec import ServingEngine
from ceph_tpu_torch.exec import workload
from ceph_tpu_torch.plugins.registry import ErasureCodePluginRegistry

PACKAGES = ["ceph_tpu", "ceph_tpu_torch"]
CHUNK = 256
STRIPE = 4 * CHUNK


def _load(name: str) -> SimpleNamespace:
    ex = importlib.import_module(f"{name}.exec")
    be = importlib.import_module(f"{name}.backend.ecutil")
    reg = importlib.import_module(f"{name}.plugins.registry")
    mclock = importlib.import_module(f"{name}.osd.mclock")
    plugin = "jax_rs" if name == "ceph_tpu" else "torch_rs"
    profile = {"plugin": plugin, "k": "4", "m": "2", "device": "numpy",
               "technique": "reed_sol_van"}

    def codec(**over):
        ec = reg.ErasureCodePluginRegistry.instance().factory(
            plugin, "", {**profile, **over})
        return ec, be.StripeInfo(int(over.get("k", 4)), CHUNK)
    return SimpleNamespace(name=name, ex=ex, ecutil=be, mclock=mclock,
                           codec=codec)


@pytest.fixture(params=PACKAGES)
def pkg(request):
    return _load(request.param)


def payload(n, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, size=n, dtype=np.uint8).tobytes()


def counting(ec):
    calls = {"n": 0}
    orig = ec.encode_chunks

    def wrapped(want, chunks):
        calls["n"] += 1
        return orig(want, chunks)
    ec.encode_chunks = wrapped
    return calls


# -- differential: the JAX engine against the port's --------------------------

def _engines(k, m, depth, tag):
    prof = {"k": str(k), "m": str(m), "technique": "reed_sol_van"}
    jec = JaxRegistry().factory("jax_rs", "", prof | {"device": "jax"})
    ec = ErasureCodePluginRegistry().factory("torch_rs", "",
                                             prof | {"device": "cpu"})
    from ceph_tpu.backend import ecutil as jecutil
    chunk = 1024 if k == 4 else 4096
    jeng = JaxEngine(ec_impl=jec, sinfo=jecutil.StripeInfo(k, chunk),
                     name=f"jax.{tag}", pipeline_depth=depth)
    eng = ServingEngine(ec_impl=ec, sinfo=ecutil.StripeInfo(k, chunk),
                        name=f"port.{tag}", pipeline_depth=depth)
    return jeng, eng, k * chunk


@pytest.mark.parametrize("depth", [0, 1, 4])
@pytest.mark.parametrize("k,m", [(4, 2), (8, 4)])
def test_engine_bitwise_equal_to_jax_engine(k, m, depth):
    jeng, eng, width = _engines(k, m, depth, f"{k}{m}{depth}")
    rng = np.random.default_rng(100 * k + depth)
    # ragged ops: whole stripes, and one with an unaligned tail
    sizes = [width, 3 * width, 2 * width + 100, width, 4 * width]
    bufs = [rng.integers(0, 256, n, dtype=np.uint8) for n in sizes]
    try:
        got, want = [], []
        for engine, out in ((eng, got), (jeng, want)):
            futs = [engine.submit_encode(b) for b in bufs]
            engine.flush()
            out.extend(f.result(30) for f in futs)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for c in g:
                assert np.array_equal(np.asarray(g[c]), np.asarray(w[c]))
        # degraded reads: a data and a parity chunk lost, then two data
        # chunks lost, from the port's own shards
        for lost in ((0, k + 1), (1, 2)):
            reads = [{c: v for c, v in e.items() if c not in lost}
                     for e in got]
            outs = []
            for engine in (eng, jeng):
                futs = [engine.submit_decode(r) for r in reads]
                engine.flush()
                outs.append([f.result(30) for f in futs])
            padded = [b.tobytes() + b"\0" * (-len(b) % width) for b in bufs]
            assert outs[0] == outs[1] == padded
        # every depth, 0 included, dispatches through the pipeline
        assert eng.pipeline.perf.get("submitted") >= 3
        assert eng.pipeline.perf.get("errors") == 0
    finally:
        jeng.stop()
        eng.stop()


def test_closed_loop_encode_and_decode_through_the_port():
    """The serving entry point as a user drives it: a threaded engine
    under ``closed_loop`` in both directions, every result checked."""
    ec = ErasureCodePluginRegistry().factory(
        "torch_rs", "", {"k": "8", "m": "4", "device": "cpu"})
    sinfo = ecutil.StripeInfo(8, 4096)
    pays = workload.make_payloads(sinfo.stripe_width * 2, 4, seed=5)
    want = ecutil.encode_many(sinfo, ec, pays)
    eng = ServingEngine(ec_impl=ec, sinfo=sinfo, name="t.loop",
                        pipeline_depth=4).start()
    seen = []
    submit = eng.submit_encode
    index = {id(p): i for i, p in enumerate(pays)}

    def recording(buf, **kw):
        fut = submit(buf, **kw)
        seen.append((index[id(buf)], fut))
        return fut
    eng.submit_encode = recording
    try:
        enc = workload.closed_loop(eng, 16, 4, payloads=pays)
        assert enc["ops"] == 16 and enc["kind"] == "encode"
        assert enc["batches"] >= 1 and enc["p99_ms"] >= enc["p50_ms"]
        assert len(seen) == 16
        for i, fut in seen:
            for c in range(12):
                assert np.array_equal(fut.result(5)[c], want[i][c])
        reads = [{c: w[c] for c in range(1, 9)} for w in want]
        dec = workload.closed_loop(eng, 8, 4, payloads=reads,
                                   kind="decode")
        assert dec["kind"] == "decode"
        assert dec["op_bytes"] == 8 * want[0][0].nbytes
        assert eng.pipeline.perf.get("errors") == 0
        with pytest.raises(ValueError, match="kind"):
            workload.closed_loop(eng, 1, 1, payloads=pays, kind="scrub")
    finally:
        eng.stop()


def test_compare_batched_unbatched_small():
    ec = ErasureCodePluginRegistry().factory(
        "torch_rs", "", {"k": "4", "m": "2", "device": "cpu"})
    out = workload.compare_batched_unbatched(
        ec, ecutil.StripeInfo(4, 1024), n_ops=16, concurrency=8,
        warmup_ops=4)
    assert out["batched"]["ops"] == out["unbatched"]["ops"] == 16
    assert out["unbatched"]["mean_batch_size"] == 1.0
    assert out["speedup"] > 0


@pytest.mark.parametrize("depth", [0, 2])
def test_batches_reach_the_codec_unpadded(depth):
    """Three one-stripe encodes and three degraded reads go to the codec
    as batches of exactly three stripes: no size-bucket padding."""
    ec = ErasureCodePluginRegistry().factory(
        "torch_rs", "", {"k": "4", "m": "2", "device": "cpu"})
    sinfo = ecutil.StripeInfo(4, 1024)
    widths = []
    codec = ec.device_codec(1)
    for name in ("encode_device", "decode_device"):
        orig = getattr(codec, name)

        def spy(data, *args, _orig=orig):
            widths.append(data.shape[1])
            return _orig(data, *args)
        setattr(codec, name, spy)
    eng = ServingEngine(ec_impl=ec, sinfo=sinfo, name=f"t.nopad{depth}",
                        pipeline_depth=depth)
    try:
        bufs = [payload(sinfo.stripe_width, seed=i) for i in range(3)]
        futs = [eng.submit_encode(b) for b in bufs]
        eng.flush()
        encs = [f.result(1) for f in futs]
        ref = ErasureCodePluginRegistry().factory(
            "torch_rs", "", {"k": "4", "m": "2", "device": "numpy"})
        for b, got in zip(bufs, encs):
            want = ecutil.encode(sinfo, ref, b)
            assert all(np.array_equal(got[c], want[c]) for c in want)
        futs = [eng.submit_decode({c: e[c] for c in (1, 2, 3, 4)})
                for e in encs]
        eng.flush()
        assert [f.result(1) for f in futs] == bufs
        assert widths == [3 * sinfo.chunk_size] * 2
        assert eng.pipeline.perf.get("submitted") == 2
    finally:
        del codec.encode_device, codec.decode_device
        eng.stop()


# -- copied modules: throttle -------------------------------------------------

def test_throttle_get_put_counts(pkg):
    t = pkg.ex.Throttle("t", 10)
    assert t.get(4) and t.count == 4
    assert t.get(6) and t.count == 10
    t.put(10)
    assert t.count == 0


def test_throttle_get_or_fail_backpressure(pkg):
    t = pkg.ex.Throttle("t", 4)
    assert t.get_or_fail(3)
    assert not t.get_or_fail(2)
    assert t.get_or_fail(1)
    assert not t.get_or_fail(1)
    assert t.perf.get("get_or_fail_fail") == 2


def test_throttle_blocking_get_waits_for_put(pkg):
    t = pkg.ex.Throttle("t", 2)
    t.get(2)
    order = []

    def taker():
        t.get(1)
        order.append("took")
    th = threading.Thread(target=taker, daemon=True)
    th.start()
    time.sleep(0.05)
    assert order == [] and t.waiters() == 1
    t.put(1)
    th.join(2)
    assert order == ["took"]


def test_throttle_fifo_large_request_not_starved(pkg):
    t = pkg.ex.Throttle("t", 4)
    t.get(4)
    got = []

    def take(n, tag):
        t.get(n)
        got.append(tag)
    big = threading.Thread(target=take, args=(4, "big"), daemon=True)
    big.start()
    time.sleep(0.02)
    small = threading.Thread(target=take, args=(1, "small"), daemon=True)
    small.start()
    time.sleep(0.02)
    t.put(4)
    big.join(2)
    assert got == ["big"]
    t.put(4)
    small.join(2)
    assert got == ["big", "small"]


def test_throttle_get_timeout(pkg):
    t = pkg.ex.Throttle("t", 1)
    t.get(1)
    assert t.get(1, timeout=0.02) is False
    assert t.waiters() == 0


def test_throttle_oversized_singleton_admitted_when_empty(pkg):
    t = pkg.ex.Throttle("t", 4)
    assert t.get_or_fail(100)
    assert not t.get_or_fail(1)
    t.put(100)
    assert t.get_or_fail(1)


# -- copied modules: finisher -------------------------------------------------

def test_finisher_inline_drain_preserves_order(pkg):
    f = pkg.ex.Finisher("t")
    out = []
    for i in range(5):
        f.queue(out.append, i)
    assert f.drain() == 5
    assert out == list(range(5))


def test_finisher_threaded_stop_drains_everything(pkg):
    f = pkg.ex.Finisher("t").start()
    out = []
    for i in range(100):
        f.queue(out.append, i)
    f.stop()
    assert out == list(range(100))


def test_finisher_crashing_callback_does_not_kill_the_rest(pkg):
    f = pkg.ex.Finisher("t")
    out = []
    f.queue(lambda: 1 / 0)
    f.queue(out.append, "ok")
    f.drain()
    assert out == ["ok"]


# -- copied modules: coalescing (batcher + engine) ----------------------------

def test_many_ops_one_dispatch_results_exact(pkg):
    ec, sinfo = pkg.codec()
    eng = pkg.ex.ServingEngine(ec_impl=ec, sinfo=sinfo, name="t.co")
    calls = counting(ec)
    bufs = [payload(STRIPE * (1 + i % 3), seed=i) for i in range(16)]
    futs = [eng.submit_encode(b) for b in bufs]
    eng.step()
    assert calls["n"] == 1, "concurrent submissions did not coalesce"
    for b, fut in zip(bufs, futs):
        want = pkg.ecutil.encode(sinfo, ec, b)
        got = fut.result(1)
        for c in want:
            assert np.array_equal(got[c], want[c]), f"chunk {c}"


def test_batch_max_ops_splits_batches(pkg):
    ec, sinfo = pkg.codec()
    eng = pkg.ex.ServingEngine(ec_impl=ec, sinfo=sinfo, name="t.max",
                               batch_max_ops=4)
    calls = counting(ec)
    futs = [eng.submit_encode(payload(STRIPE, seed=i)) for i in range(10)]
    eng.flush()
    assert calls["n"] == 3             # 4 + 4 + 2
    assert all(f.done() for f in futs)
    assert eng.perf.get("batches") == 3


def test_decode_ops_coalesce_and_match(pkg):
    ec, sinfo = pkg.codec()
    eng = pkg.ex.ServingEngine(ec_impl=ec, sinfo=sinfo, name="t.dec")
    bufs = [payload(STRIPE * (1 + i % 2), seed=i) for i in range(8)]
    encoded = [pkg.ecutil.encode(sinfo, ec, b) for b in bufs]
    futs = [eng.submit_decode({c: e[c] for c in (0, 2, 3, 5)})
            for e in encoded]
    eng.flush()
    for b, fut in zip(bufs, futs):
        assert fut.result(1) == b


def test_mixed_codecs_do_not_fuse(pkg):
    ec1, sinfo1 = pkg.codec()
    ec2, sinfo2 = pkg.codec(k="2", m="1")
    eng = pkg.ex.ServingEngine(name="t.mix")
    c1, c2 = counting(ec1), counting(ec2)
    f1 = eng.submit_encode(payload(STRIPE), sinfo=sinfo1, ec_impl=ec1)
    f2 = eng.submit_encode(payload(2 * CHUNK, seed=1), sinfo=sinfo2,
                           ec_impl=ec2)
    eng.step()
    assert c1["n"] == 1 and c2["n"] == 1
    assert f1.result(1) is not None and f2.result(1) is not None


def test_unaligned_op_padded_to_stripe(pkg):
    ec, sinfo = pkg.codec()
    eng = pkg.ex.ServingEngine(ec_impl=ec, sinfo=sinfo, name="t.pad")
    raw = payload(STRIPE + 100, seed=3)
    fut = eng.submit_encode(raw)
    eng.flush()
    want = pkg.ecutil.encode(sinfo, ec, raw + b"\0" * (STRIPE - 100))
    got = fut.result(1)
    for c in want:
        assert np.array_equal(got[c], want[c])


def test_group_error_fails_futures_not_engine(pkg):
    ec, sinfo = pkg.codec()
    eng = pkg.ex.ServingEngine(ec_impl=ec, sinfo=sinfo, name="t.err")

    def boom(want, chunks):
        raise RuntimeError("device fell over")
    orig = ec.encode_chunks
    ec.encode_chunks = boom
    try:
        fut = eng.submit_encode(payload(STRIPE))
        eng.flush()
        with pytest.raises(RuntimeError, match="fell over"):
            fut.result(1)
    finally:
        ec.encode_chunks = orig
    assert eng.op_throttle.count == 0
    fut2 = eng.submit_encode(payload(STRIPE))
    eng.flush()
    assert fut2.result(1)


# -- copied modules: deadline -------------------------------------------------

def test_partial_batch_dispatches_at_deadline(pkg):
    ec, sinfo = pkg.codec()
    eng = pkg.ex.ServingEngine(ec_impl=ec, sinfo=sinfo, name="t.dl",
                               batch_max_ops=64,
                               batch_max_delay_ms=10.0).start()
    try:
        fut = eng.submit_encode(payload(STRIPE))
        assert fut.result(2.0) is not None
        assert fut.t_dispatch - fut.t_submit < 1.0
    finally:
        eng.stop()


def test_sync_encode_cuts_through_deadline(pkg):
    ec, sinfo = pkg.codec()
    eng = pkg.ex.ServingEngine(ec_impl=ec, sinfo=sinfo, name="t.eager",
                               batch_max_ops=64,
                               batch_max_delay_ms=500.0).start()
    try:
        t0 = time.monotonic()
        for i in range(3):
            assert eng.encode(payload(STRIPE, seed=i), timeout=5.0)
        assert time.monotonic() - t0 < 0.5
    finally:
        eng.stop()


def test_full_batch_does_not_wait_for_deadline(pkg):
    ec, sinfo = pkg.codec()
    eng = pkg.ex.ServingEngine(ec_impl=ec, sinfo=sinfo, name="t.full",
                               batch_max_ops=4,
                               batch_max_delay_ms=10_000.0).start()
    try:
        futs = [eng.submit_encode(payload(STRIPE, seed=i))
                for i in range(4)]
        for f in futs:
            f.result(5.0)
    finally:
        eng.stop()


# -- copied modules: backpressure ---------------------------------------------

def test_fail_fast_bounds_queue(pkg):
    ec, sinfo = pkg.codec()
    eng = pkg.ex.ServingEngine(ec_impl=ec, sinfo=sinfo, name="t.ff",
                               max_ops=4, fail_fast=True)
    for i in range(4):
        eng.submit_encode(payload(STRIPE, seed=i))
    with pytest.raises(pkg.ex.ThrottleFull):
        eng.submit_encode(payload(STRIPE))
    d = eng.depths()
    assert d["_total"] == 4
    assert eng.perf.get("ops_rejected") == 1
    assert eng.perf.get("queue_depth") == 4
    eng.flush()
    assert eng.submit_encode(payload(STRIPE)) is not None
    eng.flush()


def test_byte_throttle_bounds_queued_bytes(pkg):
    ec, sinfo = pkg.codec()
    eng = pkg.ex.ServingEngine(ec_impl=ec, sinfo=sinfo, name="t.bytes",
                               max_bytes=4 * STRIPE, fail_fast=True)
    eng.submit_encode(payload(3 * STRIPE))
    with pytest.raises(pkg.ex.ThrottleFull):
        eng.submit_encode(payload(2 * STRIPE))
    assert eng.depths()["_bytes"] <= 4 * STRIPE
    eng.flush()


def test_blocking_submitter_parks_until_capacity(pkg):
    ec, sinfo = pkg.codec()
    eng = pkg.ex.ServingEngine(ec_impl=ec, sinfo=sinfo, name="t.blk",
                               max_ops=2, fail_fast=False)
    eng.submit_encode(payload(STRIPE, seed=0))
    eng.submit_encode(payload(STRIPE, seed=1))
    submitted = []

    def third():
        submitted.append(eng.submit_encode(payload(STRIPE, seed=2)))
    th = threading.Thread(target=third, daemon=True)
    th.start()
    time.sleep(0.05)
    assert not submitted
    assert eng.depths()["_total"] == 2
    eng.step()
    th.join(2)
    assert submitted
    eng.flush()
    assert submitted[0].result(1)


@pytest.mark.parametrize("throttle", ["max_ops", "max_bytes"])
def test_an_engine_its_submitter_steps_flushes_to_admit(throttle):
    """``flush_to_admit``: on an engine without threads, a submission
    that would wait on a full throttle flushes what the engine holds
    first, on the submitting thread; each result is still exact."""
    pkg = _load("ceph_tpu_torch")
    ec, sinfo = pkg.codec()
    eng = ServingEngine(ec_impl=ec, sinfo=sinfo, name=f"t.fta.{throttle}",
                        flush_to_admit=True, fail_fast=False,
                        **{throttle: 2 if throttle == "max_ops"
                           else 2 * STRIPE})
    bufs = [payload(STRIPE, seed=i) for i in range(5)]
    futs = [eng.submit_encode(b) for b in bufs]
    assert eng.perf.get("batches") == 2        # 2 + 2 flushed, 1 held
    assert not futs[-1].done()
    eng.flush()
    for b, fut in zip(bufs, futs):
        want = pkg.ecutil.encode(sinfo, ec, b)
        got = fut.result(1)
        assert all(np.array_equal(got[c], want[c]) for c in want)


# -- copied modules: QoS and futures ------------------------------------------

def test_client_ops_dequeue_ahead_of_scrub(pkg):
    ec, sinfo = pkg.codec()
    eng = pkg.ex.ServingEngine(ec_impl=ec, sinfo=sinfo, name="t.qos",
                               batch_max_ops=5)
    scrub = [eng.submit_encode(payload(STRIPE, seed=i),
                               op_class=pkg.mclock.BG_SCRUB)
             for i in range(4)]
    client = [eng.submit_encode(payload(STRIPE, seed=10 + i),
                                op_class=pkg.mclock.CLIENT_OP)
              for i in range(4)]
    eng.step()
    assert all(f.done() for f in client)
    assert sum(f.done() for f in scrub) <= 1
    eng.flush()
    assert all(f.done() for f in scrub)


def test_add_done_callback_after_completion_runs_inline(pkg):
    ec, sinfo = pkg.codec()
    eng = pkg.ex.ServingEngine(ec_impl=ec, sinfo=sinfo, name="t.fut")
    fut = eng.submit_encode(payload(STRIPE))
    eng.flush()
    seen = []
    fut.add_done_callback(seen.append)
    assert seen == [fut]
    assert isinstance(fut, pkg.ex.BatchFuture)


def test_result_timeout(pkg):
    ec, sinfo = pkg.codec()
    eng = pkg.ex.ServingEngine(ec_impl=ec, sinfo=sinfo, name="t.to")
    fut = eng.submit_encode(payload(STRIPE))
    with pytest.raises(TimeoutError):
        fut.result(0.01)
    eng.flush()
    assert fut.result(1)


def test_e2e_latency_histogram_counts_ops(pkg):
    ctx_mod = importlib.import_module(f"{pkg.name}.common")
    ec, sinfo = pkg.codec()
    eng = pkg.ex.ServingEngine(cct=ctx_mod.Context(), ec_impl=ec,
                               sinfo=sinfo, name="latm")
    for i in range(5):
        eng.submit_encode(payload(STRIPE, seed=i))
    eng.flush()
    dump = eng.perf.dump()
    assert dump["op_e2e_lat"]["count"] == 5
    assert dump["queue_wait_lat"]["count"] == 5
    assert dump["e2e_time"]["avgcount"] == 5


# -- copied modules: dmClock --------------------------------------------------

def run_schedule(q, duration: float, tick: float = 0.001):
    served = {}
    now = 0.0
    while now < duration:
        item = q.dequeue(now)
        if item is None:
            nxt = q.next_eligible_time(now)
            if nxt is None or nxt >= duration:
                break
            now = max(nxt, now + tick)
            continue
        served[item[0]] = served.get(item[0], 0) + 1
    return served


def test_mclock_reservation_is_a_hard_floor(pkg):
    mc = pkg.mclock
    infos = {"A": mc.ClientInfo(reservation=100.0, weight=1.0),
             "B": mc.ClientInfo(reservation=0.0, weight=1000.0)}
    q = mc.MClockQueue(lambda c: infos[c])
    for i in range(200):
        q.enqueue("A", ("A", i), now=0.0)
        q.enqueue("B", ("B", i), now=0.0)
    served = {"A": 0, "B": 0}
    for slot in range(150):
        item = q.dequeue(slot / 150.0)
        assert item is not None
        served[item[0]] += 1
    assert served["A"] >= 100, served


def test_mclock_idle_client_tags_reset_to_now(pkg):
    mc = pkg.mclock
    q = mc.MClockQueue(lambda c: mc.ClientInfo(reservation=10.0))
    q.enqueue("A", ("A", 0), now=0.0)
    assert q.dequeue(0.0) is not None
    q.enqueue("A", ("A", 1), now=100.0)
    assert q.dequeue(100.0) is not None


def test_mclock_surplus_split_by_weight(pkg):
    mc = pkg.mclock
    infos = {"A": mc.ClientInfo(weight=2.0), "B": mc.ClientInfo(weight=1.0)}
    q = mc.MClockQueue(lambda c: infos[c])
    for i in range(300):
        q.enqueue("A", ("A", i), now=0.0)
        q.enqueue("B", ("B", i), now=0.0)
    served = {"A": 0, "B": 0}
    for _ in range(150):
        served[q.dequeue(now=1000.0)[0]] += 1
    assert served["A"] == 2 * served["B"], served


def test_mclock_weight_phase_credits_reservation(pkg):
    mc = pkg.mclock
    q = mc.MClockQueue(
        lambda c: mc.ClientInfo(reservation=10.0, weight=100.0))
    for i in range(20):
        q.enqueue("A", ("A", i), now=0.0)
    for _ in range(10):
        assert q.dequeue(0.0) is not None
    before = q.served_reservation
    assert q.dequeue(0.11) is not None
    assert q.served_reservation == before + 1


def test_mclock_limit_is_a_hard_cap(pkg):
    mc = pkg.mclock
    q = mc.MClockQueue(lambda c: mc.ClientInfo(weight=1.0, limit=5.0))
    for i in range(100):
        q.enqueue("A", ("A", i), now=0.0)
    assert run_schedule(q, duration=2.0).get("A", 0) <= 11


def test_mclock_over_limit_queue_idles_not_busy_loops(pkg):
    mc = pkg.mclock
    q = mc.MClockQueue(lambda c: mc.ClientInfo(weight=1.0, limit=1.0))
    q.enqueue("A", ("A", 0), now=0.0)
    q.enqueue("A", ("A", 1), now=0.0)
    assert q.dequeue(0.0) is not None
    assert q.dequeue(0.5) is None
    assert q.next_eligible_time(0.5) == pytest.approx(1.0)
    assert q.dequeue(1.0) is not None


def test_mclock_strict_bypasses_qos(pkg):
    mc = pkg.mclock
    q = mc.MClockQueue(lambda c: mc.ClientInfo(weight=1.0, limit=0.001))
    q.enqueue("A", ("A", 0), now=0.0)
    q.enqueue_strict(200, ("peering", 0))
    q.enqueue_strict(100, ("boot", 0))
    assert q.dequeue(0.0)[0] == "peering"
    assert q.dequeue(0.0)[0] == "boot"


def test_mclock_empty(pkg):
    mc = pkg.mclock
    q = mc.MClockQueue(lambda c: mc.ClientInfo())
    assert q.empty()
    q.enqueue_strict(1, "x")
    assert not q.empty()
    q.dequeue(0.0)
    assert q.empty()


def test_mclock_background_classes_cannot_starve_clients(pkg):
    mc = pkg.mclock
    q = mc.MClockOpClassQueue()
    for i in range(500):
        for cls in (mc.CLIENT_OP, mc.BG_RECOVERY, mc.BG_SCRUB):
            q.enqueue(cls, (cls, i), now=0.0)
    served = {}
    for slot in range(300):
        item = q.dequeue(now=slot / 300.0)
        if item is not None:
            served[item[0]] = served.get(item[0], 0) + 1
    assert served[mc.CLIENT_OP] > 250, served
    assert served.get(mc.BG_SCRUB, 0) <= 1, served


def test_mclock_recovery_reservation_guarantees_progress(pkg):
    mc = pkg.mclock
    q = mc.MClockOpClassQueue()
    for i in range(1000):
        q.enqueue(mc.CLIENT_OP, (mc.CLIENT_OP, i), now=0.0)
    for i in range(20):
        q.enqueue(mc.BG_RECOVERY, (mc.BG_RECOVERY, i), now=0.0)
    served = {}
    for slot in range(600):
        item = q.dequeue(now=slot * 0.01)
        if item:
            served[item[0]] = served.get(item[0], 0) + 1
    assert served.get(mc.BG_RECOVERY, 0) >= 5, served
    assert served[mc.CLIENT_OP] > 500, served
