"""The port's codec pipeline and pipelined ECUtil forms against the JAX
package's.

The JAX side runs ``jax_rs`` with ``device=jax`` on JAX-CPU; the port runs
``torch_rs`` with ``device=cpu``, whose pipeline dispatches the plain
PyTorch apply synchronously and waits on no event.  Encoded chunks and
decoded bytes must be bitwise equal.  The behaviour cases mirror
``tests/test_pipeline.py``: out-of-order completion, faults surfacing on
the future and on the op (nothing is served on the host), the breaker
failing fast, depth and backpressure, and the mesh option with too few
devices.
"""
import numpy as np
import pytest
import torch

from ceph_tpu.backend import ecutil as jecutil
from ceph_tpu.ops.pipeline import CodecPipeline as JaxPipeline
from ceph_tpu.plugins import ErasureCodePluginRegistry as JaxRegistry
from ceph_tpu_torch.backend import ecutil
from ceph_tpu_torch.common import Context
from ceph_tpu_torch.exec.engine import ServingEngine
from ceph_tpu_torch.failure import (CLOSED, OPEN, BreakerOpen, DeviceFaults,
                                    FaultInjector, FaultPlan, InjectedFault,
                                    InjectedOOM)
from ceph_tpu_torch.ops import pipeline as pipeline_mod
from ceph_tpu_torch.ops.codec import RSCodec
from ceph_tpu_torch.ops.pipeline import CodecPipeline, PipelineFuture
from ceph_tpu_torch.plugins.registry import ErasureCodePluginRegistry

K, M, CHUNK = 4, 2, 1024
CONFIGS = [(4, 2, 1024), (8, 4, 4096)]


def _port_ec(k=K, m=M, device="cpu"):
    return ErasureCodePluginRegistry().factory(
        "torch_rs", "", {"k": str(k), "m": str(m),
                         "technique": "reed_sol_van", "device": device})


def _jax_ec(k=K, m=M):
    return JaxRegistry().factory(
        "jax_rs", "", {"k": str(k), "m": str(m),
                       "technique": "reed_sol_van", "device": "jax"})


def _payloads(sinfo, stripe_counts, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, sinfo.stripe_width * s, dtype=np.uint8)
            for s in stripe_counts]


def _assert_chunks_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for c in g:
            assert np.array_equal(np.asarray(g[c]), np.asarray(w[c])), c


# -- the pipelined ECUtil forms -----------------------------------------------

@pytest.mark.parametrize("k,m,chunk", CONFIGS)
def test_encode_many_pipelined_matches_sync_and_jax(k, m, chunk):
    sinfo = ecutil.StripeInfo(k, chunk)
    bufs = _payloads(sinfo, [1, 3, 2], seed=k)
    ec, jec = _port_ec(k, m), _jax_ec(k, m)
    pl, jpl = CodecPipeline(depth=4, name="t.enc"), \
        JaxPipeline(depth=4, name="t.jenc")
    try:
        fut = ecutil.encode_many_pipelined(sinfo, ec, bufs, pl)
        jfut = jecutil.encode_many_pipelined(
            jecutil.StripeInfo(k, chunk), jec, bufs, jpl)
        got = fut.result(30)
        _assert_chunks_equal(got, ecutil.encode_many(sinfo, ec, bufs))
        _assert_chunks_equal(got, jfut.result(30))
    finally:
        pl.close()
        jpl.close()


@pytest.mark.parametrize("k,m,chunk", CONFIGS)
def test_decode_many_pipelined_matches_sync_and_jax(k, m, chunk):
    sinfo = ecutil.StripeInfo(k, chunk)
    bufs = _payloads(sinfo, [2, 1, 4, 3], seed=10 + k)
    ec, jec = _port_ec(k, m), _jax_ec(k, m)
    encoded = ecutil.encode_many(sinfo, ec, bufs)
    # three signatures: a data and a parity chunk lost, two data chunks
    # lost, and only parity lost (a host-only group)
    lost_sets = [{0, k + 1}, {1, 2}, {k}, {0, k + 1}]
    batches = [{c: v for c, v in e.items() if c not in lost}
               for e, lost in zip(encoded, lost_sets)]
    pl, jpl = CodecPipeline(depth=2, name="t.dec"), \
        JaxPipeline(depth=2, name="t.jdec")
    try:
        pending = ecutil.decode_many_pipelined(sinfo, ec, batches, pl)
        # the JAX form pads each group to a power-of-two size bucket; the
        # bytes are the same
        pad = lambda s: 1 << max(0, (s - 1).bit_length())   # noqa: E731
        jpending = jecutil.decode_many_pipelined(
            jecutil.StripeInfo(k, chunk), jec, batches, jpl,
            pad_chunks=pad, chunk_size=chunk)
        got = [None] * len(batches)
        for idxs, fut in pending:
            for i, data in zip(idxs, fut.result(30)):
                got[i] = data
        jgot = [None] * len(batches)
        for idxs, fut in jpending:
            for i, data in zip(idxs, fut.result(30)):
                jgot[i] = data
        assert [idxs for idxs, _ in pending] == \
            [idxs for idxs, _ in jpending]
        assert got == [b.tobytes() for b in bufs]
        assert got == jgot
        assert got == ecutil.decode_many(sinfo, ec, batches)
    finally:
        pl.close()
        jpl.close()


def test_pipelined_forms_decline_without_a_tensor_codec():
    """A numpy-routed plugin has no device codec: the pipelined forms
    return None and the caller keeps the synchronous path."""
    sinfo = ecutil.StripeInfo(K, CHUNK)
    ec = _port_ec(device="numpy")
    pl = CodecPipeline(depth=2, name="t.none")
    try:
        bufs = _payloads(sinfo, [1], seed=3)
        assert ecutil.encode_many_pipelined(sinfo, ec, bufs, pl) is None
        enc = ecutil.encode_many(sinfo, ec, bufs)[0]
        assert ecutil.decode_many_pipelined(
            sinfo, ec, [{c: enc[c] for c in range(1, K + M)}], pl) is None
        assert pl.perf.get("submitted") == 0
    finally:
        pl.close()


# -- raw pipeline semantics ---------------------------------------------------

def _blocks(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (K, CHUNK), np.uint8) for _ in range(n)]


def test_out_of_order_completion():
    pl = CodecPipeline(depth=8, name="t.ooo")
    try:
        codec = RSCodec(K, M, device="cpu")
        blocks = _blocks(3, seed=3)
        futs = [pl.submit(lambda b=b: b,
                          lambda packed: pl.dispatch_encode(codec, packed,
                                                            CHUNK),
                          lambda packed, parity: parity)
                for b in blocks]
        assert pl.in_flight == 3
        # force the LAST future first: it completes alone, the earlier
        # ones stay dispatched
        p2 = futs[2].result(10)
        assert futs[2].done() and not futs[0].done()
        assert pl.in_flight == 2
        p0 = futs[0].result(10)
        p1 = futs[1].result(10)
        assert pl.in_flight == 0
        for b, p in zip(blocks, (p0, p1, p2)):
            np.testing.assert_array_equal(p, codec.encode_host(b))
    finally:
        pl.close()


def test_injected_failure_surfaces_on_future():
    pl = CodecPipeline(depth=4, name="t.fail")
    try:
        def boom(_packed):
            raise RuntimeError("device exploded at dispatch")
        f1 = pl.submit(lambda: None, boom, lambda p, h: h)
        assert isinstance(f1.exception(1), RuntimeError)
        with pytest.raises(RuntimeError, match="at dispatch"):
            f1.result(1)

        class _Wedged:                  # the event wait fails
            def wait(self):
                raise ValueError("device-side failure at completion")
        f2 = pl.submit(lambda: None, lambda _p: _Wedged(),
                       lambda p, h: h)
        assert not f2.done()            # dispatch itself succeeded
        with pytest.raises(ValueError, match="at completion"):
            f2.result(1)
        assert pl.perf.get("errors") == 2
        # the pipeline stays usable after failures
        codec = RSCodec(K, M, device="cpu")
        data = np.arange(K * CHUNK, dtype=np.uint8).reshape(K, CHUNK)
        f3 = pl.submit(lambda: data,
                       lambda d: pl.dispatch_encode(codec, d, CHUNK),
                       lambda p, h: h)
        np.testing.assert_array_equal(f3.result(10), codec.encode_host(data))
    finally:
        pl.close()


@pytest.mark.parametrize("fault,exc", [
    (DeviceFaults(dispatch_fail_prob=1.0), InjectedFault),
    (DeviceFaults(oom_prob=1.0), InjectedOOM),
    (DeviceFaults(completion_fail_prob=1.0), InjectedFault),
])
def test_injected_device_faults_surface_with_errors_count(fault, exc):
    """The fault plan's device plane, rolled at dispatch and completion:
    the fault lands on the future and counts."""
    pl = CodecPipeline(depth=4, name="t.inject")
    try:
        pl.inject_faults(FaultInjector(FaultPlan(seed=7, device=fault)))
        codec = RSCodec(K, M, device="cpu")
        fut = pl.submit(lambda: _blocks(1, 0)[0],
                        lambda d: pl.dispatch_encode(codec, d, CHUNK),
                        lambda p, h: h)
        with pytest.raises(exc):
            fut.result(5)
        assert pl.perf.get("errors") == 1
        # a completion fault fails an item that was dispatched
        assert pl.perf.get("completed") == int(fault.completion_fail_prob > 0)
        pl.inject_faults(None)
        data = _blocks(1, 1)[0]
        ok = pl.submit(lambda: data,
                       lambda d: pl.dispatch_encode(codec, d, CHUNK),
                       lambda p, h: h)
        np.testing.assert_array_equal(ok.result(5), codec.encode_host(data))
    finally:
        pl.close()


def test_breaker_opens_and_fails_fast():
    """pipeline_breaker_threshold consecutive device failures open the
    breaker: each failure surfaces on its future, and once open a submit
    fails at once with BreakerOpen, without dispatching and without
    serving the batch anywhere else.  A successful half-open probe
    re-closes it."""
    cct = Context({"pipeline_breaker_threshold": 3,
                   "pipeline_breaker_cooldown": 60.0})
    pl = CodecPipeline(depth=4, name="t.breaker", cct=cct)
    calls = {"n": 0}
    try:
        codec = RSCodec(K, M, device="cpu")

        def dying(_packed):
            calls["n"] += 1
            raise RuntimeError("card lost")
        futs = [pl.submit(lambda b=b: b, dying, lambda p, h: h)
                for b in _blocks(5, seed=9)]
        for fut in futs[:3]:
            with pytest.raises(RuntimeError, match="card lost"):
                fut.result(5)
        for fut in futs[3:]:
            with pytest.raises(BreakerOpen):
                fut.result(5)
        assert pl.breaker.state == OPEN
        assert calls["n"] == 3                  # open: dispatch skipped
        assert pl.perf.get("errors") == 5
        assert pl.perf.get("completed") == 0
        assert pl.perf.get("breaker_state") == 2
        # the cooldown over, one probe dispatches on the device again
        pl.breaker.cooldown = 0.0
        data = _blocks(1, 4)[0]
        probe = pl.submit(lambda: data,
                          lambda d: pl.dispatch_encode(codec, d, CHUNK),
                          lambda p, h: h)
        np.testing.assert_array_equal(probe.result(5),
                                      codec.encode_host(data))
        assert pl.breaker.state == CLOSED
        assert pl.perf.get("breaker_state") == 0
    finally:
        pl.close()


def test_engine_surfaces_pipeline_failure_on_batch_future(monkeypatch):
    """A failing device dispatch surfaces on the batch future: the op
    fails, and nothing serves it on the host."""
    ec, sinfo = _port_ec(), ecutil.StripeInfo(K, CHUNK)
    eng = ServingEngine(ec_impl=ec, sinfo=sinfo, name="t.efail",
                        pipeline_depth=4)
    try:
        monkeypatch.setattr(
            CodecPipeline, "dispatch_encode",
            lambda self, codec, data, chunk: (_ for _ in ()).throw(
                RuntimeError("injected")))
        fut = eng.submit_encode(_payloads(sinfo, [1], 0)[0])
        eng.flush()
        with pytest.raises(RuntimeError, match="injected"):
            fut.result(5)
        assert eng.perf.get("ops_failed") == 1
        assert eng.pipeline.perf.get("errors") == 1
    finally:
        eng.stop()


@pytest.mark.parametrize("depth", [0, 4])
@pytest.mark.parametrize("fault,exc", [
    (DeviceFaults(dispatch_fail_prob=1.0), InjectedFault),
    (DeviceFaults(oom_prob=1.0), InjectedOOM),
    (DeviceFaults(completion_fail_prob=1.0), InjectedFault),
])
def test_engine_device_fault_fails_the_op(fault, exc, depth):
    """An injected device fault through the engine's hook fails the op
    that hit it, at any depth; with the injector detached the engine
    serves again."""
    ec, sinfo = _port_ec(), ecutil.StripeInfo(K, CHUNK)
    eng = ServingEngine(ec_impl=ec, sinfo=sinfo, name=f"t.efault{depth}",
                        pipeline_depth=depth)
    try:
        eng.inject_device_faults(
            FaultInjector(FaultPlan(seed=3, device=fault)))
        enc = eng.submit_encode(_payloads(sinfo, [2], 1)[0])
        dec = eng.submit_decode({c: np.zeros(CHUNK, np.uint8)
                                 for c in range(1, K + 1)})
        eng.flush()
        for fut in (enc, dec):
            with pytest.raises(exc):
                fut.result(5)
        assert eng.perf.get("ops_failed") == 2
        assert eng.pipeline.perf.get("errors") == 2
        eng.inject_device_faults(None)
        buf = _payloads(sinfo, [2], 2)[0]
        chunks = eng.encode(buf, timeout=5)
        want = ecutil.encode(sinfo, ec, buf)
        assert all(np.array_equal(chunks[c], want[c]) for c in want)
    finally:
        eng.stop()


def test_depth_zero_engine_dispatches_through_the_pipeline():
    """Depth 0 is a synchronous pipeline, not a second path: every batch
    is submitted to it and completes before the dispatch returns."""
    ec, sinfo = _port_ec(), ecutil.StripeInfo(K, CHUNK)
    eng = ServingEngine(ec_impl=ec, sinfo=sinfo, name="t.depth0",
                        pipeline_depth=0)
    try:
        assert eng.pipeline.depth == 0
        futs = [eng.submit_encode(p)
                for p in _payloads(sinfo, [1, 2, 1], seed=8)]
        eng.step()
        assert all(f.done() for f in futs)
        assert eng.pipeline.perf.get("submitted") == 1
        assert eng.pipeline.perf.get("completed") == 1
        assert eng.pipeline.in_flight == 0
        hist = eng.pipeline.perf.dump()["inflight_depth"]
        assert hist["count"] == 1 and hist["sum"] == 1
    finally:
        eng.stop()


def test_depth_counters_and_backpressure():
    pl = CodecPipeline(depth=2, name="t.depth")
    try:
        codec = RSCodec(K, M, device="cpu")
        futs = []
        for d in _blocks(5, seed=5):
            futs.append(pl.submit(
                lambda d=d: d,
                lambda p: pl.dispatch_encode(codec, p, CHUNK),
                lambda p, h: h))
            # depth-limited: never more than `depth` in flight
            assert pl.in_flight <= 2
        assert pl.perf.get("submitted") == 5
        hist = pl.perf.dump()["inflight_depth"]
        # depth at each dispatch, before the oldest completes: 1, 2, 3, 3, 3
        assert hist["count"] == 5 and hist["sum"] == 12
        pl.flush()
        assert pl.in_flight == 0
        assert pl.perf.get("completed") == 5
        assert all(f.done() for f in futs)
    finally:
        pl.close()


@pytest.mark.parametrize("depth", [1, 2, 4, 8])
def test_engine_roundtrip_bitwise_identical_to_sync(depth):
    ec, sinfo = _port_ec(), ecutil.StripeInfo(K, CHUNK)
    payloads = _payloads(sinfo, [1, 2, 3, 4] * 2, seed=depth)
    sync = ServingEngine(ec_impl=ec, sinfo=sinfo, name=f"t.sync{depth}",
                         pipeline_depth=0)
    pipe = ServingEngine(ec_impl=ec, sinfo=sinfo, name=f"t.pipe{depth}",
                         pipeline_depth=depth)
    try:
        futs_s = [sync.submit_encode(p) for p in payloads]
        sync.flush()
        futs_p = [pipe.submit_encode(p) for p in payloads]
        pipe.flush()
        enc_p = [f.result(10) for f in futs_p]
        _assert_chunks_equal(enc_p, [f.result(10) for f in futs_s])
        degraded = [{c: v for c, v in e.items() if c not in (0, K + 1)}
                    for e in enc_p]
        dfuts = [pipe.submit_decode(d) for d in degraded]
        pipe.flush()
        assert [f.result(10) for f in dfuts] == \
            [p.tobytes() for p in payloads]
        assert pipe.pipeline.perf.get("submitted") >= 2
    finally:
        sync.stop()
        pipe.stop()


def test_threaded_engine_roundtrip():
    ec, sinfo = _port_ec(), ecutil.StripeInfo(K, CHUNK)
    payloads = _payloads(sinfo, [1, 2] * 8, seed=42)
    eng = ServingEngine(ec_impl=ec, sinfo=sinfo, name="t.thr",
                        pipeline_depth=4).start()
    try:
        futs = [eng.submit_encode(p) for p in payloads]
        encs = [f.result(30) for f in futs]
        outs = [eng.decode({c: v for c, v in e.items() if c != 1},
                           timeout=30) for e in encs]
        assert outs == [p.tobytes() for p in payloads]
    finally:
        eng.stop()


# -- the mesh option ----------------------------------------------------------

def test_mesh_option_ignored_when_too_few_devices():
    ec, sinfo = _port_ec(), ecutil.StripeInfo(K, CHUNK)
    eng = ServingEngine(ec_impl=ec, sinfo=sinfo, name="t.m64",
                        pipeline_depth=4)
    eng.pipeline.mesh_devices = 64
    try:
        assert CodecPipeline(depth=1, name="t.m2",
                             mesh_devices=2)._mesh_ctx() is None
        fut = eng.submit_encode(_payloads(sinfo, [1], 0)[0])
        eng.flush()
        assert fut.result(10)              # single-device path
        assert eng.pipeline.perf.get("mesh_dispatches") == 0
    finally:
        eng.stop()


def test_mesh_with_enough_cards_is_not_ported(monkeypatch):
    """Enough cards for the mesh: construction refuses rather than run
    quietly on one card."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(NotImplementedError, match="mesh"):
        CodecPipeline(depth=1, name="t.mesh4", mesh_devices=2)
    assert CodecPipeline(depth=1, name="t.mesh8",
                         mesh_devices=8)._mesh_ctx() is None


# -- the completion boundary --------------------------------------------------

def test_settle_and_host_buffers():
    """CPU tensors complete without a wait; a cpu codec's host buffers
    are plain numpy; a cuda codec without a card raises, never falls
    back."""
    t = torch.arange(6, dtype=torch.uint8).reshape(2, 3)
    assert np.array_equal(pipeline_mod.settle(t), t.numpy())
    assert pipeline_mod.settle(None) is None
    arr = np.ones(4, np.uint8)
    assert pipeline_mod.settle(arr) is arr
    buf = CodecPipeline.host_block(RSCodec(K, M, device="cpu").torch_device,
                                   (K, 256))
    assert isinstance(buf, np.ndarray) and buf.shape == (K, 256)
    buf[:] = 7
    out = pipeline_mod.launch(torch.device("cpu"), buf, lambda t: t ^ 1)
    assert np.array_equal(pipeline_mod.settle(out), np.full((K, 256), 6))


def test_pipelined_encode_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sinfo = ecutil.StripeInfo(K, CHUNK)
    ec = _port_ec(device="cuda")
    pl = CodecPipeline(depth=2, name="t.nocard")
    try:
        fut = ecutil.encode_many_pipelined(
            sinfo, ec, _payloads(sinfo, [1], 0), pl)
        with pytest.raises(RuntimeError, match="cuda"):
            fut.result(5)
        assert pl.perf.get("errors") == 1
        assert pl.perf.get("completed") == 0
    finally:
        pl.close()


def test_future_callbacks_and_value():
    pl = CodecPipeline(depth=4, name="t.cb")
    try:
        codec = RSCodec(K, M, device="cpu")
        data = _blocks(1, 2)[0]
        fut = pl.submit(lambda: data,
                        lambda d: pl.dispatch_encode(codec, d, CHUNK),
                        lambda p, h: h)
        assert isinstance(fut, PipelineFuture)
        seen = []
        fut.add_done_callback(seen.append)
        assert seen == []
        pl.flush()
        assert seen == [fut] and fut.error is None
        np.testing.assert_array_equal(fut.value, codec.encode_host(data))
        fut.add_done_callback(seen.append)      # already done: inline
        assert seen == [fut, fut]
    finally:
        pl.close()


def test_concurrent_submit_and_force_completes_each_item_once():
    """More threads than cores submit and force completions out of order
    (short switch interval): every item completes exactly once, with its
    own parity, and the counters balance."""
    import os
    import sys
    import threading
    pl = CodecPipeline(depth=3, name="t.stress")
    codec = RSCodec(K, M, device="cpu")
    finished = []
    lock = threading.Lock()
    errors = []

    def worker(seed):
        try:
            for b in _blocks(6, seed):
                fut = pl.submit(lambda b=b: b,
                                lambda p: pl.dispatch_encode(codec, p, 64),
                                lambda p, h: h)
                fut.add_done_callback(lambda f: finished.append(f))
                if seed % 2:
                    got = fut.result(30)
                    if not np.array_equal(got, codec.encode_host(b)):
                        with lock:
                            errors.append(seed)
        except Exception as e:          # noqa: BLE001 — asserted below
            with lock:
                errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(s,), daemon=True)
                   for s in range(2 * (os.cpu_count() or 2) + 2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        assert not any(th.is_alive() for th in threads)
        pl.flush()
    finally:
        sys.setswitchinterval(old)
        pl.close()
    n = 6 * len(threads)
    assert errors == []
    assert len(finished) == n and len({id(f) for f in finished}) == n
    assert pl.perf.get("submitted") == pl.perf.get("completed") == n
    assert pl.in_flight == 0
