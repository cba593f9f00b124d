"""The serving decode's slot layout (``ecutil._submit_decode_group``).

A signature group packs into one block [k + p, total]: the k logical data
rows in order, an erased row's an empty slot, then the p parity rows the
decode matrix reads.  The survivors go to the device as the block's runs
of rows, the recovered rows land in the slots, and each read's bytes come
out of its columns in one strided copy.  The returned ``bytes`` must be
the ones ``decode_many`` returns and, where JAX is, the JAX package's
``decode_many_pipelined``; ``decode_one_pass`` / ``decode_repacked``
count the batches.

The ``cuda`` cases run where a card is; the card's machine has no JAX and
runs them without the suite's ``conftest.py`` (it imports JAX):

    python -m pytest --noconftest tests/test_torch_decode_relayout.py -m card
"""
from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from ceph_tpu_torch.backend import ecutil
from ceph_tpu_torch.exec.engine import ServingEngine
from ceph_tpu_torch.ops import pipeline as pipeline_mod
from ceph_tpu_torch.ops.pipeline import CodecPipeline
from ceph_tpu_torch.parallel.mesh import make_mesh
from ceph_tpu_torch.plugins.registry import ErasureCodePluginRegistry

K, M, CHUNK = 8, 4, 4096

# the lost chunks of each read, cycled over a batch's reads
CASES = {
    "lost_1_9": [{1, 9}],                       # the read cell's signature
    "lost_0_5": [{0, 5}],                       # two data chunks
    "parity_only": [{9, 10}],                   # no dispatch
    "more_than_k": [{1}],                       # 11 of 12 available
    "three_signatures": [{1, 9}, {0, 5}, {9, 10}],
}
SHAPES = [(1, "equal"), (16, "equal"), (16, "unequal")]
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.card)]


def _device(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return device


def _ec(device, k=K, m=M):
    return ErasureCodePluginRegistry().factory(
        "torch_rs", "", {"k": str(k), "m": str(m),
                         "technique": "reed_sol_van", "device": device})


def _payloads(sinfo, stripe_counts, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, sinfo.stripe_width * s, dtype=np.uint8)
            for s in stripe_counts]


def _reads(encoded, lost_sets):
    return [{c: v for c, v in e.items()
             if c not in lost_sets[i % len(lost_sets)]}
            for i, e in enumerate(encoded)]


def _gather(pending, n):
    got = [None] * n
    for idxs, fut in pending:
        for i, data in zip(idxs, fut.result(60)):
            got[i] = data
    return got


def _jax_decode(batches):
    """The JAX package's ``decode_many_pipelined`` on JAX-CPU; None where
    JAX is not installed (the card's machine)."""
    try:
        from ceph_tpu.backend import ecutil as jecutil
        from ceph_tpu.ops.pipeline import CodecPipeline as JaxPipeline
        from ceph_tpu.plugins import ErasureCodePluginRegistry as JaxRegistry
    except ImportError:
        return None
    jec = JaxRegistry().factory(
        "jax_rs", "", {"k": str(K), "m": str(M),
                       "technique": "reed_sol_van", "device": "jax"})
    jpl = JaxPipeline(depth=2, name="t.relayout.jax")
    try:
        # the JAX form pads each group to a power-of-two size bucket
        pad = lambda s: 1 << max(0, (s - 1).bit_length())   # noqa: E731
        return _gather(jecutil.decode_many_pipelined(
            jecutil.StripeInfo(K, CHUNK), jec, batches, jpl,
            pad_chunks=pad, chunk_size=CHUNK), len(batches))
    finally:
        jpl.close()


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("ops,lengths", SHAPES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_many_pipelined_returns_the_bytes(case, ops, lengths,
                                                 device):
    device = _device(device)
    sinfo = ecutil.StripeInfo(K, CHUNK)
    counts = [2] * ops if lengths == "equal" else \
        [1 + i % 3 for i in range(ops)]
    bufs = _payloads(sinfo, counts, seed=len(case) * 31 + ops)
    encoded = ecutil.encode_many(sinfo, _ec("cpu"), bufs)
    batches = _reads(encoded, CASES[case])
    pl = CodecPipeline(depth=2, name=f"t.relayout.{case}.{ops}.{lengths}")
    try:
        pending = ecutil.decode_many_pipelined(sinfo, _ec(device), batches,
                                               pl)
        got = _gather(pending, ops)
        perf = pl.perf.dump()
    finally:
        pl.close()
    assert all(type(g) is bytes for g in got)
    assert got == [b.tobytes() for b in bufs]
    assert got == ecutil.decode_many(sinfo, _ec("cpu"), batches)
    jgot = _jax_decode(batches)
    if device == "cpu":
        assert jgot is not None, "the CPU cases hold the port against JAX"
    if jgot is not None:
        assert got == jgot
    groups = len({frozenset(b) for b in batches})
    assert len(pending) == groups
    assert perf["decode_one_pass"] == groups
    assert perf["decode_repacked"] == 0


def test_a_mesh_returns_the_rows_apart_and_counts_them_repacked():
    """A CPU mesh of 8 takes the survivors as one stack and returns the
    recovered rows apart: they are copied into the block's slots
    (``decode_repacked``); the group that needs no dispatch keeps the
    slot layout (``decode_one_pass``)."""
    sinfo = ecutil.StripeInfo(K, CHUNK)
    bufs = _payloads(sinfo, [1, 3, 2, 2, 1, 3], seed=41)
    encoded = ecutil.encode_many(sinfo, _ec("cpu"), bufs)
    batches = _reads(encoded, CASES["three_signatures"])
    pl = CodecPipeline(depth=2, name="t.relayout.mesh")
    pl.mesh = make_mesh(8, devices=["cpu"] * 8)
    try:
        got = _gather(ecutil.decode_many_pipelined(
            sinfo, _ec("cpu"), batches, pl), len(batches))
        perf = pl.perf.dump()
    finally:
        pl.close()
    assert got == [b.tobytes() for b in bufs]
    assert perf["mesh_dispatches"] == 2
    assert perf["decode_repacked"] == 2
    assert perf["decode_one_pass"] == 1


@pytest.mark.parametrize("rows,runs", [
    ([0, 2, 3, 4, 5, 6, 7, 8], [(0, 0, 1), (1, 2, 7)]),
    ([1, 2, 4, 6, 7, 8, 9, 10], [(0, 1, 2), (2, 4, 1), (3, 6, 5)]),
    ([0, 1, 2, 3], [(0, 0, 4)]),
    ([5], [(0, 5, 1)]),
])
def test_runs_are_the_copies_of_consecutive_rows(rows, runs):
    assert pipeline_mod._runs(rows) == runs


@pytest.mark.parametrize("device", DEVICES)
def test_launch_reads_its_rows_and_lands_in_the_block(device):
    """``launch`` with ``rows`` and ``land``: the card's input is the
    block's rows in order, the result lands in the named rows of the
    same block, the batch settles to that block, and the bytes it
    brought back are the landed rows'."""
    dev = torch.device(_device(device))
    block = CodecPipeline.host_block(dev, (6, 256))
    block[:] = np.arange(6, dtype=np.uint8)[:, None]
    rows, land = [0, 2, 3, 5], [1, 4]

    def run(card):
        # row i of the result: the XOR of input rows i and i + 2
        return card[:2] ^ card[2:]
    dispatched = pipeline_mod.launch(dev, block, run, rows=rows, land=land)
    host = pipeline_mod.settle(dispatched)
    assert host is block
    assert pipeline_mod.landed_bytes(dispatched, host) == 2 * 256
    want = np.arange(6, dtype=np.uint8)[:, None].repeat(256, 1)
    want[1], want[4] = 0 ^ 3, 2 ^ 5
    assert np.array_equal(block, want)


def _rbd_engine(ec, sinfo, name):
    """The engine at ``rbd_rs84_4m``'s settings."""
    return ServingEngine(ec_impl=ec, sinfo=sinfo, name=name,
                         pipeline_depth=4, batch_max_ops=64,
                         batch_max_delay_ms=2.0, max_bytes=64 << 20,
                         max_ops=1024, fail_fast=False).start()


@pytest.mark.parametrize("device", DEVICES)
def test_closed_loop_reads_through_the_engine_return_their_payloads(device):
    """16 closed-loop clients of degraded reads, 12 rounds each, through
    a started engine with 4 batches in flight: blocks are made and freed
    while others are in flight, and every read returns its payload."""
    device = _device(device)
    sinfo = ecutil.StripeInfo(K, CHUNK)
    bufs = _payloads(sinfo, [1 + i % 4 for i in range(24)], seed=77)
    encoded = ecutil.encode_many(sinfo, _ec("cpu"), bufs)
    reads = _reads(encoded, [{1, 9}, {1, 9}, {1, 9}, {0, 5}])
    clients, total = 16, 16 * 12
    lock = threading.Lock()
    state = {"submitted": 0, "done": 0}
    wrong: list[tuple[int, str]] = []
    finished = threading.Event()
    eng = _rbd_engine(_ec(device), sinfo, f"t.relayout.loop.{device}")

    def submit():
        with lock:
            if state["submitted"] >= total:
                return
            j = state["submitted"] % len(reads)
            state["submitted"] += 1
        eng.submit_decode(reads[j]).add_done_callback(
            lambda f, j=j: on_done(f, j))

    def on_done(fut, j):
        err = fut.exception(0)
        if err is not None:
            wrong.append((j, repr(err)))
        elif fut.result(0) != bufs[j].tobytes():
            wrong.append((j, "bytes"))
        with lock:
            state["done"] += 1
            if state["done"] == total:
                finished.set()
        submit()
    try:
        for _ in range(clients):
            submit()
        assert finished.wait(120), state
        perf = eng.pipeline.perf.dump()
    finally:
        eng.stop()
    assert wrong == []
    assert perf["decode_one_pass"] >= 2
    assert perf["decode_repacked"] == 0
