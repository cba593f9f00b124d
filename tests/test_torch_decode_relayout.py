"""The batch layout of every pipelined GF(2^8) apply.

A batch packs into one block of chunk rows: the k logical data rows in
order, then only the parity rows it reads or writes (a repair leg: its
data rows, then its running-sum rows).  The card's input is the block's
runs of rows, its result lands in the block's output rows, and the batch
settles to that block.  The serving decode (``ecutil._submit_slot_group``)
leaves an erased row an empty slot and each read's bytes come out of its
columns in one strided copy; the returned ``bytes`` must be the ones
``decode_many`` returns and, where JAX is, the JAX package's
``decode_many_pipelined``.  The encode, the recovery decode and the repair
legs are held against the JAX package's ``encode_many``,
``decode_shards_many``, ``partial_sum_accumulate``, ``regen_project`` and
``regen_combine`` on the same inputs.

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


def _spy_settles(pl):
    """The host result each batch of ``pl`` settled to, in completion
    order: "block" when it is the batch's own block (the first item of a
    decode's packed tuple), "none" for a batch that dispatched nothing,
    else "apart"."""
    settled = []
    submit = pl.submit

    def spy(pack, dispatch, unpack, **kw):
        def check(packed, host):
            block = packed[0] if isinstance(packed, tuple) else packed
            settled.append("block" if host is block else
                           "none" if host is None else "apart")
            return unpack(packed, host)
        return submit(pack, dispatch, check, **kw)
    pl.submit = spy
    return settled


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
    settled = _spy_settles(pl)
    try:
        pending = ecutil.decode_many_pipelined(sinfo, _ec(device), batches,
                                               pl)
        got = _gather(pending, ops)
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
    # a group with a data row lost settles to its block; one whose data
    # rows all survived dispatches nothing
    dispatching = sum(1 for sig in {frozenset(b) for b in batches}
                      if any(i not in sig for i in range(K)))
    assert sorted(settled) == sorted(["block"] * dispatching +
                                     ["none"] * (groups - dispatching))


def test_a_mesh_returns_the_rows_apart_and_counts_them_repacked():
    """A CPU mesh of 8 takes the survivors as one stack; its ``finish``
    puts the recovered rows in the block's slots, so a mesh batch settles
    to its block like any other; the group that needs no dispatch
    dispatches nothing.  The bytes are the JAX package's."""
    sinfo = ecutil.StripeInfo(K, CHUNK)
    bufs = _payloads(sinfo, [1, 3, 2, 2, 1, 3], seed=41)
    encoded = ecutil.encode_many(sinfo, _ec("cpu"), bufs)
    batches = _reads(encoded, CASES["three_signatures"])
    pl = CodecPipeline(depth=2, name="t.relayout.mesh")
    pl.mesh = make_mesh(8, devices=["cpu"] * 8)
    settled = _spy_settles(pl)
    try:
        got = _gather(ecutil.decode_many_pipelined(
            sinfo, _ec("cpu"), batches, pl), len(batches))
        perf = pl.perf.dump()
    finally:
        pl.close()
    assert got == [b.tobytes() for b in bufs]
    assert got == _jax_decode(batches)
    assert perf["mesh_dispatches"] == 2
    assert sorted(settled) == ["block", "block", "none"]


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
    assert dispatched.nbytes == 2 * 256
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
    settled = _spy_settles(eng.pipeline)

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
    finally:
        eng.stop()
    assert wrong == []
    assert len(settled) >= 2 and set(settled) == {"block"}


# -- the encode, the recovery decode and the repair legs -----------------------

def _jax_port():
    """The JAX package's ``ecutil``, its ``StripeInfo`` and an RS(8,4)
    plugin on the host codec; None where JAX is not installed (the card's
    machine)."""
    try:
        from ceph_tpu.backend import ecutil as jecutil
        from ceph_tpu.plugins import ErasureCodePluginRegistry as JaxRegistry
    except ImportError:
        return None
    return jecutil, jecutil.StripeInfo(K, CHUNK), JaxRegistry().factory(
        "jax_rs", "", {"k": str(K), "m": str(M),
                       "technique": "reed_sol_van", "device": "numpy"})


def _held_against_jax(device):
    jax = _jax_port()
    if device == "cpu":
        assert jax is not None, "the CPU cases hold the port against JAX"
    return jax


def _chunks_bytes(per_op):
    return [{c: np.asarray(v).tobytes() for c, v in op.items()}
            for op in per_op]


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("ops,lengths", SHAPES)
def test_encode_many_pipelined_lands_the_parity_in_its_block(ops, lengths,
                                                             device):
    """One [n, total] block: the data packed into rows [0, k), the parity
    landed in rows [k, n), the batch settled to the block, and every chunk
    handed out a view of it, with the JAX ``encode_many``'s bytes."""
    device = _device(device)
    sinfo = ecutil.StripeInfo(K, CHUNK)
    counts = [2] * ops if lengths == "equal" else \
        [1 + i % 3 for i in range(ops)]
    bufs = _payloads(sinfo, counts, seed=7 * ops + len(lengths))
    pl = CodecPipeline(depth=2, name=f"t.layout.enc.{ops}.{lengths}")
    settled = _spy_settles(pl)
    try:
        got = ecutil.encode_many_pipelined(sinfo, _ec(device), bufs,
                                           pl).result(60)
    finally:
        pl.close()
    assert settled == ["block"]
    assert len({id(v.base) for op in got for v in op.values()}) == 1
    assert all(sorted(op) == list(range(K + M)) for op in got)
    got = _chunks_bytes(got)
    assert got == _chunks_bytes(ecutil.encode_many(sinfo, _ec("cpu"), bufs))
    jax = _held_against_jax(device)
    if jax is not None:
        jecutil, jsinfo, jec = jax
        assert got == _chunks_bytes(jecutil.encode_many(jsinfo, jec, bufs))


# the lost chunks of each object, cycled over a recovery wave's objects
RECOVERY = {
    "parity_only": [{9, 10}],
    "data_and_parity": [{1, 9}],
    "three_signatures": [{1, 9}, {0, 5}, {10}],
}


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("read", ["all", "minimum"])
@pytest.mark.parametrize("case", sorted(RECOVERY))
def test_decode_shards_many_lands_the_erased_rows_in_their_block(case, read,
                                                                 device):
    """Each (signature, want) group packs its survivors once into their
    rows of one block and its erased rows land in theirs, parity erasures
    included (``read`` "minimum" leaves unread chunks erased too); each
    group settles to its block, and each wanted chunk is the JAX
    ``decode_shards_many``'s."""
    device = _device(device)
    ec = _ec(device)
    sinfo = ecutil.StripeInfo(K, CHUNK)
    bufs = _payloads(sinfo, [1 + i % 3 for i in range(6)], seed=len(case))
    encoded = ecutil.encode_many(sinfo, _ec("cpu"), bufs)
    lost_sets = RECOVERY[case]
    batches = []
    for i, chunks in enumerate(encoded):
        lost = lost_sets[i % len(lost_sets)]
        avail = set(range(K + M)) - lost
        if read == "minimum":
            avail = set(ec.minimum_to_decode(set(lost), avail))
        batches.append(({c: chunks[c] for c in sorted(avail)}, set(lost)))
    pl = CodecPipeline(depth=2, name=f"t.layout.rec.{case}.{read}")
    settled = _spy_settles(pl)
    try:
        got = ecutil.decode_shards_many(sinfo, ec, batches, pipeline=pl)
    finally:
        pl.close()
    groups = {(frozenset(a), frozenset(w)) for a, w in batches}
    assert settled == ["block"] * len(groups)
    for chunks, rec, (_avail, want) in zip(encoded, got, batches):
        assert sorted(rec) == sorted(want)
        for c in want:
            assert np.asarray(rec[c]).tobytes() == chunks[c].tobytes()
    got = _chunks_bytes(got)
    assert got == _chunks_bytes(ecutil.decode_shards_many(
        sinfo, _ec("cpu"), batches))
    jax = _held_against_jax(device)
    if jax is not None:
        jecutil, jsinfo, jec = jax
        assert got == _chunks_bytes(jecutil.decode_shards_many(
            jsinfo, jec, batches))


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("hop", ["first", "later"])
def test_partial_sum_accumulate_lands_in_the_running_sum_rows(hop, device):
    """A chain hop's block is its stream row and then its running-sum
    rows (empty on the first hop); the product, XOR the sums, lands in
    them and the batch settles to the block.  The sums are the JAX hop's,
    through the pipeline and without one."""
    device = _device(device)
    rng = np.random.default_rng(len(hop))
    stream = rng.integers(0, 256, 3 * CHUNK, dtype=np.uint8)
    acc = None if hop == "first" else \
        [rng.integers(0, 256, 3 * CHUNK, dtype=np.uint8).tobytes()
         for _ in range(2)]
    coeffs = [int(c) for c in rng.integers(1, 256, 2)]
    pl = CodecPipeline(depth=1, name=f"t.layout.hop.{hop}")
    settled = _spy_settles(pl)
    try:
        got = ecutil.partial_sum_accumulate(coeffs, stream, acc,
                                            pipeline=pl, device=device)
    finally:
        pl.close()
    assert settled == ["block"]
    assert got == ecutil.partial_sum_accumulate(coeffs, stream, acc,
                                                device=device)
    assert got == ecutil.partial_sum_accumulate(coeffs, stream, acc,
                                                device="numpy")
    jax = _held_against_jax(device)
    if jax is not None:
        assert got == jax[0].partial_sum_accumulate(coeffs,
                                                    stream.tobytes(), acc)


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("leg", ["project", "combine"])
def test_regen_legs_land_in_the_rows_after_their_data(leg, device):
    """A regenerating-repair leg has no running sums: its block is its
    data rows and then r empty rows, the result lands in those and the
    batch settles to the block.  The bytes are the JAX leg's."""
    device = _device(device)
    rng = np.random.default_rng(3 if leg == "project" else 4)
    sub, d, width = 4, 5, 2 * CHUNK
    pl = CodecPipeline(depth=1, name=f"t.layout.regen.{leg}")
    settled = _spy_settles(pl)
    try:
        if leg == "project":
            coeffs = rng.integers(0, 256, sub, dtype=np.uint8).tobytes()
            chunk = rng.integers(0, 256, sub * width, dtype=np.uint8)
            got = ecutil.regen_project(coeffs, chunk, sub, pipeline=pl,
                                       device=device)
            sync = ecutil.regen_project(coeffs, chunk, sub, device=device)
            jax_leg = lambda j: j.regen_project(coeffs, chunk, sub)  # noqa
            assert len(got) * sub == chunk.size
        else:
            mat = rng.integers(0, 256, sub * d, dtype=np.uint8).tobytes()
            streams = [rng.integers(0, 256, width, dtype=np.uint8)
                       .tobytes() for _ in range(d)]
            got = ecutil.regen_combine(mat, streams, sub, pipeline=pl,
                                       device=device)
            sync = ecutil.regen_combine(mat, streams, sub, device=device)
            jax_leg = lambda j: j.regen_combine(mat, streams, sub)  # noqa
            assert len(got) == sub * width
    finally:
        pl.close()
    assert settled == ["block"]
    assert got == sync
    jax = _held_against_jax(device)
    if jax is not None:
        assert got == jax_leg(jax[0])
