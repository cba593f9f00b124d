"""The port's repair path against the JAX package's.

crc32c rows and the fused encode + checksum, HashInfo chaining, the
chain-repair hop (``partial_sum_accumulate``), the regenerating-repair legs
(``regen_project``/``regen_combine`` on pm_regen) and recovery waves
(``decode_shards_many``), each with the same numpy inputs from a seed
through ``ceph_tpu`` (JAX on the CPU) and ``ceph_tpu_torch`` (``device=cpu``:
the plain PyTorch versions the wrappers run for a CPU tensor, and the
pipeline dispatching synchronously).  The arithmetic is integer, so every
comparison is bitwise.  The fault cases show that a failure in a repair
leg's dispatch fails it and is never answered by the host GF math.
"""
import numpy as np
import pytest
import torch

from ceph_tpu.backend import ecutil as jecutil
from ceph_tpu.ops import codec as jcodec
from ceph_tpu.ops import rs_kernels as jrk
from ceph_tpu.ops.codec import RSCodec as JaxRSCodec
from ceph_tpu.ops.pipeline import CodecPipeline as JaxPipeline
from ceph_tpu.plugins import ErasureCodePluginRegistry as JaxRegistry
from ceph_tpu_torch.backend import ecutil
from ceph_tpu_torch.failure import (DeviceFaults, FaultInjector, FaultPlan,
                                    InjectedFault)
from ceph_tpu_torch.ops import codec
from ceph_tpu_torch.ops import rs_kernels as trk
from ceph_tpu_torch.ops.codec import RSCodec
from ceph_tpu_torch.ops.pipeline import CodecPipeline
from ceph_tpu_torch.plugins.registry import ErasureCodePluginRegistry

K, M, CHUNK = 4, 2, 2048


def _rng(seed):
    return np.random.default_rng(seed)


def _rand(rng, shape):
    return rng.integers(0, 256, size=shape, dtype=np.uint8)


def _port_ec(name="torch_rs", **profile):
    return ErasureCodePluginRegistry().factory(name, "", profile)


def _jax_ec(name="jax_rs", **profile):
    return JaxRegistry().factory(name, "", profile)


# -- crc32c rows ---------------------------------------------------------------

def _crc_target_suffix(prefix: np.ndarray, target: int) -> np.ndarray:
    """Four bytes X with crc32c(0, prefix + X) == target: crc32c(0, .) of
    four bytes is an invertible GF(2)-linear map of their 32 bits, and
    crc32c(0, P + X) == Z_4(crc32c(0, P)) ^ crc32c(0, X)."""
    want = target ^ ecutil.crc32c_zeros(ecutil.crc32c(0, prefix), 4)
    cols = [ecutil.crc32c(0, (1 << i).to_bytes(4, "little"))
            for i in range(32)]
    # solve sum_i x_i cols[i] = want over GF(2) by elimination
    rows = [(cols[i], 1 << i) for i in range(32)]
    basis: dict[int, tuple[int, int]] = {}
    for v, x in rows:
        for bit in range(31, -1, -1):
            if not (v >> bit) & 1:
                continue
            if bit in basis:
                bv, bx = basis[bit]
                v, x = v ^ bv, x ^ bx
            else:
                basis[bit] = (v, x)
                break
    x = 0
    for bit in range(31, -1, -1):
        if (want >> bit) & 1:
            bv, bx = basis[bit]
            want, x = want ^ bv, x ^ bx
    assert want == 0
    return np.frombuffer(x.to_bytes(4, "little"), np.uint8)


@pytest.mark.parametrize("n", [1, 7, 127, 4096, 4099])
def test_crc32c_rows_plain_matches_jax(n):
    rng = _rng(n)
    rows = _rand(rng, (6, n))
    if n >= 4:
        # crcs at the top of the uint32 range: 0xFFFFFFFF and 0x80000000
        for i, target in ((0, 0xFFFFFFFF), (1, 0x80000000)):
            rows[i, n - 4:] = _crc_target_suffix(rows[i, :n - 4], target)
    want = np.asarray(jrk.crc32c_rows(rows)).astype(np.int64)
    got = trk.crc32c_rows_plain(torch.from_numpy(rows))
    assert got.dtype == torch.int64 and got.shape == (6,)
    assert np.array_equal(got.numpy(), want)
    assert got.tolist() == [ecutil.crc32c(0, r) for r in rows]
    if n >= 4:
        assert got[:2].tolist() == [4294967295, 2147483648]


def test_crc32c_rows_on_the_cpu_runs_the_plain_version():
    rows = _rand(_rng(3), (4, 300))
    trk.reset_launches()
    got = trk.crc32c_rows(rows)
    assert np.array_equal(got.numpy(),
                          trk.crc32c_rows_plain(torch.from_numpy(rows)))
    assert trk.crc32c_rows(np.zeros((0, 5), np.uint8)).shape == (0,)
    assert trk.launches["crc32c_rows"] == 0
    with pytest.raises(ValueError):
        trk.crc32c_rows(np.zeros(8, np.uint8))


def test_crc_kernel_operators_are_powers_of_two_zero_advances():
    """The words the kernel folds with: row j advances through 2^j zero
    bytes, checked against the host's operator at a few powers."""
    words = trk.crc_zpow_words()
    assert words.shape == (trk.CRC_ZPOW, 32) and words.dtype == np.uint32
    for j in (0, 3, 8, 16, 20):
        assert tuple(int(w) for w in words[j]) == \
            ecutil.crc32c_zeros_op(1 << j)


@pytest.mark.parametrize("k,m", [(2, 1), (4, 2), (6, 3)])
@pytest.mark.parametrize("n", [64, 1000, 4096])
def test_gf_encode_with_crc_matches_jax(k, m, n):
    codec_ = RSCodec(k, m, device="cpu")
    data = _rand(_rng(k * 1000 + n), (k, n))
    parity, crcs = trk.gf_encode_with_crc(codec_.parity_mat, data)
    jpar, jcrcs = jrk.gf_encode_with_crc(codec_.parity_mat, data)
    assert np.array_equal(parity.numpy(), np.asarray(jpar))
    assert crcs.dtype == torch.int64 and crcs.shape == (k + m,)
    assert np.array_equal(crcs.numpy(), np.asarray(jcrcs).astype(np.int64))


@pytest.mark.parametrize("device", ["cpu", "numpy"])
@pytest.mark.parametrize("k,m", [(2, 1), (4, 2), (6, 3)])
@pytest.mark.parametrize("n", [64, 1000, 4096])
def test_encode_with_crc_bitwise(device, k, m, n):
    """The cases of tests/test_zero_copy.py: the SAME parity as the host
    reference and the SAME seed-free row crcs as a host loop over
    concat(data, parity), and the JAX codec's answer."""
    codec_ = RSCodec(k, m, device=device)
    data = _rand(_rng(k * 1000 + n), (k, n))
    parity, crcs = codec_.encode_with_crc(data)
    ref = codec_.encode_host(data)
    assert np.array_equal(parity, ref)
    rows = np.concatenate([data, ref], axis=0)
    assert crcs.dtype == np.uint32
    assert [int(c) for c in crcs] == [ecutil.crc32c(0, r) for r in rows]
    jpar, jcrcs = JaxRSCodec(k, m).encode_with_crc(data)
    assert np.array_equal(parity, jpar) and np.array_equal(crcs, jcrcs)


def test_append_crcs_matches_append():
    rng = _rng(17)
    h_ref, h_dev, h_jax = (ecutil.HashInfo(3), ecutil.HashInfo(3),
                           jecutil.HashInfo(3))
    old = 0
    for nbytes in (512, 64, 1 << 14, 33):
        chunks = {s: _rand(rng, nbytes) for s in range(3)}
        h_ref.append(old, chunks)
        h_jax.append(old, chunks)
        h_dev.append_crcs(old, {s: ecutil.crc32c(0, c)
                                for s, c in chunks.items()}, nbytes)
        old += nbytes
    assert h_ref.cumulative_shard_hashes == h_dev.cumulative_shard_hashes \
        == h_jax.cumulative_shard_hashes
    assert h_ref.total_chunk_size == h_dev.total_chunk_size \
        == h_jax.total_chunk_size


@pytest.mark.parametrize("device", ["cpu", "numpy"])
def test_hinfo_append_matches_jax_device_path(device):
    """``hinfo_append`` with a tensor codec checksums every appended shard
    in one ``crc32c_rows`` call; the running hashes equal the JAX
    package's fused path and the pure host append."""
    ec = _port_ec(k="4", m="2", technique="reed_sol_van", device=device)
    jec = _jax_ec(k="4", m="2", technique="reed_sol_van", device="jax")
    assert (ec.device_codec(4096 * 6) is not None) == (device == "cpu")
    rng = _rng(23)
    h_ref, h_dev, h_jax = (ecutil.HashInfo(6), ecutil.HashInfo(6),
                           jecutil.HashInfo(6))
    old = 0
    for nbytes in (4096, 512, 129):
        chunks = {s: _rand(rng, nbytes) for s in range(6)}
        h_ref.append(old, chunks)
        ecutil.hinfo_append(h_dev, old, chunks, ec_impl=ec)
        jecutil.hinfo_append(h_jax, old, chunks, ec_impl=jec)
        old += nbytes
    assert h_dev.to_dict() == h_ref.to_dict() == h_jax.to_dict()


# -- the repair legs' GF products ----------------------------------------------

@pytest.mark.parametrize("r", [1, 2, 3])
@pytest.mark.parametrize("n", [1, 1000, 4096])
@pytest.mark.parametrize("with_acc", [False, True])
def test_scale_accumulate_matches_jax(r, n, with_acc):
    rng = _rng(r * 7 + n)
    mat, data = _rand(rng, (r, 1)), _rand(rng, (1, n))
    acc = _rand(rng, (r, n)) if with_acc else None
    want = np.asarray(jcodec.scale_accumulate_device(mat, data, acc))
    assert np.array_equal(jcodec.scale_accumulate_host(mat, data, acc),
                          want)
    got = codec.scale_accumulate_device(
        torch.from_numpy(mat), torch.from_numpy(data),
        None if acc is None else torch.from_numpy(acc))
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)
    assert np.array_equal(codec.scale_accumulate_host(mat, data, acc), want)


@pytest.mark.parametrize("rows,depth", [(1, 2), (1, 4), (2, 4), (4, 4),
                                        (3, 5)])
@pytest.mark.parametrize("n", [1, 1000, 4096])
def test_gf_inner_product_matches_jax(rows, depth, n):
    rng = _rng(rows * 100 + depth * 10 + n)
    mat, data = _rand(rng, (rows, depth)), _rand(rng, (depth, n))
    want = np.asarray(jcodec.gf_inner_product_device(mat, data))
    assert np.array_equal(jcodec.gf_inner_product_host(mat, data), want)
    got = codec.gf_inner_product_device(torch.from_numpy(mat),
                                        torch.from_numpy(data))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(codec.gf_inner_product_host(mat, data), want)


# -- chain repair --------------------------------------------------------------

# how a repair leg is called: the exact host GF math ("host", device
# numpy), the plain version called synchronously ("sync", device cpu with
# no pipeline), or one dispatch through a cpu pipeline ("pipeline")
ROUTES = ["host", "sync", "pipeline"]


def _route(route, name):
    if route == "pipeline":
        return CodecPipeline(depth=4, name=name), "cpu"
    return None, "numpy" if route == "host" else "cpu"


def _encoded_objects(ec, sinfo, n_objects, seed):
    rng = _rng(seed)
    bufs = [_rand(rng, sinfo.stripe_width * (1 + i % 3))
            for i in range(n_objects)]
    return ecutil.encode_many(sinfo, ec, bufs)


@pytest.mark.parametrize("lost", [(1,), (0, 5), (2, 3)])
@pytest.mark.parametrize("route", ROUTES)
def test_partial_sum_chain_matches_jax(lost, route):
    """Three objects repaired by a hop chain over the four survivors the
    code picks: the port's hops (host GF math, the plain version called
    synchronously, or one dispatch each through a cpu pipeline) equal the
    JAX package's host hops at every hop, and the last hop's sums are the
    lost shards."""
    ec = _port_ec(k=str(K), m=str(M), device="cpu")
    jec = _jax_ec(k=str(K), m=str(M), device="numpy")
    sinfo = ecutil.StripeInfo(K, CHUNK)
    objs = _encoded_objects(ec, sinfo, 3, seed=sum(lost))
    sources = sorted(set(range(K + M)) - set(lost))[:K]
    coeffs, rows = ec.partial_sum_coefficients(set(lost), sources)
    assert (coeffs, rows) == jec.partial_sum_coefficients(set(lost),
                                                          sources)
    pl, device = _route(route, "t.chain")
    acc = jacc = None
    try:
        for src in sources:
            stream = np.concatenate([o[src] for o in objs])
            acc = ecutil.partial_sum_accumulate(
                coeffs[src], stream, acc, pipeline=pl, device=device)
            jacc = jecutil.partial_sum_accumulate(coeffs[src],
                                                  stream.tobytes(), jacc)
            assert acc == jacc
    finally:
        if pl is not None:
            pl.close()
    for r, e in enumerate(rows):
        assert acc[r] == np.concatenate([o[e] for o in objs]).tobytes()


def test_partial_sum_accumulate_host_path():
    """The unit case of tests/test_chain_repair.py, against the JAX hop."""
    rng = _rng(1)
    stream = _rand(rng, 1024).tobytes()
    prev = [_rand(rng, 1024).tobytes() for _ in range(2)]
    for acc in (prev, None):
        out = ecutil.partial_sum_accumulate([3, 7], stream, acc,
                                            device="numpy")
        assert out == jecutil.partial_sum_accumulate([3, 7], stream, acc)
    pl = CodecPipeline(depth=1, name="t.hop")
    try:
        assert ecutil.partial_sum_accumulate(
            [3, 7], stream, prev, pipeline=pl,
            device="cpu") == jecutil.partial_sum_accumulate([3, 7], stream,
                                                            prev)
        assert pl.perf.get("completed") == 1
    finally:
        pl.close()


# -- regenerating repair (pm_regen) --------------------------------------------

REGEN = [("mbr", "3", "2", "4"), ("msr", "3", "2", "4"),
         ("mbr", "4", "3", "5"), ("msr", "4", "3", "6")]


@pytest.mark.parametrize("mode,k,m,d", REGEN)
def test_pm_regen_matrices_match_jax(mode, k, m, d):
    profile = {"k": k, "m": m, "d": d, "mode": mode}
    ec = _port_ec("pm_regen", **profile, device="cpu")
    jec = _jax_ec("pm_regen", **profile, device="numpy")
    assert np.array_equal(ec._psi, jec._psi)
    assert np.array_equal(ec._enc, jec._enc)
    n = int(k) + int(m)
    for lost in range(n):
        assert np.array_equal(ec.repair_projection(lost),
                              jec.repair_projection(lost))
        helpers = [c for c in range(n) if c != lost][:int(d)]
        assert np.array_equal(ec.repair_combine(lost, helpers),
                              jec.repair_combine(lost, helpers))


@pytest.mark.parametrize("mode,k,m,d", REGEN)
@pytest.mark.parametrize("route", ROUTES)
def test_regen_repair_matches_jax(mode, k, m, d, route):
    """Every chunk repaired from d helpers' beta-streams: each helper's
    ``regen_project`` and the newcomer's ``regen_combine`` equal the JAX
    package's, and the rebuilt chunk equals the stored one."""
    profile = {"k": k, "m": m, "d": d, "mode": mode}
    ec = _port_ec("pm_regen", **profile, device="cpu")
    jec = _jax_ec("pm_regen", **profile, device="numpy")
    n, alpha = ec.get_chunk_count(), ec.get_sub_chunk_count()
    data = _rand(_rng(int(d)), 3 * ec.get_chunk_size(1) * int(k)).tobytes()
    enc = ec.encode(set(range(n)), data)
    jenc = jec.encode(set(range(n)), data)
    for c in range(n):
        assert np.array_equal(enc[c], np.asarray(jenc[c]))
    pl, device = _route(route, "t.regen")
    try:
        for lost in range(n):
            helpers = ec.minimum_to_repair(
                lost, ec.d, {c: 1 for c in range(n) if c != lost})
            assert helpers == jec.minimum_to_repair(
                lost, jec.d, {c: 1 for c in range(n) if c != lost})
            proj = ec.repair_projection(lost).tobytes()
            streams = []
            for h in helpers:
                beta = ecutil.regen_project(proj, enc[h], alpha,
                                            pipeline=pl, device=device)
                assert beta == jecutil.regen_project(proj, enc[h], alpha)
                assert len(beta) * alpha == len(enc[h])
                streams.append(beta)
            comb = ec.repair_combine(lost, helpers).tobytes()
            out = ecutil.regen_combine(comb, streams, alpha, pipeline=pl,
                                       device=device)
            assert out == jecutil.regen_combine(comb, streams, alpha)
            assert out == enc[lost].tobytes()
    finally:
        if pl is not None:
            pl.close()


def test_regen_project_rejects_a_ragged_chunk():
    with pytest.raises(ValueError, match="sub-chunks"):
        ecutil.regen_project(b"\x01\x02", np.zeros(5, np.uint8), 2)


# -- recovery waves ------------------------------------------------------------

def _wave(ec, sinfo, seed, want_sets):
    objs = _encoded_objects(ec, sinfo, 6, seed)
    n = ec.get_chunk_count()
    batches = []
    for i, chunks in enumerate(objs):
        want = want_sets[i % len(want_sets)]
        avail = sorted(ec.minimum_to_decode(set(want),
                                            set(range(n)) - set(want)))
        batches.append(({c: chunks[c] for c in avail}, set(want)))
    return objs, batches


@pytest.mark.parametrize("depth", [None, 1, 4])
@pytest.mark.parametrize("want_sets", [[{1}], [{0}, {1}], [{0, 5}, {3}]])
def test_decode_shards_many_matches_jax(depth, want_sets):
    """The recovery wave of tests/test_pipeline.py: the port's answer (no
    pipeline, or a cpu pipeline at depth 1 or 4) equals the JAX package's
    synchronous and pipelined answers and the original shards."""
    ec = _port_ec(k=str(K), m=str(M), technique="reed_sol_van",
                  device="cpu")
    jec = _jax_ec(k=str(K), m=str(M), technique="reed_sol_van",
                  device="jax")
    sinfo = ecutil.StripeInfo(K, CHUNK)
    objs, batches = _wave(ec, sinfo, len(want_sets), want_sets)
    pl = None if depth is None else CodecPipeline(depth=depth, name="wave")
    jpl = JaxPipeline(depth=4, name="jwave")
    try:
        got = ecutil.decode_shards_many(sinfo, ec, batches, pipeline=pl)
        want = jecutil.decode_shards_many(sinfo, jec, batches)
        jpiped = jecutil.decode_shards_many(sinfo, jec, batches,
                                            pipeline=jpl)
        if pl is not None:
            assert pl.perf.get("completed") == len(
                {(frozenset(a), frozenset(w)) for a, w in batches})
    finally:
        jpl.close()
        if pl is not None:
            pl.close()
    for obj, g, w, jp, (_avail, wanted) in zip(objs, got, want, jpiped,
                                               batches):
        assert sorted(g) == sorted(w) == sorted(jp) == sorted(wanted)
        for c in g:
            assert np.array_equal(np.asarray(g[c]), np.asarray(w[c]))
            assert np.array_equal(np.asarray(g[c]), np.asarray(jp[c]))
            assert np.array_equal(np.asarray(g[c]), obj[c])


def test_decode_shards_many_numpy_route_ignores_the_pipeline():
    ec = _port_ec(k=str(K), m=str(M), device="numpy")
    sinfo = ecutil.StripeInfo(K, CHUNK)
    objs, batches = _wave(ec, sinfo, 5, [{2}])
    pl = CodecPipeline(depth=4, name="t.numpy")
    try:
        got = ecutil.decode_shards_many(sinfo, ec, batches, pipeline=pl)
        assert pl.perf.get("submitted") == 0
    finally:
        pl.close()
    for obj, g in zip(objs, got):
        assert np.array_equal(g[2], obj[2])


def test_decode_shards_matches_jax():
    ec = _port_ec(k=str(K), m=str(M), device="cpu")
    jec = _jax_ec(k=str(K), m=str(M), device="numpy")
    sinfo = ecutil.StripeInfo(K, CHUNK)
    obj = _encoded_objects(ec, sinfo, 1, 9)[0]
    avail = {c: obj[c] for c in (1, 2, 4, 5)}
    got = ecutil.decode_shards(sinfo, ec, avail, {0, 3})
    want = jecutil.decode_shards(sinfo, jec, avail, {0, 3})
    for c in (0, 3):
        assert np.array_equal(got[c], np.asarray(want[c]))
        assert np.array_equal(got[c], obj[c])


# -- a failure on the card fails the repair leg --------------------------------

def _faulty_pipeline(name):
    pl = CodecPipeline(depth=4, name=name)
    pl.inject_faults(FaultInjector(FaultPlan(
        seed=5, device=DeviceFaults(dispatch_fail_prob=1.0))))
    return pl


@pytest.mark.parametrize("leg", ["partial_sum", "regen_project",
                                 "regen_combine", "decode_shards_many"])
def test_dispatch_fault_fails_the_repair_leg(monkeypatch, leg):
    """An injected dispatch fault fails the leg's future and so the call;
    the host GF math that ``pipeline=None`` would run is never reached."""
    def no_host(*_a, **_k):
        raise AssertionError("a repair leg was served on the host")
    for name in ("scale_accumulate_host", "gf_inner_product_host"):
        monkeypatch.setattr(codec, name, no_host)
    pl = _faulty_pipeline(f"t.fault.{leg}")
    rng = _rng(11)
    try:
        with pytest.raises(InjectedFault):
            if leg == "partial_sum":
                ecutil.partial_sum_accumulate(
                    [3, 7], _rand(rng, 512), [_rand(rng, 512)] * 2,
                    pipeline=pl, device="cpu")
            elif leg == "regen_project":
                ecutil.regen_project(b"\x01\x02", _rand(rng, 512), 2,
                                     pipeline=pl, device="cpu")
            elif leg == "regen_combine":
                ecutil.regen_combine(bytes(range(1, 9)),
                                     [_rand(rng, 256) for _ in range(4)], 2,
                                     pipeline=pl, device="cpu")
            else:
                ec = _port_ec(k=str(K), m=str(M), device="cpu")
                sinfo = ecutil.StripeInfo(K, CHUNK)
                _objs, batches = _wave(ec, sinfo, 3, [{1}])
                ecutil.decode_shards_many(sinfo, ec, batches, pipeline=pl)
        assert pl.perf.get("errors") >= 1
        assert pl.perf.get("completed") == 0
    finally:
        pl.close()


def test_kernel_fault_in_a_hop_fails_the_hop(monkeypatch):
    """A fault raised by the apply itself (as a failed launch on the card
    would) surfaces from the hop; nothing answers on the host."""
    def broken(*_a, **_k):
        raise RuntimeError("gf_apply failed: cudaError_t 700")
    monkeypatch.setattr(trk, "gf_apply", broken)
    monkeypatch.setattr(codec, "scale_accumulate_host",
                        lambda *a, **k: pytest.fail("served on the host"))
    pl = CodecPipeline(depth=0, name="t.kernel_fault")
    try:
        with pytest.raises(RuntimeError, match="cudaError_t 700"):
            ecutil.partial_sum_accumulate([5], _rand(_rng(2), 64), None,
                                          pipeline=pl, device="cpu")
        assert pl.perf.get("errors") == 1
    finally:
        pl.close()
