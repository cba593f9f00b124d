"""The port's jerasure plugin against the JAX package's.

Every technique (the w=8 byte-codec ones on ``gf_apply``, the bitmatrix
and w=16/32 ones on ``xor_apply``), with and without a chunk ``mapping``,
runs with ``device=cpu`` (the plain PyTorch versions) and ``device=numpy``
(host) and must give the JAX plugin's shards, decodes,
``minimum_to_decode`` answers and envelope errors; ECUtil through
liber8tion and w=16 must give the JAX package's shards and HashInfo.
Everything is exact integer arithmetic: all comparisons are bitwise.
"""
import io
from contextlib import redirect_stdout

import numpy as np
import pytest

from ceph_tpu.backend import ecutil as jecutil
from ceph_tpu.bench import ec_bench as jax_ec_bench
from ceph_tpu.plugins import ErasureCodePluginRegistry as JaxRegistry
from ceph_tpu_torch import convert
from ceph_tpu_torch.backend import ecutil
from ceph_tpu_torch.bench import ec_bench
from ceph_tpu_torch.ops import rs_kernels
from ceph_tpu_torch.plugins.plugin_jerasure import (
    ErasureCodeJerasureBitmatrix, ErasureCodeJerasureCompat)
from ceph_tpu_torch.plugins.registry import ErasureCodePluginRegistry

PROFILES = {
    "liberation": {"technique": "liberation", "k": "4", "w": "7",
                   "packetsize": "8"},
    "liberation-default-w": {"technique": "liberation", "k": "3",
                             "packetsize": "4"},
    "blaum_roth": {"technique": "blaum_roth", "k": "4", "w": "6",
                   "packetsize": "8"},
    "blaum_roth-w7": {"technique": "blaum_roth", "k": "3", "w": "7",
                      "packetsize": "4"},
    "liber8tion": {"technique": "liber8tion", "k": "6", "packetsize": "8"},
    "liber8tion-mapping": {"technique": "liber8tion", "k": "2",
                           "packetsize": "4", "mapping": "D_DC"},
    "reed_sol_van-w8": {"technique": "reed_sol_van", "k": "4", "m": "2"},
    "reed_sol_van-w8-mapping": {"technique": "reed_sol_van", "k": "3",
                                "m": "2", "mapping": "_DD_D"},
    "reed_sol_van-w16": {"technique": "reed_sol_van", "k": "4", "m": "3",
                         "w": "16", "packetsize": "8"},
    "reed_sol_van-w32": {"technique": "reed_sol_van", "k": "3", "m": "2",
                         "w": "32", "packetsize": "4"},
    "reed_sol_van-w16-mapping": {"technique": "reed_sol_van", "k": "2",
                                 "m": "2", "w": "16", "packetsize": "4",
                                 "mapping": "_DD_"},
    "reed_sol_r6_op-w8": {"technique": "reed_sol_r6_op", "k": "4",
                          "m": "5"},
    "reed_sol_r6_op-w16": {"technique": "reed_sol_r6_op", "k": "4",
                           "m": "5", "w": "16", "packetsize": "8"},
    "cauchy_orig-w8": {"technique": "cauchy_orig", "k": "5", "m": "3"},
    "cauchy_good-w16": {"technique": "cauchy_good", "k": "3", "m": "2",
                        "w": "16", "packetsize": "4"},
    "cauchy_orig-w32": {"technique": "cauchy_orig", "k": "2", "m": "2",
                        "w": "32", "packetsize": "4"},
}


def _pair(profile, device):
    ec = ErasureCodePluginRegistry().factory("jerasure", "",
                                             profile | {"device": device})
    jec = JaxRegistry().factory("jerasure", "", profile | {"device": "numpy"})
    return ec, jec


def _payload(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


@pytest.mark.parametrize("device", ["cpu", "numpy"])
@pytest.mark.parametrize("name", sorted(PROFILES))
def test_plugin_matches_jax(name, device):
    profile = PROFILES[name]
    ec, jec = _pair(profile, device)
    assert type(ec).__name__ == type(jec).__name__
    n, k = ec.get_chunk_count(), ec.get_data_chunk_count()
    assert (n, k) == (jec.get_chunk_count(), jec.get_data_chunk_count())
    assert ec.get_alignment() == jec.get_alignment()
    assert ec.get_chunk_mapping() == jec.get_chunk_mapping()
    assert ec.get_profile()["technique"] == jec.get_profile()["technique"]
    for size in (1, 3000, 20011):
        assert ec.get_chunk_size(size) == jec.get_chunk_size(size)
    data = _payload(9000, n * 10 + k)
    enc = ec.encode(set(range(n)), data)
    jenc = jec.encode(set(range(n)), data)
    assert sorted(enc) == sorted(jenc)
    for i in enc:
        assert np.array_equal(enc[i], np.asarray(jenc[i])), i
    m = n - k
    for lost in ({0}, {n - 1}, set(range(min(m, 2))), {1, n - 1}):
        if len(lost) > m:
            continue
        avail = {i: v for i, v in enc.items() if i not in lost}
        if name == "blaum_roth-w7" and len(lost) == 2 and max(lost) < k:
            # the w=7 compat hazard: every (data, data) pair is undecodable
            for plugin in (ec, jec):
                with pytest.raises(np.linalg.LinAlgError):
                    plugin.decode(set(range(n)), avail)
            continue
        got = ec.decode(set(range(n)), avail)
        want = jec.decode(set(range(n)), avail)
        for i in range(n):
            assert np.array_equal(got[i], np.asarray(want[i])), (lost, i)
            assert np.array_equal(got[i], enc[i]), (lost, i)
        assert ec.decode_concat(avail)[:len(data)] == data
        assert ec.minimum_to_decode(set(lost), set(avail)) == \
            jec.minimum_to_decode(set(lost), set(avail))
        costs = {c: (c * 7) % 5 for c in avail}
        assert ec.minimum_to_decode_with_cost(set(lost), costs) == \
            jec.minimum_to_decode_with_cost(set(lost), costs)


@pytest.mark.parametrize("name", ["liber8tion", "reed_sol_van-w16",
                                  "cauchy_orig-w32", "reed_sol_van-w8"])
def test_cpu_plugin_matches_jax_device_path(name):
    """The port's plain PyTorch path against the JAX plugin on JAX-CPU
    (XLA), not only its numpy path."""
    profile = PROFILES[name]
    ec = ErasureCodePluginRegistry().factory("jerasure", "",
                                             profile | {"device": "cpu"})
    jec = JaxRegistry().factory("jerasure", "", profile | {"device": "jax"})
    n = ec.get_chunk_count()
    data = _payload(5000, n)
    enc, jenc = ec.encode(set(range(n)), data), jec.encode(set(range(n)), data)
    for i in range(n):
        assert np.array_equal(enc[i], np.asarray(jenc[i]))
    avail = {i: v for i, v in enc.items() if i not in (0, n - 1)}
    got = ec.decode(set(range(n)), avail)
    want = jec.decode(set(range(n)), avail)
    for i in range(n):
        assert np.array_equal(got[i], np.asarray(want[i]))


def test_bitmatrix_plugin_runs_xor_apply_on_a_tensor_device():
    """device=cpu goes through rs_kernels.xor_apply (its plain version, so
    no launch is counted); device=numpy never reaches it."""
    calls = []
    orig = rs_kernels.xor_apply

    def spy(W, packets):
        calls.append((tuple(W.shape), tuple(packets.shape), W.device.type))
        return orig(W, packets)

    rs_kernels.xor_apply = spy
    try:
        before = dict(rs_kernels.launches)
        cpu, _ = _pair(PROFILES["liber8tion"], "cpu")
        enc = cpu.encode(set(range(8)), _payload(4000, 1))
        cpu.decode(set(range(8)), {i: enc[i] for i in range(2, 8)})
        p = cpu.get_chunk_size(4000) // 8
        assert calls == [((16, 48), (48, p), "cpu")] * 2
        host, _ = _pair(PROFILES["liber8tion"], "numpy")
        host.encode(set(range(8)), _payload(4000, 1))
        assert len(calls) == 2
        assert rs_kernels.launches == before
    finally:
        rs_kernels.xor_apply = orig
    # the coding matrix is uploaded once per device
    assert list(cpu._coding_dev) == [cpu.tensor_device()]


@pytest.mark.parametrize("profile", [
    {"technique": "liberation", "k": "4", "m": "3"},
    {"technique": "liberation", "k": "4", "w": "6"},
    {"technique": "liberation", "k": "8", "w": "7"},
    {"technique": "liberation", "k": "4", "w": "7", "packetsize": "6"},
    {"technique": "liberation", "k": "4", "w": "7", "packetsize": "-4"},
    {"technique": "blaum_roth", "k": "4", "w": "5"},
    {"technique": "liber8tion", "k": "9"},
    {"technique": "reed_sol_van", "k": "4", "m": "2", "w": "12"},
    {"technique": "cauchy_good", "k": "1", "m": "2", "w": "16"},
    {"technique": "reed_sol_van", "k": "4", "m": "2", "w": "16",
     "mapping": "DD_"},
    {"technique": "liber8tion", "k": "4", "mapping": "DDD_"},
    {"technique": "no_such_technique"},
    {"technique": "liber8tion", "k": "x"},
    {"technique": "liber8tion", "device": "gpu"},
])
def test_envelope_errors_match_jax(profile):
    with pytest.raises(ValueError) as want:
        JaxRegistry().factory("jerasure", "",
                              {"device": "numpy"} | profile)
    with pytest.raises(ValueError) as got:
        ErasureCodePluginRegistry().factory("jerasure", "",
                                            {"device": "numpy"} | profile)
    if "device" not in profile:              # the two name other devices
        assert str(got.value) == str(want.value)


def test_defaults_and_forced_parameters_match_jax():
    for profile in ({"technique": "liberation", "k": "2"},
                    {"technique": "blaum_roth"},
                    {"technique": "liber8tion", "k": "4", "w": "16",
                     "m": "5"},
                    {"technique": "reed_sol_van", "w": "16"},
                    {"technique": "reed_sol_r6_op", "m": "7", "w": "32"},
                    {}):
        ec, jec = _pair(profile, "numpy")
        assert type(ec).__name__ == type(jec).__name__
        for attr in ("k", "m", "w", "packetsize"):
            if hasattr(jec, attr):
                assert getattr(ec, attr) == getattr(jec, attr), attr
        if hasattr(jec, "coding"):
            assert np.array_equal(ec.coding, jec.coding)
        # routing keys differ by design (cuda|cpu|numpy|auto here); the
        # JAX codec's kernel variant has no counterpart
        keys = set(jec.get_profile()) - {"device", "jax-threshold",
                                         "variant"}
        for key in keys:
            assert ec.get_profile().get(key) == jec.get_profile()[key], key
    assert isinstance(_pair({"technique": "cauchy_good"}, "numpy")[0],
                      ErasureCodeJerasureCompat)
    assert isinstance(_pair({"technique": "cauchy_good", "w": "32"},
                            "numpy")[0], ErasureCodeJerasureBitmatrix)


def test_device_routing_defaults_to_cuda():
    reg = ErasureCodePluginRegistry()
    for profile in ({"technique": "liber8tion"},
                    {"technique": "reed_sol_van", "w": "16"},
                    {"technique": "reed_sol_van"}):
        ec = reg.factory("jerasure", "", profile)
        assert ec.get_profile()["device"] == "cuda"
        assert ec.use_device(1)
    with pytest.raises(ValueError, match="cuda"):
        reg.factory("jerasure", "", {"technique": "liber8tion",
                                     "device": "jax"})
    auto = reg.factory("jerasure", "", {"technique": "liber8tion",
                                        "device": "auto",
                                        "jax-threshold": "65536"})
    assert not auto.use_device(65535) and auto.use_device(65536)
    data = _payload(3000, 5)
    host, _ = _pair({"technique": "liber8tion"}, "numpy")
    assert all(np.array_equal(v, host.encode(set(range(4)), data)[i])
               for i, v in auto.encode(set(range(4)), data).items())


# -- ECUtil through the bitmatrix codes ------------------------------------------

@pytest.mark.parametrize("device", ["cpu", "numpy"])
@pytest.mark.parametrize("profile,lost_sets", [
    ({"technique": "liber8tion", "k": "4", "packetsize": "16"},
     ([0, 5], [2, 3])),
    ({"technique": "reed_sol_van", "k": "4", "m": "3", "w": "16",
      "packetsize": "8"}, ([0, 5], [1, 2, 6])),
])
def test_ecutil_through_jerasure_matches_jax(profile, lost_sets, device):
    ec, _ = _pair(profile, device)
    jec = JaxRegistry().factory("jerasure", "", profile | {"device": "jax"})
    k, n = ec.get_data_chunk_count(), ec.get_chunk_count()
    unit = 64                        # rounds up to the plugin's alignment
    sinfo = ecutil.StripeInfo(k, ec.get_chunk_size(k * unit))
    jsinfo = jecutil.StripeInfo(k, jec.get_chunk_size(k * unit))
    assert sinfo.chunk_size == jsinfo.chunk_size == ec.get_alignment()
    rng = np.random.default_rng(k + n)
    bufs = [rng.integers(0, 256, sinfo.stripe_width * s, dtype=np.uint8)
            for s in (1, 3, 2)]
    got = ecutil.encode_many(sinfo, ec, bufs)
    want = jecutil.encode_many(jsinfo, jec, bufs)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for c in g:
            assert np.array_equal(g[c], np.asarray(w[c])), c
    h, jh = ecutil.HashInfo(n), jecutil.HashInfo(n)
    for shards in got + got:
        ecutil.hinfo_append(h, h.get_total_chunk_size(), shards, ec)
        jecutil.hinfo_append(jh, jh.get_total_chunk_size(), shards, jec)
    assert h.to_dict() == jh.to_dict()
    for lost in lost_sets:
        batches = [{c: v for c, v in g.items() if c not in lost} for g in got]
        dec = ecutil.decode_many(sinfo, ec, batches)
        assert dec == jecutil.decode_many(jsinfo, jec, batches)
        assert dec == [b.tobytes() for b in bufs]


# -- convert ---------------------------------------------------------------------

@pytest.mark.parametrize("technique,k,m,w", [
    ("liberation", 4, 2, 7), ("blaum_roth", 4, 2, 6), ("liber8tion", 5, 2, 8),
    ("reed_sol_van", 4, 3, 16), ("cauchy_good", 3, 2, 32),
])
def test_bitmatrix_from_reference(technique, k, m, w):
    jec = JaxRegistry().factory("jerasure", "", {
        "technique": technique, "k": str(k), "m": str(m), "w": str(w),
        "packetsize": "8", "device": "numpy"})
    ec = convert.bitmatrix_from_reference(jec.coding, technique, k, m, w,
                                          packetsize=8, device="cpu")
    assert isinstance(ec, ErasureCodeJerasureBitmatrix)
    assert np.array_equal(ec.coding, jec.coding) and ec.device == "cpu"
    data = _payload(4000, k)
    n = k + m
    enc, jenc = ec.encode(set(range(n)), data), jec.encode(set(range(n)), data)
    assert all(np.array_equal(enc[i], jenc[i]) for i in range(n))
    flipped = jec.coding.copy()
    flipped[1, 2] ^= 1
    with pytest.raises(ValueError, match="differs"):
        convert.bitmatrix_from_reference(flipped, technique, k, m, w)
    with pytest.raises(ValueError, match="differs"):
        convert.bitmatrix_from_reference(jec.coding[:-1], technique, k, m, w)


# -- ec_bench over the bitmatrix codes -------------------------------------------

@pytest.mark.parametrize("extra", [
    [],
    ["--workload", "decode", "--erased", "0", "--erased", "5"],
    ["--workload", "decode", "--erasures", "2", "-E", "exhaustive"],
])
@pytest.mark.parametrize("params", [
    ["-P", "technique=liber8tion", "-P", "k=4", "-P", "packetsize=16"],
    ["-P", "technique=reed_sol_van", "-P", "k=4", "-P", "m=2", "-P", "w=16",
     "-P", "packetsize=8"],
])
def test_ec_bench_bitmatrix_matches_jax_cli(params, extra):
    argv = ["--plugin", "jerasure", "--size", "8192", "--iterations", "2",
            "-P", "device=cpu"] + params + extra
    out = []
    for main, dev in ((ec_bench.main, "device=cpu"),
                      (jax_ec_bench.main, "device=numpy")):
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = main([a.replace("device=cpu", dev) for a in argv])
        assert rc == 0
        out.append(buf.getvalue().strip().splitlines())
    assert len(out[0]) == 1 and out[0][0].split("\t")[1] == "16"
    assert out[0][0].split("\t")[1] == out[1][0].split("\t")[1]
