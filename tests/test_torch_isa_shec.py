"""The port's isa and shec plugins against the JAX package's.

Both run on the ``gf_apply`` kernel on the card; here ``device=cpu``
(its plain PyTorch version) and ``device=numpy`` (host) must give the JAX
plugins' shards, decodes, ``minimum_to_decode`` answers (shec: the decode
plan search, with and without cost) and envelope errors, bitwise.
"""
import itertools

import numpy as np
import pytest

from ceph_tpu.backend import ecutil as jecutil
from ceph_tpu.plugins import ErasureCodePluginRegistry as JaxRegistry
from ceph_tpu.plugins.plugin_shec import shec_coding_matrix as jshec_matrix
from ceph_tpu_torch.backend import ecutil
from ceph_tpu_torch.ops import rs_kernels
from ceph_tpu_torch.plugins.plugin_shec import (MULTIPLE, PLAN_CACHE_SIZE,
                                                SINGLE, shec_coding_matrix)
from ceph_tpu_torch.plugins.registry import ErasureCodePluginRegistry


def _pair(name, profile, device, jax_device="numpy"):
    ec = ErasureCodePluginRegistry().factory(name, "",
                                             profile | {"device": device})
    jec = JaxRegistry().factory(name, "", profile | {"device": jax_device})
    return ec, jec


def _payload(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


def _assert_round_trips_match(ec, jec, data, lost_sets):
    n = ec.get_chunk_count()
    enc = ec.encode(set(range(n)), data)
    jenc = jec.encode(set(range(n)), data)
    for i in range(n):
        assert np.array_equal(enc[i], np.asarray(jenc[i])), i
    for lost in lost_sets:
        avail = {i: v for i, v in enc.items() if i not in lost}
        got = ec.decode(set(range(n)), avail)
        want = jec.decode(set(range(n)), avail)
        for i in range(n):
            assert np.array_equal(got[i], np.asarray(want[i])), (lost, i)
            assert np.array_equal(got[i], enc[i]), (lost, i)
        assert ec.decode_concat(avail)[:len(data)] == data


# -- isa -------------------------------------------------------------------------

@pytest.mark.parametrize("device", ["cpu", "numpy"])
@pytest.mark.parametrize("profile", [
    {"k": "8", "m": "4"},
    {"k": "8", "m": "4", "technique": "cauchy"},
    {"k": "21", "m": "4", "technique": "reed_sol_van"},
    {"k": "22", "m": "4", "technique": "cauchy"},
    {"k": "4", "m": "2", "mapping": "_DD_DD"},
    {},
])
def test_isa_matches_jax(profile, device):
    ec, jec = _pair("isa", profile, device)
    n, k = ec.get_chunk_count(), ec.get_data_chunk_count()
    assert (n, k) == (jec.get_chunk_count(), jec.get_data_chunk_count())
    assert ec.get_profile()["technique"] == jec.get_profile()["technique"]
    assert np.array_equal(ec.codec.parity_mat, jec.codec.parity_mat)
    m = n - k
    _assert_round_trips_match(ec, jec, _payload(7000, n),
                              [{0}, set(range(m)), {1, n - 1}])
    avail = set(range(n)) - {0, n - 1}
    assert ec.minimum_to_decode({0}, avail) == \
        jec.minimum_to_decode({0}, avail)


def test_isa_cpu_matches_jax_device_path():
    ec, jec = _pair("isa", {"k": "8", "m": "4"}, "cpu", jax_device="jax")
    _assert_round_trips_match(ec, jec, _payload(9000, 1), [{0, 9}])


@pytest.mark.parametrize("profile", [
    {"k": "22", "m": "4"},
    {"k": "33", "m": "2"},
    {"k": "8", "m": "5"},
    {"k": "4", "m": "2", "technique": "liberation"},
    {"k": "4", "m": "2", "w": "16"},
    {"k": "1", "m": "2"},
    {"k": "4", "m": "2", "mapping": "DD_"},
])
def test_isa_envelope_errors_match_jax(profile):
    with pytest.raises(ValueError) as want:
        JaxRegistry().factory("isa", "", profile | {"device": "numpy"})
    with pytest.raises(ValueError) as got:
        ErasureCodePluginRegistry().factory("isa", "",
                                            profile | {"device": "numpy"})
    assert str(got.value) == str(want.value)


# -- shec ------------------------------------------------------------------------

@pytest.mark.parametrize("k,m,c", [(4, 3, 2), (6, 4, 2), (8, 4, 3),
                                   (4, 2, 2), (12, 8, 4), (5, 5, 1)])
def test_shec_matrix_matches_jax(k, m, c):
    for technique in (MULTIPLE, SINGLE):
        assert np.array_equal(shec_coding_matrix(k, m, c, technique),
                              jshec_matrix(k, m, c, technique))


@pytest.mark.parametrize("device", ["cpu", "numpy"])
@pytest.mark.parametrize("profile", [
    {"k": "4", "m": "3", "c": "2"},
    {"k": "8", "m": "4", "c": "3"},
    {"k": "6", "m": "3", "c": "2", "technique": "single"},
    {},
])
def test_shec_matches_jax(profile, device):
    ec, jec = _pair("shec", profile, device)
    n = ec.get_chunk_count()
    c = ec.c
    assert np.array_equal(ec.matrix, jec.matrix)
    assert ec.get_profile()["technique"] == jec.get_profile()["technique"]
    # every pattern of up to c losses (shec's durability promise)
    patterns = [set(p) for r in range(1, c + 1)
                for p in itertools.combinations(range(n), r)]
    _assert_round_trips_match(ec, jec, _payload(5000, n), patterns[::3])
    for lost in patterns:
        avail = set(range(n)) - lost
        assert ec.minimum_to_decode(lost, avail) == \
            jec.minimum_to_decode(lost, avail), lost
        costs = {i: (i * 5) % 3 for i in avail}
        assert ec.minimum_to_decode_with_cost(lost, costs) == \
            jec.minimum_to_decode_with_cost(lost, costs), lost
        # a partial want: one lost chunk and one surviving one
        want = {min(lost), max(avail)}
        assert ec.minimum_to_decode(want, avail) == \
            jec.minimum_to_decode(want, avail), want


def test_shec_cpu_matches_jax_device_path():
    ec, jec = _pair("shec", {"k": "8", "m": "4", "c": "3"}, "cpu",
                    jax_device="jax")
    _assert_round_trips_match(ec, jec, _payload(9000, 2),
                              [{0, 9}, {1, 2, 3}, {8, 10, 11}])


def test_shec_decode_failures_match_jax():
    ec, jec = _pair("shec", {"k": "4", "m": "3", "c": "2"}, "numpy")
    for plugin in (ec, jec):
        with pytest.raises(IOError):
            plugin.minimum_to_decode({0, 1, 2, 3}, {4, 5, 6})
        with pytest.raises(ValueError):
            plugin.minimum_to_decode({99}, {0, 1})


def test_shec_plan_cache_is_an_lru():
    ec, _ = _pair("shec", {"k": "4", "m": "3", "c": "2"}, "numpy")
    first = ec.minimum_to_decode({0}, {1, 2, 3, 4, 5, 6})
    assert len(ec._plan_cache) == 1
    assert ec.minimum_to_decode({0}, {1, 2, 3, 4, 5, 6}) == first
    assert len(ec._plan_cache) == 1
    assert PLAN_CACHE_SIZE == 2516


def test_shec_routing_and_coding_upload():
    reg = ErasureCodePluginRegistry()
    dflt = reg.factory("shec", "", {})
    assert dflt.device == "cuda" and dflt.use_device(1)
    for key in ("device-threshold", "jax-threshold"):
        auto = reg.factory("shec", "", {"device": "auto", key: "5000"})
        assert not auto.use_device(4999) and auto.use_device(5000)
    with pytest.raises(ValueError, match="cuda"):
        reg.factory("shec", "", {"device": "jax"})
    cpu = reg.factory("shec", "", {"device": "cpu"})
    before = dict(rs_kernels.launches)
    enc = cpu.encode(set(range(7)), _payload(3000, 4))
    cpu.decode({0}, {i: enc[i] for i in range(1, 7)})
    assert list(cpu._matrix_dev) == [cpu.tensor_device()]
    assert rs_kernels.launches == before     # plain versions launch nothing


@pytest.mark.parametrize("profile", [
    {"k": "0", "m": "3", "c": "2"},
    {"k": "4", "m": "0", "c": "2"},
    {"k": "4", "m": "3", "c": "0"},
    {"k": "4", "m": "2", "c": "3"},
    {"k": "13", "m": "3", "c": "2"},
    {"k": "12", "m": "9", "c": "2"},
    {"k": "3", "m": "4", "c": "2"},
    {"k": "4", "m": "3"},
    {"k": "4", "m": "3", "c": "2", "w": "16"},
    {"k": "4", "m": "3", "c": "2", "technique": "bogus"},
    {"k": "x", "m": "3", "c": "2"},
])
def test_shec_envelope_errors_match_jax(profile):
    with pytest.raises(ValueError) as want:
        JaxRegistry().factory("shec", "", profile | {"device": "numpy"})
    with pytest.raises(ValueError) as got:
        ErasureCodePluginRegistry().factory("shec", "",
                                            profile | {"device": "numpy"})
    assert str(got.value) == str(want.value)


# -- ECUtil through isa and shec -------------------------------------------------

@pytest.mark.parametrize("name,profile,lost", [
    ("isa", {"k": "4", "m": "2"}, [0, 5]),
    ("shec", {"k": "4", "m": "3", "c": "2"}, [1, 6]),
])
def test_ecutil_through_isa_shec_matches_jax(name, profile, lost):
    ec, jec = _pair(name, profile, "cpu", jax_device="jax")
    k, n = ec.get_data_chunk_count(), ec.get_chunk_count()
    sinfo, jsinfo = ecutil.StripeInfo(k, 256), jecutil.StripeInfo(k, 256)
    rng = np.random.default_rng(n)
    bufs = [rng.integers(0, 256, sinfo.stripe_width * s, dtype=np.uint8)
            for s in (2, 1)]
    got = ecutil.encode_many(sinfo, ec, bufs)
    want = jecutil.encode_many(jsinfo, jec, bufs)
    for g, w in zip(got, want):
        for c in range(n):
            assert np.array_equal(g[c], np.asarray(w[c])), c
    h, jh = ecutil.HashInfo(n), jecutil.HashInfo(n)
    for shards in got:
        ecutil.hinfo_append(h, h.get_total_chunk_size(), shards, ec)
        jecutil.hinfo_append(jh, jh.get_total_chunk_size(), shards, jec)
    assert h.to_dict() == jh.to_dict()
    batches = [{c: v for c, v in g.items() if c not in lost} for g in got]
    assert ecutil.decode_many(sinfo, ec, batches) == \
        jecutil.decode_many(jsinfo, jec, batches) == \
        [b.tobytes() for b in bufs]
