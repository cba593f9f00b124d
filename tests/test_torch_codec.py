"""The port's RSCodec against the JAX package's RSCodec(device="jax").

Both codecs see the same numpy inputs from ``np.random.default_rng``; the
port runs with ``device="cpu"`` (its plain PyTorch versions) and
``device="numpy"``.  Comparisons are bitwise.
"""
import numpy as np
import pytest
import torch

from ceph_tpu.ops.codec import RSCodec as JaxRSCodec
from ceph_tpu_torch import convert
from ceph_tpu_torch.ops import codec as tcodec
from ceph_tpu_torch.ops.codec import RSCodec

TECHNIQUES = ["reed_sol_van", "vandermonde", "cauchy"]


def _pair(technique, k=4, m=2, device="cpu"):
    return (JaxRSCodec(k, m, technique=technique, device="jax"),
            RSCodec(k, m, technique=technique, device=device))


def _full(codec, data):
    par = codec.encode(data)
    k = data.shape[0]
    return {i: data[i] for i in range(k)} | \
        {k + i: par[i] for i in range(par.shape[0])}


@pytest.mark.parametrize("device", ["cpu", "numpy"])
@pytest.mark.parametrize("technique", TECHNIQUES)
def test_encode_matches_jax(technique, device):
    jc, tc = _pair(technique, 6, 3, device)
    assert np.array_equal(jc.parity_mat, tc.parity_mat)
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, size=(6, 1000), dtype=np.uint8)
    assert np.array_equal(tc.encode(data), np.asarray(jc.encode(data)))
    batch = rng.integers(0, 256, size=(3, 6, 256), dtype=np.uint8)
    got = tc.encode(batch)
    assert got.shape == (3, 3, 256)
    assert np.array_equal(got, np.asarray(jc.encode(batch)))
    assert np.array_equal(tc.encode_host(data), jc.encode_host(data))


@pytest.mark.parametrize("technique", TECHNIQUES)
def test_decode_matches_jax(technique):
    jc, tc = _pair(technique)
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, size=(4, 640), dtype=np.uint8)
    full = _full(jc, data)
    for erasures in ([0], [1, 4], [2, 5], [0, 3]):
        avail = {i: v for i, v in full.items() if i not in erasures}
        want = jc.decode(avail, erasures)
        got = tc.decode(avail, erasures)
        assert sorted(got) == sorted(want) == sorted(erasures)
        for e in erasures:
            assert np.array_equal(got[e], np.asarray(want[e]))
            assert np.array_equal(got[e], full[e])
    assert tc.decode(full, []) == {}


@pytest.mark.parametrize("technique", TECHNIQUES)
def test_decode_batch_unsorted_src_matches_jax(technique):
    jc, tc = _pair(technique)
    rng = np.random.default_rng(23)
    B, n = 3, 256
    data = rng.integers(0, 256, size=(B, 4, n), dtype=np.uint8)
    par = jc.encode(data)
    full = np.concatenate([data, np.asarray(par)], axis=1)     # [B, 6, n]
    erasures = [1, 4]
    for src in ([5, 0, 3, 2], [0, 2, 3, 5], [3, 5, 2, 0]):
        stack = np.ascontiguousarray(full[:, src, :])
        want = np.asarray(jc.decode_batch(stack, src, erasures))
        got = tc.decode_batch(stack, src, erasures)
        assert got.shape == (B, 2, n)
        assert np.array_equal(got, want)
        assert np.array_equal(got, full[:, erasures, :])
        got_dev = tc.decode_batch_device(torch.from_numpy(stack), src,
                                         erasures)
        want_dev = np.asarray(jc.decode_batch_device(stack, src, erasures))
        assert np.array_equal(got_dev.numpy(), want_dev)


@pytest.mark.parametrize("technique", TECHNIQUES)
def test_device_entry_points_match_jax(technique):
    jc, tc = _pair(technique)
    rng = np.random.default_rng(29)
    data = rng.integers(0, 256, size=(4, 384), dtype=np.uint8)
    enc = tc.encode_device(torch.from_numpy(data))
    assert isinstance(enc, torch.Tensor) and enc.device.type == "cpu"
    assert np.array_equal(enc.numpy(),
                          np.asarray(jc.encode_device(data)))
    full = _full(jc, data)
    erasures, available = [0, 5], [1, 2, 3, 4]
    D, src = tc.decode_matrix(erasures, available)
    jD, jsrc = jc.decode_matrix(erasures, available)
    assert src == jsrc and np.array_equal(D, jD)
    stack = np.stack([full[s] for s in src])
    got = tc.decode_device(torch.from_numpy(stack), erasures, available)
    want = np.asarray(jc.decode_device(stack, erasures, available))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(tc.decode_host(stack, erasures, available),
                          jc.decode_host(stack, erasures, available))
    with pytest.raises(ValueError):
        tc.decode_device(torch.from_numpy(stack[:3]), erasures, available)


def test_lru_hits_cost_zero_uploads():
    tc = RSCodec(4, 2, device="cpu")
    rng = np.random.default_rng(2)
    data = rng.integers(0, 256, size=(4, 128), dtype=np.uint8)
    for _ in range(3):
        tc.encode(data)
    assert tc.parity_uploads == 1
    full = _full(tc, data)
    avail = {i: v for i, v in full.items() if i not in (0, 1)}
    for _ in range(4):
        tc.decode(avail, [0, 1])
        tc.decode_matrix_device([0, 1], list(avail))
    assert tc.decode_table_uploads == 1
    tc.decode(avail | {0: full[0]}, [1])      # a new signature uploads once
    assert tc.decode_table_uploads == 2


def test_lru_capacity_evicts_oldest(monkeypatch):
    assert tcodec.DECODE_CACHE_SIZE == 2516
    monkeypatch.setattr(tcodec, "DECODE_CACHE_SIZE", 5)
    tc = RSCodec(6, 3, device="numpy")
    for e in range(8):
        tc.decode_matrix([e])
    tc.decode_matrix([3])                         # a hit moves to the end
    tc.decode_matrix([0, 1])
    assert len(tc._decode_cache) == 5
    assert list(tc._decode_cache) == [((e,), None) for e in (5, 6, 7, 3)] \
        + [((0, 1), None)]


def test_codec_rejects_bad_parameters():
    with pytest.raises(ValueError):
        RSCodec(1, 1)
    with pytest.raises(ValueError):
        RSCodec(4, 2, technique="liberation")
    with pytest.raises(ValueError):
        RSCodec(22, 4, technique="vandermonde")
    with pytest.raises(ValueError):
        RSCodec(4, 2, device="jax")


@pytest.mark.parametrize("technique", TECHNIQUES)
def test_codec_from_reference_round_trips(technique):
    jc = JaxRSCodec(6, 3, technique=technique, device="jax")
    rng = np.random.default_rng(31)
    data = rng.integers(0, 256, size=(6, 512), dtype=np.uint8)
    full = _full(jc, data)
    for erasures in ([0, 1], [2, 7], [8]):
        jc.decode({i: v for i, v in full.items() if i not in erasures},
                  erasures)
    tables = {sig: (e.D, e.src) for sig, e in jc._decode_cache.items()}
    tc = convert.codec_from_reference(jc.parity_mat, 6, 3, technique,
                                      tables, device="cpu")
    assert tc.parity_uploads == 1
    assert tc.decode_table_uploads == len(tables) == 3
    assert list(tc._decode_cache) == list(jc._decode_cache)
    for sig, entry in tc._decode_cache.items():
        assert np.array_equal(entry.D, jc._decode_cache[sig].D)
        assert entry.src == jc._decode_cache[sig].src
    for erasures in ([0, 1], [2, 7], [8]):
        avail = {i: v for i, v in full.items() if i not in erasures}
        got = tc.decode(avail, erasures)
        for e in erasures:
            assert np.array_equal(got[e], full[e])
    assert tc.decode_table_uploads == 3          # every call was an LRU hit
    assert np.array_equal(tc.encode(data), np.asarray(jc.encode(data)))


def test_codec_from_reference_rejects_foreign_matrix():
    jc = JaxRSCodec(4, 2, technique="cauchy", device="jax")
    with pytest.raises(ValueError):
        convert.codec_from_reference(jc.parity_mat, 4, 2, "reed_sol_van",
                                     device="numpy")
    with pytest.raises(ValueError):
        convert.codec_from_reference(jc.parity_mat[:1], 4, 2, "cauchy",
                                     device="numpy")
