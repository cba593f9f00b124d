"""The port's ECUtil stripe path against ``ceph_tpu.backend.ecutil``.

The JAX side runs ``jax_rs`` with ``device=jax`` on JAX-CPU (its device
crc32c path included); the port runs ``torch_rs`` with ``device=cpu``.
Shards, decoded bytes and HashInfo must be bitwise equal.
"""
import numpy as np
import pytest

from ceph_tpu.backend import ecutil as jecutil
from ceph_tpu.plugins import ErasureCodePluginRegistry as JaxRegistry
from ceph_tpu_torch import convert
from ceph_tpu_torch.backend import ecutil
from ceph_tpu_torch.plugins.registry import ErasureCodePluginRegistry


def _impls(k, m, technique="reed_sol_van", device="cpu"):
    prof = {"k": str(k), "m": str(m), "technique": technique}
    return (ErasureCodePluginRegistry().factory(
                "torch_rs", "", prof | {"device": device}),
            JaxRegistry().factory("jax_rs", "", prof | {"device": "jax"}))


def _bufs(rng, sinfo, stripe_counts):
    return [rng.integers(0, 256, sinfo.stripe_width * s, dtype=np.uint8)
            for s in stripe_counts]


def _assert_shards_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for c in g:
            assert np.array_equal(np.asarray(g[c]), np.asarray(w[c])), c


@pytest.mark.parametrize("device", ["cpu", "numpy"])
@pytest.mark.parametrize("k,m,chunk,stripes", [
    (4, 2, 128, [1, 3, 2]),
    (8, 4, 512, [2, 1, 4, 3]),
])
def test_stripe_path_matches_jax(k, m, chunk, stripes, device):
    ec, jec = _impls(k, m, device=device)
    sinfo = ecutil.StripeInfo(k, chunk)
    jsinfo = jecutil.StripeInfo(k, chunk)
    rng = np.random.default_rng(k * 10 + m)
    bufs = _bufs(rng, sinfo, stripes)

    got = ecutil.encode_many(sinfo, ec, bufs)
    want = jecutil.encode_many(jsinfo, jec, bufs)
    _assert_shards_equal(got, want)
    for buf, g in zip(bufs, got):
        _assert_shards_equal([ecutil.encode(sinfo, ec, buf)], [g])
        _assert_shards_equal([ecutil.encode(sinfo, ec, buf.tobytes(),
                                            want={0, k})],
                             [{0: g[0], k: g[k]}])

    # HashInfo: append each object's shards twice (a chained seed)
    h, jh = ecutil.HashInfo(k + m), jecutil.HashInfo(k + m)
    for shards in got + got:
        ecutil.hinfo_append(h, h.get_total_chunk_size(), shards, ec)
        jecutil.hinfo_append(jh, jh.get_total_chunk_size(), shards, jec)
    assert h.to_dict() == jh.to_dict()
    host = ecutil.HashInfo(k + m)
    for shards in got + got:
        host.append(host.get_total_chunk_size(), shards)
    assert host.to_dict() == h.to_dict()

    # decode_many: two erasure signatures, m losses and fewer
    lost = [{0, k + 1}, set(range(1, m + 1)), {0, k + 1}, {k}]
    batches = [{c: v for c, v in g.items() if c not in lost[i % len(lost)]}
               for i, g in enumerate(got)]
    dec = ecutil.decode_many(sinfo, ec, batches)
    jdec = jecutil.decode_many(jsinfo, jec, batches)
    assert dec == jdec
    assert dec == [b.tobytes() for b in bufs]
    assert ecutil.decode(sinfo, ec, batches[0]) == bufs[0].tobytes()


def test_decode_many_pads_like_jax():
    ec, jec = _impls(4, 2)
    sinfo = ecutil.StripeInfo(4, 128)
    rng = np.random.default_rng(8)
    bufs = _bufs(rng, sinfo, [1, 2])
    enc = ecutil.encode_many(sinfo, ec, bufs)
    batches = [{c: v for c, v in e.items() if c not in (1, 4)} for e in enc]
    pad = lambda s: 1 << (s - 1).bit_length()           # noqa: E731
    dec = ecutil.decode_many(sinfo, ec, batches, pad_chunks=pad)
    assert dec == jecutil.decode_many(jecutil.StripeInfo(4, 128), jec,
                                      batches, pad_chunks=pad)
    assert dec == [b.tobytes() for b in bufs]
    assert ecutil.decode_many(sinfo, ec, []) == []
    assert ecutil.encode_many(sinfo, ec, []) == []


def test_stripe_path_rejects_bad_buffers():
    ec, _ = _impls(4, 2)
    sinfo = ecutil.StripeInfo(4, 128)
    with pytest.raises(ValueError):
        ecutil.encode(sinfo, ec, b"x" * 100)
    with pytest.raises(ValueError):
        ecutil.encode_many(sinfo, ec, [b"x" * 512, b"x" * 100])
    with pytest.raises(ValueError):
        ecutil.decode(sinfo, ec, {0: b"x" * 128, 1: b"x" * 256})


def test_hinfo_append_host_paths_match_jax():
    """Hash-less objects and numpy routing take HashInfo.append."""
    ec, jec = _impls(4, 2, device="numpy")
    rng = np.random.default_rng(4)
    shards = {c: rng.integers(0, 256, 300, dtype=np.uint8) for c in range(6)}
    h, jh = ecutil.HashInfo(6), jecutil.HashInfo(6)
    ecutil.hinfo_append(h, 0, shards, ec)
    jecutil.hinfo_append(jh, 0, shards, jec)
    assert h.to_dict() == jh.to_dict()
    h.set_total_chunk_size_clear_hash(300)
    jh.set_total_chunk_size_clear_hash(300)
    cpu, _ = _impls(4, 2)
    ecutil.hinfo_append(h, 300, shards, cpu)
    jecutil.hinfo_append(jh, 300, shards, jec)
    assert h.to_dict() == jh.to_dict()
    ecutil.hinfo_append(h, 600, {}, cpu)
    assert h.get_total_chunk_size() == 600


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 4095, 4096, 4097, 70000])
def test_host_crc32c_matches_jax(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    for seed in (0, 0xFFFFFFFF, 0x12345678):
        want = jecutil.crc32c(seed, data.tobytes())
        assert ecutil.crc32c(seed, data) == want
        assert ecutil.crc32c(seed, data.tobytes()) == want
        assert ecutil.crc32c_zeros(seed, n) == jecutil.crc32c_zeros(seed, n)
    assert ecutil.crc32c_zeros_op(n) == jecutil.crc32c_zeros_op(n)


def test_stripe_info_matches_jax():
    s, js = ecutil.StripeInfo(4, 256), jecutil.StripeInfo(4, 256)
    for off in (0, 1, 1023, 1024, 1025, 5000):
        for name in ("logical_to_prev_chunk_offset",
                     "logical_to_next_chunk_offset",
                     "logical_to_prev_stripe_offset",
                     "logical_to_next_stripe_offset",
                     "logical_offset_is_stripe_aligned"):
            assert getattr(s, name)(off) == getattr(js, name)(off), name
        assert s.offset_len_to_stripe_bounds(off, 3000) == \
            js.offset_len_to_stripe_bounds(off, 3000)
    assert s.aligned_offset_len_to_chunk(2048, 4096) == \
        js.aligned_offset_len_to_chunk(2048, 4096)
    mbr, jmbr = ecutil.StripeInfo(4, 256, 512), jecutil.StripeInfo(4, 256, 512)
    assert mbr.chunk_to_stored(768) == jmbr.chunk_to_stored(768)
    assert mbr.stored_to_chunk(1024) == jmbr.stored_to_chunk(1024)


def test_hashinfo_from_reference_dict():
    rng = np.random.default_rng(12)
    jh = jecutil.HashInfo(6)
    shards = {c: rng.integers(0, 256, 512, dtype=np.uint8) for c in range(6)}
    jh.append(0, shards)
    jh.version = 7
    h = convert.hashinfo_from_dict(jh.to_dict())
    assert isinstance(h, ecutil.HashInfo)
    assert h.to_dict() == jh.to_dict()
    # both go on from the carried state identically
    more = {c: rng.integers(0, 256, 512, dtype=np.uint8) for c in range(6)}
    h.append(512, more)
    jh.append(512, more)
    assert h.to_dict() == jh.to_dict()
    sinfo = ecutil.StripeInfo(4, 512)
    assert h.get_total_logical_size(sinfo) == \
        jh.get_total_logical_size(jecutil.StripeInfo(4, 512))
