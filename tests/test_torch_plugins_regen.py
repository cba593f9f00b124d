"""The port's xor, lrc, clay and pm_regen plugins against the JAX package's.

Every scenario of tests/test_clay.py, tests/test_lrc.py and the xor and
pm_regen plugin cases runs once per package: ``jax`` builds the JAX
package's plugin (``device=numpy``), ``torch`` the port's
(``device=cpu``: the plain PyTorch versions of the kernels), and every
chunk, decode and plan is also held bitwise against the JAX package's
answer to the same input.  The port names the RS plugin ``torch_rs``
where the JAX package names it ``jax_rs``.
"""
import itertools
import json

import numpy as np
import pytest

from ceph_tpu.plugins import ErasureCodePluginRegistry as JaxRegistry
from ceph_tpu_torch.plugins.registry import ErasureCodePluginRegistry

PKGS = ["jax", "torch"]
RS = {"jax": "jax_rs", "torch": "torch_rs"}
DEVICE = {"jax": "numpy", "torch": "cpu"}


def _registry(pkg):
    return JaxRegistry() if pkg == "jax" else ErasureCodePluginRegistry()


def _port_profile(pkg, profile: dict) -> dict:
    """The profile as ``pkg`` names it: its RS plugin and its device."""
    out = {}
    for key, v in profile.items():
        out[key] = RS[pkg] if v == "jax_rs" else v
    if "device" in out:
        out["device"] = DEVICE[pkg]
    return out


def _make(pkg, name, profile):
    """(the plugin of ``pkg``, the JAX package's plugin) for ``profile``."""
    ec = _registry(pkg).factory(name, "", _port_profile(pkg, profile))
    ref = JaxRegistry().factory(name, "", _port_profile("jax", profile))
    return ec, ref


def _payload(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


def _same(a, b) -> bool:
    return np.array_equal(np.asarray(a, dtype=np.uint8),
                          np.asarray(b, dtype=np.uint8))


def _encode_both(ec, ref, data):
    n = ec.get_chunk_count()
    enc = ec.encode(set(range(n)), data)
    want = ref.encode(set(range(n)), data)
    assert sorted(enc) == sorted(want)
    for c in enc:
        assert _same(enc[c], want[c]), c
    return enc


def _decode_both(ec, ref, want, avail, **kw):
    got = ec.decode(set(want), avail, **kw)
    ref_got = ref.decode(set(want), avail, **kw)
    for c in want:
        assert _same(got[c], ref_got[c]), c
    return got


# -- xor -------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_xor_roundtrip(pkg):
    ec, ref = _make(pkg, "xor", {"k": "3"})
    encoded = _encode_both(ec, ref, _payload(999))
    for lost in range(4):
        available = {i: v for i, v in encoded.items() if i != lost}
        decoded = _decode_both(ec, ref, {lost}, available)
        np.testing.assert_array_equal(decoded[lost], encoded[lost])
    with pytest.raises(IOError):
        ec.decode({0, 1}, {i: encoded[i] for i in (2, 3)})
    with pytest.raises(ValueError):
        _registry(pkg).factory("xor", "", {"k": "2", "m": "2"})


@pytest.mark.parametrize("pkg", PKGS)
def test_xor_registry_load(pkg):
    registry = _registry(pkg)
    plugin = registry.load("xor")
    assert registry.get("xor") is plugin
    with pytest.raises(ValueError):
        registry.add("xor", object())
    ec = registry.factory("xor", "", {"k": "5"})
    assert (ec.get_chunk_count(), ec.get_data_chunk_count()) == (6, 5)
    assert ec.get_profile()["plugin"] == "xor"


# -- clay: geometry --------------------------------------------------------------

def _clay(pkg, k, m, d=None, **extra):
    profile = {"k": str(k), "m": str(m), "device": "numpy", **extra}
    if d is not None:
        profile["d"] = str(d)
    return _make(pkg, "clay", profile)


@pytest.mark.parametrize("pkg", PKGS)
def test_clay_geometry_defaults(pkg):
    ec, _ = _clay(pkg, 4, 2)          # d defaults to k+m-1 = 5
    assert ec.d == 5 and ec.q == 2 and ec.nu == 0 and ec.t == 3
    assert ec.get_sub_chunk_count() == 8
    assert ec.get_chunk_count() == 6
    assert ec.get_data_chunk_count() == 4


@pytest.mark.parametrize("pkg", PKGS)
def test_clay_geometry_with_nu(pkg):
    ec, _ = _clay(pkg, 3, 2, d=4)
    assert ec.q == 2 and ec.nu == 1 and ec.t == 3
    assert ec.get_sub_chunk_count() == 8


@pytest.mark.parametrize("pkg", PKGS)
def test_clay_chunk_size_subchunk_aligned(pkg):
    ec, ref = _clay(pkg, 4, 2)
    for size in (1, 100000):
        cs = ec.get_chunk_size(size)
        assert cs == ref.get_chunk_size(size)
        assert cs * 4 >= size and cs % ec.get_sub_chunk_count() == 0


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("profile", [
    {"k": "4", "m": "2", "d": "3"},      # d < k
    {"k": "4", "m": "2", "d": "6"},      # d > k+m-1
    {"k": "4", "m": "2", "scalar_mds": "bogus"},
    {"k": "4", "m": "2", "technique": "bogus"},
    {"k": "4", "m": "2", "scalar_mds": "isa", "technique": "liber8tion"},
    {"k": "4", "m": "2", "scalar_mds": "jax_rs", "technique": "liber8tion"},
])
def test_clay_invalid_profiles(pkg, profile):
    with pytest.raises(ValueError):
        _registry(pkg).factory("clay", "", _port_profile(
            pkg, {**profile, "device": "numpy"}))


def test_clay_names_the_port_rs_plugin():
    """scalar_mds takes torch_rs in the port, as jax_rs in the JAX
    package; each package refuses the other's name."""
    ErasureCodePluginRegistry().factory(
        "clay", "", {"k": "4", "m": "2", "scalar_mds": "torch_rs",
                     "device": "cpu"})
    with pytest.raises(ValueError, match="torch_rs"):
        ErasureCodePluginRegistry().factory(
            "clay", "", {"k": "4", "m": "2", "scalar_mds": "jax_rs"})


# -- clay: roundtrips ------------------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("k,m,d", [(4, 2, 5), (2, 2, 3), (3, 2, 4),
                                   (4, 3, 6), (6, 3, 8)])
def test_clay_encode_decode_all_single_erasures(pkg, k, m, d):
    ec, ref = _clay(pkg, k, m, d)
    data = _payload(ec.get_chunk_size(1) * k, seed=k * 10 + m)
    n = k + m
    encoded = _encode_both(ec, ref, data)
    for lost in range(n):
        available = {i: v for i, v in encoded.items() if i != lost}
        decoded = _decode_both(ec, ref, {lost}, available)
        np.testing.assert_array_equal(decoded[lost], encoded[lost],
                                      err_msg=f"lost={lost}")


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("k,m", [(4, 2), (4, 3)])
def test_clay_decode_all_m_erasures(pkg, k, m):
    ec, ref = _clay(pkg, k, m)
    data = _payload(ec.get_chunk_size(1) * k, seed=9)
    n = k + m
    encoded = _encode_both(ec, ref, data)
    for lost in itertools.combinations(range(n), m):
        available = {i: v for i, v in encoded.items() if i not in lost}
        decoded = _decode_both(ec, ref, set(lost), available)
        for e in lost:
            np.testing.assert_array_equal(decoded[e], encoded[e],
                                          err_msg=f"lost={lost}")


@pytest.mark.parametrize("pkg", PKGS)
def test_clay_decode_concat_roundtrip(pkg):
    ec, ref = _clay(pkg, 4, 2)
    data = _payload(3000, seed=4)
    encoded = _encode_both(ec, ref, data)
    available = {i: encoded[i] for i in (1, 2, 3, 5)}
    got = ec.decode_concat(available)
    assert got == ref.decode_concat(available)
    assert got[:len(data)] == data


# -- clay: repair ----------------------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_clay_minimum_to_repair_reads_fraction(pkg):
    ec, ref = _clay(pkg, 4, 2)          # q=2: helpers send 1/2 chunk
    lost = 1
    available = set(range(6)) - {lost}
    minimum = ec.minimum_to_decode({lost}, available)
    assert minimum == ref.minimum_to_decode({lost}, available)
    assert len(minimum) == ec.d == 5
    sub = ec.get_sub_chunk_count()
    for node, runs in minimum.items():
        assert sum(count for _, count in runs) == sub // ec.q, node


@pytest.mark.parametrize("pkg", PKGS)
def test_clay_minimum_to_decode_falls_back_to_full(pkg):
    ec, ref = _clay(pkg, 4, 2)
    got = ec.minimum_to_decode({0, 1}, {2, 3, 4, 5})
    assert got == ref.minimum_to_decode({0, 1}, {2, 3, 4, 5})
    sub = ec.get_sub_chunk_count()
    assert all(runs == [(0, sub)] for runs in got.values())


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("k,m,d", [(4, 2, 5), (4, 3, 6), (3, 2, 4)])
def test_clay_repair_with_subchunk_reads(pkg, k, m, d):
    """repair() fed only the sub-chunk runs minimum_to_decode asked for
    rebuilds the lost chunk exactly (the regenerating property)."""
    ec, ref = _clay(pkg, k, m, d)
    chunk_size = ec.get_chunk_size(1) * 4
    data = _payload(chunk_size * k, seed=13)
    n = k + m
    encoded = _encode_both(ec, ref, data)
    sub = ec.get_sub_chunk_count()
    sc_size = chunk_size // sub
    for lost in range(n):
        available = set(range(n)) - {lost}
        minimum = ec.minimum_to_decode({lost}, available)
        assert len(minimum) == d
        helper_chunks = {}
        for node, runs in minimum.items():
            full = encoded[node].reshape(sub, sc_size)
            parts = [full[off:off + cnt] for off, cnt in runs]
            helper_chunks[node] = np.concatenate(parts).reshape(-1)
            assert helper_chunks[node].nbytes < chunk_size
        decoded = _decode_both(ec, ref, {lost}, helper_chunks,
                               chunk_size=chunk_size)
        np.testing.assert_array_equal(decoded[lost], encoded[lost],
                                      err_msg=f"lost={lost}")


@pytest.mark.parametrize("pkg", PKGS)
def test_clay_repair_bandwidth_ratio(pkg):
    ec, _ = _clay(pkg, 4, 2)
    minimum = ec.minimum_to_decode({0}, {1, 2, 3, 4, 5})
    sub = ec.get_sub_chunk_count()
    total_sub = sum(sum(c for _, c in runs) for runs in minimum.values())
    assert total_sub < 4 * sub      # 5 * 4 = 20 < 32


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("scalar_mds,technique", [
    ("jerasure", "reed_sol_van"),
    ("isa", "cauchy"),
    ("jax_rs", "cauchy"),
    ("shec", "single"),
])
def test_clay_scalar_mds_choices(pkg, scalar_mds, technique):
    ec, ref = _clay(pkg, 4, 2, scalar_mds=scalar_mds, technique=technique)
    data = _payload(ec.get_chunk_size(1) * 4, seed=5)
    encoded = _encode_both(ec, ref, data)
    available = {i: encoded[i] for i in (0, 2, 3, 4)}
    decoded = _decode_both(ec, ref, {1, 5}, available)
    np.testing.assert_array_equal(decoded[1], encoded[1])
    np.testing.assert_array_equal(decoded[5], encoded[5])


# -- lrc -------------------------------------------------------------------------

KML = {"k": "4", "m": "2", "l": "3", "device": "numpy"}

LAYERS = {
    "mapping": "__DD__DD",
    "layers": json.dumps([
        ["_cDD_cDD", {"plugin": "jax_rs", "device": "numpy"}],
        ["c_DD____", {"plugin": "jax_rs", "device": "numpy"}],
        ["____c_DD", {"plugin": "jax_rs", "device": "numpy"}],
    ]),
}


def _lrc_profile(pkg, profile):
    """lrc's layers carry their own profiles inside a JSON string: name
    the package's RS plugin and device there too."""
    out = _port_profile(pkg, profile)
    if "layers" in out:
        out["layers"] = json.dumps(
            [[m, _port_profile(pkg, c) if isinstance(c, dict) else c]
             for m, c in json.loads(out["layers"])])
    return out


def _lrc(pkg, profile):
    return (_registry(pkg).factory("lrc", "", _lrc_profile(pkg, profile)),
            JaxRegistry().factory("lrc", "", _lrc_profile("jax", profile)))


@pytest.mark.parametrize("pkg", PKGS)
def test_lrc_kml_generates_mapping_and_layers(pkg):
    ec, ref = _lrc(pkg, KML)
    assert ec.get_chunk_count() == 8
    assert ec.get_data_chunk_count() == 4
    assert len(ec.layers) == 3
    assert [lay.chunks_map for lay in ec.layers] == \
        [lay.chunks_map for lay in ref.layers]
    assert "mapping" not in ec.get_profile()
    assert "layers" not in ec.get_profile()


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("profile,match", [
    ({"k": "4", "m": "2"}, "all of k, m, l"),
    ({"k": "4", "m": "2", "l": "4"}, "multiple of l"),
    ({"k": "4", "m": "2", "l": "3", "mapping": "x"}, "cannot be set"),
    ({"k": "4", "m": "2", "l": "2"}, "k must be a multiple"),
    ({"k": "4", "m": "4", "l": "0"}, "multiple of l"),
    ({"k": "8", "m": "4", "l": "4"}, "k must be a multiple"),
])
def test_lrc_kml_validation(pkg, profile, match):
    with pytest.raises(ValueError, match=match):
        _registry(pkg).factory("lrc", "", dict(profile))


@pytest.mark.parametrize("pkg", PKGS)
def test_lrc_layers_roundtrip(pkg):
    ec, ref = _lrc(pkg, LAYERS)
    assert ec.get_chunk_count() == 8
    assert ec.get_data_chunk_count() == 4
    data = _payload(5000)
    encoded = _encode_both(ec, ref, data)
    assert set(encoded) == set(range(8))
    assert ec.decode_concat(encoded)[:len(data)] == data


@pytest.mark.parametrize("pkg", PKGS)
def test_lrc_local_repair_single_failure(pkg):
    ec, ref = _lrc(pkg, LAYERS)
    encoded = _encode_both(ec, ref, _payload(3000, seed=1))
    available = {i: v for i, v in encoded.items() if i != 6}
    decoded = _decode_both(ec, ref, {6}, available)
    np.testing.assert_array_equal(decoded[6], encoded[6])
    got = ec.minimum_to_decode({6}, set(available))
    assert got == ref.minimum_to_decode({6}, set(available))
    assert set(got) <= {4, 7}


@pytest.mark.parametrize("pkg", PKGS)
def test_lrc_global_repair_two_failures(pkg):
    ec, ref = _lrc(pkg, LAYERS)
    encoded = _encode_both(ec, ref, _payload(3000, seed=2))
    available = {i: v for i, v in encoded.items() if i not in (6, 7)}
    decoded = _decode_both(ec, ref, {6, 7}, available)
    np.testing.assert_array_equal(decoded[6], encoded[6])
    np.testing.assert_array_equal(decoded[7], encoded[7])


@pytest.mark.parametrize("pkg", PKGS)
def test_lrc_cascading_repair(pkg):
    ec, ref = _lrc(pkg, KML)
    n = ec.get_chunk_count()
    encoded = _encode_both(ec, ref, _payload(4096, seed=3))
    repaired = 0
    for lost in itertools.chain(((i,) for i in range(n)),
                                itertools.combinations(range(n), 2)):
        available = {i: v for i, v in encoded.items() if i not in lost}
        try:
            decoded = ec.decode(set(lost), available)
        except IOError:
            with pytest.raises(IOError):
                ref.decode(set(lost), available)
            continue
        want = ref.decode(set(lost), available)
        for e in lost:
            np.testing.assert_array_equal(decoded[e], encoded[e],
                                          err_msg=f"lost={lost}")
            assert _same(decoded[e], want[e])
        repaired += 1
    assert repaired >= n


@pytest.mark.parametrize("pkg", PKGS)
def test_lrc_minimum_to_decode_cases(pkg):
    ec, ref = _lrc(pkg, LAYERS)
    n = ec.get_chunk_count()
    got = ec.minimum_to_decode({2, 3}, set(range(n)))
    assert set(got) == {2, 3}
    assert got == ref.minimum_to_decode({2, 3}, set(range(n)))
    with pytest.raises(IOError):
        ec.minimum_to_decode({2}, {0, 4})


@pytest.mark.parametrize("pkg", PKGS)
def test_lrc_layer_validation(pkg):
    registry = _registry(pkg)
    with pytest.raises(ValueError, match="characters long"):
        registry.factory("lrc", "", {"mapping": "DD__",
                                     "layers": json.dumps([["DDc", ""]])})
    with pytest.raises(ValueError):
        registry.factory("lrc", "", {"mapping": "DD_",
                                     "layers": json.dumps({"a": 1})})
    with pytest.raises(ValueError, match="layers"):
        registry.factory("lrc", "", {"mapping": "DD_"})


@pytest.mark.parametrize("pkg", PKGS)
def test_lrc_crush_rule_steps(pkg):
    registry = _registry(pkg)
    ec = registry.factory("lrc", "", dict(KML))
    assert ec.rule_steps == [("chooseleaf", "host", 0)]
    ec2 = registry.factory("lrc", "", {**KML, "crush-locality": "rack"})
    assert ec2.rule_steps[0] == ("choose", "rack", 2)
    assert ec2.rule_steps[1] == ("chooseleaf", "host", 4)
    ec3, _ = _lrc(pkg, {**LAYERS, "crush-steps": json.dumps(
        [["choose", "rack", 2], ["chooseleaf", "host", 4]])})
    assert ec3.rule_steps == [("choose", "rack", 2), ("chooseleaf", "host", 4)]


def _crush_map():
    from ceph_tpu.crush.map import CRUSH_BUCKET_STRAW2, CrushMap
    cmap = CrushMap()
    cmap.set_type_name(1, "host")
    cmap.set_type_name(2, "root")
    hosts = [cmap.add_bucket(CRUSH_BUCKET_STRAW2, 1, [h * 2, h * 2 + 1],
                             weights=[0x10000, 0x10000]) for h in range(4)]
    root = cmap.add_bucket(CRUSH_BUCKET_STRAW2, 2, hosts,
                           weights=[0x20000] * 4)
    cmap.set_item_name(root, "default")
    cmap.finalize()
    return cmap, root


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("locality", ["", "host"])
def test_lrc_create_rule_with_crush_map(pkg, locality):
    """The port's create_rule is duck-typed on the map it is given (here
    the JAX package's CrushMap) and writes the same steps."""
    extra = {"crush-locality": locality} if locality else {}
    steps = []
    for make in (lambda: _registry(pkg), JaxRegistry):
        cmap, root = _crush_map()
        ec = make().factory("lrc", "", {**KML, **extra})
        ruleno = ec.create_rule("lrcrule", cmap)
        assert cmap.rule_names["lrcrule"] == ruleno
        steps.append(cmap.rules[ruleno].steps)
        assert steps[-1][0][1] == root
        with pytest.raises(ValueError, match="exists"):
            ec.create_rule("lrcrule", cmap)
    assert steps[0] == steps[1]


def test_lrc_forwards_a_top_level_device_to_its_layers():
    """The port's one departure: a top-level device reaches every layer
    whose config names none; a layer's own device stays."""
    ec = ErasureCodePluginRegistry().factory("lrc", "", dict(KML))
    assert {lay.erasure_code.get_profile()["device"]
            for lay in ec.layers} == {"numpy"}
    ec = ErasureCodePluginRegistry().factory("lrc", "", {
        "mapping": "__DD__DD", "device": "numpy",
        "layers": json.dumps([
            ["_cDD_cDD", {"plugin": "torch_rs", "device": "cpu"}],
            ["c_DD____", {"plugin": "torch_rs"}],
            ["____c_DD", ""]])})
    assert [lay.erasure_code.get_profile()["device"]
            for lay in ec.layers] == ["cpu", "numpy", "numpy"]
    ec = ErasureCodePluginRegistry().factory(
        "lrc", "", {"k": "4", "m": "2", "l": "3"})
    assert {lay.erasure_code.get_profile()["device"]
            for lay in ec.layers} == {"cuda"}


# -- pm_regen --------------------------------------------------------------------

PM = [("mbr", 3, 2, 4), ("msr", 3, 2, 4), ("mbr", 4, 2, 4),
      ("mbr", 2, 2, 3), ("msr", 4, 3, 6)]


def _pm(pkg, mode, k, m, d):
    return _make(pkg, "pm_regen", {"k": str(k), "m": str(m), "d": str(d),
                                   "mode": mode, "device": "numpy"})


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("mode,k,m,d", PM)
def test_pm_regen_geometry(pkg, mode, k, m, d):
    ec, ref = _pm(pkg, mode, k, m, d)
    assert (ec.alpha, ec.B, ec.get_sub_chunk_count()) == \
        (ref.alpha, ref.B, ref.get_sub_chunk_count())
    assert ec.get_alignment() == ref.get_alignment()
    cs = ec.get_chunk_size(10000)
    assert cs == ref.get_chunk_size(10000)
    assert ec.get_stored_chunk_size(cs) == ref.get_stored_chunk_size(cs)
    assert ec.requires_full_chunk_io == (mode == "mbr")


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("mode,k,m,d", PM)
def test_pm_regen_decode_every_erasure_pattern(pkg, mode, k, m, d):
    ec, ref = _pm(pkg, mode, k, m, d)
    n = k + m
    data = _payload(2 * ec.get_chunk_size(1) * k - 7, seed=k + d)
    encoded = _encode_both(ec, ref, data)
    for size in range(1, m + 1):
        for lost in itertools.combinations(range(n), size):
            available = {i: v for i, v in encoded.items() if i not in lost}
            decoded = _decode_both(ec, ref, set(lost), available)
            for e in lost:
                np.testing.assert_array_equal(decoded[e], encoded[e])
            got = ec.decode_concat(available)
            assert got == ref.decode_concat(available)
            assert got[:len(data)] == data
            assert ec.minimum_to_decode(set(lost), set(available)) == \
                ref.minimum_to_decode(set(lost), set(available))


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("profile", [
    {"k": "3", "m": "2", "mode": "xyz"},
    {"k": "3", "m": "2", "mode": "mbr", "d": "2"},
    {"k": "3", "m": "2", "mode": "mbr", "d": "5"},
    {"k": "3", "m": "2", "mode": "msr", "d": "3"},
    {"k": "4", "m": "2", "mode": "msr"},
    {"k": "3", "m": "2", "w": "16"},
    {"k": "3", "m": "2", "mapping": "DD_D_"},
])
def test_pm_regen_invalid_profiles(pkg, profile):
    with pytest.raises(ValueError):
        _registry(pkg).factory("pm_regen", "", {**profile,
                                                "device": "numpy"})


@pytest.mark.parametrize("pkg", PKGS)
def test_pm_regen_selects_d_cheapest_helpers(pkg):
    ec, ref = _pm(pkg, "mbr", 3, 2, 4)
    assert ec.supports_regenerating_repair() is True
    costs = {1: 1, 2: 3, 3: 1, 4: 1}
    helpers = ec.minimum_to_repair(0, 4, costs)
    assert helpers == ref.minimum_to_repair(0, 4, costs)
    assert sorted(helpers) == [1, 2, 3, 4]
    ec5, ref5 = _pm(pkg, "msr", 2, 2, 2)
    helpers = ec5.minimum_to_repair(0, 2, costs)
    assert helpers == ref5.minimum_to_repair(0, 2, costs)
    assert len(helpers) == 2 and 2 not in helpers
    with pytest.raises(IOError):
        ec.minimum_to_repair(0, 4, {1: 1, 2: 1, 3: 1})


@pytest.mark.parametrize("pkg", PKGS)
def test_non_regenerating_plugins_default_off(pkg):
    ec = _registry(pkg).factory(RS[pkg], "", {"k": "4", "m": "2",
                                              "device": "numpy"})
    assert ec.supports_regenerating_repair() is False
    costs = {0: 1, 1: 1, 2: 1, 3: 1, 4: 3, 5: 3}
    assert ec.minimum_to_repair(0, 4, costs) == \
        ec.minimum_to_decode_with_cost(
            {0}, {c: v for c, v in costs.items() if c != 0})
