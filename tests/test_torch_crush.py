"""The port's CRUSH against the JAX package and the reference C, bitwise.

Hashes and crush_ln against the golden vectors; the port's host
interpreter against every golden run; the plain version of the bulk
straw2 mapper (``device="cpu"``) against ``ceph_tpu.crush.jax_mapper``
on JAX-CPU over the cases of tests/test_jax_mapper.py.  Maps are built in
the JAX package and carried across with ``convert.crushmap_from_reference``.
Every comparison is exact (tolerance 0: placements are integers).
"""
import json
import os

import numpy as np
import pytest
import torch

from ceph_tpu.crush import CrushMap as RefCrushMap
from ceph_tpu.crush import crush_hash32_2_np as ref_hash2_np
from ceph_tpu.crush import crush_hash32_3_np as ref_hash3_np
from ceph_tpu.crush.jax_mapper import BulkMapper as RefBulkMapper
from ceph_tpu_torch import convert
from ceph_tpu_torch.crush import (CRUSH_BUCKET_LIST, CRUSH_BUCKET_STRAW2,
                                  CRUSH_ITEM_NONE,
                                  CRUSH_RULE_CHOOSELEAF_FIRSTN,
                                  CRUSH_RULE_CHOOSELEAF_INDEP,
                                  CRUSH_RULE_CHOOSE_FIRSTN,
                                  CRUSH_RULE_CHOOSE_INDEP, CRUSH_RULE_EMIT,
                                  CRUSH_RULE_TAKE, LN_TABLE, CrushMap,
                                  crush_do_rule, crush_hash32,
                                  crush_hash32_2, crush_hash32_2_torch,
                                  crush_hash32_3, crush_hash32_3_torch,
                                  crush_hash32_4, crush_hash32_5, crush_ln,
                                  crush_ln_np)
from ceph_tpu_torch.crush.torch_mapper import BulkMapper
from ceph_tpu_torch.ops import crush_kernels

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "crush_golden.json")
with open(GOLDEN) as f:
    G = json.load(f)

NX = 48


# -- hash and ln ---------------------------------------------------------------

def test_hash_golden_all_arities():
    xs = G["hash"]["inputs"]
    n = len(xs)
    for i in range(n):
        a, b, c, d, e = (xs[(i + j) % n] for j in range(5))
        assert crush_hash32(a) == G["hash"]["h1"][i]
        assert crush_hash32_2(a, b) == G["hash"]["h2"][i]
        assert crush_hash32_3(a, b, c) == G["hash"]["h3"][i]
        assert crush_hash32_4(a, b, c, d) == G["hash"]["h4"][i]
        assert crush_hash32_5(a, b, c, d, e) == G["hash"]["h5"][i]


def test_hash_torch_matches_golden():
    xs = torch.tensor(G["hash"]["inputs"], dtype=torch.int64)
    h3 = crush_hash32_3_torch(xs, torch.roll(xs, -1), torch.roll(xs, -2))
    h2 = crush_hash32_2_torch(xs, torch.roll(xs, -1))
    assert h3.tolist() == G["hash"]["h3"]
    assert h2.tolist() == G["hash"]["h2"]


@pytest.mark.parametrize("seed", [0, 1])
def test_hash_torch_matches_reference(seed):
    """Full-range uint32 inputs (negative int32 bit patterns included),
    broadcast against a row, as the straw2 draw and is_out call them."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 32, size=(64, 1), dtype=np.uint64)
    b = rng.integers(-(1 << 31), 1 << 31, size=(1, 16), dtype=np.int64)
    c = rng.integers(0, 1 << 32, size=(64, 1), dtype=np.uint64)
    got3 = crush_hash32_3_torch(torch.from_numpy(a.astype(np.int64)),
                                torch.from_numpy(b),
                                torch.from_numpy(c.astype(np.int64)))
    want3 = ref_hash3_np(a.astype(np.uint32), b.astype(np.uint32),
                         c.astype(np.uint32))
    assert np.array_equal(got3.numpy(), want3.astype(np.int64))
    got2 = crush_hash32_2_torch(torch.from_numpy(a.astype(np.int64)),
                                torch.from_numpy(b))
    want2 = ref_hash2_np(a.astype(np.uint32), b.astype(np.uint32))
    assert np.array_equal(got2.numpy(), want2.astype(np.int64))


def test_crush_ln_golden_and_table_identical():
    for x, v in zip(G["crush_ln"]["inputs"], G["crush_ln"]["values"]):
        assert crush_ln(x) == v
    got = crush_ln_np(np.array(G["crush_ln"]["inputs"]))
    assert got.astype(np.uint64).tolist() == G["crush_ln"]["values"]
    with open(os.path.join(ROOT, "ceph_tpu", "crush", "data",
                           "crush_ln16.npy"), "rb") as f:
        ref = f.read()
    with open(os.path.join(ROOT, "ceph_tpu_torch", "crush", "data",
                           "crush_ln16.npy"), "rb") as f:
        assert f.read() == ref
    assert LN_TABLE.dtype == np.uint64 and LN_TABLE.shape == (65536,)


# -- the host interpreter --------------------------------------------------------

def _runs():
    for g in G["groups"]:
        for run in g["runs"]:
            yield g["map"], run


@pytest.mark.parametrize("case", list(_runs()),
                         ids=[r["name"] for _, r in _runs()])
def test_do_rule_golden(case):
    """The port's crush_do_rule equals the reference C on every golden run
    (every bucket algorithm, legacy and optimal tunables)."""
    map_dict, run = case
    cmap = CrushMap.from_dict(map_dict)
    for x, want in enumerate(run["results"]):
        got = crush_do_rule(cmap, run["ruleno"], x, run["result_max"],
                            run["weights"])
        assert got == want, f"{run['name']} x={x}"


@pytest.mark.parametrize("group", range(len(G["groups"])))
def test_text_compiler_matches_jax_package(group):
    """crushtool -d / -c: the port decompiles a golden map to the JAX
    package's text and compiles that text to the JAX package's map."""
    from ceph_tpu.crush import compile_crushmap as ref_compile
    from ceph_tpu.crush import decompile as ref_decompile
    from ceph_tpu_torch.crush import compile_crushmap, decompile
    d = G["groups"][group]["map"]
    text = decompile(CrushMap.from_dict(d))
    assert text == ref_decompile(RefCrushMap.from_dict(d))
    assert compile_crushmap(text).to_dict() == ref_compile(text).to_dict()


def test_map_dict_round_trip():
    """from_dict reads the reference's to_dict unchanged and to_dict
    writes the same dict back."""
    for g in G["groups"]:
        ref = RefCrushMap.from_dict(g["map"]).to_dict()
        assert convert.crushmap_from_reference(ref).to_dict() == ref


# -- the plain bulk mapper against the JAX package ---------------------------------

def _golden_straw2_cases():
    for g in G["groups"]:
        cmap = CrushMap.from_dict(g["map"])
        if any(b.alg != CRUSH_BUCKET_STRAW2 for b in cmap.buckets.values()):
            continue
        if cmap.tunables["choose_local_tries"]:
            continue
        for run in g["runs"]:
            if len(cmap.rules[run["ruleno"]].steps) != 3:
                continue
            yield g["map"], run


CASES = list(_golden_straw2_cases())


@pytest.mark.parametrize("case", CASES, ids=[r["name"] for _, r in CASES])
def test_plain_matches_golden(case):
    """The plain version equals the reference C on every golden run the
    bulk path takes (the JAX mapper equals the same vectors in
    tests/test_jax_mapper.py)."""
    map_dict, run = case
    cmap = CrushMap.from_dict(map_dict)
    bm = BulkMapper(cmap, device="cpu")
    nx = len(run["results"])
    out, placed = bm.map_rule(run["ruleno"], np.arange(nx),
                              reweights=run["weights"],
                              result_max=run["result_max"])
    firstn = cmap.rules[run["ruleno"]].steps[1][0] in (
        CRUSH_RULE_CHOOSE_FIRSTN, CRUSH_RULE_CHOOSELEAF_FIRSTN)
    for x, want in enumerate(run["results"]):
        # firstn rows are as long as the reference C placed; indep rows
        # keep every position
        assert placed[x] == (len(want) if firstn else out.shape[1])
        want = want + [CRUSH_ITEM_NONE] * (out.shape[1] - len(want))
        assert out[x].tolist() == want[:out.shape[1]], f"x={x}"


def _three_level_map(seed=0):
    """racks -> hosts -> osds with uneven weights, some zero, built in the
    JAX package.  The variants below share seed 0 wherever the map's
    weights are not the point, so the JAX mapper compiles each rule shape
    once for the file (its cache is keyed by map content)."""
    rng = np.random.default_rng(seed)
    cmap = RefCrushMap()
    osd = 0
    racks = []
    for _ in range(3):
        hosts = []
        for _ in range(3):
            n = int(rng.integers(2, 5))
            items = list(range(osd, osd + n))
            osd += n
            w = [int(rng.integers(0, 5)) * 0x8000 for _ in items]
            hosts.append(cmap.add_bucket(CRUSH_BUCKET_STRAW2, 1, items, w))
        hw = [max(sum(cmap.buckets[h].item_weights), 0) for h in hosts]
        racks.append(cmap.add_bucket(CRUSH_BUCKET_STRAW2, 2, hosts, hw))
    rw = [sum(cmap.buckets[r].item_weights) for r in racks]
    root = cmap.add_bucket(CRUSH_BUCKET_STRAW2, 3, racks, rw)
    cmap.finalize()
    return cmap, root


def _compare(ref_map, ruleno, result_max, weights=None, choose_args=None,
             xs=None):
    """The port's plain mapper, its interpreter and the JAX mapper agree."""
    xs = np.arange(NX) if xs is None else xs
    want = RefBulkMapper(ref_map).map_rule(
        ruleno, xs, reweights=weights, result_max=result_max,
        choose_args=choose_args)
    cmap = convert.crushmap_from_reference(ref_map.to_dict())
    got = BulkMapper(cmap, device="cpu").map_rule(
        ruleno, xs, reweights=weights, result_max=result_max,
        choose_args=choose_args)
    assert got[0].dtype == np.int32 and got[1].dtype == np.int32
    assert np.array_equal(got[0], want[0]), "out"
    assert np.array_equal(got[1], want[1]), "placed"
    return got


def _rule(ref_map, root, op, numrep, ttype):
    return ref_map.add_rule([(CRUSH_RULE_TAKE, root, 0), (op, numrep, ttype),
                             (CRUSH_RULE_EMIT, 0, 0)])


@pytest.mark.parametrize("op,numrep,ttype", [
    (CRUSH_RULE_CHOOSELEAF_FIRSTN, 3, 2),
    (CRUSH_RULE_CHOOSELEAF_INDEP, 4, 1),
    (CRUSH_RULE_CHOOSE_FIRSTN, 2, 1),
    (CRUSH_RULE_CHOOSE_INDEP, 3, 0),
    (CRUSH_RULE_CHOOSELEAF_FIRSTN, 2, 0),
])
def test_plain_matches_jax_three_level(op, numrep, ttype):
    ref_map, root = _three_level_map()
    _compare(ref_map, _rule(ref_map, root, op, numrep, ttype), numrep)


def test_plain_with_reweights():
    ref_map, root = _three_level_map()
    ruleno = _rule(ref_map, root, CRUSH_RULE_CHOOSELEAF_INDEP, 4, 1)
    rng = np.random.default_rng(7)
    weights = [int(w) for w in rng.choice(
        [0, 0x4000, 0x8000, 0xC000, 0x10000], size=ref_map.max_devices)]
    _compare(ref_map, ruleno, 4, weights=weights)
    ruleno = _rule(ref_map, root, CRUSH_RULE_CHOOSELEAF_FIRSTN, 3, 2)
    _compare(ref_map, ruleno, 3, weights=weights)


def test_plain_numrep_zero_uses_result_max():
    ref_map, root = _three_level_map()
    ruleno = _rule(ref_map, root, CRUSH_RULE_CHOOSELEAF_INDEP, 0, 1)
    _compare(ref_map, ruleno, 4)


def _host_weight_sets(cmap, n_positions, seed):
    rng = np.random.default_rng(seed)
    args = {}
    for bid, b in cmap.buckets.items():
        if b.type != 1:
            continue
        args[bid] = {"weight_set": [
            [int(w * rng.choice([0.5, 0.75, 1.0, 1.25]))
             for w in b.item_weights] for _ in range(n_positions)]}
    return args


@pytest.mark.parametrize("op,numrep,ttype", [
    (CRUSH_RULE_CHOOSELEAF_FIRSTN, 3, 2),
    (CRUSH_RULE_CHOOSELEAF_INDEP, 4, 1),
    (CRUSH_RULE_CHOOSE_INDEP, 3, 0),
    (CRUSH_RULE_CHOOSE_FIRSTN, 2, 1),
])
def test_plain_choose_args_weight_sets(op, numrep, ttype):
    ref_map, root = _three_level_map()
    ruleno = _rule(ref_map, root, op, numrep, ttype)
    _compare(ref_map, ruleno, numrep,
             choose_args=_host_weight_sets(ref_map, numrep, seed=31))


def test_plain_choose_args_short_sets():
    """A weight_set shorter than numrep clamps to its last entry."""
    ref_map, root = _three_level_map()
    ruleno = _rule(ref_map, root, CRUSH_RULE_CHOOSELEAF_FIRSTN, 3, 2)
    _compare(ref_map, ruleno, 3,
             choose_args=_host_weight_sets(ref_map, 2, seed=37))


def test_plain_choose_args_ids_override():
    ref_map, root = _three_level_map()
    ruleno = _rule(ref_map, root, CRUSH_RULE_CHOOSELEAF_INDEP, 4, 1)
    args = {bid: {"ids": [int(i) + 1000 for i in b.items]}
            for bid, b in ref_map.buckets.items() if b.type == 1}
    _compare(ref_map, ruleno, 4, choose_args=args)


def test_plain_choose_args_mixed_with_reweights():
    ref_map, root = _three_level_map()
    ruleno = _rule(ref_map, root, CRUSH_RULE_CHOOSELEAF_INDEP, 4, 1)
    rng = np.random.default_rng(47)
    weights = [int(w) for w in rng.choice(
        [0, 0x8000, 0x10000], size=ref_map.max_devices, p=[0.1, 0.3, 0.6])]
    _compare(ref_map, ruleno, 4, weights=weights,
             choose_args=_host_weight_sets(ref_map, 4, seed=43))


def test_plain_root_id_minus_one():
    ref_map = RefCrushMap()
    ref_map.add_bucket(CRUSH_BUCKET_STRAW2, 3, [-2, -3], [0x40000, 0x40000],
                       id=-1)
    ref_map.add_bucket(CRUSH_BUCKET_STRAW2, 1, [0, 1], [0x20000, 0x20000],
                       id=-2)
    ref_map.add_bucket(CRUSH_BUCKET_STRAW2, 1, [2, 3], [0x20000, 0x20000],
                       id=-3)
    ref_map.finalize()
    ruleno = _rule(ref_map, -1, CRUSH_RULE_CHOOSELEAF_FIRSTN, 2, 1)
    out, _ = _compare(ref_map, ruleno, 2)
    assert (out != CRUSH_ITEM_NONE).all()


def test_plain_result_max_smaller_than_numrep():
    ref_map, root = _three_level_map()
    _compare(ref_map, _rule(ref_map, root, CRUSH_RULE_CHOOSE_INDEP, 5, 0), 3)
    _compare(ref_map, _rule(ref_map, root, CRUSH_RULE_CHOOSELEAF_FIRSTN, 4,
                            1), 2)


def test_plain_seeds_past_two_to_the_31():
    """Hashed placement seeds use the full uint32 range; they never turn
    into negative int32."""
    ref_map, root = _three_level_map()
    xs = np.random.default_rng(3).integers(1 << 31, 1 << 32, size=NX,
                                           dtype=np.uint64).astype(np.uint32)
    _compare(ref_map, _rule(ref_map, root, CRUSH_RULE_CHOOSELEAF_FIRSTN, 3,
                            2), 3, xs=xs)
    _compare(ref_map, _rule(ref_map, root, CRUSH_RULE_CHOOSELEAF_INDEP, 4,
                            1), 4, xs=xs)


def test_plain_dangling_bucket_reference():
    """An item naming a bucket the map lacks: the gathers wrap and clamp
    as the reference's do, so both packages place identically."""
    ref_map = RefCrushMap()
    host = ref_map.add_bucket(CRUSH_BUCKET_STRAW2, 1, [0, 1],
                              [0x10000, 0x10000])
    root = ref_map.add_bucket(CRUSH_BUCKET_STRAW2, 2, [host, -9],
                              [0x20000, 0x20000])
    ref_map.finalize()
    for op in (CRUSH_RULE_CHOOSE_FIRSTN, CRUSH_RULE_CHOOSELEAF_INDEP):
        _compare(ref_map, _rule(ref_map, root, op, 2, 1), 2)


def test_unsupported_maps_and_rules_raise_in_both():
    ref_map = RefCrushMap()
    ref_map.add_bucket(CRUSH_BUCKET_LIST, 1, [0, 1], [0x10000, 0x10000])
    ref_map.finalize()
    cmap = convert.crushmap_from_reference(ref_map.to_dict())
    for mapper in (RefBulkMapper, lambda m: BulkMapper(m, device="cpu")):
        with pytest.raises(ValueError, match="straw2"):
            mapper(ref_map if mapper is RefBulkMapper else cmap)
    ref3, root = _three_level_map()
    ref3.tunables["choose_local_tries"] = 2
    with pytest.raises(ValueError, match="local retry"):
        RefBulkMapper(ref3)
    with pytest.raises(ValueError, match="local retry"):
        BulkMapper(convert.crushmap_from_reference(ref3.to_dict()),
                   device="cpu")
    ref4, root = _three_level_map()
    two_step = ref4.add_rule([(CRUSH_RULE_TAKE, root, 0),
                              (CRUSH_RULE_CHOOSE_FIRSTN, 2, 2),
                              (CRUSH_RULE_CHOOSELEAF_FIRSTN, 1, 1),
                              (CRUSH_RULE_EMIT, 0, 0)])
    zero = _rule(ref4, root, CRUSH_RULE_CHOOSELEAF_INDEP, 0, 1)
    port = BulkMapper(convert.crushmap_from_reference(ref4.to_dict()),
                      device="cpu")
    for mapper in (RefBulkMapper(ref4), port):
        with pytest.raises(ValueError, match="take/choose/emit"):
            mapper.map_rule(two_step, np.arange(4))
        with pytest.raises(ValueError, match="result_max"):
            mapper.map_rule(zero, np.arange(4))


def test_tensor_xs_stay_tensors_and_nothing_launches():
    """A tensor of seeds gives tensors back on the mapper's device; the
    CPU runs the plain version and counts no launch."""
    ref_map, root = _three_level_map(seed=17)
    ruleno = _rule(ref_map, root, CRUSH_RULE_CHOOSELEAF_INDEP, 4, 1)
    bm = BulkMapper(convert.crushmap_from_reference(ref_map.to_dict()),
                    device="cpu")
    crush_kernels.reset_launches()
    out, placed = bm.map_rule(ruleno, torch.arange(NX), result_max=4)
    assert isinstance(out, torch.Tensor) and out.dtype == torch.int32
    host, host_placed = bm.map_rule(ruleno, np.arange(NX), result_max=4)
    assert np.array_equal(out.numpy(), host)
    assert np.array_equal(placed.numpy(), host_placed)
    assert crush_kernels.launches == {"crush_straw2": 0}


def test_map_digest_cache_is_shared_and_bounded():
    ref_map, _ = _three_level_map(seed=19)
    cmap = convert.crushmap_from_reference(ref_map.to_dict())
    a = BulkMapper(cmap, device="cpu")
    b = BulkMapper(convert.crushmap_from_reference(ref_map.to_dict()),
                   device="cpu")
    assert a._cache is b._cache
    a.tables(None)
    assert "cpu" in b._cache
    for seed in range(BulkMapper._GLOBAL_CACHE_CAP + 1):
        BulkMapper(convert.crushmap_from_reference(
            _three_level_map(seed=100 + seed)[0].to_dict()), device="cpu")
    assert len(BulkMapper._global_cache) <= BulkMapper._GLOBAL_CACHE_CAP


def test_cuda_without_a_card_raises(monkeypatch):
    """device="cuda" (the default) never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ref_map, root = _three_level_map(seed=2)
    ruleno = _rule(ref_map, root, CRUSH_RULE_CHOOSELEAF_FIRSTN, 3, 1)
    bm = BulkMapper(convert.crushmap_from_reference(ref_map.to_dict()))
    crush_kernels.reset_launches()
    with pytest.raises(RuntimeError, match="cuda"):
        bm.map_rule(ruleno, np.arange(8), result_max=3)
    assert crush_kernels.launches == {"crush_straw2": 0}
