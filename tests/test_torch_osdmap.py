"""The port's OSDMap chain, bulk PG mapper and the two CLIs against the
JAX package, bitwise.

Maps are built in the JAX package (tests/test_osdmap.py's
``build_cluster``: racks -> hosts -> osds, a replicated size-3 pool and
an EC size-6 pool) and carried across with ``convert.osdmap_from_reference``.
The port maps on the CPU (``device="cpu"``: the plain straw2 version) and
the JAX package on JAX-CPU; every array, dict and report line must be
equal (tolerance 0).  The scenarios share one CRUSH map where the map is
not the point, so the JAX mapper compiles each rule shape once.
"""
import io
import json

import numpy as np
import pytest

from ceph_tpu.crush import (CRUSH_BUCKET_LIST, CRUSH_RULE_CHOOSELEAF_FIRSTN,
                            CRUSH_RULE_EMIT, CRUSH_RULE_TAKE)
from ceph_tpu.crush import CrushMap as RefCrushMap
from ceph_tpu.osdmap import PG as RefPG
from ceph_tpu.osdmap import BulkPGMapper as RefBulkPGMapper
from ceph_tpu.osdmap import Incremental as RefIncremental
from ceph_tpu.osdmap import apply_incremental as ref_apply_incremental
from ceph_tpu.tools import test_map_pgs as ref_map_pgs_report
from ceph_tpu.tools import test_rule as ref_rule_report
from ceph_tpu.tools.crushtool import main as ref_crushtool_main
from ceph_tpu.tools.osdmaptool import main as ref_osdmaptool_main
from ceph_tpu_torch import convert
from ceph_tpu_torch.osdmap import PG, BulkPGMapper, Incremental, \
    apply_incremental
from ceph_tpu_torch.tools import crushtool, osdmaptool

from test_osdmap import build_cluster


def _port(ref_m):
    return convert.osdmap_from_reference(ref_m.to_dict())


def _same_mapping(got, want):
    for f in ("up", "up_primary", "acting", "acting_primary", "pps"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def _map_both(ref_m, pool_id):
    want = RefBulkPGMapper(ref_m).map_pool(pool_id)
    got = BulkPGMapper(_port(ref_m), device="cpu").map_pool(pool_id)
    _same_mapping(got, want)
    return got


def _degrade(m):
    rng = np.random.default_rng(11)
    downs = rng.choice(m.max_osd, size=4, replace=False)
    for o in downs[:2]:
        m.osd_state[o] &= ~2            # down
    for o in downs[2:]:
        m.osd_weight[o] = 0             # out
    m.osd_weight[int(downs[0])] = 0x8000


def _affinity_and_overrides(m, pool_id):
    m.set_primary_affinity(0, 0)
    m.set_primary_affinity(3, 0x8000)
    m.set_primary_affinity(7, 0x4000)
    m.pg_temp[RefPG(pool_id, 2)] = ([8, 7, 6] if pool_id == 1
                                    else [8, 7, 6, 5, 4, 3])
    m.primary_temp[RefPG(pool_id, 4)] = 5
    m.pg_upmap[RefPG(pool_id, 9)] = ([1, 10, 20] if pool_id == 1
                                     else [1, 10, 20, 2, 11, 21])
    up0, *_ = m.pg_to_up_acting_osds(RefPG(pool_id, 5))
    if up0:
        repl = [o for o in range(m.max_osd) if o not in up0][0]
        m.pg_upmap_items[RefPG(pool_id, 5)] = [(up0[0], repl)]


@pytest.mark.parametrize("pool_id", [1, 2])
@pytest.mark.parametrize("scenario", ["clean", "degraded", "overrides",
                                      "all"])
def test_map_pool_matches_jax(pool_id, scenario):
    m = build_cluster()
    if scenario in ("degraded", "all"):
        _degrade(m)
    if scenario in ("overrides", "all"):
        _affinity_and_overrides(m, pool_id)
    got = _map_both(m, pool_id)
    # and the port's own scalar chain agrees PG for PG
    pm = _port(m)
    for ps in range(m.pools[pool_id].pg_num):
        up, upp, act, actp = pm.pg_to_up_acting_osds(PG(pool_id, ps))
        assert got.up[ps][:len(up)].tolist() == up and got.up_primary[ps] \
            == upp and got.acting[ps][:len(act)].tolist() == act and \
            got.acting_primary[ps] == actp, ps


def test_map_pool_nonpow2_and_plain_pps():
    """pg_num off a power of two (stable_mod folds) and a pool without
    FLAG_HASHPSPOOL (seed = ps + pool)."""
    m = build_cluster()
    m.pools[1].pg_num = m.pools[1].pgp_num = 24
    m.pools[2].flags = 0
    _map_both(m, 1)
    _map_both(m, 2)


def test_pool_pps_full_range():
    """Hashed seeds span the whole uint32 range at 2^12 PGs."""
    m = build_cluster()
    m.pools[1].pg_num = m.pools[1].pgp_num = 1 << 12
    want = RefBulkPGMapper(m).pool_pps(m.pools[1])
    got = BulkPGMapper(_port(m), device="cpu").pool_pps(_port(m).pools[1])
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert want.max() >= 1 << 31


def test_map_cluster_and_stage_times():
    m = build_cluster()
    _degrade(m)
    mapper = BulkPGMapper(_port(m), device="cpu")
    got = mapper.map_cluster()
    want = RefBulkPGMapper(m).map_cluster()
    assert sorted(got) == sorted(want)
    for pid in want:
        _same_mapping(got[pid], want[pid])
    assert set(mapper.times) == {"pps", "map", "post"}
    assert all(v > 0 for v in mapper.times.values())


def test_non_straw2_map_maps_through_the_scalar_chain():
    """A rule the bulk path rejects (two choose steps) maps through the
    scalar oracle in both packages."""
    m = build_cluster()
    root = [b for b, bk in m.crush.buckets.items() if bk.type == 3][0]
    ruleno = m.crush.add_rule([(CRUSH_RULE_TAKE, root, 0),
                               (2, 2, 2), (CRUSH_RULE_CHOOSELEAF_FIRSTN, 1, 1),
                               (CRUSH_RULE_EMIT, 0, 0)])
    m.pools[1].crush_rule = ruleno
    m.pools[1].size = 2
    _map_both(m, 1)


def test_osdmap_dict_round_trip_and_incrementals():
    m = build_cluster()
    _degrade(m)
    _affinity_and_overrides(m, 1)
    d = m.to_dict()
    pm = convert.osdmap_from_reference(d)
    assert pm.to_dict() == d
    ref_inc = RefIncremental()
    ref_inc.new_pg_upmap_items[RefPG(1, 3)] = [(0, 5)]
    ref_inc.new_weight = {2: 0}
    inc = Incremental()
    inc.new_pg_upmap_items[PG(1, 3)] = [(0, 5)]
    inc.new_weight = {2: 0}
    assert apply_incremental(pm, inc).to_dict() == \
        ref_apply_incremental(m, ref_inc).to_dict()


def test_object_name_hash_matches_jax_package():
    """ceph_str_hash_rjenkins over every tail length of the 12-byte
    blocks, and the object -> PG placement it feeds."""
    from ceph_tpu.osdmap.str_hash import ceph_str_hash_rjenkins as ref_hash
    from ceph_tpu_torch.osdmap.str_hash import ceph_str_hash_rjenkins
    rng = np.random.default_rng(9)
    for n in range(40):
        data = bytes(rng.integers(0, 256, size=n, dtype=np.uint8))
        assert ceph_str_hash_rjenkins(data) == ref_hash(data)
    for name in ("rbd_data.1234.0000000000000001", "obj", "héllo"):
        assert ceph_str_hash_rjenkins(name) == ref_hash(name)


# -- osdmaptool ---------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["plain", "dump", "dump_all"])
def test_test_map_pgs_report_matches_jax(mode):
    m = build_cluster()
    _degrade(m)
    _affinity_and_overrides(m, 1)
    kw = {"dump": mode == "dump", "dump_all": mode == "dump_all"}
    want_out, got_out = io.StringIO(), io.StringIO()
    want = ref_map_pgs_report(m, out=want_out, **kw)
    got = osdmaptool.test_map_pgs(_port(m), out=got_out, device="cpu", **kw)
    assert got_out.getvalue() == want_out.getvalue()
    assert got == want
    assert list(got["size_hist"]) == list(want["size_hist"])


def test_test_map_pgs_one_pool():
    m = build_cluster()
    want_out, got_out = io.StringIO(), io.StringIO()
    assert osdmaptool.test_map_pgs(_port(m), pool=2, out=got_out,
                                   device="cpu") == \
        ref_map_pgs_report(m, pool=2, out=want_out)
    assert got_out.getvalue() == want_out.getvalue()


def test_osdmaptool_cli_matches_jax(tmp_path, capsys):
    m = build_cluster()
    _degrade(m)
    path = tmp_path / "osdmap.json"
    path.write_text(json.dumps(m.to_dict()))
    args = [str(path), "--print", "--test-map-pg", "1.7", "--test-map-pgs"]
    assert ref_osdmaptool_main(args) == 0
    want = capsys.readouterr().out
    assert osdmaptool.main(args + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out == want


# -- crushtool ----------------------------------------------------------------------

SHOW = {"show_mappings": True, "show_bad_mappings": True,
        "show_statistics": True, "show_utilization": True}


def test_crushtool_report_matches_jax():
    m = build_cluster()
    weights = [0x10000] * m.crush.max_devices
    weights[3] = 0
    weights[5] = 0x8000
    # as many x's as the pools have PGs: the JAX mapper's compilations
    # (one per input shape) are then those of the map_pool tests
    for ruleno, num_rep, max_x in ((0, 3, 63), (1, 6, 47)):
        want_out, got_out = io.StringIO(), io.StringIO()
        want = ref_rule_report(m.crush, ruleno, num_rep, 0, max_x, weights,
                               out=want_out, **SHOW)
        cmap = convert.crushmap_from_reference(m.crush.to_dict())
        got = crushtool.test_rule(cmap, ruleno, num_rep, 0, max_x, weights,
                                  out=got_out, device="cpu", **SHOW)
        assert got_out.getvalue() == want_out.getvalue()
        assert got == want


def test_crushtool_outside_the_envelope_uses_the_interpreter():
    """A list-bucket map is outside the bulk path (ValueError): both
    packages answer through the host interpreter."""
    ref = RefCrushMap()
    ref.add_bucket(CRUSH_BUCKET_LIST, 1, [0, 1, 2], [0x10000] * 3)
    ref.finalize()
    root = min(ref.buckets)
    ruleno = ref.add_rule([(CRUSH_RULE_TAKE, root, 0),
                           (CRUSH_RULE_CHOOSELEAF_FIRSTN, 2, 0),
                           (CRUSH_RULE_EMIT, 0, 0)])
    want_out, got_out = io.StringIO(), io.StringIO()
    want = ref_rule_report(ref, ruleno, 2, 0, 63, out=want_out, **SHOW)
    got = crushtool.test_rule(convert.crushmap_from_reference(ref.to_dict()),
                              ruleno, 2, 0, 63, out=got_out, **SHOW)
    assert got_out.getvalue() == want_out.getvalue() and got == want


def test_crushtool_cli_matches_jax(tmp_path, capsys):
    m = build_cluster()
    path = tmp_path / "crush.json"
    path.write_text(json.dumps(m.crush.to_dict()))
    args = ["-i", str(path), "--test", "--rule", "0", "--num-rep", "3",
            "--max-x", "63", "--weight", "4", "0.5", "--show-mappings",
            "--show-statistics", "--show-utilization",
            "--show-bad-mappings"]
    assert ref_crushtool_main(args) == 0
    want = capsys.readouterr().out
    assert crushtool.main(args + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out == want
