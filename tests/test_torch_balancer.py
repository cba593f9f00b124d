"""The port's balancer against the JAX package's, exactly.

osd_deviation, the crush-compat weight set (calc_weight_set) and the
upmap optimizer (calc_pg_upmaps, and osdmaptool --upmap over it) on maps
built in the JAX package (tests/test_osdmap.py's ``build_cluster``) and
carried across with ``convert.osdmap_from_reference``.  The port maps on
the CPU (``device="cpu"``); counts, targets, weight sets and upmap
entries must be identical.
"""
import json

import numpy as np
import pytest
import torch

from ceph_tpu.mgr import calc_pg_upmaps as ref_calc_pg_upmaps
from ceph_tpu.mgr import calc_weight_set as ref_calc_weight_set
from ceph_tpu.mgr import osd_deviation as ref_osd_deviation
from ceph_tpu.tools.osdmaptool import main as ref_osdmaptool_main
from ceph_tpu_torch import convert
from ceph_tpu_torch.mgr import (calc_pg_upmaps, calc_weight_set,
                                osd_deviation)
from ceph_tpu_torch.ops import crush_kernels
from ceph_tpu_torch.tools import osdmaptool

from test_osdmap import build_cluster


def _cluster(pg_num=128):
    """build_cluster's map with more PGs in the replicated pool (room to
    balance) and one OSD reweighted, as the balancer tests run it."""
    m = build_cluster()
    m.pools[1].pg_num = m.pools[1].pgp_num = pg_num
    m.osd_weight[4] = 0xC000
    return m


def _port(ref_m):
    return convert.osdmap_from_reference(ref_m.to_dict())


@pytest.mark.parametrize("pools", [None, [1], [2]])
def test_osd_deviation_matches_jax(pools):
    m = _cluster()
    want_c, want_t, want_maps = ref_osd_deviation(m, pools)
    got_c, got_t, got_maps = osd_deviation(_port(m), pools, device="cpu")
    assert np.array_equal(got_c, want_c) and got_c.dtype == want_c.dtype
    assert np.array_equal(got_t, want_t)
    assert sorted(got_maps) == sorted(want_maps)
    for pid in want_maps:
        assert np.array_equal(got_maps[pid].up, want_maps[pid].up)


@pytest.mark.parametrize("pools", [[1], None])
def test_calc_weight_set_matches_jax(pools):
    m = _cluster()
    want = ref_calc_weight_set(m, max_iterations=6, pools=pools)
    got = calc_weight_set(_port(m), max_iterations=6, pools=pools,
                          device="cpu")
    assert got == want
    assert want is not None


@pytest.mark.parametrize("pools,max_deviation", [([1], 1.0), (None, 2.0)])
def test_calc_pg_upmaps_matches_jax(pools, max_deviation):
    m = _cluster()
    want = ref_calc_pg_upmaps(m, max_iterations=8,
                              max_deviation=max_deviation, pools=pools)
    got = calc_pg_upmaps(_port(m), max_iterations=8,
                         max_deviation=max_deviation, pools=pools,
                         device="cpu")
    assert {(pg.pool, pg.ps): items
            for pg, items in got.new_pg_upmap_items.items()} == \
        {(pg.pool, pg.ps): items
         for pg, items in want.new_pg_upmap_items.items()}
    assert want.new_pg_upmap_items


def test_osdmaptool_upmap_cli_matches_jax(tmp_path, capsys):
    m = _cluster()
    path = tmp_path / "osdmap.json"
    path.write_text(json.dumps(m.to_dict()))
    want_file, got_file = tmp_path / "want.json", tmp_path / "got.json"
    assert ref_osdmaptool_main([str(path), "--upmap", str(want_file),
                                "--upmap-max", "6", "--pool", "1"]) == 0
    want = capsys.readouterr().out
    assert osdmaptool.main([str(path), "--upmap", str(got_file),
                            "--upmap-max", "6", "--pool", "1",
                            "--device", "cpu"]) == 0
    assert capsys.readouterr().out == want.replace(str(want_file),
                                                   str(got_file))
    assert got_file.read_text() == want_file.read_text()


def test_balancer_defaults_to_the_card(monkeypatch):
    """With no device the balancer maps on the card: without one it
    raises and nothing runs on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = _port(_cluster())
    crush_kernels.reset_launches()
    for call in (lambda: osd_deviation(m),
                 lambda: calc_weight_set(m, max_iterations=1),
                 lambda: calc_pg_upmaps(m, max_iterations=1)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    assert crush_kernels.launches == {"crush_straw2": 0}
