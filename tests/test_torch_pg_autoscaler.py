"""The port's pg_autoscaler against the JAX package's, on the CPU.

The same maps (``tests/test_osdmap.build_cluster`` carried across with
``convert.osdmap_from_reference``, with OSDs marked out and pools whose
profile is only a string, as a reloaded map holds them; and the maps of
MiniClusters built alike) and the same usage, capacity and per-pool
options give recommendations that are equal, field for field.
"""
from __future__ import annotations

import pytest

from ceph_tpu.mgr import pg_autoscaler as jauto
from ceph_tpu_torch import convert
from ceph_tpu_torch.mgr import pg_autoscaler as auto
from test_osdmap import build_cluster
from test_torch_cluster import JAX, PORT, fixed_clock  # noqa: F401

GIB = 1 << 30

CASES = {
    "grow_and_shrink": ({1: 1 << 20, 2: 40 * GIB}, 100 * GIB,
                        {2: {"k": 4}}, 100),
    "target_ratio": ({1: 0, 2: 0}, 100 * GIB,
                     {1: {"target_size_ratio": 0.5}}, 100),
    "bias_and_floor": ({1: 5 * GIB, 2: 1 * GIB}, 50 * GIB,
                       {1: {"pg_autoscale_bias": 4.0},
                        2: {"pg_num_min": 32, "k": 2}}, 200),
    "target_bytes": ({1: 0, 2: 2 * GIB}, 10 * GIB,
                     {1: {"target_size_bytes": 6 * GIB}}, 50),
    "no_capacity": ({1: 10, 2: 10}, 0, {}, 100),
}


def _maps(out_osds=(), profile: str | None = None):
    ref = build_cluster(seed=3)
    for o in out_osds:
        ref.osd_weight[o] = 0
    if profile is not None:
        ref.pools[2].erasure_code_profile = profile
    return ref, convert.osdmap_from_reference(ref.to_dict())


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("out_osds,profile", [
    ((), None), ((0, 5, 13), None), ((), "k=4 m=2 plugin=jerasure")],
    ids=["all_in", "three_out", "profile_string"])
def test_recommendations_equal_the_jax_package(name, out_osds, profile):
    used, cap, opts, target = CASES[name]
    ref, port = _maps(out_osds, profile)
    want = jauto.autoscale_recommendations(ref, used, cap, target, opts)
    got = auto.autoscale_recommendations(port, used, cap, target, opts)
    assert got == want
    assert [r["pool_id"] for r in got] == [1, 2]


@pytest.mark.parametrize("n", [0.5, 1, 3, 5, 6.1, 1500, 2 ** 20 + 1])
def test_nearest_power_of_two(n):
    assert auto.nearest_power_of_two(n) == jauto.nearest_power_of_two(n)


def test_cluster_maps_give_equal_recommendations():
    recs = []
    for side in (JAX, PORT):
        c = side.MiniCluster(n_osds=12, osds_per_host=3, chunk_size=128,
                             cct=side.Context())
        try:
            dev = "numpy" if side is JAX else "cpu"
            ec = c.create_ec_pool("ec", {"plugin": side.rs, "k": "4",
                                         "m": "2", "device": dev},
                                  pg_num=32)
            rep = c.create_replicated_pool("rep", 3, 8)
            mod = jauto if side is JAX else auto
            recs.append(mod.autoscale_recommendations(
                c.osdmap, {ec: 3 * GIB, rep: GIB}, 12 * 4 * GIB))
        finally:
            c.shutdown()
    assert recs[0] == recs[1]
    assert {r["raw_used_rate"] for r in recs[1]} == {1.5, 3.0}
