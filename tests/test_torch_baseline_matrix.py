"""The port's baseline matrix tool on the CPU, against the JAX tool's
JSON keys (BASELINE_RESULTS.json is that tool's output)."""
import json
import os

import pytest

from ceph_tpu_torch.tools import baseline_matrix

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "BASELINE_RESULTS.json")) as _f:
    JAX_RESULTS = json.load(_f)


def keys(x):
    """The key tree of a result (a list of dicts by its first entry)."""
    if isinstance(x, dict):
        return {k: keys(v) for k, v in x.items()}
    if isinstance(x, list) and x and isinstance(x[0], dict):
        return [keys(x[0])]
    return None


@pytest.fixture(scope="module")
def quick_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("baseline") / "results.json"
    assert baseline_matrix.main(["--quick", "--only", "1,3", "--device",
                                 "cpu", "--out", str(out)]) == 0
    with open(out) as f:
        return json.load(f)


def test_keys_equal_the_jax_tools(quick_run):
    assert set(quick_run) == {"cpu_baseline_simd", "batch_queue_curve",
                              "_meta"}
    for name, got in quick_run.items():
        assert keys(got) == keys(JAX_RESULTS[name]), name


def test_cpu_baseline_runs_the_native_codec(quick_run):
    got = quick_run["cpu_baseline_simd"]
    assert got["simd_name"] == {0: "scalar", 1: "avx2", 2: "gfni+avx2",
                                3: "gfni+avx512"}[got["simd_level"]]
    for km in ("rs_k4m2", "rs_k8m4"):
        assert got[km]["encode_mibs"] > 0 and got[km]["decode_mibs"] > 0


def test_batch_queue_curve_coalesces(quick_run):
    got = quick_run["batch_queue_curve"]
    assert (got["k"], got["m"], got["chunk"]) == (8, 4, 4096)
    curve = got["curve"]
    assert [p["max_batch"] for p in curve] == [1, 4, 16, 64, 256]
    # the warm-up stripe, then 256 stripes in batches of at most max_batch
    assert curve[0]["dispatches"] == 257
    for p in curve:
        assert 1 + -(-256 // p["max_batch"]) <= p["dispatches"] <= 257
        assert p["stripes_per_s"] > 0 and p["mibs"] > 0


def test_single_stripe_keys_equal_the_jax_tools(tmp_path):
    out = tmp_path / "results.json"
    assert baseline_matrix.main(["--quick", "--only", "2", "--device",
                                 "cpu", "--out", str(out)]) == 0
    with open(out) as f:
        got = json.load(f)["single_stripe_incl_transfer"]
    assert keys(got) == keys(JAX_RESULTS["single_stripe_incl_transfer"])
    assert got["platform"] == "cpu"
