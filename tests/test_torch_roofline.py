"""The port's roofline ledger against the JAX package's, on the CPU.

The same ``record_compile`` / ``record_call`` sequences with the same
peak overrides go through ``ceph_tpu.common.roofline`` and
``ceph_tpu_torch.common.roofline``; every ``snapshot()`` row and the
totals must be equal (floats to 1e-12 relative, the rest exactly).  The
port's own parts are tested beside them: the H100 peak registry (no TPU
entry), the ``cuda_event`` estimator of rows the launch ledger times on
the card, host-booked rows judged against the nominal CPU peaks, and
the ``device roofline`` admin command.
"""
from __future__ import annotations

import pytest

from ceph_tpu.common import Context as JContext
from ceph_tpu.common import roofline as jroof
from ceph_tpu_torch.common import Context, roofline
from ceph_tpu_torch.common import device_telemetry

PEAKS = {"device_peak_flops": 1e12, "device_peak_hbm_bytes_per_sec": 2e11}
KEY = (((4, 8), "uint8"), ((8, 1024), "uint8"))
SMALL = (((2, 2), "uint8"),)

# (op, args) sequences played on both modules
SEQUENCES = {
    "memory_bound": [
        ("compile", ("enc", KEY, 512.0, 1024.0)),
        ("call", ("enc", KEY, 0.001, True)),
        ("call", ("enc", KEY, 0.001))],
    "compute_bound": [
        ("compile", ("mm", SMALL, 1e9, 1e3)),
        ("call", ("mm", SMALL, 0.01, True)),
        ("call", ("mm", SMALL, 0.012))],
    "input_bytes_fallback": [
        ("compile", ("nf", SMALL, 0.0, 0.0, 4096)),
        ("call", ("nf", SMALL, 0.001))],
    "async_undercount": [
        ("compile", ("a", KEY, 1e6, 1e6)),
        ("call", ("a", KEY, 0.010, True))] + [
        ("call", ("a", KEY, 0.0001))] * 9 + [
        ("compile", ("s", KEY, 1e6, 1e6)),
        ("call", ("s", KEY, 0.010, True)),
        ("call", ("s", KEY, 0.009))],
    "reset_reseeds_from_cost": [
        ("compile", ("enc", KEY, 10.0, 100.0)),
        ("call", ("enc", KEY, 0.001, True, (10.0, 100.0, 0))),
        ("reset", ()),
        ("call", ("enc", KEY, 0.002, False, (10.0, 100.0, 0))),
        ("call", ("ghost", SMALL, 0.001))],
    "recompile_and_two_rows": [
        ("compile", ("enc", KEY, 10.0, 100.0)),
        ("call", ("enc", KEY, 0.001, True)),
        ("compile", ("enc", KEY, 20.0, 300.0)),
        ("call", ("enc", KEY, 0.003)),
        ("compile", ("dec", SMALL, 0.0, 64.0)),
        ("call", ("dec", SMALL, 0.0005, True))],
}


def _play(mod, seq) -> None:
    mod.reset()
    for op, args in seq:
        if op == "compile":
            mod.record_compile(*args)
        elif op == "call":
            mod.record_call(*args)
        else:
            mod.reset()


def _close(a, b) -> bool:
    if isinstance(a, float) or isinstance(b, float):
        return a == pytest.approx(b, rel=1e-12, abs=1e-12)
    return a == b


@pytest.fixture(autouse=True)
def _fresh():
    roofline.reset()
    jroof.reset()
    yield
    roofline.reset()
    jroof.reset()


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_snapshot_rows_equal_the_jax_package(name):
    _play(jroof, SEQUENCES[name])
    _play(roofline, SEQUENCES[name])
    want = jroof.snapshot(JContext(PEAKS))
    got = roofline.snapshot(Context(PEAKS))
    assert sorted(got["executables"]) == sorted(want["executables"])
    assert got["executables"], name
    for eid, row in want["executables"].items():
        assert set(got["executables"][eid]) == set(row), eid
        for field, v in row.items():
            assert _close(got["executables"][eid][field], v), (eid, field)
    for field, v in want["totals"].items():
        assert _close(got["totals"][field], v), field
    for field in ("flops", "hbm_bytes_s", "source", "ridge_flops_per_byte"):
        assert got["peaks"][field] == want["peaks"][field]


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_report_and_table_equal_the_jax_package(name):
    _play(jroof, SEQUENCES[name])
    _play(roofline, SEQUENCES[name])
    want = jroof.report(limit=5, cct=JContext(PEAKS))
    got = roofline.report(limit=5, cct=Context(PEAKS))
    assert [r["executable"] for r in got["executables"]] == \
        [r["executable"] for r in want["executables"]]
    assert roofline.render_table(got) == jroof.render_table(want)


def test_flat_series_keys_equal_the_jax_package():
    _play(jroof, SEQUENCES["memory_bound"])
    _play(roofline, SEQUENCES["memory_bound"])
    assert set(roofline.flat_series()) == set(jroof.flat_series())


@pytest.mark.parametrize("kind,flops,hbm,source", [
    ("NVIDIA H100 80GB HBM3", 989e12, 3.35e12, "registry:h100 hbm3"),
    ("NVIDIA H100 PCIe", 756e12, 2.0e12, "registry:h100 pcie"),
])
def test_h100_registry(kind, flops, hbm, source):
    p = roofline.lookup_peaks(device_kind=kind, platform="gpu")
    assert (p["flops"], p["hbm_bytes_s"], p["source"]) == (flops, hbm,
                                                          source)
    assert p["ridge_flops_per_byte"] == pytest.approx(flops / hbm)


@pytest.mark.parametrize("kind,platform", [
    ("NVIDIA A100-SXM4-80GB", "gpu"), ("TPU v5 lite", "tpu"),
    ("TPU v5e", "tpu"), ("cpu", "cpu")])
def test_unknown_kinds_fall_to_overrides_then_nominal_cpu(kind, platform):
    """No TPU entry and no guess: a kind the registry does not know takes
    the option overrides, and without them the nominal CPU spec."""
    p = roofline.lookup_peaks(device_kind=kind, platform=platform)
    assert p["source"].startswith("nominal-cpu(")
    p = roofline.lookup_peaks(Context(PEAKS), device_kind=kind,
                              platform=platform)
    assert (p["flops"], p["hbm_bytes_s"], p["source"]) == (1e12, 2e11,
                                                          "config")
    p = roofline.lookup_peaks(
        Context({"device_peak_hbm_bytes_per_sec": 1e12}),
        device_kind="NVIDIA H100 80GB HBM3", platform="gpu")
    assert (p["flops"], p["hbm_bytes_s"]) == (989e12, 1e12)
    assert p["source"] == "registry:h100 hbm3+config-hbm"


def test_peaks_come_from_the_inventory(monkeypatch):
    monkeypatch.setattr(device_telemetry, "device_inventory", lambda: {
        "device_kind": "NVIDIA H100 80GB HBM3", "platform": "gpu"})
    assert roofline.lookup_peaks()["source"] == "registry:h100 hbm3"


def test_cuda_event_rows_keep_their_device_seconds():
    """A row timed by CUDA events is device time: the mean of the
    launches after the synced first one (which also loads the kernel's
    module) stands for every call."""
    key = (((4, 8), "uint8"), ((8, 524288), "uint8"))
    cost = (0.0, 6291456.0, 0)
    roofline.record_compile("gf_apply", key, *cost[:2],
                            meta={"modeled_source": "launch_ledger",
                                  "route": "cuda"})
    roofline.record_call("gf_apply", key, 0.5, synced=True, cost=cost,
                         clock="cuda_event")
    for _ in range(9):
        roofline.record_call("gf_apply", key, 0.001, cost=cost,
                             clock="cuda_event")
    snap = roofline.snapshot(Context())
    row = snap["executables"]["gf_apply[4x8:uint8,8x524288:uint8]"]
    assert row["estimator"] == "cuda_event"
    assert row["est_seconds"] == pytest.approx(0.010)
    assert row["seconds"] == pytest.approx(0.509)
    assert row["modeled_source"] == "launch_ledger"
    assert row["route"] == "cuda" and row["bound"] == "memory"


def test_host_rows_judged_against_cpu_peaks_on_a_card(monkeypatch):
    monkeypatch.setattr(device_telemetry, "device_inventory", lambda: {
        "device_kind": "NVIDIA H100 80GB HBM3", "platform": "gpu"})
    cost = (0.0, 3e10, 0)
    for route, key in (("cuda", SMALL), ("cpu", SMALL + ("cpu",))):
        roofline.record_compile("k", key, *cost[:2],
                                meta={"route": route})
        roofline.record_call("k", key, 1.0, cost=cost)
    rows = roofline.snapshot()["executables"]
    assert rows["k[2x2:uint8]"]["pct_of_peak"] == pytest.approx(
        100 * 3e10 / 3.35e12, rel=1e-3)
    assert rows["k[2x2:uint8,cpu]"]["pct_of_peak"] == pytest.approx(
        100 * 3e10 / roofline.CPU_NOMINAL_DRAM_BPS, rel=1e-3)


def test_admin_command_and_refresh():
    cct = Context(PEAKS)
    roofline.record_compile("enc", KEY, 100.0, 1000.0)
    roofline.record_call("enc", KEY, 0.001)
    rep = cct.admin_socket.call("device roofline")
    assert rep["executables"][0]["executable"] == \
        "enc[4x8:uint8,8x1024:uint8]"
    snap = roofline.refresh(cct)
    pc = cct.perf.get("device_efficiency")
    assert pc.get("executables") == 1 and pc.get("calls") == 1
    assert pc.get("achieved_bytes_s") == int(
        snap["totals"]["achieved_bytes_s"])


def test_resolvers_run_before_a_snapshot():
    ran = []
    fn = lambda: ran.append(1)                      # noqa: E731
    roofline.add_resolver(fn)
    roofline.add_resolver(fn)
    try:
        roofline.snapshot()
        assert ran == [1]
    finally:
        roofline._resolvers.remove(fn)
