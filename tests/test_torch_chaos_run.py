"""The seeded chaos campaign over the port (``tools/chaos_run.py``), on
the CPU, against the JAX package's campaign.

Two port campaigns at seed 13 must hold what the JAX package's soak
asserts (``tests/test_chaos.py::TestChaosSoak``), with phase 3 as the
port runs it: no host fallback, so every faulted future fails (the
injected fault, then ``BreakerOpen``) and the half-open probe re-closes
the breaker through the kernel's path.  One JAX campaign at the same
seed must agree with them on the writes, the flapping OSD, the health
checks raised and the injected events.
"""
import copy
import importlib.util
import sys
from pathlib import Path

import pytest

from ceph_tpu_torch.tools import chaos_run

SEED, OPS = 13, 12


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def reports():
    return [chaos_run.run_campaign(seed=SEED, ops=OPS, device="cpu")
            for _ in range(2)]


@pytest.fixture(scope="module")
def jax_report():
    root = str(Path(__file__).resolve().parent.parent)
    sys.path.insert(0, root)
    try:
        from tools.chaos_run import run_campaign
    finally:
        sys.path.remove(root)
    return run_campaign(seed=SEED, ops=OPS)


def test_campaign_deterministic_and_invariants_hold(reports):
    for rep in reports:
        assert rep["ok"] and rep["device"] == "cpu"
        assert rep["verified"] == rep["acked_writes"] > 0
        assert rep["breaker"]["opens"] >= 1
        assert rep["breaker"]["state"] == "closed"
        assert {"OSD_FLAPPING", "DEVICE_DEGRADED"} <= \
            set(rep["health_seen"])
        assert rep["events"]["total"] > 0
    assert reports[0]["event_digest"] == reports[1]["event_digest"], \
        "same seed produced different injected-event logs"


def test_phase3_fails_fast_and_the_probe_recloses(reports):
    for rep in reports:
        # threshold 2: two batches fail with the injected dispatch fault
        # and open the breaker, the other four fail fast; none is served
        assert rep["phase3"]["failed"] == {"BreakerOpen": 4,
                                           "InjectedFault": 2}
        assert rep["phase3"]["probe_gf_apply"] == 1
        assert rep["breaker"]["probes"] == 1
        assert rep["events"]["planes"]["device"] == {"dispatch_fail": 2}


def test_campaign_books_its_launches(reports):
    for rep in reports:
        # device="cpu": the plain versions, booked on the ledger's cpu
        # route through the same wrappers the card's launches go through
        assert rep["launches"]["gf_apply"] > 0
        assert rep["launches"]["crc32c_rows"] > 0
        t = rep["timing"]
        assert t["puts"] == OPS and t["gets"] > 0
        assert t["put_ms"] > 0 and t["get_ms"] > 0
    assert reports[0]["launches"] == reports[1]["launches"]


def test_campaign_matches_the_jax_packages(reports, jax_report):
    ref = jax_report
    assert ref["ok"]
    for rep in reports:
        assert (rep["acked_writes"], rep["verified"]) == \
            (ref["acked_writes"], ref["verified"])
        assert rep["flap"] == ref["flap"]
        assert rep["health_seen"] == ref["health_seen"]
        # every plane but the device plane is untouched by the port's
        # phase 3; the device plane rolls the same two dispatch faults
        # (the JAX package's breaker also opens at 2 and its fallback
        # rolls nothing), so the whole event log agrees
        for plane, counts in ref["events"]["planes"].items():
            if plane != "device":
                assert rep["events"]["planes"][plane] == counts, plane
        assert rep["events"] == ref["events"]
        assert rep["event_digest"] == ref["event_digest"]
        assert rep["tier"]["acked_writes"] == ref["tier"]["acked_writes"]
        assert rep["tier"]["victims"] == ref["tier"]["victims"]
        assert rep["transport"] == ref["transport"]


def test_cli_writes_the_report(tmp_path, monkeypatch, capsys):
    seen = {}

    def fake(**kw):
        seen.update(kw)
        return {"ok": True, "seed": kw["seed"]}
    monkeypatch.setattr(chaos_run, "run_campaign", fake)
    out = tmp_path / "r.json"
    assert chaos_run.main(["--seed", "5", "--ops", "3", "--device", "cpu",
                           "--json", str(out), "-q"]) == 0
    assert seen == {"seed": 5, "ops": 3, "data_dir": None,
                    "verbose": False, "device": "cpu"}
    assert '"seed": 5' in out.read_text()

    def failing(**kw):
        raise AssertionError("invariant broke")
    monkeypatch.setattr(chaos_run, "run_campaign", failing)
    assert chaos_run.main(["--device", "cpu", "-q"]) == 1
    assert "CHAOS FAIL: invariant broke" in capsys.readouterr().err


def test_chip_smoke_phase_chaos_checks_the_campaigns(reports, monkeypatch):
    """chip_smoke's phase ``chaos`` over this module's two campaigns
    (replayed, not rerun): its checks pass, and its tracer line shows the
    default tracer following the campaign Context's live conf.set."""
    from ceph_tpu_torch.common import tracer
    from ceph_tpu_torch.ops import rs_kernels
    chip_smoke = _chip_smoke()
    replay = iter(copy.deepcopy(reports))
    monkeypatch.setattr(chaos_run, "run_campaign",
                        lambda **kw: next(replay))
    tr = tracer.default_tracer()
    saved = (tr.sample_rate, tr.slow_threshold_s)
    try:
        out, wiring, n_apply, n_crc = chip_smoke.phase_chaos(
            rs_kernels, "card, 700 W", device="cpu")
    finally:
        tr.sample_rate, tr.slow_threshold_s = saved
    assert out["digests_equal"] and len(out["campaigns"]) == 2
    assert all(c["launches"]["gf_apply"] > 0 for c in out["campaigns"])
    assert (n_apply, n_crc) == (0, 0)          # no card launch on the CPU
    assert wiring == {"slow_threshold_s": 5.0, "osd_op_complaint_time": 5.0,
                      "sample_rate": 1.0, "tracer_sample_rate": 1.0}


def test_chip_smoke_phase_chaos_fails_on_diverging_digests(reports,
                                                           monkeypatch):
    from ceph_tpu_torch.ops import rs_kernels
    bad = copy.deepcopy(reports)
    bad[1]["event_digest"] = "0" * 64
    chip_smoke = _chip_smoke()
    replay = iter(bad)
    monkeypatch.setattr(chaos_run, "run_campaign",
                        lambda **kw: next(replay))
    with pytest.raises(AssertionError, match="digests"):
        chip_smoke.phase_chaos(rs_kernels, "card", device="cpu")
