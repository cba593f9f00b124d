"""The port's soak campaign (``ceph_tpu_torch/tools/soak_sweep.py``) on the
CPU, against the JAX package's (``tests/test_soak.py``).

Both packages' ``MiniCluster.operate`` and ``scrub_pool`` are wrapped to
log each call: the oid, the op kinds, the snap read and the outcome (a
digest of every op's result, or the exception's class); a scrub logs its
report.  At seeds 1 and 113 on both pool types the port's campaign
(``torch_rs`` with ``device="cpu"``, the plain versions) must give the
JAX campaign's log exactly.  At all seven seeds of the JAX test the
port's own model must hold, and ``ceph_tpu_torch.cluster.MessageBus`` is
restored after a campaign that raises.
"""
import hashlib
import importlib.util
from pathlib import Path

import pytest

import ceph_tpu.cluster as jax_cluster
import ceph_tpu_torch.cluster as port_cluster
from ceph_tpu_torch.tools import soak_sweep

ROOT = Path(__file__).resolve().parents[1]
SEEDS = [1, 7, 106, 110, 113, 114, 20260730]      # tests/test_soak.py:41


@pytest.fixture(scope="module")
def jax_soak():
    spec = importlib.util.spec_from_file_location(
        "jax_test_soak", ROOT / "tests" / "test_soak.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _digest(value) -> str:
    return hashlib.sha256(repr(value).encode()).hexdigest()[:16]


def _canonical_scrub(report: dict) -> list:
    return sorted((str(pg), sorted((oid, sorted(shards))
                                   for oid, shards in objs.items()))
                  for pg, objs in report.items())


def _record(monkeypatch, cls) -> list:
    """Wrap ``cls.operate`` and ``cls.scrub_pool``; returns the log."""
    log = []
    operate, scrub_pool = cls.operate, cls.scrub_pool

    def logged_operate(self, pool_id, oid, op, *args, **kw):
        kinds = [o.op for o in op.ops]
        head = ("op", oid, kinds, kw.get("snapid"))
        try:
            reply = operate(self, pool_id, oid, op, *args, **kw)
        except Exception as e:
            log.append(head + (type(e).__name__,))
            raise
        log.append(head + (_digest([reply.outdata(i)
                                    for i in range(len(kinds))]),))
        return reply

    def logged_scrub(self, pool_id, *args, **kw):
        rep = scrub_pool(self, pool_id, *args, **kw)
        log.append(("scrub", _canonical_scrub(rep)))
        return rep

    monkeypatch.setattr(cls, "operate", logged_operate)
    monkeypatch.setattr(cls, "scrub_pool", logged_scrub)
    return log


@pytest.mark.parametrize("pool_type", ["ec", "rep"])
@pytest.mark.parametrize("seed", [1, 113])
def test_campaign_log_equals_the_jax_campaign(jax_soak, monkeypatch, seed,
                                              pool_type):
    jax_log = _record(monkeypatch, jax_cluster.MiniCluster)
    jax_soak.test_soak_campaign(seed, pool_type)
    port_log = _record(monkeypatch, port_cluster.MiniCluster)
    report = soak_sweep.soak_campaign(seed, pool_type, device="cpu")
    assert len(port_log) > 100
    assert sum(e[0] == "scrub" for e in port_log) >= 3
    assert port_log == jax_log
    assert report["final_scrub"] == {} and report["health"] == "HEALTH_OK"


@pytest.mark.parametrize("pool_type", ["ec", "rep"])
@pytest.mark.parametrize("seed", SEEDS)
def test_model_holds(seed, pool_type):
    report = soak_sweep.soak_campaign(seed, pool_type, device="cpu")
    assert report["steps"] == soak_sweep.STEPS
    assert sum(report["actions"].values()) == soak_sweep.STEPS
    assert report["final_scrub"] == {}
    assert report["health"] == "HEALTH_OK"
    assert report["device"] == ("cpu" if pool_type == "ec" else None)


@pytest.mark.parametrize("where", ["setup", "step"])
def test_message_bus_restored_after_a_raising_campaign(monkeypatch, where):
    bus = port_cluster.MessageBus
    if where == "setup":
        target, name = port_cluster.MiniCluster, "attach_monitor"
    else:
        target, name = port_cluster.MiniCluster, "scrub_pool"

    def boom(*args, **kw):
        assert port_cluster.MessageBus is not bus     # the faulty bus
        raise RuntimeError("injected")
    monkeypatch.setattr(target, name, boom)
    with pytest.raises(RuntimeError, match="injected"):
        soak_sweep.soak_campaign(113, "ec", device="cpu")
    assert port_cluster.MessageBus is bus


def test_a_broken_model_raises(monkeypatch):
    """The model's checks fire: a read that returns other bytes than the
    model acked fails the campaign with AssertionError."""
    orig = port_cluster.MiniCluster.operate

    def corrupting(self, pool_id, oid, op, *args, **kw):
        reply = orig(self, pool_id, oid, op, *args, **kw)
        if op.ops[0].op == "read" and reply.outdata(0):
            data = bytearray(reply.outdata(0))
            data[0] ^= 1
            reply.ops[0].outdata = bytes(data)
        return reply
    monkeypatch.setattr(port_cluster.MiniCluster, "operate", corrupting)
    with pytest.raises(AssertionError):
        soak_sweep.soak_campaign(1, "rep", device="cpu")


def test_sweep_main_summary(capsys, monkeypatch):
    """main() mirrors tools/soak_sweep.py: the summary line, the shrink
    hint and exit 1 on a failure, exit 0 on none."""
    assert soak_sweep.main(["--seeds", "1", "2", "--pool-types", "rep",
                            "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip() == "1 campaigns, 0 failures"

    def fail(seed, pool_type, device="cuda"):
        raise AssertionError(f"model broke at {seed}")
    monkeypatch.setattr(soak_sweep, "soak_campaign", fail)
    assert soak_sweep.main(["--seeds", "3", "5", "--pool-types", "ec",
                            "rep", "--device", "cpu"]) == 1
    captured = capsys.readouterr()
    assert captured.out.splitlines()[0] == "4 campaigns, 4 failures"
    assert "shrink a failure" in captured.out
    assert "FAIL seed=3 ec: model broke at 3" in captured.err
