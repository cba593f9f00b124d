"""The port's ``ceph`` CLI against the JAX package's, on the CPU.

Each package builds a durable cluster alike under its own directory (12
OSDs on 4 hosts, an EC pool k=4 m=2: ``jax_rs`` with ``device=numpy``
and ``torch_rs`` with ``device=cpu``, a replicated pool, the same seeded
objects, a health mute persisted in one scenario) and shuts it down;
then each package's ``tools.ceph_cli.main`` reopens its directory and
the printed text of ``osd tree``, ``pg dump``, ``df``, ``osd df``,
``health detail`` and ``status`` must be equal, byte for byte.  A port
cluster made from the JAX package's stores by
``convert.cluster_from_reference`` prints the same tables too.
"""
from __future__ import annotations

import contextlib
import io
import subprocess
import sys
import os

import pytest

from test_torch_cluster import JAX, PORT, fixed_clock, payload  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VERBS = (["osd", "tree"], ["pg", "dump"], ["df"], ["osd", "df"],
         ["health", "detail"], ["health"], ["status"],
         ["device", "profile", "status"])


def _build(side, d, muted: bool):
    c = side.MiniCluster(n_osds=12, osds_per_host=3, chunk_size=128,
                         cct=side.Context(), data_dir=d,
                         store_backend="bluestore")
    dev = "numpy" if side is JAX else "cpu"
    pid = c.create_ec_pool("ec", {"plugin": side.rs, "k": "4", "m": "2",
                                  "device": dev}, pg_num=8)
    rep = c.create_replicated_pool("rep", 3, 4)
    for i in range(6):
        c.put(pid, f"obj{i}", payload(1000 + 97 * i, seed=i))
        c.put(rep, f"r{i}", payload(300 + i, seed=10 + i))
    if muted:
        c.mute_health("SLOW_OPS")
    c.shutdown()


def _cli(pkg: str, d, argv) -> tuple[int, str]:
    mod = __import__(f"{pkg}.tools.ceph_cli", fromlist=["main"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = mod.main(["--data-dir", str(d), *argv])
    text = out.getvalue()
    # the profiler status names each package's own directory
    return rc, text.replace(str(d), "<D>")


@pytest.mark.parametrize("muted", [False, True], ids=["plain", "muted"])
@pytest.mark.parametrize("argv", VERBS, ids=lambda a: "_".join(a))
def test_cli_text_equals_the_jax_package(tmp_path, argv, muted):
    jd, pd = tmp_path / "jax", tmp_path / "port"
    _build(JAX, jd, muted)
    _build(PORT, pd, muted)
    want = _cli("ceph_tpu", jd, argv)
    got = _cli("ceph_tpu_torch", pd, argv)
    assert got == want
    assert got[0] == 0 and got[1].strip()


@pytest.mark.parametrize("argv", (["osd", "tree"], ["pg", "dump"], ["df"],
                                  ["health", "detail"]),
                         ids=lambda a: "_".join(a))
def test_converted_cluster_prints_the_same_tables(tmp_path, argv):
    """The JAX package's cluster carried across with
    ``convert.cluster_from_reference`` into a durable port cluster."""
    from ceph_tpu_torch import convert
    from test_torch_cluster import _dump_store, _meta
    jd, pd = tmp_path / "jax", tmp_path / "port"
    _build(JAX, jd, muted=False)
    jc = JAX.MiniCluster.load(jd, cct=JAX.Context())
    try:
        meta = _meta(jc)
        dump = {o: _dump_store(d.store) for o, d in jc.osds.items()}
    finally:
        jc.shutdown()
    pc = convert.cluster_from_reference(meta, dump, cct=PORT.Context(),
                                        device="cpu", data_dir=pd,
                                        store_backend="bluestore")
    pc.shutdown()
    assert _cli("ceph_tpu_torch", pd, argv) == _cli("ceph_tpu", jd, argv)


def test_unknown_verb_and_missing_dir(tmp_path):
    from ceph_tpu_torch.tools import ceph_cli
    assert ceph_cli.main(["--data-dir", str(tmp_path), "status"]) == 2
    pd = tmp_path / "port"
    _build(PORT, pd, muted=False)
    with contextlib.redirect_stdout(io.StringIO()):
        assert ceph_cli.main(["--data-dir", str(pd), "no", "such"]) == 2
        assert ceph_cli.main(["--data-dir", str(pd), "device", "profile",
                              "start"]) == 2


def test_status_as_a_process(tmp_path):
    pd = tmp_path / "port"
    _build(PORT, pd, muted=False)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.tools.ceph_cli",
         "--data-dir", str(pd), "-s"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "health: HEALTH_OK" in proc.stdout
    assert proc.stdout == _cli("ceph_tpu_torch", pd, ["status"])[1]
