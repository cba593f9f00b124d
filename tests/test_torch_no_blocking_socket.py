"""Guard: the port's ``ceph_tpu_torch/msg/`` stays readiness-driven.

Applies the reference's ``blocking-socket`` and ``thread-spawn-site``
rules (``ceph_tpu.analysis.rules_guards``) to the port's messenger
sources, unchanged: blocking socket verbs only inside ``on_*`` readiness
callbacks, ``threading.Thread`` only at the three fixed spawn sites (the
reactor loop, the dispatch pool, the mux sender).  The rules scope
``ceph_tpu/msg``, so the port's files are indexed under that prefix.
"""
import os

import ceph_tpu.analysis as A
from ceph_tpu.analysis.engine import ProjectIndex
from ceph_tpu.analysis.rules_guards import (THREAD_SPAWN_ALLOWLIST,
                                            blocking_socket_sites,
                                            msg_thread_spawn_sites)

MSG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "ceph_tpu_torch", "msg")


def _index() -> ProjectIndex:
    files = {}
    for name in sorted(os.listdir(MSG)):
        if name.endswith(".py"):
            with open(os.path.join(MSG, name)) as f:
                files[f"ceph_tpu/msg/{name}"] = f.read()
    return ProjectIndex(files)


def test_scan_sees_the_port_sources():
    idx = _index()
    files = {m.rel.rsplit("/", 1)[-1]
             for m in idx.iter_modules(("ceph_tpu/msg",))}
    assert {"connection.py", "reactor.py", "server.py", "client.py",
            "parser.py", "staging.py", "proto.py", "shed.py",
            "frontend.py"} <= files
    assert ("connection.py", "AsyncConnection.on_readable", "recv") in \
        blocking_socket_sites(idx)


def test_blocking_socket_verbs_only_in_readiness_callbacks():
    offenders = [f.render() for f in A.run_rules(_index(),
                                                 ("blocking-socket",))]
    assert not offenders, "\n".join(offenders)


def test_no_per_connection_thread_spawns():
    idx = _index()
    offenders = [f.render() for f in A.run_rules(idx,
                                                 ("thread-spawn-site",))]
    assert not offenders, "\n".join(offenders)
    assert msg_thread_spawn_sites(idx) == THREAD_SPAWN_ALLOWLIST
