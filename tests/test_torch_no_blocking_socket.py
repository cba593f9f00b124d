"""Guard: the port's ``ceph_tpu_torch/msg/`` stays readiness-driven.

Applies the port's ``blocking-socket`` and ``thread-spawn-site`` rules
(``ceph_tpu_torch.analysis.rules_guards``) to the port's messenger
sources: blocking socket verbs only inside ``on_*`` readiness callbacks,
``threading.Thread`` only at the three fixed spawn sites (the reactor
loop, the dispatch pool, the mux sender).
"""
import ceph_tpu_torch.analysis as A
from ceph_tpu_torch.analysis.engine import ProjectIndex
from ceph_tpu_torch.analysis.rules_guards import (THREAD_SPAWN_ALLOWLIST,
                                                  blocking_socket_sites,
                                                  msg_thread_spawn_sites)


def _index() -> ProjectIndex:
    return ProjectIndex.from_tree(scan=("ceph_tpu_torch/msg",))


def test_scan_sees_the_port_sources():
    idx = _index()
    files = {m.rel.rsplit("/", 1)[-1]
             for m in idx.iter_modules(("ceph_tpu_torch/msg",))}
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
