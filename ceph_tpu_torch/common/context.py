"""Context: the per-process service bundle (CephContext analog).

A cut of ``ceph_tpu.common.context`` to what the port's serving path,
OSD backend and monitor read: the config store (``conf``, a
:class:`ConfigProxy`), the log (``log``, ``dout``), the perf-counter
collection (``perf``), with the device-attribution ledger registered in
it, and the admin socket (``admin_socket``), where PG backends hang
their op-tracker dumps.  The standard admin commands of the JAX
package's Context are not ported yet.
"""
from __future__ import annotations

from . import device_attribution
from .admin_socket import AdminSocket
from .log import Log
from .options import ConfigProxy
from .perf_counters import PerfCountersCollection


class Context:
    def __init__(self, overrides: dict | None = None):
        self.conf = ConfigProxy(overrides)
        self.log = Log(self.conf)
        self.perf = PerfCountersCollection()
        # the device-time attribution ledger (who occupies the card, by
        # owner class) is process-wide: every Context's collection
        # carries it
        self.perf.add(device_attribution.perf_counters())
        self.admin_socket = AdminSocket()

    def dout(self, subsys: str, level: int, message: str) -> None:
        self.log.dout(subsys, level, message)


_default: Context | None = None


def default_context() -> Context:
    global _default
    if _default is None:
        _default = Context()
    return _default
