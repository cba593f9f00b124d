"""Context: the per-process service bundle (CephContext analog).

The port's copy of ``ceph_tpu.common.context``: owns the config store
(``conf``, a :class:`ConfigProxy`), the log (``log``, ``dout``), the
perf-counter collection (``perf``), with the process-wide ``jit`` launch
telemetry and device-attribution collections registered in it, and the
admin socket (``admin_socket``), pre-registered with the standard admin
commands: ``perf dump``, ``config show|diff|set``, ``log dump``, ``trace
dump|reset``, ``jit dump|reset`` (``ops/launch_ledger.py``'s per-(kernel,
launch shape) records), ``device dump`` (``device_telemetry``: the card
over ``torch.cuda``), ``device top`` and ``device roofline``.
Daemon-ish objects (ECBackend, shards) take a Context and hang their
counters and commands off it.  A Context wires its config into the
process-wide instrument switch (``instruments_enabled``) and the default
tracer (``tracer_sample_rate``, ``osd_op_complaint_time`` as the slow-span
promotion threshold), at construction and on every live ``conf.set``.
"""
from __future__ import annotations

from . import device_attribution, instruments
from . import tracer as tracer_mod
from .admin_socket import AdminSocket
from .log import Log
from .options import ConfigProxy
from .perf_counters import PerfCountersCollection


def _resolve_launches() -> None:
    """Read the launch ledger's finished CUDA-event pairs (no wait)."""
    from ..ops import launch_ledger
    launch_ledger.resolve()


class Context:
    def __init__(self, overrides: dict | None = None):
        self.conf = ConfigProxy(overrides)
        self.log = Log(self.conf)
        self.perf = PerfCountersCollection()
        self.admin_socket = AdminSocket()
        # adopt the instrument kill-switch and the tracer's sampling and
        # slow-promotion knobs from this conf, and follow live updates.
        # Both targets are process-wide (there is ONE default tracer), as
        # the reference's md_config observers feed process singletons.
        instruments.wire_config(self.conf)
        tracer_mod.wire_config(self.conf)
        # the process-wide launch telemetry collection and the device-time
        # attribution ledger (who occupies the card, by owner class) are
        # shared by every Context, so any `perf dump` / prometheus render
        # carries them
        self.perf.add(tracer_mod.jit_perf_counters())
        self.perf.add(device_attribution.perf_counters())

        self.admin_socket.register(
            "perf dump", lambda **kw: self.perf.perf_dump(),
            "dump all perf counters")
        self.admin_socket.register(
            "config show", lambda **kw: self.conf.show_config(),
            "show all config values")
        self.admin_socket.register(
            "config diff", lambda **kw: self.conf.diff(),
            "show non-default config values")

        def _config_set(name: str = "", value: str = "", **kw):
            self.conf.set(name, value)
            return {"success": f"{name} = {value}"}
        self.admin_socket.register("config set", _config_set,
                                   "set a config option")
        self.admin_socket.register(
            "log dump", lambda **kw: self.log.dump_recent(),
            "dump recent log entries")
        self.admin_socket.register(
            "trace dump",
            lambda **kw: tracer_mod.default_tracer().dump(),
            "dump the span tracer as Chrome trace-event JSON")
        self.admin_socket.register(
            "trace reset",
            lambda **kw: tracer_mod.default_tracer().reset(),
            "clear the span tracer ring buffer and histograms")

        def _jit_dump(**kw):
            _resolve_launches()
            return tracer_mod.jit_dump()
        self.admin_socket.register(
            "jit dump", _jit_dump,
            "per-(kernel, launch shape) first-launch and launch telemetry")

        def _device_dump(initialize: str = "", **kw):
            from . import device_telemetry
            # never creates a CUDA context: the card's memory is read
            # only where CUDA is already initialized in this process
            return device_telemetry.refresh(self)
        self.admin_socket.register(
            "device dump", _device_dump,
            "card inventory + memory/build-cache telemetry "
            "(torch.cuda; creates no CUDA context)")
        self.admin_socket.register(
            "jit reset", lambda **kw: tracer_mod.jit_reset(),
            "clear the per-(kernel, launch shape) launch telemetry records")

        def _device_top(limit: str = "10", **kw):
            return device_attribution.device_top(int(limit))
        self.admin_socket.register(
            "device top", _device_top,
            "device occupancy by owner class (client/serving/recovery/"
            "scrub/rebalance) + costliest kernel launch shapes")

        def _device_roofline(limit: str = "20", **kw):
            from . import roofline
            return roofline.report(int(limit), cct=self)
        self.admin_socket.register(
            "device roofline", _device_roofline,
            "per-(kernel, launch shape) roofline ledger: achieved vs peak "
            "FLOP/s and device-memory B/s, arithmetic intensity, "
            "memory/compute-bound classification")

    def dout(self, subsys: str, level: int, message: str) -> None:
        self.log.dout(subsys, level, message)


_default: Context | None = None


def default_context() -> Context:
    global _default
    if _default is None:
        _default = Context()
    return _default
