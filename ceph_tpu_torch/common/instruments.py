"""Process-wide instrumentation kill-switch.

A copy of ``ceph_tpu.common.instruments``: the port keeps its own copy,
so it needs nothing of the JAX package.

The measurement lever: every tracer span, instant and complete checks
:func:`enabled` before doing any work, so ``instruments_enabled=false``
(adopted by every :class:`~ceph_tpu_torch.common.context.Context` through
:func:`wire_config`, and followed on a live ``config set``) or a
:func:`disabled` block turns the instrumentation plane into cheap no-op
guards.

The flag is deliberately a bare module global read without a lock: the
hot paths pay one attribute load + truth test per instrument call, and
a torn read is impossible under the GIL (the value is a bool).

What the switch does NOT stub: perf-counter math that the control plane
*acts on* (throttle gauges) keeps running — observability must be free
to drop, behavior must not change with it.
"""
from __future__ import annotations

from contextlib import contextmanager

_enabled = True


def enabled() -> bool:
    """The hot-path guard: True when the instruments should record."""
    return _enabled


def set_enabled(on: bool) -> None:
    global _enabled
    _enabled = bool(on)


@contextmanager
def disabled():
    """Scoped kill-switch: instruments off inside the block, restored to
    the PRIOR state on exit."""
    prior = _enabled
    set_enabled(False)
    try:
        yield
    finally:
        set_enabled(prior)


def wire_config(conf) -> None:
    """Adopt ``instruments_enabled`` from a ConfigProxy and follow live
    updates (``config set instruments_enabled false`` on a running
    cluster flips the process-wide switch, like every other option)."""
    if "instruments_enabled" not in conf.schema:
        return
    set_enabled(bool(conf.get("instruments_enabled")))
    conf.add_observer("instruments_enabled",
                      lambda _name, v: set_enabled(bool(v)))
