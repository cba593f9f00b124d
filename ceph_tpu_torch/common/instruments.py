"""Process-wide instrumentation kill-switch.

A copy of ``ceph_tpu.common.instruments``: the port keeps its own copy,
so it needs nothing of the JAX package.

The measurement lever: every tracer span, instant and complete checks
:func:`enabled` before doing any work, so :func:`set_enabled` (False)
turns the instrumentation plane into cheap no-op guards.

The flag is deliberately a bare module global read without a lock: the
hot paths pay one attribute load + truth test per instrument call, and
a torn read is impossible under the GIL (the value is a bool).

What the switch does NOT stub: perf-counter math that the control plane
*acts on* (throttle gauges) keeps running — observability must be free
to drop, behavior must not change with it.
"""
from __future__ import annotations

_enabled = True


def enabled() -> bool:
    """The hot-path guard: True when the instruments should record."""
    return _enabled


def set_enabled(on: bool) -> None:
    global _enabled
    _enabled = bool(on)
