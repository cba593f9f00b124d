"""The device-plane half of ``ceph_tpu.failure``: the circuit breaker
that makes the codec pipeline fail fast on a failing card, and the
seeded fault plan and injector the pipeline rolls at dispatch and
completion."""
from .breaker import (CLOSED, HALF_OPEN, OPEN, BreakerOpen, CircuitBreaker,
                      live_breakers, state_rank)
from .config import DeviceFaults, FaultPlan
from .injector import FaultInjector, InjectedFault, InjectedOOM

__all__ = [
    "CLOSED", "HALF_OPEN", "OPEN", "BreakerOpen", "CircuitBreaker",
    "DeviceFaults", "FaultInjector", "FaultPlan", "InjectedFault",
    "InjectedOOM", "live_breakers", "state_rank",
]
