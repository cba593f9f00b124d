"""The bus and device planes of ``ceph_tpu.failure``: the circuit
breaker that makes the codec pipeline fail fast on a failing card, the
seeded fault plan (bus and device planes) and the injector the pipeline
rolls at dispatch and completion."""
from .breaker import (CLOSED, HALF_OPEN, OPEN, BreakerOpen, CircuitBreaker,
                      live_breakers, state_rank)
from .config import DeviceFaults, FaultConfig, FaultPlan
from .injector import FaultInjector, InjectedFault, InjectedOOM

__all__ = [
    "CLOSED", "HALF_OPEN", "OPEN", "BreakerOpen", "CircuitBreaker",
    "DeviceFaults", "FaultConfig", "FaultInjector", "FaultPlan",
    "InjectedFault", "InjectedOOM", "live_breakers", "state_rank",
]
