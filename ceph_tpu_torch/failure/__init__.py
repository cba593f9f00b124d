"""The bus, store and device planes of ``ceph_tpu.failure``: the circuit
breaker that makes the codec pipeline fail fast on a failing card, the
seeded fault plan (bus, store and device planes), the injector its
planes roll, the store wrapper of the store plane, and the monitor's
mark-down limiter (flap damping, ``OSD_FLAPPING``).  The transport plane
and the reconnect backoff come with the port's messenger."""
from .breaker import (CLOSED, HALF_OPEN, OPEN, BreakerOpen, CircuitBreaker,
                      live_breakers, state_rank)
from .config import DeviceFaults, FaultConfig, FaultPlan, StoreFaults
from .injector import FaultInjector, InjectedFault, InjectedOOM
from .markdown import MarkDownLimiter
from .store import FaultyStore, unwrap

__all__ = [
    "CLOSED", "HALF_OPEN", "OPEN", "BreakerOpen", "CircuitBreaker",
    "DeviceFaults", "FaultConfig", "FaultInjector", "FaultPlan",
    "FaultyStore", "InjectedFault", "InjectedOOM", "MarkDownLimiter",
    "StoreFaults", "live_breakers", "state_rank", "unwrap",
]
