"""The port's ``ceph_tpu.failure``: the circuit breaker that makes the
codec pipeline fail fast on a failing card, the seeded fault plan (bus,
transport, store and device planes), the injector its planes roll, the
transport plane's connection hooks and the bounded full-jitter backoff
behind the TCP client's reconnect and resend, the store wrapper of the
store plane, and the monitor's mark-down limiter (flap damping,
``OSD_FLAPPING``)."""
from .backoff import ExponentialBackoff, RetriesExhausted
from .breaker import (CLOSED, HALF_OPEN, OPEN, BreakerOpen, CircuitBreaker,
                      live_breakers, state_rank)
from .config import (DeviceFaults, FaultConfig, FaultPlan, StoreFaults,
                     TransportFaults)
from .injector import FaultInjector, InjectedFault, InjectedOOM
from .markdown import MarkDownLimiter
from .store import FaultyStore, unwrap
from .transport import TransportFaultHooks

__all__ = [
    "CLOSED", "HALF_OPEN", "OPEN", "BreakerOpen", "CircuitBreaker",
    "DeviceFaults", "ExponentialBackoff", "FaultConfig", "FaultInjector",
    "FaultPlan", "FaultyStore", "InjectedFault", "InjectedOOM",
    "MarkDownLimiter", "RetriesExhausted", "StoreFaults",
    "TransportFaultHooks", "TransportFaults", "live_breakers",
    "state_rank", "unwrap",
]
