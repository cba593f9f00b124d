"""Device-plane fault configuration: one seed, the codec pipeline's
faults.

The device half of ``ceph_tpu.failure.config``: a :class:`FaultPlan`
carries one campaign seed and the **device** plane
(:class:`DeviceFaults`: injected dispatch/completion failures and
simulated OOM in the codec pipeline).  The JAX package's bus, transport
and store planes come with the port's messenger and object-store slices.

Everything here is a plain dataclass of probabilities — stdlib only, no
runtime state.  The runtime half (seeded decision streams, the injected-
event log, perf stamping) lives in
:class:`~ceph_tpu_torch.failure.injector.FaultInjector`.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class DeviceFaults:
    """Device-plane faults injected into the codec pipeline: a failed
    launch, a failed completion and an out-of-memory as reproducible
    inputs instead of production surprises."""
    dispatch_fail_prob: float = 0.0     # async launch raises
    completion_fail_prob: float = 0.0   # the completion wait raises
    oom_prob: float = 0.0               # RESOURCE_EXHAUSTED at dispatch


@dataclass
class FaultPlan:
    """One campaign: one seed and the device plane.  Hand a
    :class:`~ceph_tpu_torch.failure.injector.FaultInjector` over it to
    ``CodecPipeline.inject_faults`` or ``ServingEngine.inject_device_faults``."""
    seed: int = 0
    device: DeviceFaults = field(default_factory=DeviceFaults)
