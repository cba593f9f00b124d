"""Fault-plane configuration: one seed, the bus and the codec pipeline.

The bus and device halves of ``ceph_tpu.failure.config``: a
:class:`FaultPlan` carries one campaign seed, the **bus** plane
(:class:`FaultConfig`: the in-process message bus's cross-sender
reorder, duplicate delivery and silent drops) and the **device** plane
(:class:`DeviceFaults`: injected dispatch/completion failures and
simulated OOM in the codec pipeline).  The JAX package's transport and
store planes come with the port's messenger and object-store slices.

Everything here is a plain dataclass of probabilities — stdlib only, no
runtime state.  The runtime half (seeded decision streams, the injected-
event log, perf stamping) lives in
:class:`~ceph_tpu_torch.failure.injector.FaultInjector`.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass
class FaultConfig:
    """Message-level fault injection for the in-process bus (the
    messenger half of the Thrasher: the reference's ``ms inject socket
    failures`` / delivery randomization, qa/tasks/ceph_manager.py).
    Faithful to messenger semantics:

    - per-SENDER ordering is always preserved (in-order delivery per
      connection) — ``reorder`` randomizes scheduling ACROSS senders at
      each destination, which also models arbitrary cross-connection
      delay;
    - ``dup_prob`` redelivers a message immediately after the first
      delivery (connection reset + resend: shards dedup sub-writes by
      at_version);
    - ``drop_prob`` silently discards (a reset with no resend — only for
      tests that exercise stall handling).
    """
    seed: int = 0
    reorder: bool = False
    dup_prob: float = 0.0
    drop_prob: float = 0.0


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
    """One campaign: one seed, the bus and device planes.  Hand it to
    ``MessageBus.inject_faults`` (the bus plane), and a
    :class:`~ceph_tpu_torch.failure.injector.FaultInjector` over it to
    ``CodecPipeline.inject_faults`` or ``ServingEngine.inject_device_faults``."""
    seed: int = 0
    bus: FaultConfig = field(default_factory=FaultConfig)
    device: DeviceFaults = field(default_factory=DeviceFaults)

    def bus_config(self) -> FaultConfig:
        """The bus plane with the CAMPAIGN seed (a bus sub-config
        carrying its own nonzero seed keeps it)."""
        if self.bus.seed:
            return self.bus
        return replace(self.bus, seed=self.seed)
