"""Fault-plane configuration: one seed, every plane.

The port's copy of ``ceph_tpu.failure.config``: a :class:`FaultPlan`
carries one campaign seed, the **bus** plane (:class:`FaultConfig`: the
in-process message bus's cross-sender reorder, duplicate delivery and
silent drops), the **transport** plane (:class:`TransportFaults`, the
TCP messenger in ``net.py``: connection resets, black-holed requests,
truncated frames, send delays), the **store** plane
(:class:`StoreFaults`, any ObjectStore behind
:class:`~ceph_tpu_torch.failure.store.FaultyStore`: EIO on read/write,
torn writes, slow-read latency) and the **device** plane
(:class:`DeviceFaults`: injected dispatch/completion failures and
simulated OOM in the codec pipeline).

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
class TransportFaults:
    """TCP-plane faults applied by the server's connection hooks
    (``ms inject socket failures`` territory).  All probabilities are
    per-message decisions on the post-auth path — the cephx handshake is
    never faulted, so a reconnecting client always gets back in."""
    reset_prob: float = 0.0        # abrupt connection close mid-stream
    blackhole_prob: float = 0.0    # request swallowed: no reply ever
    truncate_prob: float = 0.0     # partial frame on the wire, then reset
    delay_prob: float = 0.0        # per-message send stall ...
    delay_ms: float = 0.0          # ... of this many milliseconds


@dataclass
class StoreFaults:
    """ObjectStore-plane faults (filestore EIO / bluestore debug read
    error injection territory)."""
    eio_read_prob: float = 0.0     # read raises EIO
    eio_write_prob: float = 0.0    # queue_transaction raises EIO, no apply
    torn_write_prob: float = 0.0   # a PREFIX of the transaction applies
    slow_read_prob: float = 0.0    # read stalls ...
    slow_read_ms: float = 0.0      # ... this long


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
    """One campaign: one seed, every plane.  Hand it to
    ``MiniCluster.inject_faults`` (which builds the
    :class:`~ceph_tpu_torch.failure.injector.FaultInjector` and fans the
    plan out to bus/store/device) and the injector to
    ``ClusterServer.inject_faults`` (the transport plane); or to
    ``MessageBus.inject_faults`` alone (the bus plane), or a
    FaultInjector over it to ``CodecPipeline.inject_faults`` or
    ``ServingEngine.inject_device_faults``."""
    seed: int = 0
    bus: FaultConfig = field(default_factory=FaultConfig)
    transport: TransportFaults = field(default_factory=TransportFaults)
    store: StoreFaults = field(default_factory=StoreFaults)
    device: DeviceFaults = field(default_factory=DeviceFaults)

    def bus_config(self) -> FaultConfig:
        """The bus plane with the CAMPAIGN seed (a bus sub-config
        carrying its own nonzero seed keeps it)."""
        if self.bus.seed:
            return self.bus
        return replace(self.bus, seed=self.seed)
