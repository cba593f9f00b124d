"""ceph_tpu_torch.msg — the async messenger (reference: src/msg/async).

A readiness-driven transport replacing thread-per-connection serving:

- :mod:`~ceph_tpu_torch.msg.reactor` — the event loop (selectors + timers);
- :mod:`~ceph_tpu_torch.msg.parser` — zero-copy incremental v2-frame parsing;
- :mod:`~ceph_tpu_torch.msg.connection` — per-socket state: framed sends with
  write-queue backpressure, readiness callbacks, fault hooks;
- :mod:`~ceph_tpu_torch.msg.proto` — session-multiplexing frame types;
- :mod:`~ceph_tpu_torch.msg.server` — accept + cephx handshake state machines
  + dmClock-ordered dispatch with a bounded worker pool;
- :mod:`~ceph_tpu_torch.msg.client` — MuxClient: thousands of logical
  sessions over few connections;
- :mod:`~ceph_tpu_torch.msg.shed` — overload shedding by dmClock op class;
- :mod:`~ceph_tpu_torch.msg.frontend` — sharded serving engines behind
  striper-aware routing.
"""
from .connection import AsyncConnection
from .client import MuxCall, MuxClient, MuxSession
from .frontend import FrontendBusy, ShardedFrontend
from .parser import StreamParser
from .proto import RpcBatch, RpcResultBatch
from .reactor import Reactor, client_reactor
from .server import AsyncServerTransport, Dispatcher
from .shed import DEFAULT_SHED_FRACTIONS, EBUSY, ShedPolicy

__all__ = [
    "AsyncConnection", "AsyncServerTransport", "DEFAULT_SHED_FRACTIONS",
    "Dispatcher", "EBUSY", "FrontendBusy", "MuxCall", "MuxClient",
    "MuxSession", "Reactor", "RpcBatch", "RpcResultBatch", "ShardedFrontend",
    "ShedPolicy", "StreamParser", "client_reactor",
]
