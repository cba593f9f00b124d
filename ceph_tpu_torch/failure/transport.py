"""Transport-plane fault policy for the TCP messenger (``net.py``).

The port's copy of ``ceph_tpu.failure.transport``.

The socket half of ``ms inject socket failures``: the server attaches a
:class:`TransportFaultHooks` to every AUTHENTICATED connection (the
cephx handshake is never faulted — a reconnecting client must always be
able to get back in), and the channel/read loops consult it:

- :meth:`on_send` decides per outbound message: deliver, delay-then-
  deliver, TRUNCATE (a partial frame hits the wire, then the connection
  closes — the peer sees a cut-off frame exactly like a mid-frame RST),
  or RESET (abrupt close);
- :meth:`on_recv` decides per inbound request: deliver, BLACKHOLE (the
  request is swallowed and no reply is ever sent — the client's per-RPC
  deadline is what heals this), or RESET.

Decisions come from the shared :class:`~ceph_tpu_torch.failure.injector.
FaultInjector` streams, so a campaign's transport events land in the
same seeded event log as every other plane.
"""
from __future__ import annotations

import time

SEND_OK = "ok"
SEND_TRUNCATE = "truncate"
SEND_RESET = "reset"

RECV_DELIVER = "deliver"
RECV_BLACKHOLE = "blackhole"
RECV_RESET = "reset"


class TransportFaultHooks:
    """Per-server transport fault policy over one injector."""

    def __init__(self, injector, sleep=time.sleep):
        self.inj = injector
        self._sleep = sleep

    def on_send(self, msg_type: str, nbytes: int, target: str) -> str:
        f = self.inj.plan.transport
        if self.inj.roll("transport", "delay", f.delay_prob,
                         target=target, msg=msg_type, ms=f.delay_ms):
            self._sleep(f.delay_ms / 1000.0)
        if self.inj.roll("transport", "truncate", f.truncate_prob,
                         target=target, msg=msg_type, bytes=nbytes):
            return SEND_TRUNCATE
        if self.inj.roll("transport", "reset", f.reset_prob,
                         target=target, msg=msg_type):
            return SEND_RESET
        return SEND_OK

    def on_recv(self, msg_type: str, target: str) -> str:
        f = self.inj.plan.transport
        if self.inj.roll("transport", "blackhole", f.blackhole_prob,
                         target=target, msg=msg_type):
            return RECV_BLACKHOLE
        if self.inj.roll("transport", "recv_reset", f.reset_prob,
                         target=target, msg=msg_type):
            return RECV_RESET
        return RECV_DELIVER
