"""Session-multiplexing frame types for the async messenger.

``net.py`` owns the base RPC vocabulary (cephx handshake frames,
RpcCall/RpcResult, watch/notify).  This module adds the frames the
multiplexed transport introduces — carrying MANY logical sessions'
calls per TCP connection in one frame, the reference messenger's
out-queue coalescing made explicit on the wire:

- :class:`RpcBatch`   — client->server: a vector of RpcCalls (possibly
  from many logical sessions) submitted as one frame: one pickle, one
  MAC, one send for a whole admission window;
- :class:`RpcResultBatch` — server->client: the results a dispatch
  worker produced for one batch, returned as one frame.

Both register wire-accounting sizers (the no-unmetered-types contract)
and join ``net._TYPES`` so the shared codec (``net._encode``/
``net._decode``) carries them: they are post-auth
pickle frames, never valid before the HMAC session.

Reqid-dedup semantics are untouched: every inner call keeps its own
``(session, rid)``, so a resent batch (or a single resent call from a
dead batch) dedups per call, exactly like the unbatched path.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..common import wire_accounting
from .. import net


@dataclass
class RpcBatch:
    """A vector of :class:`~ceph_tpu_torch.net.RpcCall` riding one frame."""
    calls: list = field(default_factory=list)


@dataclass
class RpcResultBatch:
    """The :class:`~ceph_tpu_torch.net.RpcResult` vector for one RpcBatch."""
    results: list = field(default_factory=list)


_blob = wire_accounting.blob_size
wire_accounting.register_wire_sizes({
    RpcBatch: lambda m: sum(
        len(c.method) + _blob(c.args) + 16 for c in m.calls) + 8,
    RpcResultBatch: lambda m: sum(
        _blob(r.value) + len(r.error) + 16 for r in m.results) + 8,
})

# join the shared RPC registry: the codec resolves frame type names
# through net._TYPES, and every name in it is individually metered
# (tests/test_torch_wire.py pins that)
net._TYPES.update({
    "RpcBatch": RpcBatch,
    "RpcResultBatch": RpcResultBatch,
})


# ---- sideband codecs (zero-copy batch frames) ------------------
#
# Batch frames are where bulk payloads actually ride the mux transport,
# so both batch types register extract/reattach hooks with the shared
# codec: eligible args/value blobs lift out of the pickled control
# header into the frame's raw third segment (net._encode_parts), and
# land on the far side with one staged copy (net._sideband_payloads).
# Extraction copies the CONTAINERS only (a fresh calls list + args
# dicts, never payload bytes): retries resend the same RpcCall objects,
# which must keep their real payloads.

def _batch_extract(msg):
    views: list = []
    calls, dirty = [], False
    for c in msg.calls:
        repl = net._call_extract_args(c, views)
        if repl is not None:
            dirty = True
            c = net.RpcCall(c.rid, c.method, repl, trace=c.trace,
                            session=c.session, op_class=c.op_class)
        calls.append(c)
    if not dirty:
        return None
    return RpcBatch(calls), views


def _batch_reattach(msg, payloads) -> None:
    for c in msg.calls:
        net._call_reattach_args(c, payloads)


def _batch_payload_bytes(msg) -> int:
    return sum(len(v) for c in msg.calls for v in c.args.values()
               if net._sb_eligible(v))


def _result_batch_extract(msg):
    views: list = []
    results, dirty = [], False
    for r in msg.results:
        if net._sb_splice(r.value):
            dirty = True
            v = r.value
            views.append(v if isinstance(v, memoryview)
                         else memoryview(v))
            r = net.RpcResult(r.rid, r.ok,
                              net.SidebandRef(len(views) - 1),
                              r.error, r.errno, trace=r.trace)
        results.append(r)
    if not dirty:
        return None
    return RpcResultBatch(results), views


def _result_batch_reattach(msg, payloads) -> None:
    for r in msg.results:
        net._rpc_result_reattach(r, payloads)


def _result_batch_payload_bytes(msg) -> int:
    return sum(len(r.value) for r in msg.results
               if net._sb_eligible(r.value))


net._SIDEBAND_CODECS.update({
    "RpcBatch": net._SidebandCodec(
        _batch_extract, _batch_reattach, _batch_payload_bytes),
    "RpcResultBatch": net._SidebandCodec(
        _result_batch_extract, _result_batch_reattach,
        _result_batch_payload_bytes),
})


def batch_trace_ctx(msg):
    """The trace context a batch frame's wire bytes charge to: batches
    are client-op vectors, so the first traced member speaks for the
    frame (the per-class byte partition stays exact — one frame, one
    class — while mixed-class batches are a documented approximation)."""
    items = getattr(msg, "calls", None) or getattr(msg, "results", None) \
        or ()
    for m in items:
        ctx = getattr(m, "trace", None)
        if ctx is not None:
            return ctx
    return None
