"""Device-time attribution: who is occupying the card, by owner class.

A copy of ``ceph_tpu.common.device_attribution``: the port keeps its own
copy, so it needs nothing of the JAX package.

Once serving batches, recovery waves and
the async codec pipeline all share one device, a single throughput number
cannot say *whose* work the chip is doing — "recovery is stealing 40% of
the chip from serving" must be a measurable fact before the dmClock knobs
can act on it.  This module is the process-wide ledger:

- every :class:`~ceph_tpu_torch.ops.pipeline.CodecPipeline` dispatch is tagged
  with an **owner class** (``client``/``serving``/``recovery``/``scrub``/
  ``rebalance`` — resolved from the caller's explicit tag or the active
  :class:`~ceph_tpu_torch.common.tracer.TraceContext`), and its wall-clock
  device occupancy is accounted at the pipeline's completion boundary;
- overlapping in-flight batches are clamped against the ledger's last
  completion edge, so the per-class seconds SUM to the pipeline's busy
  time instead of double-counting overlap (the acceptance invariant);
- :func:`record_executable` folds in each hand kernel's stated cost per
  launch shape (FLOPs, bytes; fed by ``ops/launch_ledger.py`` at a key's
  first launch), giving each kernel a cost model next to its measured
  occupancy;
- surfaces: the ``device_attribution`` PerfCounters collection,
  :func:`snapshot` and the ``device top`` admin command
  (:func:`device_top`).

The JAX package's host-fallback ledger (``record_host_fallback``) is not
ported: the port never serves a batch on the host in place of the card
(a failure on the card fails the op), so there is nothing to book.

Stdlib-only (the tracer's discipline), and the ONLY module in the
accounting path allowed a bare clock: it IS the device-occupancy clock.
"""
from __future__ import annotations

import threading
import time

#: the canonical owner classes
OWNER_CLASSES = ("client", "serving", "recovery", "scrub", "rebalance")

# dmClock op classes / historical aliases -> canonical owner class
_OWNER_ALIASES = {
    "client": "client", "client_op": "client",
    "serving": "serving",
    "recovery": "recovery", "bg_recovery": "recovery",
    "scrub": "scrub", "bg_scrub": "scrub",
    # snaptrim is background maintenance walking the stores, like scrub
    "bg_snaptrim": "scrub",
    "rebalance": "rebalance", "backfill": "rebalance",
}


def canonical_owner(name: str | None) -> str:
    """Clamp any op-class string onto the canonical owner set."""
    return _OWNER_ALIASES.get(name or "", "client")


def resolve_owner(owner: str | None = None) -> str:
    """An explicit tag wins; otherwise the active TraceContext's op
    class; otherwise ``client`` (untagged foreground work)."""
    if owner is not None:
        return canonical_owner(owner)
    from . import tracer as tracer_mod
    ctx = tracer_mod.default_tracer().current_ctx()
    return canonical_owner(ctx.op_class if ctx is not None else None)


_lock = threading.Lock()
_classes: dict[str, dict] = {}      # owner -> {device_s, batches, bytes}
_busy_s = 0.0                       # union device-occupancy (the invariant)
_last_end = 0.0                     # trailing completion edge (clamp point)
_executables: dict[str, dict] = {}  # label -> {flops, bytes, compiles}
_perf = None


def perf_counters():
    """The process-wide ``device_attribution`` PerfCounters collection
    (lazy, like the tracer's jit collection): per-class device seconds +
    the busy-time total every Context registers for perf dump/prometheus."""
    global _perf
    with _lock:
        if _perf is None:
            from .perf_counters import PerfCountersBuilder
            b = PerfCountersBuilder("device_attribution")
            for cls in OWNER_CLASSES:
                b.add_time_avg(f"{cls}_device_time",
                               f"device occupancy attributed to {cls} work")
            b.add_time_avg("busy_time",
                           "total device busy time at the pipeline "
                           "completion boundary (per-class times sum to "
                           "this)")
            b.add_u64_counter("batches", "device batches accounted")
            _perf = b.create_perf_counters()
        return _perf


def dispatch_mark() -> float:
    """Timestamp an async device dispatch (call right after the launch
    returns); pass the mark to :func:`record_batch` at completion."""
    return time.perf_counter()


def record_batch(owner: str | None, dispatched_at: float,
                 nbytes: int = 0) -> float:
    """Account one completed device batch to ``owner`` (resolved through
    :func:`resolve_owner`).  The busy interval is
    ``[max(dispatched_at, last completion edge), now]`` — batches overlap
    in flight, the device serializes them, so clamping to the previous
    completion edge keeps per-class seconds summing to busy time.
    Returns the seconds accounted."""
    global _busy_s, _last_end
    cls = resolve_owner(owner)
    now = time.perf_counter()
    with _lock:
        dur = max(0.0, now - max(dispatched_at, _last_end))
        _last_end = max(_last_end, now)
        _busy_s += dur
        rec = _classes.get(cls)
        if rec is None:
            rec = _classes[cls] = {"device_s": 0.0, "batches": 0,
                                   "bytes": 0}
        rec["device_s"] += dur
        rec["batches"] += 1
        rec["bytes"] += int(nbytes)
    pc = perf_counters()
    pc.tinc(f"{cls}_device_time", dur)
    pc.tinc("busy_time", dur)
    pc.inc("batches")
    return dur


def record_executable(label: str, flops: float, bytes_accessed: float
                      ) -> None:
    """Fold one kernel launch shape's stated cost into the ledger
    (``ops/launch_ledger.py`` calls this once per key's first launch)."""
    with _lock:
        rec = _executables.get(label)
        if rec is None:
            _executables[label] = {"flops": float(flops),
                                   "bytes": float(bytes_accessed),
                                   "compiles": 1}
        else:
            rec["flops"] += float(flops)
            rec["bytes"] += float(bytes_accessed)
            rec["compiles"] += 1


def snapshot() -> dict:
    """{classes: {cls: {device_s, share, batches, bytes}}, busy_s,
    executables} — per-class shares of the accounted busy time."""
    with _lock:
        busy = _busy_s
        classes = {
            cls: {"device_s": rec["device_s"],
                  "share": (rec["device_s"] / busy) if busy else 0.0,
                  "batches": rec["batches"], "bytes": rec["bytes"]}
            for cls, rec in sorted(_classes.items())}
        execs = {label: dict(rec)
                 for label, rec in sorted(_executables.items())}
    return {"classes": classes, "busy_s": busy, "executables": execs}


def device_top(limit: int = 10) -> dict:
    """The ``device top`` admin command: owner classes ranked by device
    share, plus the costliest kernels by stated FLOPs."""
    snap = snapshot()
    classes = sorted(snap["classes"].items(),
                     key=lambda kv: kv[1]["device_s"], reverse=True)
    execs = sorted(snap["executables"].items(),
                   key=lambda kv: kv[1]["flops"], reverse=True)
    return {
        "busy_s": round(snap["busy_s"], 6),
        "classes": [
            {"class": cls,
             "device_s": round(rec["device_s"], 6),
             "share_pct": round(100.0 * rec["share"], 1),
             "batches": rec["batches"], "bytes": rec["bytes"]}
            for cls, rec in classes],
        "executables": [
            {"function": label, "flops": rec["flops"],
             "bytes_accessed": rec["bytes"], "compiles": rec["compiles"]}
            for label, rec in execs[:max(0, int(limit))]],
    }

