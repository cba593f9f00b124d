"""Launch ledger: every hand-kernel launch booked by (kernel, launch shape).

The port's counterpart of ``ceph_tpu.ops.traced_jit``.  PyTorch runs
eagerly and the hand kernels are built once, at first use, so there is
no ``jit`` to wrap; instead each kernel wrapper books its launch here, at
the point where it already counts one (``rs_kernels._apply``,
``xor_apply_form``, ``crc32c_rows_into`` and ``crush_kernels.straw2_map``),
with the bytes the launch must move:

    with launch_ledger.launch(label, key, nbytes, device, source):
        err = lib.<kernel>_launch(...)        # the kernel, on the stream
        ...
        launches[name] += 1

A key is :func:`launch_key`'s ``(kernel, matrix shape, data rows, data
columns)``, the form of ``tools/path_shapes.launch_key``, so the ledger's
keys and ``path_shapes``' expected rows compare directly.

- **A key's first launch** is booked as ``traced_jit`` books a first
  dispatch: synchronised (the launch's end event) and timed, then
  ``tracer.record_compilation`` with ``trace_s`` 0 and ``compile_s`` the
  kernel library's build or cached load (``ops/cuda_build.py``) for the
  first key of that library in the process, 0 afterwards, under
  ``jit.compile`` and ``jit.first_dispatch`` spans; the key's cost goes to
  ``roofline.record_compile`` and ``device_attribution.record_executable``.
- **Later launches** count as ``cache_hits`` and are timed by a pair of
  ``torch.cuda.Event(enable_timing=True)`` recorded on the launch's
  stream.  Nothing waits for them on the launch path: :func:`resolve`
  reads the finished pairs (``Event.query``) into
  ``roofline.record_call`` with ``clock="cuda_event"`` whenever the
  roofline takes a snapshot, ``jit dump`` runs, or the backlog of
  unresolved pairs reaches :data:`EVENT_BACKLOG` (and every
  :data:`RECYCLE` pairs, to reuse their events); a pair still running
  when the backlog is full is dropped from the timing (``dropped``) but
  its launch stays counted.  On an idle card the start event completes
  as it is recorded, so a pair also spans the host's submit of the
  kernel: for a launch-bound kernel it reads the launch's latency, and
  a ``torch.profiler`` trace's kernel events give the kernel alone.
- **Cost** is the wrapper's, not a compiler's: the bytes PERF.md's bound
  column uses (each input read once, each output written once) and 0
  FLOPs (a GF(2^8) product, an XOR or a crc is no floating-point work).
  straw2's integer-issue bound is not the roofline's (it has no integer
  peak) and stays in PERF.md's table.
- **CPU tensors** (the plain versions) are booked too, host-timed, with
  ``route`` "cpu", so the ledger works, and is tested, without a card.
- **CUDA graph capture**: a launch on a capturing stream is counted and
  records no event and no synchronise (either would break the capture).
  :func:`paused` does the same on purpose, for measuring tools that time
  a kernel alone.

Counts are kept per ``(route, key)``; :func:`recording` collects the
keys launched while inside it, from every thread.
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time

import torch

from ..common import device_attribution, roofline, tracer

#: unresolved CUDA-event pairs kept before the oldest finished ones are
#: read; a pair still running when the backlog is full loses its timing
EVENT_BACKLOG = 4096
#: every RECYCLE pending pairs the finished ones are read (no wait), so
#: their events are reused instead of made anew
RECYCLE = 64

_lock = threading.Lock()
_keys: dict[tuple, dict] = {}        # (route, key) -> {launches, booked, ...}
_sources_booked: set[str] = set()    # libraries whose first key was booked
_pending: collections.deque = collections.deque()
# recycled (start, end) pairs by card index: an event records only on
# streams of the card it was first recorded on
_free_events: dict[int, list] = {}
_windows: list[tuple] = []           # (Counter, labels or None, route)
_paused = 0
_dropped = 0


def launch_key(kernel: str, rows: int, cols: int, mat_shape=()) -> tuple:
    """A launch as (kernel, matrix shape, data rows, data columns) — for
    straw2, ``crush_kernels.straw2_key``'s table shapes and its output's
    [x's, positions]."""
    return (kernel, tuple(int(d) for d in mat_shape), int(rows), int(cols))


def _roofline_key(key: tuple, route: str) -> tuple:
    """The roofline row of a key: ``gf_apply[4x8:uint8,8x524288:uint8]``,
    ``crush.bulk.indep[1x73x16x74x1024:int64,1048576x12:int32]`` (table
    shapes, output); a host-booked row ends in ``,cpu``."""
    kernel, mat, rows, cols = key
    dtypes = ("int64", "int32") if kernel.startswith("crush.") \
        else ("uint8", "uint8")
    parts = ((mat, dtypes[0]),) if mat else ()
    parts += (((rows, cols), dtypes[1]),)
    return parts + (("cpu",) if route == "cpu" else ())


def _record(route: str, key: tuple, nbytes: int) -> dict:
    """The key's record, made on first sight (call under ``_lock``)."""
    rec = _keys.get((route, key))
    if rec is None:
        rec = _keys[(route, key)] = {"launches": 0, "booked": False,
                                     "bytes_per_call": int(nbytes)}
    return rec


def _count(rec: dict, route: str, key: tuple) -> None:
    """Count one launch of ``key`` (call under ``_lock``)."""
    rec["launches"] += 1
    for seen, labels, only in _windows:
        if (labels is None or key[0] in labels) and only in (None, route):
            seen[key] += 1


def _event_pair(index: int) -> tuple:
    """A (start, end) timing pair for card ``index``, recycled or new."""
    with _lock:
        pool = _free_events.get(index)
        if pool:
            return pool.pop()
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def _book_first(route: str, key: tuple, nbytes: int, seconds: float,
                wall_s: float, source: str | None, clock: str) -> None:
    """A key's first booked launch: the jit registry's compilation, the
    roofline's compile record and its first (synced) call."""
    label = key[0]
    compile_s = 0.0
    if source is not None:
        from . import cuda_build
        with _lock:
            first_of_source = source not in _sources_booked
            _sources_booked.add(source)
        info = cuda_build.build_info.get(source, {})
        if first_of_source and "load_s" in info:
            compile_s = float(info["load_s"])
            tracer.default_tracer().complete(
                "jit.compile", info["loaded_at"], compile_s, cat="jit",
                fn=label, source=source)
    tracer.record_compilation(label, key, 0.0, compile_s, wall_s)
    rkey = _roofline_key(key, route)
    meta = {"modeled_source": "launch_ledger", "route": route}
    roofline.record_compile(label, rkey, 0.0, float(nbytes), meta=meta)
    device_attribution.record_executable(label, 0.0, float(nbytes))
    roofline.record_call(label, rkey, seconds, synced=True,
                         cost=(0.0, float(nbytes), 0), clock=clock,
                         meta=meta)


@contextlib.contextmanager
def launch(label: str, key: tuple, nbytes: int, device: torch.device,
           source: str | None = None):
    """Book the launch the body makes (see the module docstring).
    ``source`` names the kernel's library (``csrc/<source>.cu``).  A body
    that raises books nothing."""
    route = "cuda" if device.type == "cuda" else "cpu"
    capturing = route == "cuda" and \
        torch.cuda.is_current_stream_capturing()
    with _lock:
        timed = not (_paused or capturing)
        rec = _record(route, key, nbytes)
        first = timed and not rec["booked"]
        rec["booked"] = rec["booked"] or first
    if not timed:
        yield
        with _lock:
            _count(rec, route, key)
        return
    try:
        t0 = time.perf_counter()
        if route == "cpu":
            if first:
                with tracer.trace_span("jit.first_dispatch", fn=label):
                    yield
            else:
                yield
            seconds = time.perf_counter() - t0
        else:
            stream = torch.cuda.current_stream(device)
            index = torch.cuda.current_device() if device.index is None \
                else device.index
            start, end = _event_pair(index)
            if first:
                with tracer.trace_span("jit.first_dispatch", fn=label):
                    start.record(stream)
                    yield
                    end.record(stream)
                    end.synchronize()
                seconds = start.elapsed_time(end) / 1e3
            else:
                start.record(stream)
                yield
                end.record(stream)
        wall = time.perf_counter() - t0
    except BaseException:
        if first:
            with _lock:              # the launch failed: not booked
                rec["booked"] = False
        raise
    full = recycle = False
    with _lock:
        _count(rec, route, key)
        if route == "cuda":
            if first:
                _free_events.setdefault(index, []).append((start, end))
            else:
                _pending.append((key, nbytes, start, end, index))
                backlog = len(_pending)
                full = backlog >= EVENT_BACKLOG
                recycle = backlog % RECYCLE == 0
    if first:
        _book_first(route, key, nbytes, seconds, wall, source,
                    "cuda_event" if route == "cuda" else "host")
        return
    tracer.record_cache_hit(label, key)
    if route == "cpu":
        roofline.record_call(label, _roofline_key(key, route), seconds,
                             cost=(0.0, float(nbytes), 0),
                             meta={"modeled_source": "launch_ledger",
                                   "route": route})
    elif full or recycle:
        resolve(make_room=full)


def resolve(make_room: bool = False) -> int:
    """Read every finished CUDA-event pair, oldest first, into the
    roofline (``clock="cuda_event"``); never waits.  ``make_room`` drops
    the oldest pair's timing when none has finished and the backlog is
    full.  Returns the pairs resolved."""
    global _dropped
    done = []
    with _lock:
        while _pending and _pending[0][3].query():
            done.append(_pending.popleft())
        if make_room and not done and len(_pending) >= EVENT_BACKLOG:
            _pending.popleft()
            _dropped += 1
    meta = {"modeled_source": "launch_ledger", "route": "cuda"}
    for key, nbytes, start, end, _index in done:
        roofline.record_call(key[0], _roofline_key(key, "cuda"),
                             start.elapsed_time(end) / 1e3,
                             cost=(0.0, float(nbytes), 0),
                             clock="cuda_event", meta=meta)
    with _lock:
        for _k, _n, start, end, index in done:
            _free_events.setdefault(index, []).append((start, end))
    return len(done)


roofline.add_resolver(resolve)


@contextlib.contextmanager
def paused():
    """Count launches but time and book none (no event, no synchronise):
    for measuring tools that time a kernel by themselves."""
    global _paused
    with _lock:
        _paused += 1
    try:
        yield
    finally:
        with _lock:
            _paused -= 1


@contextlib.contextmanager
def recording(labels=None, route: str | None = None):
    """Collect the launches made while inside, from every thread, as a
    Counter of :func:`launch_key` -> launches; ``labels`` limits it to
    those kernels, ``route`` ("cuda" or "cpu") to one route."""
    seen = collections.Counter()
    entry = (seen, None if labels is None else frozenset(labels), route)
    with _lock:
        _windows.append(entry)
    try:
        yield seen
    finally:
        with _lock:
            _windows.remove(entry)


def counts(route: str | None = None) -> collections.Counter:
    """Launches by key since the last :func:`reset` (``route`` "cuda" or
    "cpu"; both when None)."""
    out = collections.Counter()
    with _lock:
        for (r, key), rec in _keys.items():
            if route is None or r == route:
                out[key] += rec["launches"]
    return out


def totals(route: str | None = "cuda") -> collections.Counter:
    """Launches by kernel label."""
    out = collections.Counter()
    for key, n in counts(route).items():
        out[key[0]] += n
    return out


def snapshot() -> dict:
    """Every key with its launches, the bytes a launch moves and whether
    a launch of it was timed, plus the unresolved and dropped pairs."""
    resolve()
    with _lock:
        rows = [{"kernel": key[0], "mat": list(key[1]), "rows": key[2],
                 "cols": key[3], "route": route, **rec}
                for (route, key), rec in sorted(_keys.items(),
                                                key=lambda kv: repr(kv[0]))]
        return {"keys": rows, "pending": len(_pending),
                "dropped": _dropped}


def reset() -> dict:
    """Forget every key, pending pair and library booking (tests); the
    roofline and the jit registry have their own resets."""
    global _dropped
    with _lock:
        n = len(_keys)
        _keys.clear()
        _pending.clear()
        _sources_booked.clear()
        _dropped = 0
    return {"success": f"dropped {n} launch keys"}
