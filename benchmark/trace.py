"""The profiled window of a ``--trace 1`` run, and its reduction.

A window opens ``torch.profiler`` (CPU and CUDA activity, no shapes, no
stacks), runs a primer of one-byte fills and copies that takes the
records the profiler may drop when it starts (a copy of
``ceph_tpu_torch/common/profiler_capture.py``'s primer), opens the
program's launch ledger (its launch counts by kernel and launch shape)
and a ``benchmark.window`` span.  The generator closes the span when its
traffic stops; :meth:`Probe.finish` waits for the card, closes the
ledger and the profiler, and reduces the profiler's events in memory
(nothing is written to disk) to :attr:`Probe.summary`:

- ``window_s``: the span's length;
- ``busy_s``: the time inside the span in which a kernel, a copy or a
  fill ran on the card (the union of their intervals);
- ``kernels``: kernel seconds by name inside the span, and ``memcpy``
  the same of the copies (``Memcpy HtoD``, ``Memcpy DtoD``, ...);
- ``gf_apply``: the count and seconds of every ``gf_apply`` kernel after
  the primer, and ``launches``: the ledger's launches by key, over the
  same stretch (the ledger opens after the primer and closes after the
  card is idle);
- ``device_ops``: the ten device operations that took most time;
- ``idle_gaps``: idle time on the card inside the span, summed by what
  the host was doing at each gap's middle: the innermost of the
  program's own tracer spans (``pipeline.pack``, ``pipeline.complete``,
  ...; ``ceph_tpu_torch/common/tracer.py``, whose clock a marker placed
  at the window's start ties to the profiler's) and the CUDA runtime
  calls the profiler saw, the ten largest.  The profiler records the
  operators of the calling thread only, so the engine's threads show
  through the program's spans and their runtime calls.
"""
from __future__ import annotations

import bisect
import collections

import torch

WINDOW_SPAN = "benchmark.window"
PRIMER_SPAN = "benchmark.profiler_primer"
PRIMER_LAUNCHES = 256
PRIMER_COPIES = 16
#: host events scanned back from a gap's middle for one that spans it
GAP_SCAN = 64
#: characters of a device operation's name kept in the breakdown
NAME_CHARS = 160
#: the program's spans that last an op's whole life, not one stage
WHOLE_OP_SPANS = ("serving.op",)


def _prime(device: str) -> None:
    from torch.profiler import record_function
    with record_function(PRIMER_SPAN):
        flag = torch.empty(PRIMER_LAUNCHES, dtype=torch.uint8,
                           device=device)
        for i in range(PRIMER_LAUNCHES):
            flag[i:i + 1].fill_(1)
        one = torch.ones(1, dtype=torch.uint8)
        for _ in range(PRIMER_COPIES):
            flag[:1].copy_(one)
        if flag.is_cuda:
            torch.cuda.synchronize()


class Probe:
    """One profiled window; see the module's docstring."""

    def __init__(self, device: str = "cuda"):
        self.device = device
        self.summary = None
        self._prof = self._ledger = self._span = self.launches = None
        self._marker = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function
        from ceph_tpu_torch.ops import launch_ledger
        acts = [ProfilerActivity.CPU]
        if self.device == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts, record_shapes=False,
                             with_stack=False)
        self._prof.start()
        _prime(self.device)
        self._ledger = launch_ledger.recording(route=self.device)
        self.launches = self._ledger.__enter__()
        self._span = record_function(WINDOW_SPAN)
        self._span.__enter__()
        self._marker = _tracer_marker()

    def end_window(self) -> None:
        """The traffic has stopped: close the window's span."""
        self._span.__exit__(None, None, None)

    def finish(self) -> None:
        """Wait for the card, close the ledger and the profiler, reduce."""
        if self.device == "cuda":
            torch.cuda.synchronize()
        self._ledger.__exit__(None, None, None)
        self._prof.stop()
        events = _events(self._prof)
        self.summary = reduce(events + _program_spans(events, self._marker),
                              dict(self.launches))
        self._prof = None


def _tracer_marker() -> float | None:
    """An instant event in the program's tracer at the window's start;
    returns its tracer time (us), or None when the tracer is off."""
    from ceph_tpu_torch.common.tracer import default_tracer
    tracer = default_tracer()
    tracer.instant(WINDOW_SPAN, cat="benchmark")
    tracer.flush()
    for ev in reversed(tracer.dump(stitched=False)["traceEvents"]):
        if ev.get("name") == WINDOW_SPAN and ev.get("ph") == "i":
            return float(ev["ts"])
    return None


def _program_spans(events: list[tuple], marker: float | None) -> list:
    """The program tracer's finished spans, as host events on the
    profiler's clock (the window span's start is the marker's time)."""
    if marker is None:
        return []
    from ceph_tpu_torch.common.tracer import default_tracer
    start = [s for dev, n, s, _e in events if not dev and n == WINDOW_SPAN]
    if len(start) != 1:
        return []
    out = []
    for ev in default_tracer().dump(stitched=False)["traceEvents"]:
        if ev.get("ph") != "X" or ev.get("name") in WHOLE_OP_SPANS:
            continue
        s = start[0] + int((float(ev["ts"]) - marker) * 1e3)
        out.append((False, ev["name"], s, s + int(float(ev["dur"]) * 1e3)))
    return out


def _events(prof) -> list[tuple]:
    """(on_device, name, start_ns, end_ns) of every event; the profiler's
    user spans count as host events only."""
    out = []
    for e in prof.profiler.kineto_results.events():
        on_dev = str(e.device_type()).endswith("CUDA")
        if on_dev and (e.is_user_annotation()
                       or e.name() in (WINDOW_SPAN, PRIMER_SPAN)):
            continue
        s = int(e.start_ns())
        out.append((on_dev, e.name(), s, s + int(e.duration_ns())))
    return out


def device_kind(name: str) -> str | None:
    """"kernel", "memcpy" or "memset" for a device event; None for the
    synchronisation records, which are no work on the card."""
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    if "Sync" in name or "Wait" in name:
        return None
    return "kernel"


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def reduce(events: list[tuple], launches: dict) -> dict:
    """The window's summary (module docstring) from raw events."""
    span = [(s, e) for dev, n, s, e in events if not dev and n == WINDOW_SPAN]
    primer = [e for dev, n, _s, e in events if not dev and n == PRIMER_SPAN]
    if len(span) != 1:
        raise RuntimeError(f"{len(span)} {WINDOW_SPAN} spans in the trace")
    w0, w1 = span[0]
    after = max(primer) if primer else w0
    device = [(name, device_kind(name), s, e)
              for dev, name, s, e in events if dev and device_kind(name)]
    inside = [(n, k, max(s, w0), min(e, w1)) for n, k, s, e in device
              if e > w0 and s < w1]
    busy = _union([(s, e) for _n, _k, s, e in inside])
    by_kind: dict[str, dict] = {"kernel": collections.defaultdict(float),
                                "memcpy": collections.defaultdict(float),
                                "memset": collections.defaultdict(float)}
    ops: dict[str, float] = collections.defaultdict(float)
    for name, kind, s, e in inside:
        ops[name[:NAME_CHARS]] += (e - s) / 1e9
        by_kind[kind][name] += (e - s) / 1e9
    gf = [(s, e) for n, k, s, e in device
          if k == "kernel" and "gf_apply_kernel" in n and s >= after]
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "kernels": dict(by_kind["kernel"]),
        "memcpy": dict(by_kind["memcpy"]),
        "gf_apply": {"count": len(gf),
                     "seconds": sum(e - s for s, e in gf) / 1e9},
        "launches": launches,
        "device_ops": sorted(([n, v] for n, v in ops.items()),
                             key=lambda nv: -nv[1])[:10],
        "idle_gaps": _idle_gaps(events, busy, w0, w1),
    }


def _idle_gaps(events, busy, w0: int, w1: int) -> list:
    """Idle seconds inside [w0, w1] by the host event at each gap's
    middle (the shortest one spanning it), the ten largest."""
    host = sorted((s, e, n) for dev, n, s, e in events
                  if not dev and n not in (WINDOW_SPAN, PRIMER_SPAN)
                  and s < w1 and e > w0)
    starts = [s for s, _e, _n in host]
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    by_name: dict[str, float] = collections.defaultdict(float)
    for g0, g1 in zip(edges[::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = (g0 + g1) // 2
        name, best = None, None
        i = bisect.bisect_right(starts, mid)
        for s, e, n in host[max(0, i - GAP_SCAN):i][::-1]:
            if e >= mid and (best is None or e - s < best):
                name, best = n, e - s
        if name is None:
            ended = [(e, n) for s, e, n in host[max(0, i - GAP_SCAN):i]]
            name = f"after {max(ended)[1]}" if ended else "no host event"
        by_name[name] += (g1 - g0) / 1e9
    return sorted(([n, v] for n, v in by_name.items()),
                  key=lambda nv: -nv[1])[:10]
