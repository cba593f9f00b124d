"""Roofline ledger: per-kernel-launch-shape achieved vs peak FLOP/s and B/s.

The port's copy of ``ceph_tpu.common.roofline``, with an H100 peak
registry.  It joins what each hand kernel costs (the bytes and FLOPs its
wrapper states, booked by ``ops/launch_ledger.py``) with how long its
launches took, so that the question "how close to what the card allows
does this kernel run, at this shape, on this path?" has an instrument:

- a **peak-spec registry** (device kind -> peak FLOP/s and memory B/s,
  from NVIDIA's data sheets; overridable via the ``device_peak_flops`` /
  ``device_peak_hbm_bytes_per_sec`` options for cards the registry does
  not know);
- a **per-executable ledger**: one row per (kernel, launch shape) key,
  with its modeled per-call cost recorded at the key's first launch and
  each launch's seconds, and :func:`snapshot` computing achieved FLOP/s,
  achieved B/s, arithmetic intensity, memory-vs-compute-bound
  classification and %-of-peak per row;
- surfaces: the ``device_efficiency`` PerfCounters collection
  (:func:`refresh`), the ``ceph_tpu_device_efficiency{executable,stat}``
  prometheus family, the ``device roofline`` admin command
  (:func:`report`), :func:`flat_series` for the time-series ring and
  :func:`bench_block` for a bench line's ``efficiency`` block (what
  ``ceph_tpu_torch/tools/roofline_report.py`` and ``perf_gate.py``
  read).

The clock of a row: launches on the card are timed by a pair of CUDA
events on the launch's stream (the ledger resolves them later, never
synchronising the launch path), so a row booked that way carries
``estimator: "cuda_event"`` and its seconds are device time (on an idle
card including the host's submit of each launch).  Rows booked
with host wall seconds keep the JAX package's estimator:
:func:`_estimated_seconds` compares the synced-sample per-call mean with
the overall mean and, when asynchronous under-counting is evident,
extrapolates the synced mean over every call.

The GF(2^8) and GF(2) kernels and crc32c do no floating-point work, so
their rows are memory-bound by classification and their share is of the
memory rate.  CRUSH's straw2 draws are integer work: the registry has no
integer peak, so a straw2 row's share here is of the memory rate alone,
and its integer-issue bound stays in PERF.md's table
(``tools/path_shapes.STRAW2_DRAWS_PER_S``).

Stdlib-only: importable before CUDA initializes; device facts arrive as
plain numbers from callers (the launch ledger adds a resolver that
:func:`snapshot` runs first), and the device kind from
``device_telemetry.device_inventory``, which creates no CUDA context.
"""
from __future__ import annotations

import os
import threading

# -- peak-spec registry -------------------------------------------------------

#: (device-kind substrings, peak FLOP/s, peak memory bytes/s), dense bf16
#: tensor-core peak and memory rate from NVIDIA's H100 data sheet.  The
#: first entry whose substrings all occur in the lowercased device kind
#: wins.  The SXM card (HBM3) is the one PERF.md's bounds are computed for.
PEAK_SPECS: tuple[tuple[tuple[str, ...], float, float], ...] = (
    (("h100", "hbm3"), 989e12, 3.35e12),      # H100 SXM5 80GB
    (("h100", "pcie"), 756e12, 2.0e12),       # H100 PCIe 80GB (HBM2e)
)

#: nominal per-core CPU peaks (an AVX2-class core's fma throughput and a
#: share of one DDR channel) — rough on purpose: on CPU the roofline's
#: job is the memory-vs-compute CLASSIFICATION and round-over-round
#: comparison, not an absolute hardware claim (``source`` says nominal).
CPU_NOMINAL_FLOPS_PER_CORE = 5e10
CPU_NOMINAL_DRAM_BPS = 3e10


def lookup_peaks(cct=None, device_kind: str | None = None,
                 platform: str | None = None) -> dict:
    """Resolve peak FLOP/s and memory B/s for the current (or named)
    device.  The device-kind registry first; config overrides win over
    it; a kind the registry does not know falls to the overrides, then to
    a nominal CPU spec (classification still works, ``source`` marks
    it).  Never creates a CUDA context: the kind comes from
    ``device_telemetry.device_inventory``."""
    if device_kind is None and platform is None:
        from . import device_telemetry
        inv = device_telemetry.device_inventory()
        device_kind, platform = inv["device_kind"], inv["platform"]
    flops = hbm = 0.0
    source = None
    kind_l = (device_kind or "").lower()
    for subs, f, b in PEAK_SPECS:
        if all(sub in kind_l for sub in subs):
            flops, hbm, source = f, b, f"registry:{' '.join(subs)}"
            break
    if source is None:
        cores = os.cpu_count() or 1
        flops = CPU_NOMINAL_FLOPS_PER_CORE * cores
        hbm = CPU_NOMINAL_DRAM_BPS
        source = f"nominal-cpu({cores} cores)"
    if cct is not None:
        conf_f = float(cct.conf.get("device_peak_flops") or 0.0)
        conf_b = float(cct.conf.get("device_peak_hbm_bytes_per_sec") or 0)
        if conf_f > 0:
            flops, source = conf_f, "config"
        if conf_b > 0:
            hbm = conf_b
            source = "config" if conf_f > 0 else f"{source}+config-hbm"
    return {"flops": flops, "hbm_bytes_s": hbm, "source": source,
            "device_kind": device_kind, "platform": platform,
            "ridge_flops_per_byte": (flops / hbm) if hbm else 0.0}


# -- the per-executable ledger ------------------------------------------------

_lock = threading.Lock()
_execs: dict[str, dict] = {}
# callables run before every snapshot: the launch ledger registers the
# one that resolves its pending CUDA-event pairs into record_call
_resolvers: list = []


def add_resolver(fn) -> None:
    """Run ``fn()`` before every :func:`snapshot` (once per callable)."""
    if fn not in _resolvers:
        _resolvers.append(fn)


def executable_id(label: str, key) -> str:
    """A readable row name from a (label, shape key):
    ``gf_apply[4x8:uint8,8x524288:uint8]`` — one ledger row per kernel
    launch shape, not per python function."""
    parts = []
    for p in key if isinstance(key, tuple) else (key,):
        if isinstance(p, tuple) and len(p) == 2 and isinstance(p[0], tuple):
            shape, dtype = p
            parts.append("x".join(str(d) for d in shape) + f":{dtype}")
        else:
            parts.append(str(p)[:24])
    return f"{label}[{','.join(parts)}]"


def _new_row(label: str, compiles: int, flops: float, nbytes: float,
             input_bytes: int, meta: dict | None) -> dict:
    src = "cost_analysis"
    if nbytes <= 0 and input_bytes > 0:
        nbytes, src = float(input_bytes), "input_shapes"
    row = {"function": label, "compiles": compiles,
           "flops_per_call": float(flops), "bytes_per_call": float(nbytes),
           "modeled_source": src,
           "calls": 0, "seconds": 0.0,
           "synced_calls": 0, "synced_s": 0.0,
           "flops": 0.0, "bytes": 0.0}
    row.update(meta or {})
    return row


def record_compile(label: str, key, flops_per_call: float,
                   bytes_per_call: float, input_bytes: int = 0,
                   meta: dict | None = None) -> None:
    """Register one executable's modeled per-call cost.  When no byte
    traffic is modeled, the summed input-operand bytes stand in as the
    mandatory-traffic floor (``modeled_source`` records which).  ``meta``
    adds fields to a new row (the launch ledger's ``modeled_source`` and
    ``route``)."""
    eid = executable_id(label, key)
    with _lock:
        rec = _execs.get(eid)
        if rec is None:
            _execs[eid] = _new_row(label, 1, flops_per_call, bytes_per_call,
                                   input_bytes, meta)
        else:           # a recompile of the same key (e.g. after reset)
            fresh = _new_row(label, 0, flops_per_call, bytes_per_call,
                             input_bytes, meta)
            rec["compiles"] += 1
            for f in ("flops_per_call", "bytes_per_call", "modeled_source"):
                rec[f] = fresh[f]


def record_call(label: str, key, seconds: float, synced: bool = False,
                cost: tuple | None = None, clock: str | None = None,
                meta: dict | None = None) -> None:
    """Account one launch of an executable: ``seconds`` is the caller's
    measured time (``synced`` when it waited out the device — the first
    launch of every key is).  ``clock="cuda_event"`` marks the row's
    seconds as CUDA-event device time.  ``cost`` is the caller's cached
    ``(flops_per_call, bytes_per_call, input_bytes)`` so a ledger reset
    mid-run re-seeds the row on the next call (with ``meta``) instead of
    going dark until a recompile."""
    eid = executable_id(label, key)
    with _lock:
        rec = _execs.get(eid)
        if rec is None:
            if cost is None:     # no cost model at all: drop rather
                return           # than invent a zero-cost row
            flops, nbytes, input_bytes = cost
            rec = _execs[eid] = _new_row(label, 0, flops, nbytes,
                                         input_bytes, meta)
        rec["calls"] += 1
        rec["seconds"] += float(seconds)
        rec["flops"] += rec["flops_per_call"]
        rec["bytes"] += rec["bytes_per_call"]
        if synced:
            rec["synced_calls"] += 1
            rec["synced_s"] += float(seconds)
        if clock is not None:
            rec["clock"] = clock


def reset() -> dict:
    with _lock:
        n = len(_execs)
        _execs.clear()
    return {"success": f"dropped {n} executable records"}


# -- derived views ------------------------------------------------------------

#: when the sync-timed per-call mean exceeds the overall per-call mean by
#: this factor, the async dispatches are evidently returning before the
#: device finishes — rates are then computed over the synced mean
#: extrapolated to every call (conservative: first dispatches run cold)
_ASYNC_UNDERCOUNT_RATIO = 1.5


def _estimated_seconds(rec: dict) -> tuple[float, str]:
    """The seconds the rates divide by.  CUDA-event device seconds (the
    mean of the launches after the first, over every call); measured
    wall seconds when they look end-to-end; the
    synced-sample mean extrapolated over all calls when asynchronous
    dispatch evidently under-measured."""
    secs, calls = rec["seconds"], rec["calls"]
    if rec.get("clock") == "cuda_event":
        # a key's synchronised first launch also loads the kernel's module
        # on the card (CUDA's lazy loading): where later launches exist,
        # their mean stands for every call
        steady = calls - rec["synced_calls"]
        if steady > 0:
            return (secs - rec["synced_s"]) / steady * calls, "cuda_event"
        return secs, "cuda_event"
    if calls and rec["synced_calls"]:
        sync_mean = rec["synced_s"] / rec["synced_calls"]
        if sync_mean > (secs / calls) * _ASYNC_UNDERCOUNT_RATIO:
            return sync_mean * calls, "synced-extrapolated"
    return secs, "measured"


def _derive(rec: dict, peaks: dict) -> dict:
    """One row's roofline stats from its raw ledger record."""
    secs, estimator = _estimated_seconds(rec)
    out = dict(rec)
    out["est_seconds"] = round(secs, 6)
    out["estimator"] = estimator
    ach_f = (rec["flops"] / secs) if secs > 0 else 0.0
    ach_b = (rec["bytes"] / secs) if secs > 0 else 0.0
    ai = (rec["flops"] / rec["bytes"]) if rec["bytes"] > 0 else 0.0
    ridge = peaks["ridge_flops_per_byte"]
    # under the ridge the op cannot reach peak FLOP/s even at perfect
    # bandwidth: memory is the binding resource (the roofline's knee)
    bound = "memory" if (ai < ridge or not rec["flops"]) else "compute"
    if bound == "memory":
        pct = 100.0 * ach_b / peaks["hbm_bytes_s"] \
            if peaks["hbm_bytes_s"] else 0.0
    else:
        pct = 100.0 * ach_f / peaks["flops"] if peaks["flops"] else 0.0
    out.update(
        achieved_flops_s=round(ach_f, 1),
        achieved_bytes_s=round(ach_b, 1),
        arithmetic_intensity=round(ai, 4),
        bound=bound,
        pct_of_peak=round(pct, 4),
    )
    return out


def snapshot(cct=None) -> dict:
    """The full ledger view: peaks + per-row roofline stats + aggregate
    totals + the attribution ledger's busy-time context.  A row the
    launch ledger booked on the host (``route: "cpu"``, a plain version)
    is judged against the nominal CPU peaks, not the card's."""
    for fn in list(_resolvers):
        fn()
    peaks = lookup_peaks(cct)
    with _lock:
        raw = {eid: dict(rec) for eid, rec in _execs.items()}
    host_peaks = peaks
    if peaks["platform"] != "cpu" and \
            any(r.get("route") == "cpu" for r in raw.values()):
        host_peaks = lookup_peaks(cct, device_kind="cpu", platform="cpu")
    execs = {eid: _derive(rec, host_peaks if rec.get("route") == "cpu"
                          else peaks)
             for eid, rec in sorted(raw.items())}
    # the aggregate divides by the per-row ESTIMATED seconds, so an
    # async-undercounted row cannot inflate the total rate
    t_calls = sum(r["calls"] for r in raw.values())
    t_secs = sum(r["est_seconds"] for r in execs.values())
    t_flops = sum(r["flops"] for r in raw.values())
    t_bytes = sum(r["bytes"] for r in raw.values())
    agg = _derive({"calls": t_calls, "seconds": t_secs, "flops": t_flops,
                   "bytes": t_bytes, "synced_calls": 0, "synced_s": 0.0},
                  peaks)
    totals = {k: agg[k] for k in
              ("calls", "seconds", "flops", "bytes", "achieved_flops_s",
               "achieved_bytes_s", "arithmetic_intensity", "bound",
               "pct_of_peak")}
    from . import device_attribution
    busy = device_attribution.snapshot()["busy_s"]
    return {"peaks": peaks, "executables": execs, "totals": totals,
            "device_busy_s": round(busy, 6)}


def flat_series() -> dict[str, float]:
    """The time-series-ring source: aggregate efficiency as flat
    name -> value series."""
    snap = snapshot()
    t = snap["totals"]
    return {"achieved_flops_s": t["achieved_flops_s"],
            "achieved_bytes_s": t["achieved_bytes_s"],
            "pct_of_peak": t["pct_of_peak"],
            "executables": float(len(snap["executables"])),
            "device_busy_s": snap["device_busy_s"]}


def report(limit: int = 20, cct=None) -> dict:
    """The ``device roofline`` admin command: rows ranked by measured
    seconds, peaks and totals alongside."""
    snap = snapshot(cct)
    rows = sorted(snap["executables"].items(),
                  key=lambda kv: kv[1]["seconds"], reverse=True)
    return {
        "peaks": snap["peaks"],
        "totals": snap["totals"],
        "device_busy_s": snap["device_busy_s"],
        "executables": [dict(rec, executable=eid)
                        for eid, rec in rows[:max(0, int(limit))]],
    }


def bench_block(platform: str | None, cct=None, limit: int = 12) -> dict:
    """A bench line's ``efficiency`` JSON block: the roofline ledger the
    run populated, device-marked like every other block so
    ``tools/perf_gate.py`` can refuse cross-platform comparison.  The
    marker is ``"gpu"`` when ``platform`` is and the ledger holds a row
    launched on the card (route ``cuda``), else ``"cpu"``."""
    snap = snapshot(cct)
    if not snap["executables"]:
        return {"device": "none", "error": "no executables recorded"}
    rows = sorted(snap["executables"].items(),
                  key=lambda kv: kv[1]["seconds"], reverse=True)
    on_card = platform == "gpu" and \
        any(rec.get("route") == "cuda" for _eid, rec in rows)
    return {
        "device": "gpu" if on_card else "cpu",
        "peaks": snap["peaks"],
        "pct_of_peak": snap["totals"]["pct_of_peak"],
        "achieved_bytes_s": snap["totals"]["achieved_bytes_s"],
        "achieved_flops_s": snap["totals"]["achieved_flops_s"],
        "bound": snap["totals"]["bound"],
        "executables": [dict(rec, executable=eid)
                        for eid, rec in rows[:limit]],
    }


def render_table(snap_or_report: dict, limit: int = 20) -> str:
    """Human table over a :func:`snapshot`/:func:`report` shape (the
    ``ceph device roofline`` CLI rendering)."""
    execs = snap_or_report.get("executables")
    if isinstance(execs, dict):
        rows = [dict(rec, executable=eid) for eid, rec in execs.items()]
    else:
        rows = list(execs or [])
    rows.sort(key=lambda r: r.get("seconds", 0.0), reverse=True)
    peaks = snap_or_report.get("peaks") or {}
    lines = []
    if peaks:
        lines.append(
            f"peaks: {peaks.get('flops', 0) / 1e12:.1f} TFLOP/s, "
            f"{peaks.get('hbm_bytes_s', 0) / 1e9:.0f} GB/s "
            f"({peaks.get('source')})")
    lines.append(f"{'EXECUTABLE':<44} {'CALLS':>6} {'AI':>8} "
                 f"{'GB/S':>8} {'GF/S':>8} {'%PEAK':>7} BOUND")
    for r in rows[:limit]:
        lines.append(
            f"{r['executable'][:44]:<44} {r['calls']:>6} "
            f"{r['arithmetic_intensity']:>8.2f} "
            f"{r['achieved_bytes_s'] / 1e9:>8.3f} "
            f"{r['achieved_flops_s'] / 1e9:>8.3f} "
            f"{r['pct_of_peak']:>7.2f} {r['bound']}")
    return "\n".join(lines)


# -- perf-counter surface -----------------------------------------------------

EFFICIENCY_COLLECTION = "device_efficiency"


def _efficiency_perf(cct):
    pc = cct.perf.get(EFFICIENCY_COLLECTION)
    if pc is None:
        from .perf_counters import PerfCountersBuilder
        pc = (PerfCountersBuilder(EFFICIENCY_COLLECTION)
              .add_u64("executables",
                       "compiled executables in the roofline ledger")
              .add_u64("calls", "dispatches accounted by the ledger")
              .add_u64("achieved_flops_s",
                       "aggregate achieved FLOP/s over accounted "
                       "dispatch time")
              .add_u64("achieved_bytes_s",
                       "aggregate achieved bytes/s over accounted "
                       "dispatch time")
              .add_u64("pct_of_peak_x100",
                       "aggregate percent of the binding roofline peak, "
                       "x100 (4212 = 42.12%)")
              .add_u64("memory_bound",
                       "executables classified memory-bound (arithmetic "
                       "intensity under the ridge point)")
              .create_perf_counters())
        cct.perf.add(pc)
    return pc


def refresh(cct) -> dict:
    """Push the aggregate ledger view into the Context's
    ``device_efficiency`` collection (the prometheus render / perf dump
    hook).  Returns the full snapshot."""
    snap = snapshot(cct)
    pc = _efficiency_perf(cct)
    t = snap["totals"]
    pc.set("executables", len(snap["executables"]))
    pc.set("calls", t["calls"])
    pc.set("achieved_flops_s", int(t["achieved_flops_s"]))
    pc.set("achieved_bytes_s", int(t["achieved_bytes_s"]))
    pc.set("pct_of_peak_x100", int(round(t["pct_of_peak"] * 100)))
    pc.set("memory_bound",
           sum(1 for r in snap["executables"].values()
               if r["bound"] == "memory"))
    return snap
