"""trace_report: a Chrome trace-event file as a sorted self-time table.

The port's copy of the JAX package's ``tools/trace_report.py``.  Input:
the JSON ``trace dump`` returns (``{"traceEvents": [...]}``, or a bare
event array), saved with e.g.

    python - <<'PY'
    from ceph_tpu_torch.common import default_context
    open("trace.json", "w").write(
        default_context().admin_socket.call_json("trace dump"))
    PY

then ``python -m ceph_tpu_torch.tools.trace_report trace.json``.  Self
time is each span's duration minus the duration of spans nested inside
it (same pid/tid, contained by timestamps), i.e. where the wall clock
actually went, the number that ranks optimization targets, which total
time (double-counting every parent) cannot.  p50/p99 columns give each
span name's per-occurrence duration distribution, weighted by the
tracer's ``sample_weight`` in a head-sampled dump (a ``serving.op``
row's p99 IS the op tail).  ``--trace-id N`` renders one distributed
trace as a cross-daemon span tree, ``--traces`` lists them, ``--json``
is the table's machine-readable twin.  Text and JSON are the JAX
package's tool's, byte for byte, on the same dump.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
from collections import defaultdict

# THE shared nearest-rank definition (ceph_tpu_torch/common/
# percentile.py), loaded by PATH so this tool stays standalone: no
# package import (which would pull torch).  The module itself is
# stdlib-only; ceph-lint's percentile-redef rule keeps local
# redefinitions out.
_PCTL_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          os.pardir, "common", "percentile.py")
_spec = importlib.util.spec_from_file_location("_ceph_tpu_torch_percentile",
                                               _PCTL_PATH)
_pctl = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_pctl)


def load_doc(path: str) -> list[dict]:
    """Every event in the dump, metadata included (parsed once)."""
    with open(path) as f:
        doc = json.load(f)
    return doc["traceEvents"] if isinstance(doc, dict) else doc


def load_events(path: str) -> list[dict]:
    return [e for e in load_doc(path) if e.get("ph") == "X"]


def percentile_us(durs_us: list[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) over raw durations —
    the shared definition from ceph_tpu_torch/common/percentile.py."""
    return _pctl.percentile(durs_us, q)


def percentile_us_w(pairs: list[tuple], q: float) -> float:
    """Weighted nearest-rank over (duration_us, sample_weight) pairs —
    identical to :func:`percentile_us` when every weight is 1.0."""
    return _pctl.weighted_nearest_rank(sorted(pairs), q)


def event_weight(ev: dict) -> float:
    """The event's sample weight (1/rate stamped by the tracer's head
    sampler; 1.0 for unsampled-era and promoted events)."""
    try:
        w = float(ev.get("args", {}).get("sample_weight", 1.0))
    except (TypeError, ValueError):
        return 1.0
    return w if w > 0.0 else 1.0


def self_times(events: list[dict]) -> dict[str, dict]:
    """name -> {count, weight, total_us, self_us, durs_us, wdurs};
    nesting resolved per (pid, tid) with a containment stack sweep over
    ts-sorted complete events.  ``durs_us`` holds every occurrence's
    total duration (the p50/p99 source); ``wdurs`` pairs each with its
    sample weight and ``weight`` sums them (the de-biased op-count
    estimate for head-sampled dumps)."""
    agg: dict[str, dict] = defaultdict(
        lambda: {"count": 0, "weight": 0.0, "total_us": 0.0,
                 "self_us": 0.0, "durs_us": [], "wdurs": []})
    by_track: dict[tuple, list[dict]] = defaultdict(list)
    for ev in events:
        by_track[(ev.get("pid"), ev.get("tid"))].append(ev)
    for track in by_track.values():
        # parents first at equal start times (longer duration wins)
        track.sort(key=lambda e: (e["ts"], -e.get("dur", 0.0)))
        stack: list[dict] = []          # enclosing spans, innermost last
        for ev in track:
            dur = float(ev.get("dur", 0.0))
            ts = float(ev["ts"])
            while stack and stack[-1]["ts"] + stack[-1].get("dur", 0.0) \
                    <= ts:
                stack.pop()
            if stack:                   # nested: charge the parent less
                parent = agg[stack[-1]["name"]]
                parent["self_us"] -= dur
            w = event_weight(ev)
            a = agg[ev["name"]]
            a["count"] += 1
            a["weight"] += w
            a["total_us"] += dur
            a["self_us"] += dur
            a["durs_us"].append(dur)
            a["wdurs"].append((dur, w))
            stack.append(ev)
    return dict(agg)


def is_sampled(agg: dict[str, dict]) -> bool:
    """True when any row carries a non-unit sample weight (the dump came
    from a head-sampled tracer and percentiles are weight-de-biased)."""
    return any(abs(a.get("weight", a["count"]) - a["count"]) > 1e-9
               for a in agg.values())


def render_table(agg: dict[str, dict], limit: int = 0) -> str:
    rows = sorted(agg.items(), key=lambda kv: kv[1]["self_us"],
                  reverse=True)
    if limit:
        rows = rows[:limit]
    width = max([len("span")] + [len(name) for name, _ in rows])
    lines = []
    if is_sampled(agg):
        est = round(sum(a.get("weight", a["count"]) for _n, a in rows))
        n = sum(a["count"] for _n, a in rows)
        lines.append(f"sampled trace: p50/p99 weighted by sample_weight "
                     f"(~{est} ops estimated from {n} recorded spans)")
    lines.append(f"{'span':<{width}}  {'count':>7}  {'total ms':>10}  "
                 f"{'self ms':>10}  {'avg ms':>9}  {'p50 ms':>9}  "
                 f"{'p99 ms':>9}")
    for name, a in rows:
        avg = a["total_us"] / a["count"] / 1e3 if a["count"] else 0.0
        pairs = a.get("wdurs") or [(d, 1.0) for d in a.get("durs_us", [])]
        lines.append(
            f"{name:<{width}}  {a['count']:>7}  "
            f"{a['total_us'] / 1e3:>10.3f}  {a['self_us'] / 1e3:>10.3f}  "
            f"{avg:>9.3f}  {percentile_us_w(pairs, 50) / 1e3:>9.3f}  "
            f"{percentile_us_w(pairs, 99) / 1e3:>9.3f}")
    return "\n".join(lines)


def render_json(agg: dict[str, dict], limit: int = 0) -> str:
    """Machine-readable twin of the text table (CI/BENCH tooling was
    scraping the text): same rows, same order, explicit units."""
    rows = sorted(agg.items(), key=lambda kv: kv[1]["self_us"],
                  reverse=True)
    if limit:
        rows = rows[:limit]
    spans = []
    for name, a in rows:
        pairs = a.get("wdurs") or [(d, 1.0) for d in a.get("durs_us", [])]
        spans.append({
            "name": name,
            "count": a["count"],
            "est_count": round(a.get("weight", a["count"]), 1),
            "total_ms": round(a["total_us"] / 1e3, 6),
            "self_ms": round(a["self_us"] / 1e3, 6),
            "avg_ms": round(a["total_us"] / a["count"] / 1e3, 6)
            if a["count"] else 0.0,
            "p50_ms": round(percentile_us_w(pairs, 50) / 1e3, 6),
            "p99_ms": round(percentile_us_w(pairs, 99) / 1e3, 6),
        })
    return json.dumps({"spans": spans, "num_spans": len(spans),
                       "sampled": is_sampled(agg)})


def _track_names(all_events: list[dict]) -> dict:
    """pid -> daemon track name from the stitched dump's process_name
    metadata events (tracer.Tracer.dump(stitched=True))."""
    return {e["pid"]: e["args"]["name"] for e in all_events
            if e.get("ph") == "M" and e.get("name") == "process_name"}


def trace_tree(events: list[dict], trace_id: int,
               tracks: dict | None = None) -> list[str]:
    """Render ONE distributed trace as an indented span tree — the
    'where did this 1 MiB write spend its 4 ms' view.  Spans join on the
    trace/span ids the tracer stamps into event args; each line carries
    the daemon track, so a client op reads as client -> primary ->
    remote shards with per-hop durations."""
    tracks = tracks or {}
    spans = [e for e in events
             if e.get("args", {}).get("trace_id") == trace_id]
    if not spans:
        return [f"no spans for trace {trace_id}"]
    by_parent: dict[int, list[dict]] = defaultdict(list)
    ids = {e["args"]["span_id"] for e in spans}
    for e in spans:
        parent = e["args"].get("parent_span_id", 0)
        by_parent[parent if parent in ids else 0].append(e)
    for kids in by_parent.values():
        kids.sort(key=lambda e: e["ts"])
    lines = [f"trace {trace_id} ({len(spans)} spans, "
             f"{len({e.get('pid') for e in spans})} tracks)"]

    def walk(parent: int, depth: int) -> None:
        for e in by_parent.get(parent, ()):
            track = tracks.get(e.get("pid"), str(e.get("pid")))
            owner = e["args"].get("owner") or e["args"].get("op_class", "")
            extra = f" [{owner}]" if owner else ""
            lines.append(
                f"{'  ' * depth}{e['name']:<{max(1, 40 - 2 * depth)}} "
                f"{e.get('dur', 0.0) / 1e3:>9.3f} ms  @{track}{extra}")
            walk(e["args"]["span_id"], depth + 1)
    walk(0, 1)
    return lines


def list_traces(events: list[dict]) -> list[str]:
    """Traces present in the dump, largest root span first."""
    roots: dict[int, dict] = {}
    counts: dict[int, int] = defaultdict(int)
    for e in events:
        args = e.get("args", {})
        tid = args.get("trace_id")
        if tid is None:
            continue
        counts[tid] += 1
        if args.get("parent_span_id", 0) == 0:
            top = roots.get(tid)
            if top is None or e.get("dur", 0) > top.get("dur", 0):
                roots[tid] = e
    rows = sorted(roots.items(),
                  key=lambda kv: kv[1].get("dur", 0.0), reverse=True)
    out = [f"{'trace':>8}  {'spans':>6}  {'root ms':>9}  root"]
    for tid, root in rows:
        out.append(f"{tid:>8}  {counts[tid]:>6}  "
                   f"{root.get('dur', 0.0) / 1e3:>9.3f}  {root['name']}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="sorted self-time table from a Chrome trace file")
    ap.add_argument("trace", help="trace JSON ({'traceEvents': ...} or [])")
    ap.add_argument("--limit", type=int, default=0,
                    help="show only the top N spans by self time")
    ap.add_argument("--json", action="store_true",
                    help="emit the table as one JSON document instead of "
                         "text (same rows/order)")
    ap.add_argument("--trace-id", type=int, default=None,
                    help="render ONE distributed trace as a cross-daemon "
                         "span tree instead of the table")
    ap.add_argument("--traces", action="store_true",
                    help="list the distributed traces in the dump")
    args = ap.parse_args(argv)
    all_events = load_doc(args.trace)
    events = [e for e in all_events if e.get("ph") == "X"]
    if args.traces:
        print("\n".join(list_traces(events)))
        return 0
    if args.trace_id is not None:
        print("\n".join(trace_tree(events, args.trace_id,
                                   _track_names(all_events))))
        return 0
    if not events:
        # both modes keep the nonzero exit: a trace that captured
        # nothing is a failure signal CI must not green on
        if args.json:
            print(json.dumps({"spans": [], "num_spans": 0,
                              "error": "no complete ('ph': 'X') events "
                                       "in trace"}))
        else:
            print("no complete ('ph': 'X') events in trace",
                  file=sys.stderr)
        return 1
    agg = self_times(events)
    if args.json:
        print(render_json(agg, args.limit))
    else:
        print(render_table(agg, args.limit))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:         # | head closed the pipe: not an error
        sys.exit(0)
