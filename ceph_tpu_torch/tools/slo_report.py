"""slo_report: attribution + burn tables from an artifact, no cluster.

The port's copy of the JAX package's ``tools/slo_report.py``, the
read-side twin of ``roofline_report`` for the latency layer: given any
artifact carrying SLO/critical-path data, render the per-class p99
attribution table ("client p99 = 41 ms: 62% batch_delay, 21% device,
9% wire") and, when objectives were configured, the burn/budget table,
so "which phase blew the budget" is answered post-hoc, from the file
alone.

Inputs, auto-detected:

- a bench JSON line (or a driver ``BENCH_r*.json`` wrapper, via its
  ``parsed`` field): its ``slo`` block (``mgr.slo`` ``bench_block``);
- a flight-recorder bundle (``flight-*.json``): its ``slo`` source (the
  SLO status and the full critical-path ledger snapshot the WARN/ERR
  auto-capture rides);
- a raw ``trace dump`` (Chrome trace-event JSON): folds the stitched
  traces through ``ceph_tpu_torch/common/critpath.py`` right here (the
  module is stdlib-only and loaded by PATH, so this tool stays
  standalone).

Text and ``--json`` are the JAX package's tool's, byte for byte, on the
same artifact.

    python -m ceph_tpu_torch.tools.slo_report line.json
    python -m ceph_tpu_torch.tools.slo_report D/flight/flight-...-SLO_BURN.json
    python -m ceph_tpu_torch.tools.slo_report trace.json --json
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_by_path(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(_PKG, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# critpath is stdlib-only and path-loadable by design: its
# format_phase_mix is THE phase-mix rendering, shared with the live
# `ceph slo status` table so the two can never drift
_critpath = _load_by_path("common/critpath.py",
                          "_ceph_tpu_torch_critpath")
_phases_line = _critpath.format_phase_mix


def from_bench_line(line: dict) -> dict:
    """Normalize a bench line's ``slo`` block into the report shape."""
    block = line.get("slo")
    if not isinstance(block, dict):
        raise ValueError("artifact has no `slo` block")
    classes: dict = {}
    burn: dict = {}
    for cls, entry in block.items():
        if not isinstance(entry, dict) or "p99_ms" not in entry:
            continue
        classes[cls] = {"p99_ms": entry["p99_ms"],
                        "ops": entry.get("ops", 0),
                        "phases": entry.get("phases", {})}
        if "budget_remaining" in entry:
            burn[cls] = {
                "objective_p99_ms": entry.get("objective_p99_ms"),
                "burn_fast": entry.get("burn_fast"),
                "burn_slow": entry.get("burn_slow"),
                "budget_remaining": entry["budget_remaining"]}
    return {"source": "bench", "device": block.get("device"),
            "classes": classes, "burn": burn}


def from_flight_bundle(doc: dict) -> dict:
    """Normalize a flight bundle's ``slo`` source."""
    src = doc.get("slo")
    if not isinstance(src, dict) or "slo" not in src:
        raise ValueError("bundle has no `slo` source")
    status = src["slo"]
    classes: dict = {}
    for cls, summary in (status.get("attribution") or {}).items():
        if summary:
            classes[cls] = {"p99_ms": summary["p99_ms"],
                            "ops": summary["ops"],
                            "phases": summary["phases"]}
    burn: dict = {}
    for cls, s in (status.get("objectives") or {}).items():
        burn[cls] = {"objective_p99_ms": s["objective_p99_ms"],
                     "burn_fast": s["fast"]["burn"],
                     "burn_slow": s["slow"]["burn"],
                     "budget_remaining": s["budget_remaining"]}
    return {"source": "flight", "reason": doc.get("reason"),
            "classes": classes, "burn": burn}


def from_trace_dump(doc) -> dict:
    """Fold a raw trace dump through the critical-path extractor."""
    critpath = _critpath
    pctl = _load_by_path("common/percentile.py",
                         "_ceph_tpu_torch_percentile")
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    per_class: dict[str, list[dict]] = {}
    for _tid, spans in sorted(critpath.group_traces(events).items()):
        rec = critpath.decompose(spans)
        if rec is not None:
            per_class.setdefault(rec["op_class"], []).append(rec)
    classes: dict = {}
    sampled = False
    for cls, recs in sorted(per_class.items()):
        # sample-weight de-bias (the tracer's head sampling): each
        # record stands for w ops; percentiles walk cumulative weight
        # and phase fractions scale by it, so a 1%-sampled dump reports
        # the same rates an unsampled one would
        pairs = sorted((r["total_s"], r.get("w", 1.0)) for r in recs)
        wsum = sum(w for _v, w in pairs)
        if any(w != 1.0 for _v, w in pairs):
            sampled = True
        agg: dict[str, float] = {}
        for r in recs:
            rw = r.get("w", 1.0)
            for p, v in r["phases"].items():
                agg[p] = agg.get(p, 0.0) + v * rw
        whole = sum(agg.values())
        classes[cls] = {
            "p99_ms": round(
                pctl.weighted_nearest_rank(pairs, 99) * 1e3, 3),
            "ops": len(recs),
            "weighted_ops": round(wsum, 1),
            "phases": {p: round(v / whole, 4) if whole else 0.0
                       for p, v in agg.items()}}
    return {"source": "trace", "sampled": sampled, "classes": classes,
            "burn": {}}


def build_report(doc) -> dict:
    """Auto-detect the artifact shape and normalize it."""
    if isinstance(doc, dict) and isinstance(doc.get("parsed"), dict):
        doc = doc["parsed"]                        # BENCH_r wrapper
    if isinstance(doc, dict) and "slo" in doc and \
            isinstance(doc["slo"], dict) and "slo" in doc["slo"]:
        return from_flight_bundle(doc)
    if isinstance(doc, dict) and "slo" in doc:
        return from_bench_line(doc)
    if isinstance(doc, list) or (isinstance(doc, dict)
                                 and "traceEvents" in doc):
        return from_trace_dump(doc)
    raise ValueError("unrecognized artifact: need a bench line with an "
                     "`slo` block, a flight bundle with an `slo` "
                     "source, or a trace dump")


def render(report: dict) -> str:
    lines = [f"latency attribution ({report['source']} artifact):"]
    if report.get("sampled"):
        lines.append("  (head-sampled dump: percentiles and phase mixes "
                     "weighted by sample_weight)")
    if not report["classes"]:
        lines.append("  no per-class records")
    for cls, entry in sorted(report["classes"].items()):
        lines.append(f"  {cls} p99 = {entry['p99_ms']:.1f} ms "
                     f"({entry['ops']} ops): "
                     f"{_phases_line(entry['phases'])}")
    if report["burn"]:
        lines.append("error budgets:")
        lines.append(f"  {'class':<10} {'p99 obj':>9} {'burn(fast)':>10} "
                     f"{'burn(slow)':>10} {'budget left':>11}")
        for cls, b in sorted(report["burn"].items()):
            obj = b.get("objective_p99_ms")
            fast, slow = b.get("burn_fast"), b.get("burn_slow")
            lines.append(
                f"  {cls:<10} "
                f"{(f'{obj:.1f}ms' if obj is not None else '-'):>9} "
                f"{(f'{fast:.1f}x' if fast is not None else '-'):>10} "
                f"{(f'{slow:.1f}x' if slow is not None else '-'):>10} "
                f"{100 * b['budget_remaining']:>10.0f}%")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="render SLO attribution/burn tables from a bench "
                    "line, flight bundle, or trace dump")
    ap.add_argument("artifact")
    ap.add_argument("--json", action="store_true",
                    help="emit the normalized report as JSON")
    args = ap.parse_args(argv)
    with open(args.artifact) as f:
        doc = json.load(f)
    try:
        report = build_report(doc)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(report))
    else:
        print(render(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
