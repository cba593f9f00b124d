"""roofline_report: the per-kernel device-efficiency table, post-hoc.

The port's copy of the JAX package's ``tools/roofline_report.py``.  It
renders the port's roofline ledger (``ceph_tpu_torch/common/
roofline.py``: one row per hand kernel and launch key, achieved bytes/s
against the H100 peaks) from an artifact alone, no live process
required.  Accepted inputs, auto-detected:

- a bench JSON line (its ``efficiency`` block, from
  ``roofline.bench_block``), or a driver ``BENCH_r*.json`` wrapper
  (``parsed.efficiency``);
- a flight-recorder bundle (its ``efficiency`` source, the full
  roofline snapshot);
- a raw ``roofline.snapshot()`` / ``device roofline`` JSON document.

For every row: calls, modeled FLOPs and bytes, arithmetic intensity,
achieved GB/s and GFLOP/s over the measured seconds (CUDA-event device
time for launches on the card), percent of the binding roofline peak,
and the memory/compute-bound classification.  The table and ``--json``
are the JAX package's tool's, byte for byte, on the same document.

    python -m ceph_tpu_torch.tools.roofline_report line.json
    python -m ceph_tpu_torch.tools.roofline_report flight-....json --json

Stdlib-only, standalone.
"""
from __future__ import annotations

import argparse
import json
import sys


def extract(doc: dict) -> dict | None:
    """Find the efficiency payload in any accepted document shape:
    ``{peaks, executables, ...}`` with executables normalized to a list
    of rows each carrying an ``executable`` key."""
    if not isinstance(doc, dict):
        return None
    # driver wrapper -> bench line
    if isinstance(doc.get("parsed"), dict):
        doc = doc["parsed"]
    # bench line / flight bundle -> their efficiency block/source
    if isinstance(doc.get("efficiency"), dict):
        doc = doc["efficiency"]
    execs = doc.get("executables")
    if execs is None:
        return None
    if isinstance(execs, dict):              # snapshot shape: id -> rec
        rows = [dict(rec, executable=eid)
                for eid, rec in sorted(execs.items())]
    else:
        rows = [dict(r) for r in execs if isinstance(r, dict)]
    return {"peaks": doc.get("peaks") or {},
            "device": doc.get("device"),
            "totals": doc.get("totals"),
            "pct_of_peak": doc.get("pct_of_peak"),
            "executables": rows,
            "error": doc.get("error")}


def _fmt_qty(v: float) -> str:
    for unit in ("", "K", "M", "G", "T"):
        if abs(v) < 1000 or unit == "T":
            return f"{v:.1f}{unit}"
        v /= 1000.0
    return f"{v:.1f}T"                       # pragma: no cover


def render(data: dict, limit: int = 20) -> str:
    rows = sorted(data["executables"],
                  key=lambda r: r.get("seconds", 0.0), reverse=True)
    peaks = data["peaks"]
    lines = []
    head = []
    if data.get("device"):
        head.append(f"device={data['device']}")
    if peaks:
        head.append(f"peaks {peaks.get('flops', 0) / 1e12:.1f} TFLOP/s / "
                    f"{peaks.get('hbm_bytes_s', 0) / 1e9:.0f} GB/s "
                    f"({peaks.get('source')})")
    pct = data.get("pct_of_peak")
    if pct is None and isinstance(data.get("totals"), dict):
        pct = data["totals"].get("pct_of_peak")
    if pct is not None:
        head.append(f"aggregate {pct:.2f}% of peak")
    if head:
        lines.append("  ".join(head))
    lines.append(f"{'EXECUTABLE':<46} {'CALLS':>6} {'FLOPS':>8} "
                 f"{'BYTES':>8} {'AI':>7} {'GB/S':>8} {'GF/S':>8} "
                 f"{'%PEAK':>7} BOUND")
    for r in rows[:limit]:
        lines.append(
            f"{str(r.get('executable', '?'))[:46]:<46} "
            f"{int(r.get('calls', 0)):>6} "
            f"{_fmt_qty(float(r.get('flops', 0.0))):>8} "
            f"{_fmt_qty(float(r.get('bytes', 0.0))):>8} "
            f"{float(r.get('arithmetic_intensity', 0.0)):>7.2f} "
            f"{float(r.get('achieved_bytes_s', 0.0)) / 1e9:>8.3f} "
            f"{float(r.get('achieved_flops_s', 0.0)) / 1e9:>8.3f} "
            f"{float(r.get('pct_of_peak', 0.0)):>7.2f} "
            f"{r.get('bound', '?')}")
    if len(rows) > limit:
        lines.append(f"... {len(rows) - limit} more (raise --limit)")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="per-executable roofline table from a bench "
                    "artifact, flight bundle, or roofline snapshot")
    ap.add_argument("artifact", help="JSON document to render")
    ap.add_argument("--limit", type=int, default=20,
                    help="max executable rows (default 20)")
    ap.add_argument("--json", action="store_true",
                    help="emit the normalized payload as JSON")
    args = ap.parse_args(argv)

    with open(args.artifact) as f:
        doc = json.load(f)
    data = extract(doc)
    if data is None:
        print(f"error: no efficiency/roofline data in {args.artifact} "
              f"(expected a bench line with an 'efficiency' block, a "
              f"flight bundle, or a roofline snapshot)", file=sys.stderr)
        return 2
    if data.get("error") and not data["executables"]:
        print(f"error: artifact carries an efficiency error marker: "
              f"{data['error']}", file=sys.stderr)
        return 2
    try:
        if args.json:
            print(json.dumps(data))
        else:
            print(render(data, limit=args.limit))
    except BrokenPipeError:              # `... | head` is a normal use
        return 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
