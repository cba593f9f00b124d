"""ts_report: sparkline/percentile tables from an embedded time-series.

The port's copy of the JAX package's ``tools/ts_report.py``: post-hoc
analysis of a run without an external scraper.  ``mgr/timeseries.py``
records the stats digest, heat and wire rollups into a bounded ring,
the flight recorder dumps that ring into every bundle, and THIS tool
renders it back (per-series count/min/p50/p95/max plus an ascii
sparkline), so "what did the tail look like around the incident" is
answered from the artifact alone.

Inputs, auto-detected:

- a flight bundle (``flight-*.json``): its ``timeseries`` source, and
  ``--log`` replays its ``clusterlog`` entries alongside;
- a bare ``TimeSeriesRing.dump()`` JSON;
- a directory: the newest ``flight-*.json`` beneath it (e.g.
  ``<data_dir>/flight``).

Stdlib-only and standalone (``--log`` formats entries with the port's
``common/clusterlog.format_entry`` when the package is importable).
Output is the JAX package's tool's, byte for byte, on the same bundle.

    python -m ceph_tpu_torch.tools.ts_report DATA_DIR/flight
    python -m ceph_tpu_torch.tools.ts_report flight-...-OSD_DOWN.json --log
    python -m ceph_tpu_torch.tools.ts_report bundle.json --series tail_ \
        --coarse
"""
from __future__ import annotations

import argparse
import glob
import importlib.util
import json
import os
import sys

SPARK = "▁▂▃▄▅▆▇█"

# THE shared nearest-rank percentile (ceph_tpu_torch/common/
# percentile.py), loaded by PATH so this tool stays standalone; a local
# copy once drifted to a floor-index definition, the failure ceph-lint's
# percentile-redef rule exists to prevent.
_PCTL_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          os.pardir, "common", "percentile.py")
_spec = importlib.util.spec_from_file_location("_ceph_tpu_torch_percentile",
                                               _PCTL_PATH)
_pctl = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_pctl)


def sparkline(values: list[float], width: int = 32) -> str:
    """Downsample to ``width`` buckets (max per bucket — spikes must
    survive) and render with eighth-block glyphs."""
    if not values:
        return ""
    if len(values) > width:
        per = len(values) / width
        values = [max(values[int(i * per):max(int(i * per) + 1,
                                              int((i + 1) * per))])
                  for i in range(width)]
    lo, hi = min(values), max(values)
    span = hi - lo
    if span <= 0:
        return SPARK[0] * len(values)
    return "".join(SPARK[min(len(SPARK) - 1,
                             int((v - lo) / span * len(SPARK)))]
                   for v in values)


def _p(sorted_vals: list[float], q: float) -> float:
    """Shared nearest-rank percentile over a pre-sorted list."""
    return _pctl.nearest_rank(sorted_vals, q)


def load_timeseries(path: str) -> tuple[dict, dict | None]:
    """(timeseries dump, enclosing flight bundle or None)."""
    if os.path.isdir(path):
        bundles = sorted(glob.glob(os.path.join(path, "flight-*.json")),
                         key=os.path.getmtime)
        if not bundles:
            raise FileNotFoundError(f"no flight-*.json under {path}")
        path = bundles[-1]
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict):
        raise ValueError(f"{path}: not a JSON object")
    if "fine" in doc and "coarse" in doc:
        return doc, None                       # bare ring dump
    ts = doc.get("timeseries")
    if not isinstance(ts, dict) or "fine" not in ts:
        raise ValueError(f"{path}: no usable timeseries source "
                         f"(keys: {sorted(doc)[:12]})")
    return ts, doc


def series_table(ts: dict, match: str | None = None,
                 coarse: bool = False) -> list[dict]:
    points = ts.get("coarse" if coarse else "fine", [])
    names = sorted({k for p in points for k in p
                    if k not in ("t", "wall", "n")})
    rows = []
    for name in names:
        if match and match not in name:
            continue
        vals = [float(p[name]) for p in points if name in p]
        if not vals:
            continue
        s = sorted(vals)
        rows.append({"series": name, "n": len(vals),
                     "min": s[0], "p50": _p(s, 50),
                     "p95": _p(s, 95), "max": s[-1],
                     "spark": sparkline(vals)})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="render an embedded time-series ring (flight bundle "
                    "or bare dump) as sparkline/percentile tables")
    ap.add_argument("path", help="flight bundle, ring dump, or a "
                                 "directory of flight-*.json")
    ap.add_argument("--series", help="only series containing this "
                                     "substring")
    ap.add_argument("--coarse", action="store_true",
                    help="use the coarse (mean+max folded) archive")
    ap.add_argument("--log", action="store_true",
                    help="also replay the bundle's clusterlog entries")
    ap.add_argument("--json", action="store_true",
                    help="emit the table as JSON")
    args = ap.parse_args(argv)

    try:
        ts, bundle = load_timeseries(args.path)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    rows = series_table(ts, args.series, args.coarse)
    if args.json:
        print(json.dumps({"points": len(ts.get("fine", [])),
                          "interval_s": ts.get("interval_s"),
                          "series": rows}, default=str))
    else:
        print(f"# {len(ts.get('fine', []))} fine / "
              f"{len(ts.get('coarse', []))} coarse points, "
              f"interval {ts.get('interval_s')}s")
        if not rows:
            print("(no matching series)")
        w = max((len(r["series"]) for r in rows), default=6)
        for r in rows:
            print(f"{r['series']:<{w}}  n={r['n']:<4} "
                  f"min={r['min']:<10.3f} p50={r['p50']:<10.3f} "
                  f"p95={r['p95']:<10.3f} max={r['max']:<10.3f} "
                  f"{r['spark']}")
    if args.log and bundle is not None:
        entries = bundle.get("clusterlog")
        if isinstance(entries, list):
            print(f"# clusterlog ({len(entries)} entries)")
            sys.path.insert(0, os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__)))))
            try:
                from ceph_tpu_torch.common.clusterlog import format_entry
            except ImportError:      # stay standalone even off-tree
                def format_entry(e):
                    return (f"{e.get('time')} {e.get('severity')} "
                            f"[{e.get('channel')}] {e.get('message')}")
            for e in entries:
                print(format_entry(e))
    return 0


if __name__ == "__main__":
    sys.exit(main())
