"""gf_apply_roofline_pct: the time the launches of ``gf_apply.cu``'s
kernel in the profiled window would take at the card's HBM bandwidth
(their bytes, ``roofline.gf_apply_bytes`` of each launch-ledger key, at
``roofline.HBM_BYTES_S``) over the time their kernels took.  The kernel
runs under two ledger names, ``gf_apply`` (one stripe a launch) and
``gf_apply_stripes`` (the vertical layout, S stripes a launch); both
count.

The ledger counts launches and the trace kernels over the same stretch;
where the two counts differ (a launch at the stretch's edge), the bytes
are the ledger's mean a launch times the trace's count."""
import sys

from benchmark import roofline

#: the launch-ledger names whose launches run ``gf_apply_kernel``
LEDGER_NAMES = ("gf_apply", "gf_apply_stripes")


def read(run):
    t = run.trace
    if t is None or not t["gf_apply"]["count"]:
        return None
    keys = {k: n for k, n in t["launches"].items() if k[0] in LEDGER_NAMES}
    launches = sum(keys.values())
    if not launches:
        return None
    nbytes = sum(roofline.gf_apply_bytes(k) * n for k, n in keys.items())
    if launches != t["gf_apply"]["count"]:
        print(f"gf_apply: {launches} ledger launches, "
              f"{t['gf_apply']['count']} kernels traced", file=sys.stderr)
        nbytes = nbytes / launches * t["gf_apply"]["count"]
    bound_s = nbytes / roofline.HBM_BYTES_S
    return 100.0 * bound_s / t["gf_apply"]["seconds"]
