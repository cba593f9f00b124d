"""ceph-lint CLI: run the static-analysis rules over ``ceph_tpu_torch/``.

The port's copy of the JAX package's ``tools/ceph_lint.py``, with the
same flags, output and exit codes, over the port's engine and rules
(:mod:`ceph_tpu_torch.analysis`).  Run it from the repo root::

    python -m ceph_tpu_torch.tools.ceph_lint            # every finding
    python -m ceph_tpu_torch.tools.ceph_lint \
        --baseline ceph_tpu_torch/analysis/baseline.json   # the gate
    python -m ceph_tpu_torch.tools.ceph_lint --rules \
        lock-order-cycle,launch-host-sync
    python -m ceph_tpu_torch.tools.ceph_lint --list-rules
    python -m ceph_tpu_torch.tools.ceph_lint --json     # machine output

Output: one ``path:line: severity [rule] message`` line per new
finding, then a summary line.  Exit status: 0 when every finding is
baselined (or none exist), 1 when NEW findings are present, 2 on an
unknown rule id.  The baseline workflow: a finding that is reviewed and
judged benign gets an entry in ``ceph_tpu_torch/analysis/baseline.json``
(the default of :func:`lint_summary`) with a ``justification`` — new
code is gated while reviewed noise doesn't block.  Stale entries (the
finding no longer fires) are reported as warnings so the file stays
honest.  Errors are never baselined: they are fixed, or their site is
allowlisted in the rule with its reason.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import Counter


def _analysis():
    # deferred so --help stays fast
    import ceph_tpu_torch.analysis as A
    return A


def lint_summary(baseline: str | None = None) -> dict:
    """Per-rule finding counts over the whole tree plus the
    new-vs-baseline split (``baseline`` None: the package's
    ``analysis/baseline.json``); ``chip_smoke.py``'s phase ``lint``
    prints it and fails on ``new > 0``."""
    A = _analysis()
    findings = A.run_rules(A.default_index())
    base = A.load_baseline(baseline)
    new, suppressed, stale = A.split_by_baseline(findings, base)
    return {
        "total": len(findings),
        "new": len(new),
        "baselined": len(suppressed),
        "stale_baseline": len(stale),
        "rules_run": len(A.all_rules()),
        "by_rule": dict(sorted(Counter(
            f.rule for f in findings).items())),
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="ceph_lint",
        description="static analysis over ceph_tpu_torch/")
    ap.add_argument("--baseline", metavar="FILE", default=None,
                    help="suppression file; baselined findings don't "
                         "fail the run")
    ap.add_argument("--rules", metavar="ID[,ID...]", default=None,
                    help="run only these rule ids")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule table and exit")
    ap.add_argument("--json", action="store_true",
                    help="emit findings + summary as JSON")
    args = ap.parse_args(argv)

    A = _analysis()
    if args.list_rules:
        for rid, r in sorted(A.all_rules().items()):
            print(f"{rid:24s} {r.severity:8s} {r.description}")
        return 0

    rule_ids = None
    if args.rules:
        rule_ids = tuple(s.strip() for s in args.rules.split(",")
                         if s.strip())
        unknown = [r for r in rule_ids if r not in A.all_rules()]
        if unknown:
            print(f"unknown rule ids: {', '.join(unknown)}",
                  file=sys.stderr)
            return 2

    findings = A.run_rules(A.default_index(), rule_ids)
    base = A.load_baseline(args.baseline) if args.baseline else {}
    new, suppressed, stale = A.split_by_baseline(findings, base)
    if rule_ids is not None:
        stale = [k for k in stale if k[0] in rule_ids]

    if args.json:
        print(json.dumps({
            "findings": [{"rule": f.rule, "path": f.path,
                          "line": f.line, "severity": f.severity,
                          "message": f.message,
                          "baselined": f.key in base}
                         for f in findings],
            "summary": {"total": len(findings), "new": len(new),
                        "baselined": len(suppressed),
                        "stale_baseline": len(stale)},
        }, indent=1))
        return 1 if new else 0

    for f in new:
        print(f.render())
    for k in stale:
        print(f"stale baseline entry (finding no longer fires): "
              f"[{k[0]}] {k[1]}: {k[2]}", file=sys.stderr)
    n_err = sum(1 for f in new if f.severity == "error")
    n_warn = len(new) - n_err
    print(f"ceph-lint: {len(new)} new "
          f"({n_err} errors, {n_warn} warnings), "
          f"{len(suppressed)} baselined, {len(stale)} stale baseline "
          f"entries, {len(A.all_rules() if rule_ids is None else rule_ids)} "
          f"rules run")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
