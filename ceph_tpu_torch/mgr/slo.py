"""SLO engine: per-class latency objectives, error budgets, burn rates.

The health engine knows point thresholds; serving is judged on p99
and goodput-under-overload, which need an OBJECTIVE:
"99.9% of client ops complete under 40 ms" — and an alert policy that
pages on a sustained budget burn, not on one slow op.  This module is
the SRE-workbook multi-window burn-rate engine over the critical-path
ledger (``common/critpath.py``):

- **objectives** come from config: ``slo_<class>_p99_ms`` (the latency
  bound; 0 = no objective for that class) and ``slo_<class>_target``
  (the fraction of ops that must meet it, default 0.999 — the error
  budget is ``1 - target``);
- **burn rate** over a window = (fraction of ops over the bound) /
  budget: 1.0 means spending exactly the sustainable rate, 2.0 means
  the budget dies in half its period;
- **multi-window agreement**: ``SLO_BURN`` raises only when BOTH the
  fast window (``slo_fast_window``) and the slow window
  (``slo_slow_window``) burn past ``slo_burn_rate_threshold`` — a blip
  trips the fast window alone and stays silent; a sustained burn trips
  both and pages.  ``SLO_EXHAUSTED`` (HEALTH_ERR) raises when the slow
  window burns past ``slo_exhausted_burn_rate`` — the budget is not
  merely burning, it is gone at any plausible compliance period;
- windows below ``slo_min_ops`` ops never page (an idle class has no
  evidence either way).

Surfaces: the ``SLO_BURN``/``SLO_EXHAUSTED`` health checks (every
MiniCluster registers them; transitions ride the clusterlog + flight
recorder like any other check), ``slo status``/``slo dump`` admin
commands, ``ceph_tpu_slo_budget{class,stat}`` prometheus gauges, the
``slo`` series in the time-series ring, and the ``slo`` block in
bench.py artifacts gated by ``tools/perf_gate.py``.

A copy of ``ceph_tpu.mgr.slo``.
"""
from __future__ import annotations

import threading
import time
import weakref

from ..common import default_context
from ..common.critpath import PHASES, render_attribution
from ..common.device_attribution import OWNER_CLASSES
from .health import HEALTH_ERR, CheckResult

_TRACKERS: "weakref.WeakSet[SLOTracker]" = weakref.WeakSet()


def live_slo_trackers() -> list["SLOTracker"]:
    return list(_TRACKERS)


def slo_objectives(conf) -> dict[str, dict]:
    """{class: {"p99_ms", "target", "budget"}} for every class with a
    configured objective (``slo_<class>_p99_ms`` > 0)."""
    out: dict[str, dict] = {}
    for cls in OWNER_CLASSES:
        p99 = float(conf.get(f"slo_{cls}_p99_ms"))
        if p99 <= 0:
            continue
        target = min(0.999999, max(0.0, float(
            conf.get(f"slo_{cls}_target"))))
        out[cls] = {"p99_ms": p99, "target": target,
                    "budget": max(1e-9, 1.0 - target)}
    return out


class SLOTracker:
    """Error-budget accounting over the critical-path ledger's per-op
    records (each record: completion time on the perf_counter clock,
    total seconds, per-phase seconds)."""

    def __init__(self, ledger, cct=None, name: str = "slo",
                 clock=time.perf_counter):
        self.cct = cct if cct is not None else default_context()
        self.ledger = ledger
        self.name = name
        self.clock = clock
        self._lock = threading.Lock()
        _TRACKERS.add(self)

    # windows/thresholds read LIVE, like the objectives: `config set
    # slo_fast_window 5` on a running cluster must take effect the same
    # way `config set slo_client_p99_ms 40` does
    @property
    def fast_window(self) -> float:
        return float(self.cct.conf.get("slo_fast_window"))

    @property
    def slow_window(self) -> float:
        return float(self.cct.conf.get("slo_slow_window"))

    @property
    def burn_threshold(self) -> float:
        return float(self.cct.conf.get("slo_burn_rate_threshold"))

    @property
    def exhausted_burn(self) -> float:
        return float(self.cct.conf.get("slo_exhausted_burn_rate"))

    @property
    def min_ops(self) -> int:
        return int(self.cct.conf.get("slo_min_ops"))

    # -- window math -------------------------------------------------------

    @staticmethod
    def _window(records: list[dict], window_s: float, bound_ms: float,
                budget: float, now: float) -> dict:
        recs = [r for r in records if now - r["t"] <= window_s]
        # weighted by each record's sample weight (1/rate for head-
        # sampled traces, 1.0 otherwise): bad_frac stays an unbiased
        # estimate of the true bad-op RATE under sampling.  `ops` stays
        # the observed record count — it feeds the min_ops significance
        # floor, which is about how much EVIDENCE we have, not how many
        # ops the evidence represents.
        bad = sum(r.get("w", 1.0) for r in recs
                  if r["total_s"] * 1e3 > bound_ms)
        wsum = sum(r.get("w", 1.0) for r in recs)
        n = len(recs)
        bad_frac = bad / wsum if wsum else 0.0
        return {"window_s": window_s, "ops": n,
                "weighted_ops": round(wsum, 1), "bad": round(bad, 1),
                "bad_frac": round(bad_frac, 6),
                "burn": round(bad_frac / budget, 3)}

    def class_status(self, cls: str, objective: dict,
                     now: float | None = None) -> dict:
        now = self.clock() if now is None else now
        # ONE copy of the class's record window serves both burn
        # windows (records() copies the bounded deque under the ledger
        # lock — doing it per window doubled the hold for nothing)
        records = self.ledger.records(cls)
        fast = self._window(records, self.fast_window,
                            objective["p99_ms"], objective["budget"],
                            now)
        slow = self._window(records, self.slow_window,
                            objective["p99_ms"], objective["budget"],
                            now)
        enough = fast["ops"] >= self.min_ops and \
            slow["ops"] >= self.min_ops
        burning = enough and fast["burn"] >= self.burn_threshold \
            and slow["burn"] >= self.burn_threshold
        exhausted = enough and slow["burn"] >= self.exhausted_burn
        return {
            "objective_p99_ms": objective["p99_ms"],
            "target": objective["target"],
            "budget": round(objective["budget"], 6),
            "fast": fast,
            "slow": slow,
            # budget left over the slow window: 1.0 = untouched,
            # 0.0 = fully consumed (burn >= 1/budget would be needed
            # only for bad_frac = 1; the remaining fraction is the
            # honest operator number)
            "budget_remaining": round(
                max(0.0, 1.0 - slow["bad_frac"] / objective["budget"]),
                4),
            "burning": burning,
            "exhausted": exhausted,
        }

    # -- surfaces ----------------------------------------------------------

    def objectives_status(self, now: float | None = None
                          ) -> dict[str, dict]:
        """Just the per-class objective/burn state — what the two
        health checks read every evaluation (computing the full
        attribution summaries there would deep-copy and sort every
        class's record window once per check per tick for data the
        checks never look at)."""
        objectives = slo_objectives(self.cct.conf)
        now = self.clock() if now is None else now
        return {cls: self.class_status(cls, obj, now)
                for cls, obj in sorted(objectives.items())}

    def status(self, now: float | None = None) -> dict:
        """The `slo status` shape: per-class objective/burn state plus
        the ledger's attribution summaries (classes WITHOUT an
        objective still show attribution — the p99 table is useful
        before anyone commits to a number)."""
        return {
            "windows": {"fast_s": self.fast_window,
                        "slow_s": self.slow_window,
                        "burn_threshold": self.burn_threshold,
                        "exhausted_burn": self.exhausted_burn,
                        "min_ops": self.min_ops},
            "objectives": self.objectives_status(now),
            "attribution": {cls: self.ledger.class_summary(cls)
                            for cls in self.ledger.classes()},
        }

    def dump(self) -> dict:
        """`slo dump` / the flight-recorder source: status + the full
        ledger snapshot, so a WARN/ERR bundle answers 'which phase blew
        the budget' without a live cluster."""
        return {"slo": self.status(), "critpath": self.ledger.snapshot()}

    def flat_series(self) -> dict[str, float]:
        """The time-series-ring source (`slo.<class>_<stat>`)."""
        out: dict[str, float] = {}
        st = self.status()
        for cls, s in st["objectives"].items():
            out[f"{cls}_burn_fast"] = s["fast"]["burn"]
            out[f"{cls}_burn_slow"] = s["slow"]["burn"]
            out[f"{cls}_budget_remaining"] = s["budget_remaining"]
        for cls, summary in st["attribution"].items():
            if summary:
                out[f"{cls}_p99_ms"] = summary["p99_ms"]
        return out

    def bench_block(self, device: str) -> dict:
        """The bench.py `slo` block: per-class p99 + phase fractions +
        budget state — everything tools/slo_report.py needs to
        reproduce the attribution table from the artifact alone, and
        tools/perf_gate.py gates (`slo.client_p99_ms`,
        `slo.budget_remaining`)."""
        st = self.status()
        block: dict = {"device": device,
                       "windows": st["windows"]}
        for cls, summary in st["attribution"].items():
            if not summary:
                continue
            entry = {"p99_ms": summary["p99_ms"],
                     "mean_ms": summary["mean_ms"],
                     "ops": summary["ops"],
                     "phases": summary["phases"]}
            obj = st["objectives"].get(cls)
            if obj:
                entry["objective_p99_ms"] = obj["objective_p99_ms"]
                entry["budget_remaining"] = obj["budget_remaining"]
                entry["burn_fast"] = obj["fast"]["burn"]
                entry["burn_slow"] = obj["slow"]["burn"]
            block[cls] = entry
        return block

    def close(self) -> None:
        _TRACKERS.discard(self)


# -- health checks -----------------------------------------------------------

def slo_burn_check(tracker: SLOTracker):
    """SLO_BURN: fast AND slow windows agree the error budget is
    burning past threshold — a blip trips the fast window alone and
    stays silent; a sustained burn pages."""
    def check():
        hot: list[str] = []
        for cls, s in tracker.objectives_status().items():
            if s["burning"] and not s["exhausted"]:
                hot.append(
                    f"{cls}: burn x{s['fast']['burn']:.1f} fast / "
                    f"x{s['slow']['burn']:.1f} slow (p99 objective "
                    f"{s['objective_p99_ms']:.1f} ms, "
                    f"{s['slow']['bad']}/{s['slow']['ops']} ops over, "
                    f"{100 * s['budget_remaining']:.0f}% budget left)")
        if hot:
            return CheckResult(
                f"{len(hot)} class(es) burning latency error budget "
                f"(fast+slow window agreement)",
                detail=hot, count=len(hot))
        return None
    return check


def slo_exhausted_check(tracker: SLOTracker):
    """SLO_EXHAUSTED: the slow window's burn rate says the budget is
    gone at any plausible compliance period — HEALTH_ERR."""
    def check():
        hot: list[str] = []
        for cls, s in tracker.objectives_status().items():
            if s["exhausted"]:
                hot.append(
                    f"{cls}: burn x{s['slow']['burn']:.1f} over "
                    f"{s['slow']['window_s']:.0f}s "
                    f"({s['slow']['bad']}/{s['slow']['ops']} ops past "
                    f"the {s['objective_p99_ms']:.1f} ms objective)")
        if hot:
            return CheckResult(
                f"{len(hot)} class(es) exhausted their latency error "
                f"budget", detail=hot, severity=HEALTH_ERR,
                count=len(hot))
        return None
    return check


# -- rendering ---------------------------------------------------------------

def render_status(status: dict, ledger_snapshot: dict | None = None
                  ) -> str:
    """The `ceph slo status` text: per-class p99 attribution table plus
    the budget table for classes with objectives."""
    lines = ["latency attribution (critical-path ledger):"]
    snap = ledger_snapshot or {"classes": status.get("attribution", {})}
    lines += [f"  {line}" for line in render_attribution(snap)]
    objectives = status.get("objectives") or {}
    if objectives:
        lines.append("objectives:")
        lines.append(f"  {'class':<10} {'p99 obj':>9} {'p99 now':>9} "
                     f"{'burn(fast)':>10} {'burn(slow)':>10} "
                     f"{'budget left':>11}  state")
        for cls, s in sorted(objectives.items()):
            summary = (status.get("attribution") or {}).get(cls)
            now_ms = f"{summary['p99_ms']:.1f}" if summary else "-"
            state = "EXHAUSTED" if s["exhausted"] else \
                "BURNING" if s["burning"] else "ok"
            lines.append(
                f"  {cls:<10} {s['objective_p99_ms']:>7.1f}ms "
                f"{now_ms:>7}ms {s['fast']['burn']:>9.1f}x "
                f"{s['slow']['burn']:>9.1f}x "
                f"{100 * s['budget_remaining']:>10.0f}%  {state}")
    else:
        lines.append("objectives: none configured "
                     "(set slo_<class>_p99_ms)")
    return "\n".join(lines)


def render_phase_table(phases: dict[str, float]) -> str:
    """One class's phase-fraction row set (slo_report's table body)."""
    rows = [f"  {p:<12} {100 * phases.get(p, 0.0):>6.1f}%"
            for p in PHASES if phases.get(p, 0.0) > 0]
    return "\n".join(rows) if rows else "  (no attributed time)"
