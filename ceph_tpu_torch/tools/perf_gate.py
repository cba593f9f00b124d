"""perf_gate: diff a fresh bench artifact against the record.

The port's copy of the JAX package's ``tools/perf_gate.py``.  It makes
two failure modes loud and machine-checkable:

- **regression**: each comparable block (the core codec metric plus the
  ``serving``/``recovery``/``pipeline``/``efficiency``/``slo``/... blocks)
  is diffed against the reference artifact with a per-metric threshold;
  a drop past the threshold fails the gate, and a few claims are held
  to absolute caps or floors on the new artifact alone;
- **platform fallback**: an artifact whose device degraded below the
  expected platform (expected the card, measured the CPU) is a hard
  FAIL no matter how healthy its numbers look; a CPU number is not a
  slower card number, it is a different experiment;
- **verdict**: one line on stdout (``PERF GATE: PASS ...`` /
  ``PERF GATE: FAIL ...``) and exit 0/1.

Inputs are a bench JSON line, a driver ``BENCH_r*.json`` wrapper (its
``parsed`` field), or ``BASELINE_RESULTS.json``-style documents;
:func:`extract_metrics` normalizes all three.  ``METRIC_PATHS``,
``METRIC_LIMITS``, the thresholds, :func:`evaluate`,
:func:`scan_history` and :func:`main` are the JAX package's.

Where it differs: the platform of record is the card, ``"gpu"`` (what
``chip_smoke.py`` and every port block mark): a ``gpu`` reference
diffed by a ``cpu`` artifact is a platform fallback, and the history's
expected platform is ``gpu`` once any round measured on the card.  A
legacy line with no device marker and no error is still inferred as
``"tpu"``, since those lines were measured on a TPU.  So with the
repo's ``BENCH_r*.json`` history (every round a TPU or CPU line), a
``gpu`` artifact gates with no comparable reference (``evaluate``
never diffs across platforms) and no expected platform: it passes
unless it breaks an absolute limit, or an ``--expect-platform`` it was
not measured on.

    python -m ceph_tpu_torch.tools.perf_gate line.json --check
    python -m ceph_tpu_torch.tools.perf_gate line.json --baseline ref.json

Stdlib-only, standalone.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys

# metric id -> (artifact path, higher-is-better).  Paths resolve inside
# the normalized bench line; missing paths simply don't participate.
METRIC_PATHS = {
    "core.mib_s": (("value",), True),
    "serving.ops_s": (("serving", "batched", "ops_s"), True),
    "serving.p99_ms": (("serving", "batched", "p99_ms"), False),
    "recovery.mib_s": (("recovery", "batched", "mib_s"), True),
    "pipeline.mib_s": (("pipeline", "async", "mib_s"), True),
    # wire efficiency: bytes-on-wire per byte repaired / per
    # served op — lower is better; a rise past threshold means repair or
    # serving started moving more network bytes for the same work
    "recovery.wire_per_byte": (("recovery", "wire", "per_byte_repaired"),
                               False),
    "serving.wire_per_op": (("serving", "wire", "per_op"), False),
    # device efficiency: aggregate %-of-roofline-peak from the
    # per-executable ledger — a drop means the kernels moved AWAY from
    # what the hardware allows even if raw throughput held (e.g. more
    # dispatches doing the same work)
    "efficiency.pct_of_peak": (("efficiency", "pct_of_peak"), True),
    # resilience: goodput under the fixed fault schedule as a
    # fraction of the clean run (self-healing tax — a drop means retry/
    # dedup/fallback machinery got more expensive), and the host-codec
    # throughput floor while the device breaker is open
    "resilience.goodput_ratio": (("resilience", "goodput_ratio"), True),
    "resilience.fallback_mib_s": (("resilience", "breaker",
                                   "fallback_mib_s"), True),
    # latency SLO: client-class p99 from the critical-path
    # ledger (lower is better), and the remaining error budget under
    # the bench objective — a budget-burn regression (drop) fails the
    # gate even when throughput held
    "slo.client_p99_ms": (("slo", "client", "p99_ms"), False),
    "slo.budget_remaining": (("slo", "client", "budget_remaining"),
                             True),
    # chained streaming repair: throughput and the wire
    # decomposition of the chain arm, diffed against the reference like
    # every other block AND capped absolutely (METRIC_LIMITS below) so
    # the bandwidth-optimality claims can't silently erode
    "recovery.chain.mib_s": (("recovery", "chain", "mib_s"), True),
    "recovery.chain.wire_per_byte": (
        ("recovery", "chain", "wire_per_byte"), False),
    "recovery.chain.coordinator_ingress_per_byte": (
        ("recovery", "chain", "coordinator_ingress_per_byte"), False),
    "recovery.chain.newcomer_ingress_per_byte": (
        ("recovery", "chain", "newcomer_ingress_per_byte"), False),
    "recovery.chain.speedup_vs_centralized": (
        ("recovery", "chain", "speedup_vs_centralized"), True),
    # regenerating-code repair: total recovery wire per
    # stored byte repaired on a pm_regen pool, diffed like the rest AND
    # capped absolutely (METRIC_LIMITS) — MBR claims ~1.0 B/B, under
    # every decode-based repair's k-transfer floor; MSR claims d/alpha
    "recovery.regen.mbr.mib_s": (
        ("recovery", "regen", "mbr", "mib_s"), True),
    "recovery.regen.mbr.wire_per_byte": (
        ("recovery", "regen", "mbr", "wire_per_byte"), False),
    "recovery.regen.mbr.wire_reduction": (
        ("recovery", "regen", "mbr", "wire_reduction"), True),
    "recovery.regen.msr.wire_per_byte": (
        ("recovery", "regen", "msr", "wire_per_byte"), False),
    # async messenger: 10k logical closed-loop clients over
    # few connections — clean-capacity goodput and p99, plus goodput
    # while the overload arm sheds by class.  `clients` is held to an
    # absolute floor (METRIC_LIMITS): the concurrency claim itself.
    "serving.async.ops_s": (("serving", "async", "ops_s"), True),
    "serving.async.p99_ms": (("serving", "async", "p99_ms"), False),
    "serving.async.clients": (("serving", "async", "clients"), True),
    "serving.async.overload.ops_s": (
        ("serving", "async", "overload", "ops_s"), True),
    # zero-copy data path: the fused socket->HBM arms over
    # the legacy pickle path at bulk payload size.  copies_per_byte is
    # the claim itself — held to an absolute cap (METRIC_LIMITS), with
    # the legacy arm's ratio held to an absolute FLOOR so the contrast
    # the cap is measured against cannot quietly erode (a "legacy" arm
    # that stops copying is a broken bench, not a better baseline).
    "serving.zero_copy.copies_per_byte": (
        ("serving", "zero_copy", "copies_per_byte"), False),
    "serving.zero_copy.legacy_copies_per_byte": (
        ("serving", "zero_copy", "legacy_copies_per_byte"), True),
    "serving.zero_copy.ops_s": (
        ("serving", "zero_copy", "fused", "ops_s"), True),
    "serving.zero_copy.p99_ms": (
        ("serving", "zero_copy", "fused", "p99_ms"), False),
    "serving.zero_copy.goodput_ratio": (
        ("serving", "zero_copy", "goodput_ratio"), True),
    # static analysis: the ceph-lint trajectory. `new` is
    # held to an absolute zero (METRIC_LIMITS) — any non-baselined
    # finding fails the round; `baselined` is diffed against the
    # reference so suppressed debt can't quietly snowball.
    "lint.new": (("lint", "new"), False),
    "lint.baselined": (("lint", "baselined"), False),
    # observability fast path: the instrumentation tax over
    # the serving.async mux workload — instruments-on goodput diffed
    # like every throughput metric, and overhead_pct held to an
    # ABSOLUTE cap (METRIC_LIMITS): full instruments at default
    # sampling must cost single-digit percent, every artifact, no ref
    "observability.overhead_pct": (("observability", "overhead_pct"),
                                   False),
    "observability.ops_s": (
        ("observability", "instruments_on", "ops_s"), True),
    # cache tiering: a warm writeback tier under the
    # flash-crowd mux workload must ABSORB the crowd — hit rate held to
    # an absolute floor, warm-over-cold p99 and device-time ratios to
    # absolute caps (METRIC_LIMITS): a tier that is slower than the EC
    # base it fronts, or that pays EC encode for absorbed writes, is a
    # regression in the subsystem's whole reason to exist
    "tiering.hit_rate": (("tiering", "warm", "hit_rate"), True),
    "tiering.warm_p99_ms": (("tiering", "warm", "p99_ms"), False),
    "tiering.cold_p99_ms": (("tiering", "cold", "p99_ms"), False),
    "tiering.warm_over_cold_p99": (("tiering", "warm_over_cold_p99"),
                                   False),
    "tiering.warm_over_cold_device_us": (
        ("tiering", "warm_over_cold_device_us"), False),
    "tiering.warm_promotions": (("tiering", "warm", "promotions"),
                                False),
}

# absolute bounds checked on the NEW artifact alone — no reference
# needed, so a first-ever chain artifact is still held to the claims.
# ("max": value must stay at or below; "min": at or above.)  Total
# chain wire cannot beat the k-transfer information floor (~k per
# repaired byte at k=4 with one erasure); what IS gated hard is that
# the newcomer receives ~1x the bytes it re-hosts (<= 1.5, the chain
# repair's criterion), the coordinator stays out of the data path,
# total wire keeps beating the centralized arm's ~6x, and the chain arm is not
# slower than the centralized wave it replaces (0.95 absorbs timer
# jitter between the two back-to-back passes).
METRIC_LIMITS = {
    "recovery.chain.newcomer_ingress_per_byte": (1.5, "max"),
    # the regenerating-code criteria: MBR total wire at or under 1.5x
    # the stored bytes repaired (the ~1 B/B claim with control-leg
    # headroom), and any regenerating pool under the 4.0 ceiling
    "recovery.regen.mbr.wire_per_byte": (1.5, "max"),
    "recovery.regen.msr.wire_per_byte": (4.0, "max"),
    "recovery.chain.coordinator_ingress_per_byte": (0.5, "max"),
    "recovery.chain.wire_per_byte": (4.6, "max"),
    "recovery.chain.speedup_vs_centralized": (0.95, "min"),
    # the async messenger's acceptance floor: the async bench must
    # actually run >= 10k concurrent closed-loop sessions, every
    # artifact, no ref
    "serving.async.clients": (10000, "min"),
    # the zero-copy path's acceptance caps: the fused arm moves each
    # served payload byte at most ~1.3 times end to end (staging + client
    # materialize + compaction tail), while the legacy pickle arm's
    # >= 3 copies/byte keeps the contrast honest; the fused arm must
    # also not LOSE goodput to the copies it saved (1.0 floor with the
    # wall-clock jitter absorbed by the diff threshold below)
    "serving.zero_copy.copies_per_byte": (1.3, "max"),
    "serving.zero_copy.legacy_copies_per_byte": (3.0, "min"),
    "serving.zero_copy.goodput_ratio": (1.0, "min"),
    # ceph-lint must run clean against the committed baseline in every
    # artifact — a new finding is a bug (or a missing justification),
    # never acceptable drift
    "lint.new": (0, "max"),
    # the observability acceptance cap: full instruments at default
    # sampling cost <= 10% of kill-switch goodput on the mux workload
    # (to be ratcheted down as the fast path matures)
    "observability.overhead_pct": (10.0, "max"),
    # the tiering acceptance criteria: the warm pass over the identical
    # flash-crowd stream hits >= 0.8, is no slower than the cold EC
    # pass at p99, and spends STRICTLY less device time per op (the
    # write encodes writeback absorption elides; the ratio key is only
    # emitted when the cold arm's device time is measurable).  A warmed
    # tier also must not churn promotions: the warmup pass earned
    # residency, the warm pass should mostly find it.
    "tiering.hit_rate": (0.8, "min"),
    "tiering.warm_over_cold_p99": (1.0, "max"),
    "tiering.warm_over_cold_device_us": (0.99, "max"),
    "tiering.warm_promotions": (100, "max"),
}

# fraction of regression tolerated per metric before the gate fails;
# latency metrics (higher-is-worse) use the same fraction as an allowed
# increase.  Overridable per metric via --threshold NAME=0.15.
DEFAULT_THRESHOLD = 0.10

# per-metric defaults that differ from DEFAULT_THRESHOLD: the %-of-peak
# join divides modeled work by dispatch WALL seconds, which on a shared
# cpu host is the noisiest number the gate carries — gate it loosely so
# only a real efficiency cliff (not scheduler jitter) fails the round
METRIC_THRESHOLDS = {"efficiency.pct_of_peak": 0.30,
                     # both resilience numbers divide two wall-clock
                     # measurements on a possibly-shared host: gate only
                     # real cliffs, not scheduler jitter
                     "resilience.goodput_ratio": 0.30,
                     "resilience.fallback_mib_s": 0.30,
                     # per-op p99 on a shared host is tail-of-the-tail
                     # noisy; budget_remaining compounds that through a
                     # threshold — gate only real cliffs
                     "slo.client_p99_ms": 0.50,
                     "slo.budget_remaining": 0.30,
                     # a ratio of two wall-clock arms: gate cliffs only
                     # (the absolute floor in METRIC_LIMITS still holds)
                     "recovery.chain.speedup_vs_centralized": 0.30,
                     # wall-clock repair throughput and an arm ratio on
                     # a possibly-shared host: gate cliffs only (the
                     # wire caps above carry the real claims)
                     "recovery.regen.mbr.mib_s": 0.30,
                     "recovery.regen.mbr.wire_reduction": 0.30,
                     # socket wall-clock at 10k concurrency on a shared
                     # host: gate cliffs, not scheduler jitter
                     "serving.async.ops_s": 0.30,
                     "serving.async.p99_ms": 0.50,
                     "serving.async.overload.ops_s": 0.30,
                     # two closed-loop socket arms on a shared host:
                     # the wall-clock numbers gate cliffs only — the
                     # copy ratios are deterministic byte counts and
                     # keep the default tight diff
                     "serving.zero_copy.ops_s": 0.30,
                     "serving.zero_copy.p99_ms": 0.50,
                     "serving.zero_copy.goodput_ratio": 0.30,
                     # a small integer count: one justified baseline
                     # entry is ~6% at today's size, so diff loosely and
                     # let review argue each justification — the gate
                     # only stops a silent suppression avalanche
                     "lint.baselined": 0.50,
                     # a ratio of two back-to-back wall-clock socket
                     # arms: the absolute 10% cap in METRIC_LIMITS is
                     # the real gate; the diff only stops a cliff
                     "observability.overhead_pct": 5.0,
                     "observability.ops_s": 0.30,
                     # closed-loop p99 at mux-client scale on a shared
                     # host is tail-of-the-tail noisy; the absolute
                     # caps above carry the real tiering claims — the
                     # diffs only stop cliffs
                     "tiering.hit_rate": 0.15,
                     "tiering.warm_p99_ms": 0.50,
                     "tiering.cold_p99_ms": 0.50,
                     "tiering.warm_over_cold_p99": 0.30,
                     "tiering.warm_over_cold_device_us": 0.50,
                     "tiering.warm_promotions": 1.0}

_BLOCK_DEVICE = {
    "core.mib_s": ("device",),
    "serving.ops_s": ("serving", "device"),
    "serving.p99_ms": ("serving", "device"),
    "recovery.mib_s": ("recovery", "device"),
    "pipeline.mib_s": ("pipeline", "device"),
    "recovery.wire_per_byte": ("recovery", "device"),
    "serving.wire_per_op": ("serving", "device"),
    "efficiency.pct_of_peak": ("efficiency", "device"),
    "resilience.goodput_ratio": ("resilience", "device"),
    "resilience.fallback_mib_s": ("resilience", "device"),
    "slo.client_p99_ms": ("slo", "device"),
    "slo.budget_remaining": ("slo", "device"),
    "recovery.chain.mib_s": ("recovery", "device"),
    "recovery.chain.wire_per_byte": ("recovery", "device"),
    "recovery.chain.coordinator_ingress_per_byte": ("recovery", "device"),
    "recovery.chain.newcomer_ingress_per_byte": ("recovery", "device"),
    "recovery.chain.speedup_vs_centralized": ("recovery", "device"),
    "recovery.regen.mbr.mib_s": ("recovery", "device"),
    "recovery.regen.mbr.wire_per_byte": ("recovery", "device"),
    "recovery.regen.mbr.wire_reduction": ("recovery", "device"),
    "recovery.regen.msr.wire_per_byte": ("recovery", "device"),
    "serving.async.ops_s": ("serving", "device"),
    "serving.async.p99_ms": ("serving", "device"),
    "serving.async.clients": ("serving", "device"),
    "serving.async.overload.ops_s": ("serving", "device"),
    "serving.zero_copy.copies_per_byte": ("serving", "device"),
    "serving.zero_copy.legacy_copies_per_byte": ("serving", "device"),
    "serving.zero_copy.ops_s": ("serving", "device"),
    "serving.zero_copy.p99_ms": ("serving", "device"),
    "serving.zero_copy.goodput_ratio": ("serving", "device"),
    # lint is host-side AST work; the block carries no device marker, so
    # these fall back to the artifact's overall platform
    "lint.new": ("lint", "device"),
    "lint.baselined": ("lint", "device"),
    "observability.overhead_pct": ("observability", "device"),
    "observability.ops_s": ("observability", "device"),
    "tiering.hit_rate": ("tiering", "device"),
    "tiering.warm_p99_ms": ("tiering", "device"),
    "tiering.cold_p99_ms": ("tiering", "device"),
    "tiering.warm_over_cold_p99": ("tiering", "device"),
    "tiering.warm_over_cold_device_us": ("tiering", "device"),
    "tiering.warm_promotions": ("tiering", "device"),
}


def _dig(doc: dict, path: tuple):
    cur = doc
    for key in path:
        if not isinstance(cur, dict) or key not in cur:
            return None
        cur = cur[key]
    return cur


def normalize(doc: dict) -> dict:
    """Accept a bare bench line, or a driver BENCH_r wrapper (use its
    ``parsed``), and return the bench-line dict."""
    if not isinstance(doc, dict):
        raise ValueError("artifact is not a JSON object")
    if "parsed" in doc and isinstance(doc["parsed"], dict):
        return doc["parsed"]
    return doc


def extract_metrics(doc: dict) -> dict[str, dict]:
    """{metric id: {value, device, higher_better}} for every comparable
    number present in the artifact."""
    line = normalize(doc)
    # legacy-shape lines (pre-r04) carry no device markers at all:
    # artifact_platform's inference fills in, so a TPU record still
    # participates in per-metric comparison instead of being skipped as
    # device-unknown
    default_device = artifact_platform(doc)
    out: dict[str, dict] = {}
    for mid, (path, higher) in METRIC_PATHS.items():
        v = _dig(line, path)
        if not isinstance(v, (int, float)):
            continue
        device = _dig(line, _BLOCK_DEVICE[mid]) or default_device
        out[mid] = {"value": float(v), "device": device,
                    "higher_better": higher}
    return out


def artifact_platform(doc: dict) -> str | None:
    """The platform the artifact's core number was measured on."""
    line = normalize(doc)
    dev = line.get("device")
    if dev is None:
        dev = _dig(line, ("device_info", "platform"))
    if dev is None and "error" not in line and "value" in line:
        # pre-r04 artifact shape: only TPU successes omitted both the
        # device marker and the error field (BENCH_r03's record line)
        dev = "tpu"
    return dev


def evaluate(new: dict, reference: dict | None,
             thresholds: dict[str, float] | None = None,
             expect_platform: str | None = None) -> dict:
    """Gate one artifact.  Returns ``{ok, verdict, failures, compared}``;
    ``verdict`` is the one-line summary.  ``reference=None`` checks only
    the platform expectation (first run: nothing to diff against)."""
    thresholds = thresholds or {}
    failures: list[str] = []
    compared: list[dict] = []

    new_platform = artifact_platform(new)
    if expect_platform and new_platform != expect_platform:
        # the r05 failure mode: a degraded-platform artifact must be an
        # ERROR, not a silently lower number
        failures.append(
            f"platform fallback: expected {expect_platform}, measured "
            f"{new_platform or 'none'}")

    new_metrics = extract_metrics(new)
    ref_metrics = extract_metrics(reference) if reference else {}
    for mid, ref in sorted(ref_metrics.items()):
        cur = new_metrics.get(mid)
        if cur is None:
            failures.append(f"{mid}: present in reference, missing in "
                            f"new artifact")
            continue
        if ref["device"] != cur["device"]:
            if ref["device"] == "gpu" and cur["device"] in ("cpu", None):
                failures.append(
                    f"{mid}: platform fallback (reference on gpu, new on "
                    f"{cur['device'] or 'none'})")
            # numbers of two platforms are different experiments: never
            # diffed
            continue
        thr = thresholds.get(
            mid, thresholds.get(
                "*", METRIC_THRESHOLDS.get(mid, DEFAULT_THRESHOLD)))
        if ref["value"] <= 0:
            continue
        ratio = cur["value"] / ref["value"]
        comp = {"metric": mid, "new": cur["value"], "ref": ref["value"],
                "ratio": round(ratio, 3), "device": cur["device"],
                "threshold": thr}
        compared.append(comp)
        if cur["higher_better"] and ratio < 1.0 - thr:
            failures.append(
                f"{mid}: {cur['value']:.1f} vs {ref['value']:.1f} "
                f"({100 * (1 - ratio):.0f}% regression > {100 * thr:.0f}% "
                f"threshold, {cur['device']})")
        elif not cur["higher_better"] and ratio > 1.0 + thr:
            failures.append(
                f"{mid}: {cur['value']:.2f} vs {ref['value']:.2f} "
                f"({100 * (ratio - 1):.0f}% increase > {100 * thr:.0f}% "
                f"threshold, {cur['device']})")

    for mid, (bound, kind) in sorted(METRIC_LIMITS.items()):
        cur = new_metrics.get(mid)
        if cur is None:
            continue
        v = cur["value"]
        if kind == "max" and v > bound:
            failures.append(
                f"{mid}: {v:.2f} exceeds absolute cap {bound}")
        elif kind == "min" and v < bound:
            failures.append(
                f"{mid}: {v:.2f} below absolute floor {bound}")

    ok = not failures
    if ok:
        detail = (f"{len(compared)} metrics within thresholds"
                  if compared else "no comparable reference metrics")
        verdict = (f"PERF GATE: PASS ({detail}; platform="
                   f"{new_platform or 'none'})")
    else:
        verdict = f"PERF GATE: FAIL ({'; '.join(failures)})"
    return {"ok": ok, "verdict": verdict, "failures": failures,
            "compared": compared}


def scan_history(repo_dir: str
                 ) -> tuple[dict | None, str | None, str | None]:
    """ONE pass over the BENCH_r*.json history (bench.py runs this per
    emitted artifact): returns ``(reference_doc, reference_path,
    expected_platform)``.

    The reference is the newest HEALTHY round with a parsed bench line.
    Errored/fallback artifacts (the parsed line carries an ``error``
    field — r04/r05's shape) are skipped while any clean round exists:
    the degraded artifact the gate exists to catch must never become
    the baseline it measures against.  When every round errored, the
    newest one still serves (cpu-only histories compare cpu-vs-cpu
    legitimately).

    The expected platform is 'gpu' when ANY round measured on the card:
    once the record is a card number, a cpu artifact is a fallback, not
    a baseline.  The repo's own history holds TPU and CPU rounds only,
    so there it is None."""
    best: tuple[int, dict, str] | None = None
    best_clean: tuple[int, dict, str] | None = None
    expect: str | None = None
    for path in glob.glob(os.path.join(repo_dir, "BENCH_r*.json")):
        m = re.search(r"BENCH_r(\d+)\.json$", path)
        if not m:
            continue
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        parsed = doc.get("parsed")
        if not isinstance(parsed, dict):
            continue
        if expect is None and artifact_platform(doc) == "gpu":
            expect = "gpu"
        n = int(m.group(1))
        if best is None or n > best[0]:
            best = (n, doc, path)
        if "error" not in parsed and \
                (best_clean is None or n > best_clean[0]):
            best_clean = (n, doc, path)
    best = best_clean or best
    if best is None:
        return None, None, expect
    return best[1], best[2], expect


def find_reference(repo_dir: str) -> tuple[dict | None, str | None]:
    """The newest healthy BENCH_r*.json (see :func:`scan_history`)."""
    doc, path, _expect = scan_history(repo_dir)
    return doc, path


def expected_platform(repo_dir: str) -> str | None:
    """'gpu' when any prior round measured on the card (see
    :func:`scan_history`)."""
    return scan_history(repo_dir)[2]


def gate_for_bench(line: dict, repo_dir: str) -> dict:
    """The in-process entry a bench uses: reference + expected platform
    discovered from the repo's BENCH history, verdict attached to the
    artifact.  Never raises (the artifact must always emit)."""
    reference, ref_path, expect = scan_history(repo_dir)
    res = evaluate(line, reference, expect_platform=expect)
    res["reference"] = os.path.basename(ref_path) if ref_path else None
    res["expected_platform"] = expect
    return res


def _parse_thresholds(entries: list[str]) -> dict[str, float]:
    out: dict[str, float] = {}
    for e in entries:
        name, _, val = e.partition("=")
        if not val:
            out["*"] = float(name)
        else:
            out[name] = float(val)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="diff a bench artifact against the recorded "
                    "reference; exit nonzero on regression or platform "
                    "fallback")
    ap.add_argument("artifact", help="fresh bench JSON (bench.py line or "
                                     "BENCH_r wrapper)")
    ap.add_argument("--baseline",
                    help="explicit reference artifact (default: newest "
                         "BENCH_r*.json next to --repo-dir)")
    ap.add_argument("--repo-dir", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))),
        help="where BENCH_r*.json history lives")
    ap.add_argument("--expect-platform",
                    help="hard-fail unless the artifact measured on this "
                         "platform (default: gpu when any prior round "
                         "did)")
    ap.add_argument("--threshold", action="append", default=[],
                    metavar="[METRIC=]FRACTION",
                    help="per-metric regression tolerance (bare number "
                         "sets the default for all metrics)")
    ap.add_argument("--check", action="store_true",
                    help="CI mode: print ONLY the one-line verdict")
    ap.add_argument("--json", action="store_true",
                    help="emit the full evaluation as JSON")
    args = ap.parse_args(argv)

    with open(args.artifact) as f:
        new = json.load(f)
    reference, ref_name, history_expect = scan_history(args.repo_dir)
    if args.baseline:
        with open(args.baseline) as f:
            reference = json.load(f)
        ref_name = args.baseline
    expect = args.expect_platform
    if expect is None:
        expect = history_expect

    res = evaluate(new, reference, _parse_thresholds(args.threshold),
                   expect_platform=expect)
    if args.json:
        res["reference"] = ref_name
        res["expected_platform"] = expect
        print(json.dumps(res))
    elif args.check:
        print(res["verdict"])
    else:
        for c in res["compared"]:
            print(f"  {c['metric']:<18} {c['new']:>12.2f} vs "
                  f"{c['ref']:>12.2f}  x{c['ratio']:.3f}  "
                  f"[{c['device']}]")
        print(res["verdict"])
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
