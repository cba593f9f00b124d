"""FaultInjector: deterministic, seedable fault decisions + event log.

The port's copy of ``ceph_tpu.failure.injector``.

The runtime half of the :mod:`~ceph_tpu_torch.failure.config` schema.  Every
plane (transport/store/device/bus) consults ONE injector, and every injected event
is:

- appended to a bounded in-memory event log (``events``), whose
  order-sensitive digest (``event_digest``) is the reproducibility
  receipt — two campaigns with the same seed and the same workload must
  produce the same digest;
- counted in a ``faults.<name>`` perf collection (per-plane counters),
  so injected failure shows up next to every other perf surface;
- stamped into the clusterlog (DBG channel ``faults``) when one is
  wired, so ``ceph -w`` shows the chaos interleaved with its effects.

Determinism: one ``random.Random`` stream per (plane, kind), seeded from
``f"{seed}:{plane}:{kind}"`` (str seeding is stable across processes).
Decision streams are independent per kind, so adding a new fault kind to
a campaign never perturbs the decisions of existing kinds — the property
that keeps soak repros stable as the fault surface grows.
"""
from __future__ import annotations

import hashlib
import random
import threading

from .config import FaultPlan

MAX_EVENTS = 100_000      # a soak that injects more has lost the plot

PLANES = ("transport", "store", "device", "bus")


class InjectedFault(RuntimeError):
    """An injected failure (device dispatch/completion, store EIO...).
    Distinct type so self-healing tests can tell injected failures from
    real bugs in the machinery under test."""


class InjectedOOM(InjectedFault):
    """Simulated device OOM (a RESOURCE_EXHAUSTED at dispatch)."""


class FaultInjector:
    """Seeded decision streams over a :class:`FaultPlan` + the event log."""

    def __init__(self, plan: FaultPlan | None = None, clusterlog=None,
                 cct=None, name: str = "faults"):
        self.plan = plan if plan is not None else FaultPlan()
        self.clusterlog = clusterlog
        self.name = name
        self._lock = threading.Lock()
        self._rngs: dict[tuple[str, str], random.Random] = {}
        self.events: list[dict] = []
        self._seq = 0
        self.perf = None
        if cct is not None:
            from ..common.perf_counters import PerfCountersBuilder
            b = PerfCountersBuilder(f"faults.{name}")
            b.add_u64_counter("injected", "fault events injected across "
                                          "all planes")
            for plane in PLANES:
                b.add_u64_counter(f"{plane}_events",
                                  f"fault events injected on the {plane} "
                                  f"plane")
            self.perf = b.create_perf_counters()
            cct.perf.add(self.perf)
            self._cct = cct

    def close(self) -> None:
        """Unhook the perf collection (discarded injectors must not
        leave frozen counters behind)."""
        if self.perf is not None:
            self._cct.perf.remove(self.perf.name)
            self.perf = None

    # -- decisions ---------------------------------------------------------

    def _rng(self, plane: str, kind: str) -> random.Random:
        key = (plane, kind)
        rng = self._rngs.get(key)
        if rng is None:
            rng = self._rngs[key] = random.Random(
                f"{self.plan.seed}:{plane}:{kind}")
        return rng

    def roll(self, plane: str, kind: str, prob: float,
             target=None, **detail) -> bool:
        """One seeded decision: True (and the event is recorded) with
        probability ``prob``.  A zero/absent probability consumes NOTHING
        from the stream, so disabled kinds never shift enabled ones."""
        if prob <= 0.0:
            return False
        with self._lock:
            hit = self._rng(plane, kind).random() < prob
        if hit:
            self.record(plane, kind, target, **detail)
        return hit

    # -- the event log -----------------------------------------------------

    def record(self, plane: str, kind: str, target=None, **detail) -> dict:
        """Stamp one injected event (log + perf + clusterlog).  Called by
        :meth:`roll` on a hit, and directly by planes that decide with
        their own RNG (the bus's legacy FaultConfig stream)."""
        with self._lock:
            self._seq += 1
            event = {"seq": self._seq, "plane": plane, "kind": kind,
                     "target": "" if target is None else str(target)}
            if detail:
                event["detail"] = detail
            if len(self.events) < MAX_EVENTS:
                self.events.append(event)
        if self.perf is not None:
            self.perf.inc("injected")
            if plane in PLANES:
                self.perf.inc(f"{plane}_events")
        if self.clusterlog is not None:
            self.clusterlog.debug(
                f"fault injected: {plane}/{kind}"
                + (f" @ {event['target']}" if event["target"] else ""),
                channel="faults")
        return event

    # -- reproducibility ----------------------------------------------------

    def event_digest(self) -> str:
        """Order-sensitive digest over (plane, kind, target) — the
        determinism receipt.  Wall-clock detail is deliberately excluded:
        two same-seed runs differ in timing, never in decisions."""
        h = hashlib.sha256()
        with self._lock:
            for e in self.events:
                h.update(f"{e['plane']}/{e['kind']}/{e['target']}\n"
                         .encode())
        return h.hexdigest()

    def summary(self) -> dict:
        """{plane: {kind: count}} + total, for campaign reports."""
        out: dict = {}
        with self._lock:
            for e in self.events:
                out.setdefault(e["plane"], {}).setdefault(e["kind"], 0)
                out[e["plane"]][e["kind"]] += 1
            total = len(self.events)
        return {"total": total, "planes": out}
