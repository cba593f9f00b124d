"""FaultInjector: deterministic, seedable fault decisions + event log.

From ``ceph_tpu.failure.injector``, for the device plane only (the
planes of the port's :mod:`~ceph_tpu_torch.failure.config`); the port keeps
its own copy, so it needs nothing of the JAX package.

The runtime half of the :mod:`~ceph_tpu_torch.failure.config` schema.  The
codec pipeline consults ONE injector, and every injected event is:

- appended to a bounded in-memory event log (``events``): two
  campaigns with the same seed and the same workload log the same
  events;
- counted in a ``faults.<name>`` perf collection (per-plane counters),
  so injected failure shows up next to every other perf surface.

Determinism: one ``random.Random`` stream per (plane, kind), seeded from
``f"{seed}:{plane}:{kind}"`` (str seeding is stable across processes).
Decision streams are independent per kind, so adding a new fault kind to
a campaign never perturbs the decisions of existing kinds — the property
that keeps soak repros stable as the fault surface grows.
"""
from __future__ import annotations

import random
import threading

from .config import FaultPlan

MAX_EVENTS = 100_000      # a soak that injects more has lost the plot

PLANES = ("device",)


class InjectedFault(RuntimeError):
    """An injected failure (device dispatch or completion).
    Distinct type so self-healing tests can tell injected failures from
    real bugs in the machinery under test."""


class InjectedOOM(InjectedFault):
    """Simulated device OOM (the XLA RESOURCE_EXHAUSTED shape)."""


class FaultInjector:
    """Seeded decision streams over a :class:`FaultPlan` + the event log."""

    def __init__(self, plan: FaultPlan | None = None, cct=None,
                 name: str = "faults"):
        self.plan = plan if plan is not None else FaultPlan()
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
        """Stamp one injected event (log + perf).  Called by
        :meth:`roll` on a hit."""
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
        return event
