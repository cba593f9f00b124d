"""Deterministic schedule exploration: the race detector for this design.

The reference hunts data races with TSAN builds, lockdep lock-order
tracking, and valgrind suites (reference: CMakeLists.txt:585-607,
src/common/lockdep.h, qa/suites/rados/verify/validater/) — tools for
shared-memory threads.  This framework is deterministic message-passing:
its races are cross-sender DELIVERY ORDERS, so the equivalent tool
controls the nondeterminism directly.  A ``ScheduledBus`` turns every
"which message next?" decision into an explicit choice point, and the
explorer drives a scenario through many distinct schedules — randomly
sampled or exhaustively (bounded DFS over the choice tree) — asserting
the scenario's invariants after each.  A schedule that breaks an
invariant is returned as a replayable choice list (the trace IS the
reproducer, which TSAN can never give you).

Scenario contract:
    def scenario(bus: ScheduledBus) -> None:
        ... build state over the bus, call bus.run_to_quiescence(),
        assert invariants (raise AssertionError on violation) ...
Each schedule runs a FRESH scenario instance; determinism of everything
except delivery order is what makes replay exact.

The port's copy of ``ceph_tpu.utils.schedule_explorer``, over the port's
``backend.messages.MessageBus`` and ``backend.wire``.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

from ..backend.messages import MessageBus, _WireEnvelope


class _Controller:
    """Replays a choice prefix, then takes branch 0; records the trace
    and each point's branching factor for DFS frontier expansion."""

    def __init__(self, prefix: list[int]):
        self.prefix = deque(prefix)
        self.trace: list[int] = []
        self.widths: list[int] = []

    def choose(self, n: int) -> int:
        i = self.prefix.popleft() if self.prefix else 0
        if i >= n:
            i = n - 1
        self.trace.append(i)
        self.widths.append(n)
        return i


class _RandomController:
    def __init__(self, rng):
        self.rng = rng
        self.trace: list[int] = []
        self.widths: list[int] = []

    def choose(self, n: int) -> int:
        i = self.rng.randrange(n)
        self.trace.append(i)
        self.widths.append(n)
        return i


class ScheduledBus(MessageBus):
    """MessageBus whose delivery order is an explicit choice sequence.

    A choice point offers every (destination, sender) pair with a
    pending head message — per-sender FIFO stays intact (the messenger's
    per-connection ordering guarantee) while cross-sender and
    cross-destination order is fully controlled."""

    def __init__(self, controller):
        super().__init__()
        self.controller = controller

    def _options(self):
        opts = []
        for shard in sorted(self.queues):
            if shard in self.down:
                continue
            q = self.queues[shard]
            seen = set()
            for m in q:
                s = getattr(m, "from_shard", None)
                if s not in seen:
                    seen.add(s)
                    opts.append((shard, s))
        return opts

    def _deliver_from(self, shard: int, sender) -> None:
        q = self.queues[shard]
        for i, m in enumerate(q):
            if getattr(m, "from_shard", None) == sender:
                del q[i]
                if isinstance(m, _WireEnvelope):
                    from ..backend.wire import FrameParser, message_decode
                    [(tag, segs)] = FrameParser(
                        self.wire_secret).feed(m.frame)
                    m = message_decode(tag, segs)
                self.handlers[shard].handle_message(m)
                self.delivered += 1
                return
        raise AssertionError("option vanished")

    def run_to_quiescence(self, max_steps: int = 100000) -> int:
        n = 0
        while n < max_steps:
            opts = self._options()
            if not opts:
                return n
            pick = self.controller.choose(len(opts))
            shard, sender = opts[pick]
            self._deliver_from(shard, sender)
            n += 1
        raise RuntimeError("schedule did not quiesce")

    # deliver_all must also go through choice points: scenario code (and
    # framework code it calls) pumps the bus with deliver_all
    def deliver_all(self, max_rounds: int = 10000) -> int:
        return self.run_to_quiescence()


@dataclass
class ExplorationResult:
    schedules_run: int
    choice_points: int
    failure_trace: list[int] | None = None
    failure: str | None = None
    traces_seen: set = field(default_factory=set)

    @property
    def ok(self) -> bool:
        return self.failure_trace is None


def explore_random(scenario, schedules: int = 50,
                   seed: int = 0) -> ExplorationResult:
    """Sample ``schedules`` random delivery orders; stop at the first
    invariant violation (its trace replays it exactly)."""
    import random
    res = ExplorationResult(0, 0)
    for s in range(schedules):
        ctl = _RandomController(random.Random(seed + s))
        bus = ScheduledBus(ctl)
        try:
            scenario(bus)
        except AssertionError as e:
            res.failure_trace = list(ctl.trace)
            res.failure = str(e)
            return res
        finally:
            res.schedules_run += 1
            res.choice_points += len(ctl.trace)
            res.traces_seen.add(tuple(ctl.trace))
    return res


def explore_dfs(scenario, max_runs: int = 200) -> ExplorationResult:
    """Bounded-exhaustive: depth-first over the choice tree (stateless
    model checking — each run replays a prefix then defaults to 0)."""
    res = ExplorationResult(0, 0)
    stack: list[list[int]] = [[]]
    while stack and res.schedules_run < max_runs:
        prefix = stack.pop()
        ctl = _Controller(prefix)
        bus = ScheduledBus(ctl)
        try:
            scenario(bus)
        except AssertionError as e:
            res.failure_trace = list(ctl.trace)
            res.failure = str(e)
            return res
        finally:
            res.schedules_run += 1
            res.choice_points += len(ctl.trace)
            res.traces_seen.add(tuple(ctl.trace))
        # expand: for the deepest new choice points, queue sibling branches
        base = len(prefix)
        for pos in range(len(ctl.trace) - 1, base - 1, -1):
            for alt in range(ctl.trace[pos] + 1, ctl.widths[pos]):
                stack.append(ctl.trace[:pos] + [alt])
    return res


def replay(scenario, trace: list[int]) -> None:
    """Re-run a failing schedule exactly (raises its AssertionError)."""
    scenario(ScheduledBus(_Controller(list(trace))))
