"""instrument-under-lock: observability updates inside hot critical
sections.

The race-surface rule: the messenger's races were instrument updates
(perf counters, tracer events, wire accounting) performed on reactor /
messenger-worker threads while a lock was held — the exact pattern the
sharded counter cells and batched tracer flushes exist to make
unnecessary.  The rule flags any perf-counter / tracer / wire-accounting
call made while holding a lock inside ``msg/`` code that runs on a
reactor callback or a pinned worker thread: an instrument needs no
caller lock anymore, so holding one around it only re-creates the
contention/race class.

Heuristics, deliberately narrow to keep the signal clean:

- unambiguous instrument method names (``tinc``/``hinc``/``account_*``/
  ``observe_rpc``/``note_queue_depth``/``trace_span``/``trace_instant``)
  flag on the name alone;
- generic names (``inc``/``dec``/``set``/``complete``/``instant``/
  ``flush``) flag only when the receiver chain names an instrument
  object (``...perf.inc``, ``self.acct...``, ``tracer...``), so plain
  ``dict.set``-style calls never trip it.

Justified survivors live in ``analysis/baseline.json`` like every
other rule's.
"""
from __future__ import annotations

import ast

from .engine import Finding, ProjectIndex, rule
from .lockmodel import lock_events
from .rules_threads import context_model

_SCOPE = ("ceph_tpu_torch/msg",)

# method names that are instruments wherever they appear
_ALWAYS = {"tinc", "hinc", "account_tx", "account_rx", "account_msg",
           "observe_rpc", "note_queue_depth", "trace_span",
           "trace_instant", "mark_event"}

# generic method names: instruments only on an instrument-ish receiver
_GENERIC = {"inc", "dec", "set", "complete", "instant", "flush", "time"}

# receiver-chain fragments that identify an instrument object
_RECEIVER_HINTS = ("perf", "acct", "tracer", "accounting", "counters")


def _receiver_chain(call: ast.Call) -> str:
    """Dotted receiver text of an attribute call (``self.perf.inc`` ->
    ``self.perf``), empty for bare-name calls."""
    fn = call.func
    if not isinstance(fn, ast.Attribute):
        return ""
    parts: list[str] = []
    node = fn.value
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    elif isinstance(node, ast.Call) and \
            isinstance(node.func, ast.Name):
        # default_tracer().complete(...) — the factory name is the hint
        parts.append(node.func.id)
    return ".".join(reversed(parts))


def _instrument_name(call: ast.Call) -> str | None:
    fn = call.func
    if isinstance(fn, ast.Name):
        return fn.id if fn.id in _ALWAYS else None
    if not isinstance(fn, ast.Attribute):
        return None
    name = fn.attr
    if name in _ALWAYS:
        return name
    if name in _GENERIC:
        recv = _receiver_chain(call).lower()
        if any(h in recv for h in _RECEIVER_HINTS):
            return name
    return None


@rule("instrument-under-lock", severity="warning", scope=_SCOPE,
      description="a perf-counter / tracer / wire-accounting update "
                  "runs under a held lock on a reactor or msg worker "
                  "path (instruments are lock-free by design — holding "
                  "a lock around one re-creates the contention/race "
                  "class)")
def check_instrument_under_lock(index: ProjectIndex) -> list[Finding]:
    model = context_model(index)
    out: list[Finding] = []
    for mod in index.iter_modules(_SCOPE):
        for fi in mod.functions.values():
            ctxs = model.contexts.get(fi.ref, set())
            if "reactor" not in ctxs and \
                    not any(c.startswith("thread:") for c in ctxs):
                continue
            for e in lock_events(index, fi):
                if e.kind != "call" or not e.held:
                    continue
                name = _instrument_name(e.node)
                if name is None:
                    continue
                held = ",".join(str(h) for h in sorted(e.held))
                recv = _receiver_chain(e.node)
                target = f"{recv}.{name}" if recv else name
                out.append(Finding(
                    "instrument-under-lock", fi.rel, e.node.lineno,
                    "warning",
                    f"instrument update {target}() in {fi.qualname} "
                    f"while holding {held}"))
    return out
