"""Shared lock/acquisition model: who holds what, where.

One lexical walk per function produces the event stream both deep
analyses consume:

- ``acquire`` — a ``with self._lock:`` / ``with _module_lock:`` entry,
  with the locks already held at that point (the lock-ORDER edge);
- ``call``    — any call site, with the locks held around it;
- ``mutate``  — a store to ``self.attr`` (plain, augmented, or through
  a subscript on the attribute), with the locks held around it.

Lock identity is the DEFINING class + attribute name (instances are
not distinguished — a may-analysis over the static acquisition graph,
the ``lockdep.cc`` model), or module path + name for module-level
locks.  Nested function/class definitions are their own functions in
the index; the walker does not leak the enclosing ``with`` into them
(a closure runs later, on whoever calls it).

Known holes, accepted (the baseline covers what leaks through): bare
``.acquire()``/``.release()`` pairs are not tracked (the tree uses
``with`` everywhere), and ``Condition.wait`` dropping the lock while
blocked is not modelled (may-hold stays an over-approximation).
"""
from __future__ import annotations

import ast
from dataclasses import dataclass

from .engine import FunctionInfo, ProjectIndex


@dataclass(frozen=True)
class LockId:
    owner: str                      # defining class name, or module rel
    attr: str
    kind: str                       # Lock / RLock / Condition / ...

    def __str__(self) -> str:
        return f"{self.owner}.{self.attr}"

    def __lt__(self, other: "LockId") -> bool:
        return (self.owner, self.attr) < (other.owner, other.attr)


@dataclass(frozen=True)
class LockEvent:
    kind: str                       # "acquire" | "call" | "mutate"
    node: ast.AST
    held: tuple[LockId, ...]        # locks held AROUND this event
    lock: LockId | None = None      # for acquire
    attr: str | None = None         # for mutate: the self.<attr> stored


def resolve_lock_expr(index: ProjectIndex, fi: FunctionInfo,
                      expr: ast.expr) -> LockId | None:
    """``self._lock`` / module-level ``_lock`` → LockId, else None."""
    mod = index.modules[fi.rel]
    if isinstance(expr, ast.Attribute) and \
            isinstance(expr.value, ast.Name) and expr.value.id == "self":
        ci = index.class_of(fi)
        if ci is None:
            return None
        hit = index.lock_attr_owner(ci, expr.attr)
        if hit is None:
            return None
        owner, ctor = hit
        return LockId(owner, expr.attr, ctor)
    if isinstance(expr, ast.Name) and expr.id in mod.module_locks:
        return LockId(fi.rel, expr.id, mod.module_locks[expr.id])
    return None


class _Walker:
    def __init__(self, index: ProjectIndex, fi: FunctionInfo):
        self.index = index
        self.fi = fi
        self.events: list[LockEvent] = []
        self._held: list[LockId] = []

    def walk(self) -> list[LockEvent]:
        for stmt in self.fi.node.body:
            self._visit(stmt)
        return self.events

    def _visit(self, node: ast.AST) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            return                   # its own function in the index
        if isinstance(node, (ast.With, ast.AsyncWith)):
            acquired: list[LockId] = []
            for item in node.items:
                self._visit(item.context_expr)
                lid = resolve_lock_expr(self.index, self.fi,
                                        item.context_expr)
                if lid is not None:
                    self.events.append(LockEvent(
                        "acquire", item.context_expr,
                        tuple(self._held), lock=lid))
                    self._held.append(lid)
                    acquired.append(lid)
            for stmt in node.body:
                self._visit(stmt)
            for _ in acquired:
                self._held.pop()
            return
        if isinstance(node, ast.Call):
            self.events.append(LockEvent("call", node,
                                         tuple(self._held)))
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                attr = self._self_attr_target(t)
                if attr is not None:
                    self.events.append(LockEvent(
                        "mutate", node, tuple(self._held), attr=attr))
        for child in ast.iter_child_nodes(node):
            self._visit(child)

    @staticmethod
    def _self_attr_target(t: ast.expr) -> str | None:
        # self.attr = ... | self.attr[k] = ... | self.attr += ...
        if isinstance(t, (ast.Subscript,)):
            t = t.value
        if isinstance(t, ast.Attribute) and \
                isinstance(t.value, ast.Name) and t.value.id == "self":
            return t.attr
        return None


def lock_events(index: ProjectIndex,
                fi: FunctionInfo) -> list[LockEvent]:
    return _Walker(index, fi).walk()


def may_acquire_closure(index: ProjectIndex,
                        events: dict[str, list[LockEvent]],
                        functions: dict[str, FunctionInfo],
                        max_rounds: int = 6
                        ) -> dict[str, set[LockId]]:
    """Transitive may-acquire per function ref, via resolved calls."""
    acq: dict[str, set[LockId]] = {
        ref: {e.lock for e in evs if e.kind == "acquire"}
        for ref, evs in events.items()}
    call_targets: dict[str, set[str]] = {}
    for ref, evs in events.items():
        targets: set[str] = set()
        for e in evs:
            if e.kind != "call":
                continue
            for callee in index.resolve_call(functions[ref], e.node):
                if callee.ref in events:
                    targets.add(callee.ref)
        call_targets[ref] = targets
    for _ in range(max_rounds):
        changed = False
        for ref, targets in call_targets.items():
            before = len(acq[ref])
            for t in targets:
                acq[ref] |= acq[t]
            changed |= len(acq[ref]) != before
        if not changed:
            break
    return acq
