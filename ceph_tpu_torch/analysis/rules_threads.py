"""Thread-context classification + cross-thread unlocked mutations.

Every function is tagged with the set of thread contexts it can run
on, derived from the pinned spawn sites rather than guessed:

- ``thread:<Class.method>`` — a ``threading.Thread(target=self.m)``
  spawn anywhere in the tree roots ``m`` in its own context (the op /
  finisher / sender / engine worker threads);
- ``reactor`` — readiness callbacks (``on_readable`` / ``on_writable``
  / ``on_io_error`` on classes in ``msg/``) plus anything handed to
  ``call_soon`` / ``call_later`` (including lambda trampolines);
- ``caller`` — public API surface.  Assigned in a second phase, only
  to public methods no thread root already reaches, so a handler that
  merely *could* be called externally but never is does not pollute
  the context sets.

Contexts propagate through the resolved call graph (self-methods,
annotated parameters, attribute types, constructor callback bindings,
unique-name fallback).  ``cross-thread-unlocked`` then flags every
instance attribute written outside ``__init__`` from two or more
contexts whose write sites share no common held lock.  Entry-held
locks are modelled interprocedurally: a helper only ever called with
a lock held (``_finish_locked`` style) inherits the intersection of
its callers' held sets, fixpointed.
"""
from __future__ import annotations

import ast

from .engine import Finding, FunctionInfo, ProjectIndex, in_scope, rule
from .lockmodel import LockEvent, LockId, lock_events

_DEEP_SCOPE = ("ceph_tpu_torch/msg", "ceph_tpu_torch/exec",
               "ceph_tpu_torch/recovery", "ceph_tpu_torch/net.py",
               "ceph_tpu_torch/cluster.py",
               "ceph_tpu_torch/ops/pipeline.py")
_REACTOR_CALLBACKS = {"on_readable", "on_writable", "on_io_error"}
_TRAMPOLINES = {"call_soon", "call_later"}
# lifecycle methods where single-threaded setup/teardown writes live
_SETUP_METHODS = {"__init__", "__new__", "__enter__", "start"}


class ContextModel:
    """Shared product of the context analysis (built once per index)."""

    def __init__(self, index: ProjectIndex):
        self.index = index
        self.events: dict[str, list[LockEvent]] = {}
        self.functions: dict[str, FunctionInfo] = {}
        for mod in index.modules.values():
            for fi in mod.functions.values():
                self.functions[fi.ref] = fi
                self.events[fi.ref] = lock_events(index, fi)
        self.call_graph = self._build_call_graph()
        self.contexts: dict[str, set[str]] = {
            ref: set() for ref in self.functions}
        self._seed_thread_roots()
        self._seed_reactor_roots()
        self._propagate()
        self._seed_caller_roots()
        self._propagate()
        self.entry_held = self._entry_held_fixpoint()

    # -- call graph ---------------------------------------------------
    def _build_call_graph(self) -> dict[str, set[str]]:
        graph: dict[str, set[str]] = {}
        for ref, evs in self.events.items():
            fi = self.functions[ref]
            targets: set[str] = set()
            for e in evs:
                if e.kind != "call":
                    continue
                for callee in self.index.resolve_call(fi, e.node):
                    targets.add(callee.ref)
            # nested defs (closures, ``on_notify`` style) run on the
            # thread of whoever defined them unless spawned elsewhere
            for ch in ast.walk(fi.node):
                if isinstance(ch, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)) \
                        and ch is not fi.node:
                    nested = f"{ref}.{ch.name}"
                    if nested in self.functions:
                        targets.add(nested)
            graph[ref] = targets
        return graph

    # -- roots --------------------------------------------------------
    def _method_ref(self, fi: FunctionInfo, attr: str) -> str | None:
        ci = self.index.class_of(fi)
        if ci is None:
            return None
        target = self.index.lookup_method(ci, attr)
        return target.ref if target else None

    def _seed_thread_roots(self) -> None:
        for ref, evs in self.events.items():
            fi = self.functions[ref]
            for e in evs:
                if e.kind != "call":
                    continue
                call = e.node
                name = call.func.attr \
                    if isinstance(call.func, ast.Attribute) \
                    else call.func.id \
                    if isinstance(call.func, ast.Name) else None
                if name == "Thread":
                    for kw in call.keywords:
                        if kw.arg == "target" and \
                                isinstance(kw.value, ast.Attribute) and \
                                isinstance(kw.value.value, ast.Name) and \
                                kw.value.value.id == "self":
                            t = self._method_ref(fi, kw.value.attr)
                            if t:
                                qn = self.functions[t].qualname
                                self.contexts[t].add(f"thread:{qn}")
                elif name in _TRAMPOLINES:
                    self._seed_trampoline_args(fi, call)

    def _seed_trampoline_args(self, fi: FunctionInfo,
                              call: ast.Call) -> None:
        for arg in list(call.args) + [kw.value for kw in call.keywords]:
            if isinstance(arg, ast.Attribute) and \
                    isinstance(arg.value, ast.Name) and \
                    arg.value.id == "self":
                t = self._method_ref(fi, arg.attr)
                if t:
                    self.contexts[t].add("reactor")
            elif isinstance(arg, ast.Lambda):
                for ch in ast.walk(arg.body):
                    if isinstance(ch, ast.Call):
                        for callee in self.index.resolve_call(fi, ch):
                            self.contexts[callee.ref].add("reactor")

    def _seed_reactor_roots(self) -> None:
        for mod in self.index.iter_modules(("ceph_tpu_torch/msg",
                                            "ceph_tpu_torch/net.py")):
            for fi in mod.functions.values():
                if fi.class_name and fi.name in _REACTOR_CALLBACKS:
                    self.contexts[fi.ref].add("reactor")

    def _seed_caller_roots(self) -> None:
        for ref, fi in self.functions.items():
            if self.contexts[ref]:
                continue
            qn = fi.qualname
            if fi.class_name and qn.startswith(fi.class_name + "."):
                qn = qn[len(fi.class_name) + 1:]
            if fi.name.startswith("_") or "." in qn:
                continue  # private, or a nested def (not API surface)
            self.contexts[ref].add("caller")

    def _propagate(self) -> None:
        changed = True
        rounds = 0
        while changed and rounds < 50:
            changed = False
            rounds += 1
            for ref, targets in self.call_graph.items():
                src = self.contexts[ref]
                if not src:
                    continue
                for t in targets:
                    before = len(self.contexts[t])
                    self.contexts[t] |= src
                    changed |= len(self.contexts[t]) != before

    # -- entry-held locks --------------------------------------------
    def _entry_held_fixpoint(self) -> dict[str, frozenset[LockId]]:
        """Locks provably held on EVERY call into a function
        (intersection over call sites; roots start empty)."""
        callers_held: dict[str, list[frozenset[LockId]]] = {}
        entry: dict[str, frozenset[LockId]] = {
            ref: frozenset() for ref in self.functions}
        for _ in range(8):
            callers_held = {}
            for ref, evs in self.events.items():
                fi = self.functions[ref]
                base = entry[ref]
                for e in evs:
                    if e.kind != "call":
                        continue
                    held = base | frozenset(e.held)
                    for callee in self.index.resolve_call(fi, e.node):
                        callers_held.setdefault(callee.ref,
                                                []).append(held)
            new_entry = {}
            for ref in self.functions:
                sites = callers_held.get(ref)
                if sites:
                    inter = sites[0]
                    for s in sites[1:]:
                        inter &= s
                    new_entry[ref] = inter
                else:
                    new_entry[ref] = frozenset()
            if new_entry == entry:
                break
            entry = new_entry
        return entry


_MODEL_CACHE: dict[int, ContextModel] = {}


def context_model(index: ProjectIndex) -> ContextModel:
    model = _MODEL_CACHE.get(id(index))
    if model is None:
        model = ContextModel(index)
        _MODEL_CACHE.clear()
        _MODEL_CACHE[id(index)] = model
    return model


@rule("cross-thread-unlocked", severity="warning", scope=_DEEP_SCOPE,
      description="an instance attribute is written from two or more "
                  "thread contexts with no common lock held")
def check_cross_thread(index: ProjectIndex) -> list[Finding]:
    model = context_model(index)
    # (class, attr) -> list of (fn ref, line, contexts, held)
    writes: dict[tuple[str, str],
                 list[tuple[str, int, frozenset[str],
                            frozenset[LockId]]]] = {}
    for ref, evs in model.events.items():
        fi = model.functions[ref]
        if not fi.class_name or fi.name in _SETUP_METHODS:
            continue
        if not in_scope(fi.rel, _DEEP_SCOPE):
            continue
        ctxs = frozenset(model.contexts[ref])
        if not ctxs:
            continue
        base = model.entry_held[ref]
        for e in evs:
            if e.kind != "mutate":
                continue
            held = frozenset(e.held) | base
            writes.setdefault((fi.class_name, e.attr), []).append(
                (ref, e.node.lineno, ctxs, held))
    out: list[Finding] = []
    for (cls, attr), sites in sorted(writes.items()):
        all_ctx: set[str] = set()
        for _, _, ctxs, _ in sites:
            all_ctx |= ctxs
        if len(all_ctx) < 2:
            continue
        common = sites[0][3]
        for _, _, _, held in sites[1:]:
            common = common & held
        if common:
            continue
        ref0, line0 = sites[0][0], sites[0][1]
        fns = sorted({r.split(":")[1] for r, _, _, _ in sites})
        out.append(Finding(
            "cross-thread-unlocked", model.functions[ref0].rel, line0,
            "warning",
            f"{cls}.{attr} written from contexts "
            f"{{{','.join(sorted(all_ctx))}}} with no common lock "
            f"(writers: {', '.join(fns)})"))
    return out
