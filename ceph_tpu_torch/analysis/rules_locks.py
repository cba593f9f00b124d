"""Lock-order deadlock detection + callbacks/sends under a held lock.

``lock-order-cycle`` builds the static lock-acquisition graph the way
Ceph's ``lockdep.cc`` does at runtime: an edge A→B means some code
path acquires B while holding A — either lexically (nested ``with``)
or through a call made under A whose transitive may-acquire set
contains B.  A cycle in that graph is a potential ABBA deadlock.
Lock identity is (defining class, attribute), so two *instances* of
the same class taking each other's locks fold onto a self-edge; those
are skipped (the tree has no hand-over-hand instance chains).

``callback-under-lock`` flags the `_watch_lock` class of bug the
watch/notify path once had: invoking a stored callback / handler / send while
holding a lock, which both extends the critical section by arbitrary
user work and invites re-entrant deadlocks.
"""
from __future__ import annotations

import ast
import re

from .engine import Finding, FunctionInfo, ProjectIndex, rule
from .lockmodel import LockEvent, LockId, lock_events, may_acquire_closure

_DEEP_SCOPE = ("ceph_tpu_torch/msg", "ceph_tpu_torch/exec",
               "ceph_tpu_torch/recovery", "ceph_tpu_torch/net.py",
               "ceph_tpu_torch/cluster.py",
               "ceph_tpu_torch/ops/pipeline.py")

# call names that hand control to arbitrary stored code or the network
_CALLBACK_NAME = re.compile(
    r"^(cb|_cb|fn|_fn|func|callback|_callback|hook|on_[a-z0-9_]+)$")
_SEND_NAMES = {"send", "sendall", "send_message", "sendto",
               "send_from_reactor"}
# invocations that are lock-internal by design, not external hand-offs
_BENIGN_ATTRS = {"notify", "notify_all", "wait", "wait_for", "acquire",
                 "release", "append", "popleft", "pop", "add", "get",
                 "put", "discard", "remove", "clear", "update",
                 "setdefault", "items", "values", "keys", "extend"}


def _all_events(index: ProjectIndex
                ) -> tuple[dict[str, list[LockEvent]],
                           dict[str, FunctionInfo]]:
    events: dict[str, list[LockEvent]] = {}
    functions: dict[str, FunctionInfo] = {}
    for mod in index.modules.values():
        for fi in mod.functions.values():
            events[fi.ref] = lock_events(index, fi)
            functions[fi.ref] = fi
    return events, functions


def _lock_graph(index: ProjectIndex,
                events: dict[str, list[LockEvent]],
                functions: dict[str, FunctionInfo],
                acq: dict[str, set[LockId]],
                ) -> dict[tuple[LockId, LockId], list[tuple[str, int]]]:
    """edges {(held, acquired): [(witness fn ref, line), ...]}."""
    edges: dict[tuple[LockId, LockId], list[tuple[str, int]]] = {}

    def note(a: LockId, b: LockId, ref: str, line: int) -> None:
        if a == b:
            return
        edges.setdefault((a, b), [])
        if len(edges[(a, b)]) < 3:
            edges[(a, b)].append((ref, line))

    for ref, evs in events.items():
        fi = functions[ref]
        for e in evs:
            if e.kind == "acquire" and e.held:
                for h in e.held:
                    note(h, e.lock, ref, e.node.lineno)
            elif e.kind == "call" and e.held:
                for callee in index.resolve_call(fi, e.node):
                    for lid in acq.get(callee.ref, ()):
                        for h in e.held:
                            note(h, lid, ref, e.node.lineno)
    return edges


def _cycles(edges: dict[tuple[LockId, LockId], list]) -> list[list[LockId]]:
    """Strongly connected components with >1 node (or a self loop —
    already excluded upstream) in the lock graph."""
    adj: dict[LockId, set[LockId]] = {}
    for a, b in edges:
        adj.setdefault(a, set()).add(b)
        adj.setdefault(b, set())
    # iterative Tarjan
    index_of: dict[LockId, int] = {}
    low: dict[LockId, int] = {}
    on_stack: set[LockId] = set()
    stack: list[LockId] = []
    sccs: list[list[LockId]] = []
    counter = [0]

    for root in sorted(adj):
        if root in index_of:
            continue
        work = [(root, iter(sorted(adj[root])))]
        index_of[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index_of:
                    index_of[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(adj[w]))))
                    advanced = True
                    break
                if w in on_stack:
                    low[v] = min(low[v], index_of[w])
            if advanced:
                continue
            work.pop()
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])
            if low[v] == index_of[v]:
                comp: list[LockId] = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                if len(comp) > 1:
                    sccs.append(sorted(comp))
    return sccs


@rule("lock-order-cycle", severity="error",
      description="two locks are acquired in both orders on some "
                  "static path (potential ABBA deadlock)")
def check_lock_order(index: ProjectIndex) -> list[Finding]:
    events, functions = _all_events(index)
    acq = may_acquire_closure(index, events, functions)
    edges = _lock_graph(index, events, functions, acq)
    out: list[Finding] = []
    for comp in _cycles(edges):
        members = set(comp)
        witness_parts: list[str] = []
        anchor: tuple[str, int] | None = None
        for (a, b), sites in sorted(edges.items()):
            if a in members and b in members:
                ref, line = sites[0]
                witness_parts.append(f"{a}->{b} in {ref.split(':')[1]}")
                if anchor is None:
                    anchor = (functions[ref].rel, line)
        rel, line = anchor if anchor else ("ceph_tpu_torch", 1)
        names = " <-> ".join(str(lid) for lid in comp)
        out.append(Finding(
            "lock-order-cycle", rel, line, "error",
            f"lock-order cycle {names} ({'; '.join(witness_parts)})"))
    return out


def _call_name(call: ast.Call) -> str | None:
    fn = call.func
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return None


@rule("callback-under-lock", severity="warning", scope=_DEEP_SCOPE,
      description="a stored callback / handler / network send is "
                  "invoked while holding a lock (re-entrancy and "
                  "critical-section-bloat hazard)")
def check_callback_under_lock(index: ProjectIndex) -> list[Finding]:
    out: list[Finding] = []
    for mod in index.iter_modules(_DEEP_SCOPE):
        for fi in mod.functions.values():
            aliases = index.local_aliases(fi)
            for e in lock_events(index, fi):
                if e.kind != "call" or not e.held:
                    continue
                name = _call_name(e.node)
                if name is None or name in _BENIGN_ATTRS:
                    continue
                is_send = name in _SEND_NAMES
                is_cb = _CALLBACK_NAME.match(name) is not None
                # a local name judged by the self-attribute it aliases:
                # ``cb, self.on_closed = self.on_closed, None; cb(...)``
                if isinstance(e.node.func, ast.Name) and not is_cb:
                    aliased = aliases.get(e.node.func.id)
                    is_cb = aliased is not None and \
                        _CALLBACK_NAME.match(aliased) is not None
                if not (is_send or is_cb):
                    continue
                held = ",".join(str(h) for h in sorted(e.held))
                kindtxt = "send" if is_send else "callback"
                out.append(Finding(
                    "callback-under-lock", fi.rel, e.node.lineno,
                    "warning",
                    f"{kindtxt} {name}() invoked in {fi.qualname} "
                    f"while holding {held}"))
    return out
