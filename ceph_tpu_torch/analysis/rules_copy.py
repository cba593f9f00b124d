"""hot-path-copy: payload-sized host copies on the messenger/exec data
path.

The guard rule of the zero-copy data path: it works by never
materializing payload bytes between the socket and the device — staging
slices, sideband splices, and device relayouts are the ONLY sanctioned
copies, and each reports itself to ``common/copy_ledger``.  A stray
``bytes(view)`` / ``view.tobytes()`` / ``pickle.dumps(payload)`` in
``msg/`` or ``exec/`` silently reintroduces a per-byte copy the ledger
never sees, so the ratio gate under-counts and the regression ships.

Heuristics, deliberately narrow to keep the signal clean:

- ``pickle.dumps(...)`` flags unconditionally in scope: serializing on
  the data path copies everything it touches, payloads included (the
  sideband exists precisely so payloads skip the pickler);
- ``bytes(x)`` / ``bytearray(x)`` constructor calls and ``x.tobytes()``
  flag only when the operand's terminal identifier carries a payload
  hint (``payload``/``data``/``buf``/``body``/``view``/``seg``/
  ``chunk``/``value``/``piece``/``mv``) — ``bytes(name)``-style id
  materialization never trips it;
- functions whose names mark a control-plane boundary (handshake, auth,
  banner, keepalive, connect) are allowlisted: those frames are
  constant-sized and pre-date the payload path.

Justified survivors (the parser's BufferError fallback — already
ledger-counted — the 16-byte MAC slice, the striper's scatter/gather
assembly) live in ``ceph_tpu_torch/analysis/baseline.json`` with their why, like
every other rule's.
"""
from __future__ import annotations

import ast

from .engine import Finding, ProjectIndex, rule

_SCOPE = ("ceph_tpu_torch/msg", "ceph_tpu_torch/exec")

# operand identifiers that look payload-sized
_PAYLOAD_HINTS = ("payload", "data", "buf", "body", "view", "seg",
                  "chunk", "value", "piece", "mv")

# function-name fragments marking allowlisted control-plane boundaries
_BOUNDARY_HINTS = ("handshake", "auth", "banner", "keepalive", "connect",
                   "hello")


def _terminal_ident(node) -> str:
    """Lowered terminal identifier of an expression: ``self.payload[i]``
    -> ``payload``, ``mv.cast('B')`` -> ``mv`` (empty when nameless)."""
    while True:
        if isinstance(node, ast.Subscript):
            node = node.value
        elif isinstance(node, ast.Call):
            node = node.func
        elif isinstance(node, ast.Attribute):
            return node.attr.lower()
        elif isinstance(node, ast.Name):
            return node.id.lower()
        else:
            return ""


def _payloadish(node) -> bool:
    ident = _terminal_ident(node)
    return any(h in ident for h in _PAYLOAD_HINTS)


def _is_pickle_dumps(call: ast.Call) -> bool:
    fn = call.func
    return (isinstance(fn, ast.Attribute) and fn.attr == "dumps" and
            isinstance(fn.value, ast.Name) and
            fn.value.id in ("pickle", "cPickle"))


def _copy_site(call: ast.Call) -> str | None:
    """Describe the copy a call performs, or None."""
    fn = call.func
    if _is_pickle_dumps(call):
        return "pickle.dumps"
    if isinstance(fn, ast.Name) and fn.id in ("bytes", "bytearray") \
            and len(call.args) == 1 and not call.keywords \
            and _payloadish(call.args[0]):
        return f"{fn.id}({_terminal_ident(call.args[0])})"
    if isinstance(fn, ast.Attribute) and fn.attr == "tobytes" \
            and _payloadish(fn.value):
        return f"{_terminal_ident(fn.value)}.tobytes()"
    return None


def _own_calls(fn_node):
    """Call nodes in a function's OWN body — nested defs are indexed as
    their own FunctionInfo, so their bodies are skipped here to report
    each site exactly once."""
    stack = list(ast.iter_child_nodes(fn_node))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if isinstance(n, ast.Call):
            yield n
        stack.extend(ast.iter_child_nodes(n))


@rule("hot-path-copy", severity="warning", scope=_SCOPE,
      description="a payload-sized host copy (bytes()/tobytes()/"
                  "pickle.dumps) on the msg/exec data path — the "
                  "zero-copy path's sanctioned copies are staging, "
                  "sideband splice, and device relayout, each counted "
                  "by the copy ledger; anything else silently skews "
                  "bytes_copied_per_byte_served")
def check_hot_path_copy(index: ProjectIndex) -> list[Finding]:
    out: list[Finding] = []
    for mod in index.iter_modules(_SCOPE):
        for fi in mod.functions.values():
            low = fi.qualname.lower()
            if any(h in low for h in _BOUNDARY_HINTS):
                continue
            for node in _own_calls(fi.node):
                site = _copy_site(node)
                if site is None:
                    continue
                out.append(Finding(
                    "hot-path-copy", fi.rel, node.lineno, "warning",
                    f"payload copy {site} in {fi.qualname}"))
    return out
