"""Launch purity: keep the hand-kernel launch path free of host waits.

The port's counterpart of ``ceph_tpu.analysis.rules_jax``.  One hazard
carries over:

- ``launch-host-sync`` — a host synchronisation (``.item()``,
  ``.cpu()``, ``.numpy()``, ``.tolist()``, ``torch.cuda.synchronize``
  or an event's or stream's ``.synchronize()``) reachable from a
  function of ``ops/`` that launches a hand kernel, that is, one that
  loads a ``cuda_build`` library.  A launch is asynchronous on its
  stream; a wait reachable from it serialises the host with the card
  on every call, the cost ``jit-host-sync`` guards against under jit.
  The search follows resolved calls to depth 3, as ``jit-host-sync``
  does.  The boundary, where waiting is the point, is not entered: the
  launch ledger (``ops/launch_ledger.py``, the counterpart of
  ``traced_jit.py``: a key's first launch waits for its end event to
  book the build and load as compile time) and the pipeline's
  completion methods (``ops/pipeline.py``).

The JAX package's other three ``jit-*`` rules have no counterpart and
are dropped: ``jit-nonstatic-shape`` and ``jit-traced-control-flow``
guard against a recompile per value under ``jax.jit``, and the port has
no jit (a hand kernel takes its shapes as launch arguments);
``jit-donated-reuse`` guards ``donate_argnums`` buffers, and the port
donates nothing (``ops/pipeline.py``: a launch never aliases its
input).
"""
from __future__ import annotations

import ast

from .engine import Finding, FunctionInfo, ModuleInfo, ProjectIndex, rule

# attribute calls that wait for the card (or copy to the host, which
# waits for the producing kernel)
HOST_SYNC_ATTRS = {"item", "cpu", "numpy", "tolist", "synchronize"}
_MAX_DEPTH = 3
_OPS_SCOPE = ("ceph_tpu_torch/ops",)
# where waiting is the point: never entered by the search
_BOUNDARY_MODULES = {"ceph_tpu_torch/ops/launch_ledger.py"}
_BOUNDARY_FUNCS = {
    ("ceph_tpu_torch/ops/pipeline.py", q) for q in (
        "settle", "_Dispatched.wait", "PipelineFuture._force",
        "PipelineFuture.result", "PipelineFuture.exception",
        "CodecPipeline.complete", "CodecPipeline.complete_one",
        "CodecPipeline.flush")}


def host_sync_call(node: ast.Call) -> str | None:
    """The sync a call performs, rendered for a finding, or None:
    ``.item`` / ``.cpu`` / ``.numpy`` / ``.tolist`` / ``.synchronize``
    on any receiver (``torch.cuda.synchronize`` included), or a bare
    ``synchronize`` imported from ``torch.cuda``."""
    f = node.func
    if isinstance(f, ast.Attribute) and f.attr in HOST_SYNC_ATTRS:
        if f.attr == "synchronize" and isinstance(f.value, ast.Attribute) \
                and f.value.attr == "cuda" and \
                isinstance(f.value.value, ast.Name) and \
                f.value.value.id == "torch":
            return "torch.cuda.synchronize"
        return f".{f.attr}"
    if isinstance(f, ast.Name) and f.id == "synchronize":
        return "synchronize"
    return None


def _is_library_load(mod: ModuleInfo, call: ast.Call) -> bool:
    """``cuda_build.load(...)``, however ``cuda_build`` was imported."""
    f = call.func
    if not (isinstance(f, ast.Attribute) and f.attr == "load"
            and isinstance(f.value, ast.Name)):
        return False
    name = f.value.id
    if name in mod.symbol_imports:
        dotted, sym = mod.symbol_imports[name]
        return f"{dotted}.{sym}".endswith("cuda_build")
    return mod.import_aliases.get(name, "").endswith("cuda_build")


def launching_functions(index: ProjectIndex) -> list[FunctionInfo]:
    """The functions of ``ops/`` that load a kernel library to launch."""
    out = []
    for mod in index.iter_modules(_OPS_SCOPE):
        for fi in mod.functions.values():
            if any(isinstance(n, ast.Call) and _is_library_load(mod, n)
                   for n in ast.walk(fi.node)):
                out.append(fi)
    return out


def _host_sync_sites(fi: FunctionInfo) -> list[tuple[int, str]]:
    sites = []
    for node in ast.walk(fi.node):
        if isinstance(node, ast.Call):
            what = host_sync_call(node)
            if what is not None:
                sites.append((node.lineno, what))
    return sites


def _boundary(fi: FunctionInfo) -> bool:
    return fi.rel in _BOUNDARY_MODULES or \
        (fi.rel, fi.qualname) in _BOUNDARY_FUNCS


@rule("launch-host-sync", severity="error", scope=_OPS_SCOPE,
      description="a host synchronisation (.item/.cpu/.numpy/.tolist, "
                  "torch.cuda.synchronize, .synchronize) is reachable "
                  "from a function that launches a hand kernel")
def check_launch_host_sync(index: ProjectIndex) -> list[Finding]:
    out: list[Finding] = []
    for root in launching_functions(index):
        seen: set[str] = {root.ref}
        frontier = [(root, 0)]
        while frontier:
            fi, depth = frontier.pop()
            for line, what in _host_sync_sites(fi):
                via = "" if fi.ref == root.ref else \
                    f" via {fi.qualname}"
                out.append(Finding(
                    "launch-host-sync", root.rel,
                    line if fi.ref == root.ref else root.node.lineno,
                    "error",
                    f"host sync {what}() reachable from kernel launcher "
                    f"{root.qualname}{via}"))
            if depth >= _MAX_DEPTH:
                continue
            for node in ast.walk(fi.node):
                if not isinstance(node, ast.Call):
                    continue
                for callee in index.resolve_call(fi, node):
                    if callee.ref not in seen and \
                            callee.rel.startswith("ceph_tpu_torch/") and \
                            not _boundary(callee):
                        seen.add(callee.ref)
                        frontier.append((callee, depth + 1))
    return out
