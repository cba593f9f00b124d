"""The guard rules, as declarative rules on the one engine.

The port's copy of ``ceph_tpu.analysis.rules_guards``: every rule runs
over ``ceph_tpu_torch/`` under the JAX package's rule id, off the shared
:class:`~ceph_tpu_torch.analysis.engine.ProjectIndex`.  Three rules
change what they look for, because the device runtime changed:

- ``no-host-sync`` flags a JAX or ``ceph_tpu`` import and the PyTorch
  host syncs (``.item()``, ``.cpu()``, ``.numpy()``, ``.tolist()``,
  ``torch.cuda.synchronize`` and an event's or stream's
  ``.synchronize()``) where the JAX package flags ``device_get``,
  ``block_until_ready`` and ``jnp.asarray``;
- ``profiler-confinement`` confines ``torch.profiler`` (and
  ``torch.autograd.profiler``) where the JAX package confines
  ``jax.profiler``;
- ``bare-clock`` allowlists the launch ledger (the counterpart of
  ``traced_jit.py``) and the kernel build.

Rules that check against a RUNTIME registry (owner classes, critpath
phases, wire sizers) import those registries lazily inside the check,
keeping ``import ceph_tpu_torch.analysis`` free of ``torch``.
"""
from __future__ import annotations

import ast
import re
from collections.abc import Iterator

from .engine import Finding, ModuleInfo, ProjectIndex, rule
from .rules_torch import host_sync_call

# ---------------------------------------------------------------- util

_DEF_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
              ast.ClassDef)


def _walk_scope(node: ast.AST,
                enter_classes: bool = False) -> Iterator[ast.AST]:
    """ast.walk without descending into nested defs (they are their
    own entries in the index)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        sub = stack.pop()
        if isinstance(sub, _DEF_NODES):
            if enter_classes and isinstance(sub, ast.ClassDef):
                stack.extend(ast.iter_child_nodes(sub))
            continue
        yield sub
        stack.extend(ast.iter_child_nodes(sub))


def _scoped_calls(mod: ModuleInfo) -> Iterator[tuple[str, str, ast.Call]]:
    """(enclosing function name, qualname, call) for every call site,
    attributed to its innermost def; module/class level calls get
    ``<module>``."""
    for fi in mod.functions.values():
        for sub in _walk_scope(fi.node):
            if isinstance(sub, ast.Call):
                yield fi.name, fi.qualname, sub
    for sub in _walk_scope(mod.tree, enter_classes=True):
        if isinstance(sub, ast.Call):
            yield "<module>", "<module>", sub


def _call_name(call: ast.Call) -> str | None:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


# ------------------------------------------------- 1. no-host-sync

_HOST_SYNC_SCOPE = ("ceph_tpu_torch/exec", "ceph_tpu_torch/recovery")
# the device runtimes a serving/recovery module must not import: the
# JAX one, and the JAX package itself (the port imports nothing of it)
_FOREIGN_ROOTS = {"jax", "ceph_tpu"}


@rule("no-host-sync", severity="error", scope=_HOST_SYNC_SCOPE,
      description="serving/recovery hot paths import jax or ceph_tpu, "
                  "or wait on the card (.item/.cpu/.numpy/.tolist, "
                  "torch.cuda.synchronize, an event's or stream's "
                  ".synchronize) instead of ops/pipeline.py's "
                  "completion boundary")
def check_no_host_sync(index: ProjectIndex) -> list[Finding]:
    out: list[Finding] = []
    for mod in index.iter_modules(_HOST_SYNC_SCOPE):
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name.split(".")[0] in _FOREIGN_ROOTS:
                        out.append(Finding(
                            "no-host-sync", mod.rel, node.lineno,
                            "error", f"import {alias.name}"))
            elif isinstance(node, ast.ImportFrom):
                if node.level == 0 and \
                        (node.module or "").split(".")[0] \
                        in _FOREIGN_ROOTS:
                    out.append(Finding(
                        "no-host-sync", mod.rel, node.lineno, "error",
                        f"from {node.module} import ..."))
            elif isinstance(node, ast.Call):
                what = host_sync_call(node)
                if what is not None:
                    out.append(Finding(
                        "no-host-sync", mod.rel, node.lineno, "error",
                        f"{what}(...)"))
    return out


# ------------------------------------------------- 2. unbounded-queue

_QUEUE_SCOPE = ("ceph_tpu_torch/exec", "ceph_tpu_torch/recovery",
                "ceph_tpu_torch/tier")
_QUEUE_CTORS = {"Queue", "LifoQueue", "PriorityQueue"}


def _has_bound(node: ast.Call, kw_name: str, pos_index: int) -> bool:
    for kw in node.keywords:
        if kw.arg == kw_name:
            return not (isinstance(kw.value, ast.Constant)
                        and kw.value.value in (None, 0))
    if len(node.args) > pos_index:
        arg = node.args[pos_index]
        return not (isinstance(arg, ast.Constant)
                    and arg.value in (None, 0))
    return False


@rule("unbounded-queue", severity="error", scope=_QUEUE_SCOPE,
      description="a queue constructed in the bounded subsystems "
                  "(exec/, recovery/) has no explicit bound — voids "
                  "the backpressure contract")
def check_unbounded_queue(index: ProjectIndex) -> list[Finding]:
    out: list[Finding] = []
    for mod in index.iter_modules(_QUEUE_SCOPE):
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node)
            if name == "SimpleQueue":
                out.append(Finding(
                    "unbounded-queue", mod.rel, node.lineno, "error",
                    "SimpleQueue cannot be bounded — use "
                    "Queue(maxsize=...)"))
            elif name == "deque" and not _has_bound(node, "maxlen", 1):
                out.append(Finding(
                    "unbounded-queue", mod.rel, node.lineno, "error",
                    "deque without an explicit maxlen bound"))
            elif name in _QUEUE_CTORS and \
                    not _has_bound(node, "maxsize", 0):
                out.append(Finding(
                    "unbounded-queue", mod.rel, node.lineno, "error",
                    f"{name} without an explicit nonzero maxsize "
                    f"bound"))
    return out


# ------------------------------------------------- 3. blocking-socket

_MSG_SCOPE = ("ceph_tpu_torch/msg",)
_BLOCKING_SOCKET_VERBS = {"recv", "recv_into", "sendall", "accept"}


@rule("blocking-socket", severity="error", scope=_MSG_SCOPE,
      description="a blocking socket verb (recv/recv_into/sendall/"
                  "accept) appears outside a reactor readiness "
                  "callback (on_*) in ceph_tpu_torch/msg/")
def check_blocking_socket(index: ProjectIndex) -> list[Finding]:
    out: list[Finding] = []
    for mod in index.iter_modules(_MSG_SCOPE):
        for fn_name, qual, call in _scoped_calls(mod):
            f = call.func
            if isinstance(f, ast.Attribute) and \
                    f.attr in _BLOCKING_SOCKET_VERBS and \
                    not fn_name.startswith("on_"):
                out.append(Finding(
                    "blocking-socket", mod.rel, call.lineno, "error",
                    f"{qual} calls .{f.attr}() outside a readiness "
                    f"callback"))
    return out


# ---------------------------------------------- 4. thread-spawn-site

# the ONLY places a thread may be born in the async messenger: one
# reactor loop, the fixed dispatch pool, the single mux sender
THREAD_SPAWN_ALLOWLIST = {
    ("reactor.py", "Reactor.start"),
    ("server.py", "Dispatcher.start"),
    ("client.py", "MuxClient.__init__"),
}


def _is_thread_ctor(call: ast.Call) -> bool:
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr == "Thread" and isinstance(f.value, ast.Name) \
            and f.value.id == "threading"
    return isinstance(f, ast.Name) and f.id == "Thread"


@rule("thread-spawn-site", severity="error", scope=_MSG_SCOPE,
      description="threading.Thread constructed in ceph_tpu_torch/msg/ "
                  "outside the three fixed spawn sites (thread count "
                  "must never scale with connections)")
def check_thread_spawn_site(index: ProjectIndex) -> list[Finding]:
    out: list[Finding] = []
    for mod in index.iter_modules(_MSG_SCOPE):
        fname = mod.rel.rsplit("/", 1)[-1]
        for _fn, qual, call in _scoped_calls(mod):
            if _is_thread_ctor(call) and \
                    (fname, qual) not in THREAD_SPAWN_ALLOWLIST:
                out.append(Finding(
                    "thread-spawn-site", mod.rel, call.lineno, "error",
                    f"threading.Thread constructed in {qual}, outside "
                    f"the fixed spawn sites"))
    return out


def blocking_socket_sites(index: ProjectIndex
                          ) -> set[tuple[str, str, str]]:
    """(file, qualname, verb) for EVERY blocking-verb call site in
    msg/, allowed or not — the wrapper test asserts the known
    readiness callbacks are still being scanned."""
    sites: set[tuple[str, str, str]] = set()
    for mod in index.iter_modules(_MSG_SCOPE):
        fname = mod.rel.rsplit("/", 1)[-1]
        for _fn, qual, call in _scoped_calls(mod):
            f = call.func
            if isinstance(f, ast.Attribute) and \
                    f.attr in _BLOCKING_SOCKET_VERBS:
                sites.add((fname, qual, f.attr))
    return sites


def msg_thread_spawn_sites(index: ProjectIndex
                           ) -> set[tuple[str, str]]:
    """(file, qualname) of every Thread construction in msg/ — the
    wrapper test asserts the allowlisted sites still exist."""
    sites: set[tuple[str, str]] = set()
    for mod in index.iter_modules(_MSG_SCOPE):
        fname = mod.rel.rsplit("/", 1)[-1]
        for _fn, qual, call in _scoped_calls(mod):
            if _is_thread_ctor(call):
                sites.add((fname, qual))
    return sites


# ------------------------------------------------- 5. bounded-retry

_RETRY_SCOPE = ("ceph_tpu_torch/net.py", "ceph_tpu_torch/client",
                "ceph_tpu_torch/failure")
_RETRYABLE = {"ConnectionError", "OSError", "TimeoutError",
              "ConnectionResetError", "BrokenPipeError", "timeout",
              "Exception", "BaseException", "IOError", "error"}
_BOUND_NAME = re.compile(
    r"attempt|deadline|retries|tries|remaining|max|budget|stop",
    re.IGNORECASE)


def _handler_names(handler: ast.ExceptHandler) -> set[str]:
    t = handler.type
    if t is None:
        return {"BaseException"}
    parts = t.elts if isinstance(t, ast.Tuple) else [t]
    out = set()
    for p in parts:
        if isinstance(p, ast.Name):
            out.add(p.id)
        elif isinstance(p, ast.Attribute):
            out.add(p.attr)
    return out


def _swallows_retryable(node: ast.While) -> bool:
    for sub in _walk_scope(node):
        if not isinstance(sub, ast.Try):
            continue
        for h in sub.handlers:
            if not (_handler_names(h) & _RETRYABLE):
                continue
            if not any(isinstance(n, (ast.Raise, ast.Return))
                       for body in h.body for n in ast.walk(body)):
                return True
    return False


def _has_bound_reference(node: ast.While) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and _BOUND_NAME.search(sub.id):
            return True
        if isinstance(sub, ast.Attribute) and \
                _BOUND_NAME.search(sub.attr):
            return True
    return False


@rule("bounded-retry", severity="error", scope=_RETRY_SCOPE,
      description="a 'while True' loop swallows connection errors "
                  "with no attempt count or deadline in sight — a "
                  "dead server becomes a live-locked client")
def check_bounded_retry(index: ProjectIndex) -> list[Finding]:
    out: list[Finding] = []
    for mod in index.iter_modules(_RETRY_SCOPE):
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.While):
                continue
            if not (isinstance(node.test, ast.Constant)
                    and bool(node.test.value)):
                continue
            if _swallows_retryable(node) and \
                    not _has_bound_reference(node):
                out.append(Finding(
                    "bounded-retry", mod.rel, node.lineno, "error",
                    "unbounded 'while True' retry loop swallowing "
                    "connection errors — bound it with an attempt "
                    "count or deadline "
                    "(failure/backoff.ExponentialBackoff)"))
    return out


# ------------------------------------------------- 6. span-owner

_SPAN_SCOPE = ("ceph_tpu_torch/exec", "ceph_tpu_torch/recovery",
               "ceph_tpu_torch/tier")
_SPAN_CALLS = {"trace_span", "span"}


@rule("span-owner", severity="error", scope=_SPAN_SCOPE,
      description="a span opened in exec/ or recovery/ carries no "
                  "owner= (or a non-canonical one) — device-time "
                  "attribution misfiles it as client work")
def check_span_owner(index: ProjectIndex) -> list[Finding]:
    from ceph_tpu_torch.common.device_attribution import OWNER_CLASSES
    out: list[Finding] = []
    for mod in index.iter_modules(_SPAN_SCOPE):
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call) or \
                    _call_name(node) not in _SPAN_CALLS:
                continue
            owner = next((kw.value for kw in node.keywords
                          if kw.arg == "owner"), None)
            if owner is None:
                out.append(Finding(
                    "span-owner", mod.rel, node.lineno, "error",
                    "span without owner= (attribution would misfile "
                    "this as client work)"))
            elif isinstance(owner, ast.Constant) and \
                    owner.value not in OWNER_CLASSES:
                out.append(Finding(
                    "span-owner", mod.rel, node.lineno, "error",
                    f"owner={owner.value!r} is not a canonical owner "
                    f"class {OWNER_CLASSES}"))
    return out


# ------------------------------------------------- 7. span-phase

_PHASE_SCOPE = ("ceph_tpu_torch/exec", "ceph_tpu_torch/recovery",
                "ceph_tpu_torch/ops/pipeline.py", "ceph_tpu_torch/tier")
_PHASE_CALLS = {"trace_span", "span", "complete"}


@rule("span-phase", severity="error", scope=_PHASE_SCOPE,
      description="a span in exec/, recovery/ or ops/pipeline.py maps "
                  "to no declared critical-path phase — its self-time "
                  "files under 'other'")
def check_span_phase(index: ProjectIndex) -> list[Finding]:
    from ceph_tpu_torch.common.critpath import PHASES, is_declared
    out: list[Finding] = []
    for mod in index.iter_modules(_PHASE_SCOPE):
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call) or \
                    _call_name(node) not in _PHASE_CALLS or \
                    not node.args:
                continue
            first = node.args[0]
            if not (isinstance(first, ast.Constant)
                    and isinstance(first.value, str)):
                continue
            name = first.value
            phase_kw = next((kw.value for kw in node.keywords
                             if kw.arg == "phase"), None)
            if isinstance(phase_kw, ast.Constant) and \
                    phase_kw.value in PHASES:
                continue
            if is_declared(name):
                continue
            out.append(Finding(
                "span-phase", mod.rel, node.lineno, "error",
                f"span {name!r} maps to no declared critical-path "
                f"phase — add it to critpath.SPAN_PHASES or pass "
                f"phase=<one of {PHASES}>"))
    return out


# ------------------------------------------- 8. profiler-confinement

_PROFILER_SCOPE = ("ceph_tpu_torch",)
# path -> why the profiler touch is legitimate there
PROFILER_ALLOWLIST = {
    "ceph_tpu_torch/common/profiler_capture.py":
        "IS the capture-window manager (the only sanctioned owner of "
        "the process-global profiler session)",
    "ceph_tpu_torch/tools/path_shapes.py":
        "a standalone measuring tool: it times one kernel at a time in "
        "its own profiler session (device_ms) in a process that runs no "
        "cluster, so no capture window can be open beside it",
}
# the PyTorch profiler's modules: the session API and its legacy twin
_PROFILER_MODULES = ("torch.profiler", "torch.autograd.profiler")


def _is_profiler_module(name: str) -> bool:
    return any(name == m or name.startswith(m + ".")
               for m in _PROFILER_MODULES)


def _dotted_attr(node: ast.AST) -> str | None:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


@rule("profiler-confinement", severity="error", scope=_PROFILER_SCOPE,
      description="a torch.profiler touch outside "
                  "common/profiler_capture.py — captures must go "
                  "through the managed windows")
def check_profiler_confinement(index: ProjectIndex) -> list[Finding]:
    out: list[Finding] = []
    for mod in index.iter_modules(_PROFILER_SCOPE):
        if mod.rel in PROFILER_ALLOWLIST:
            continue
        for node in ast.walk(mod.tree):
            what: str | None = None
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if _is_profiler_module(alias.name):
                        what = f"import {alias.name}"
            elif isinstance(node, ast.ImportFrom):
                m = node.module or ""
                if node.level == 0 and _is_profiler_module(m):
                    what = f"from {m} import ..."
                elif node.level == 0 and any(
                        _is_profiler_module(f"{m}.{a.name}")
                        for a in node.names):
                    what = f"from {m} import profiler"
            elif isinstance(node, ast.Attribute) and \
                    node.attr == "profiler":
                dotted = _dotted_attr(node)
                if dotted is not None and _is_profiler_module(dotted):
                    what = dotted
            if what is not None:
                out.append(Finding(
                    "profiler-confinement", mod.rel, node.lineno,
                    "error", what))
    return out


# ------------------------------------------------- 9. bare-clock

_CLOCK_SCOPE = ("ceph_tpu_torch/ops", "ceph_tpu_torch/backend")
# path -> why the bare clock is legitimate there
CLOCK_ALLOWLIST = {
    "ceph_tpu_torch/ops/launch_ledger.py":
        "IS the timing wrapper, the counterpart of the JAX package's "
        "traced_jit.py (a key's first launch books its build/load and "
        "synchronised launch as compile wall time)",
    "ceph_tpu_torch/ops/cuda_build.py":
        "times the nvcc build and the library load, once per kernel "
        "source and process; it is on no encode/decode op path",
}
_BARE_TIME = re.compile(r"time\.time\(\)|perf_counter\(\)")


@rule("bare-clock", severity="error", scope=_CLOCK_SCOPE,
      description="a bare time.time()/perf_counter() in the encode/"
                  "decode hot paths — route timing through "
                  "trace_span/PerfCounters/launch_ledger")
def check_bare_clock(index: ProjectIndex) -> list[Finding]:
    out: list[Finding] = []
    for mod in index.iter_modules(_CLOCK_SCOPE):
        if mod.rel in CLOCK_ALLOWLIST:
            continue
        for lineno, line in enumerate(mod.text.splitlines(), start=1):
            if _BARE_TIME.search(line):
                out.append(Finding(
                    "bare-clock", mod.rel, lineno, "error",
                    f"bare timing call: {line.strip()}"))
    return out


# ------------------------------------------------- 10. counter-help

_COUNTER_SCOPE = ("ceph_tpu_torch",)
# adder -> index of the description positional (after self)
COUNTER_ADDERS = {"add_u64": 1, "add_u64_counter": 1, "add_u64_avg": 1,
                  "add_time_avg": 1, "add_histogram": 2}


def _description_ok(node: ast.Call, pos_index: int) -> bool:
    for kw in node.keywords:
        if kw.arg == "description":
            return not (isinstance(kw.value, ast.Constant)
                        and not kw.value.value)
    if len(node.args) > pos_index:
        arg = node.args[pos_index]
        return not (isinstance(arg, ast.Constant) and not arg.value)
    return False


@rule("counter-help", severity="error", scope=_COUNTER_SCOPE,
      description="a perf-counter adder without a description — "
                  "prometheus # HELP renders as the bare metric name")
def check_counter_help(index: ProjectIndex) -> list[Finding]:
    out: list[Finding] = []
    for mod in index.iter_modules(_COUNTER_SCOPE):
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call) or \
                    not isinstance(node.func, ast.Attribute):
                continue
            pos = COUNTER_ADDERS.get(node.func.attr)
            if pos is not None and not _description_ok(node, pos):
                out.append(Finding(
                    "counter-help", mod.rel, node.lineno, "error",
                    f"{node.func.attr}(...) without a description "
                    f"(prometheus # HELP quality)"))
    return out


def count_counter_adders(index: ProjectIndex) -> int:
    """How many adder calls the index sees — the wrapper test uses
    this to prove the rule still scans something real (>= 20)."""
    hits = 0
    for mod in index.iter_modules(_COUNTER_SCOPE):
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in COUNTER_ADDERS:
                hits += 1
    return hits


# --------------------------------------------- 11. percentile-redef

_PCTL_SCOPE = ("ceph_tpu_torch",)
_PCTL_HOME = "ceph_tpu_torch/common/percentile.py"
_PCTL_BANNED = {"percentile", "percentile_us", "nearest_rank"}


@rule("percentile-redef", severity="error", scope=_PCTL_SCOPE,
      description="a local percentile/nearest_rank redefinition "
                  "outside common/percentile.py — the drift that made "
                  "trace_report's copy silently diverge")
def check_percentile_redef(index: ProjectIndex) -> list[Finding]:
    out: list[Finding] = []
    for mod in index.iter_modules(_PCTL_SCOPE):
        if mod.rel == _PCTL_HOME:
            continue
        for node in ast.walk(mod.tree):
            if not (isinstance(node, (ast.FunctionDef,
                                      ast.AsyncFunctionDef))
                    and node.name in _PCTL_BANNED):
                continue
            # a thin delegating wrapper is fine — it must CALL the
            # shared helper, not re-derive the rank
            dump = ast.dump(node)
            if "nearest_rank" in dump or "_pctl" in dump:
                continue
            out.append(Finding(
                "percentile-redef", mod.rel, node.lineno, "error",
                f"def {node.name} redefines a percentile locally — "
                f"use ceph_tpu_torch/common/percentile.py"))
    return out


# ------------------------------------------------- 12. wire-sizer

MESSAGE_MODULES = ("ceph_tpu_torch/backend/messages.py",
                   "ceph_tpu_torch/net.py", "ceph_tpu_torch/msg/proto.py",
                   "ceph_tpu_torch/tier")
# message-shaped dataclasses that never ride a channel
NOT_WIRE_MESSAGES = {"FaultConfig"}


def _dataclass_names(mod: ModuleInfo) -> set[str]:
    names = set()
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        for dec in node.decorator_list:
            target = dec.func if isinstance(dec, ast.Call) else dec
            if isinstance(target, ast.Name) and \
                    target.id == "dataclass" or \
                    isinstance(target, ast.Attribute) and \
                    target.attr == "dataclass":
                names.add(node.name)
    return names


@rule("wire-sizer", severity="error", scope=MESSAGE_MODULES,
      description="a wire-message dataclass without a registered "
                  "payload sizer — its bytes get charged by an "
                  "unreviewed pickle estimate")
def check_wire_sizer(index: ProjectIndex) -> list[Finding]:
    # importing the modules runs their register_wire_sizes() blocks
    import ceph_tpu_torch.backend.messages  # noqa: F401
    import ceph_tpu_torch.msg.proto  # noqa: F401
    import ceph_tpu_torch.net  # noqa: F401
    from ceph_tpu_torch.common.wire_accounting import registered_wire_types
    registered = registered_wire_types()
    out: list[Finding] = []
    for mod in index.iter_modules(MESSAGE_MODULES):
        for name in sorted(_dataclass_names(mod)):
            if name.startswith("_") or name in NOT_WIRE_MESSAGES:
                continue
            if name not in registered:
                out.append(Finding(
                    "wire-sizer", mod.rel, 1, "error",
                    f"message class {name} has no wire-accounting "
                    f"sizer (register it in register_wire_sizes next "
                    f"to the definition)"))
    return out
