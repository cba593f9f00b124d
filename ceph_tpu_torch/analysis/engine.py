"""The ceph-lint engine: project index, rule registry, baseline.

The port's copy of ``ceph_tpu.analysis.engine``, scanning
``ceph_tpu_torch/`` with its own baseline file.

One parse of the tree feeds every rule.  The index is deliberately
syntactic — no imports of the code under analysis are needed to build
it — but it is CROSS-MODULE: classes, methods, module functions,
import aliases, instance-attribute types and lock attributes are all
resolved project-wide, so a rule can follow ``self.reactor.call_soon``
from ``msg/connection.py`` into ``msg/reactor.py`` and ask what locks
the callee takes.

Call resolution is best-effort and documented per tier (exact →
class/attr-typed → unique-name fallback); deep rules are written to
tolerate the unresolved remainder and ship with a reviewed baseline
for the over-approximations that survive.
"""
from __future__ import annotations

import ast
import json
from dataclasses import dataclass, field
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]

# the production tree ceph-lint covers by default: the port's package,
# its tools included (tests/ excluded: the engine's own fixtures live
# there and must not self-trip)
DEFAULT_SCAN = ("ceph_tpu_torch",)

SEVERITIES = ("error", "warning")

_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore",
               "BoundedSemaphore"}


@dataclass(frozen=True)
class Finding:
    """One lint finding.  ``message`` must be line-free and stable so a
    baseline entry survives unrelated edits above it."""

    rule: str
    path: str                       # repo-relative posix path
    line: int
    severity: str
    message: str

    @property
    def key(self) -> tuple[str, str, str]:
        return (self.rule, self.path, self.message)

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.severity} " \
               f"[{self.rule}] {self.message}"


@dataclass
class FunctionInfo:
    """One function/method (incl. nested defs), project-qualified."""

    rel: str                        # module path
    qualname: str                   # "Class.method" / "outer.inner"
    name: str
    node: ast.AST                   # FunctionDef | AsyncFunctionDef
    class_name: str | None = None   # immediately enclosing class

    @property
    def ref(self) -> str:
        return f"{self.rel}:{self.qualname}"


@dataclass
class ClassInfo:
    rel: str
    name: str
    node: ast.ClassDef
    bases: list[str] = field(default_factory=list)
    methods: dict[str, FunctionInfo] = field(default_factory=dict)
    # attr -> threading ctor name ("Lock"/"RLock"/"Condition"/...)
    lock_attrs: dict[str, str] = field(default_factory=dict)
    # attr -> project class name (self.x = Foo(...) in a method body)
    attr_types: dict[str, str] = field(default_factory=dict)


@dataclass
class ModuleInfo:
    rel: str
    text: str
    tree: ast.Module
    dotted: str                     # "ceph_tpu_torch.msg.client"
    classes: dict[str, ClassInfo] = field(default_factory=dict)
    functions: dict[str, FunctionInfo] = field(default_factory=dict)
    # import alias -> dotted module ("F" -> "torch.nn.functional")
    import_aliases: dict[str, str] = field(default_factory=dict)
    # from-import: local name -> (dotted module, original symbol)
    symbol_imports: dict[str, tuple[str, str]] = field(
        default_factory=dict)
    # module-level lock name -> ctor
    module_locks: dict[str, str] = field(default_factory=dict)


def _dotted_of(rel: str) -> str:
    p = rel[:-3] if rel.endswith(".py") else rel
    if p.endswith("/__init__"):
        p = p[: -len("/__init__")]
    return p.replace("/", ".")


class _Collector(ast.NodeVisitor):
    """One pass per module: classes, functions (nested included),
    imports, module-level locks."""

    def __init__(self, mod: ModuleInfo):
        self.mod = mod
        self._class_stack: list[ClassInfo] = []
        self._fn_stack: list[str] = []

    # -- imports -------------------------------------------------------------

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            if alias.asname:
                self.mod.import_aliases[alias.asname] = alias.name
            else:
                root = alias.name.split(".")[0]
                self.mod.import_aliases[root] = root

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        target = self._resolve_from(node)
        if target is None:
            return
        for alias in node.names:
            self.mod.symbol_imports[alias.asname or alias.name] = \
                (target, alias.name)

    def _resolve_from(self, node: ast.ImportFrom) -> str | None:
        if node.level == 0:
            return node.module
        parts = self.mod.dotted.split(".")
        # for a module file, level 1 = its package
        parts = parts[: -node.level] if node.level <= len(parts) else []
        if node.module:
            parts = parts + node.module.split(".")
        return ".".join(parts) if parts else None

    # -- defs ----------------------------------------------------------------

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        ci = ClassInfo(self.mod.rel, node.name, node,
                       bases=[b.id if isinstance(b, ast.Name) else b.attr
                              for b in node.bases
                              if isinstance(b, (ast.Name, ast.Attribute))])
        # only top-level (and class-nested) classes are indexed by name
        if not self._fn_stack:
            self.mod.classes[node.name] = ci
        self._class_stack.append(ci)
        self.generic_visit(node)
        self._class_stack.pop()

    def _visit_fn(self, node) -> None:
        self._fn_stack.append(node.name)
        qual = ".".join(
            ([self._class_stack[-1].name] if self._class_stack else [])
            + self._fn_stack)
        fi = FunctionInfo(
            self.mod.rel, qual, node.name, node,
            class_name=self._class_stack[-1].name
            if self._class_stack else None)
        self.mod.functions[qual] = fi
        if self._class_stack and len(self._fn_stack) == 1:
            self._class_stack[-1].methods[node.name] = fi
        self.generic_visit(node)
        self._fn_stack.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    # -- assignments: locks + attribute types --------------------------------

    def visit_Assign(self, node: ast.Assign) -> None:
        ctor = self._lock_ctor(node.value)
        cls_name = self._attr_class(node.value)
        for t in node.targets:
            if isinstance(t, ast.Attribute) and \
                    isinstance(t.value, ast.Name) and \
                    t.value.id == "self" and self._class_stack:
                if ctor is not None:
                    self._class_stack[-1].lock_attrs[t.attr] = ctor
                elif cls_name is not None:
                    self._class_stack[-1].attr_types.setdefault(
                        t.attr, cls_name)
            elif isinstance(t, ast.Name) and not self._fn_stack and \
                    not self._class_stack and ctor is not None:
                self.mod.module_locks[t.id] = ctor
        self.generic_visit(node)

    @staticmethod
    def _lock_ctor(value: ast.expr) -> str | None:
        if not isinstance(value, ast.Call):
            return None
        fn = value.func
        if isinstance(fn, ast.Attribute) and \
                isinstance(fn.value, ast.Name) and \
                fn.value.id == "threading" and fn.attr in _LOCK_CTORS:
            return fn.attr
        if isinstance(fn, ast.Name) and fn.id in _LOCK_CTORS:
            return fn.id
        return None

    @staticmethod
    def _attr_class(value: ast.expr) -> str | None:
        if not isinstance(value, ast.Call):
            return None
        fn = value.func
        name = fn.id if isinstance(fn, ast.Name) else \
            fn.attr if isinstance(fn, ast.Attribute) else None
        return name if name and name[:1].isupper() else None


class ProjectIndex:
    """AST + cross-module symbol/call index over a set of sources."""

    def __init__(self, files: dict[str, str]):
        self.modules: dict[str, ModuleInfo] = {}
        self._dotted_to_rel: dict[str, str] = {}
        for rel in sorted(files):
            tree = ast.parse(files[rel], filename=rel)
            mod = ModuleInfo(rel, files[rel], tree, _dotted_of(rel))
            _Collector(mod).visit(tree)
            self.modules[rel] = mod
            self._dotted_to_rel[mod.dotted] = rel
        # global lookup tables for the fallback resolution tier
        self.classes_by_name: dict[str, list[ClassInfo]] = {}
        self.functions_by_name: dict[str, list[FunctionInfo]] = {}
        for mod in self.modules.values():
            for ci in mod.classes.values():
                self.classes_by_name.setdefault(ci.name, []).append(ci)
            for fi in mod.functions.values():
                self.functions_by_name.setdefault(fi.name, []).append(fi)
        # callback-kwarg bindings: Ctor(..., on_message=self._handler)
        # records (class name, kwarg) -> {handler refs}, so calling
        # ``self.on_message(...)`` later resolves to the real handlers
        self.callback_bindings: dict[tuple[str, str],
                                     set[str]] = {}
        self._fn_by_ref: dict[str, FunctionInfo] = {
            fi.ref: fi for mod in self.modules.values()
            for fi in mod.functions.values()}
        self._collect_callback_bindings()
        self._local_alias_cache: dict[str, dict[str, str]] = {}

    def _collect_callback_bindings(self) -> None:
        for mod in self.modules.values():
            for fi in mod.functions.values():
                for node in ast.walk(fi.node):
                    if not isinstance(node, ast.Call):
                        continue
                    cls = self._call_target_class(mod, node)
                    if cls is None:
                        continue
                    for kw in node.keywords:
                        handler = self._bound_handler(fi, kw.value)
                        if handler is not None and kw.arg:
                            self.callback_bindings.setdefault(
                                (cls, kw.arg), set()).add(handler.ref)

    def _call_target_class(self, mod: ModuleInfo,
                           call: ast.Call) -> str | None:
        fn = call.func
        name = fn.id if isinstance(fn, ast.Name) else \
            fn.attr if isinstance(fn, ast.Attribute) else None
        if name is None or name not in self.classes_by_name:
            return None
        return name

    def _bound_handler(self, fi: FunctionInfo,
                       value: ast.expr) -> FunctionInfo | None:
        if isinstance(value, ast.Attribute) and \
                isinstance(value.value, ast.Name) and \
                value.value.id == "self" and fi.class_name:
            ci = self.class_of(fi)
            return self.lookup_method(ci, value.attr) if ci else None
        if isinstance(value, ast.Name):
            return self.modules[fi.rel].functions.get(value.id)
        return None

    def local_aliases(self, fi: FunctionInfo) -> dict[str, str]:
        """{local name: self-attribute it aliases} — ``cb = self.on_x``
        (incl. the tuple-swap form ``cb, self.on_x = self.on_x, None``)."""
        cached = self._local_alias_cache.get(fi.ref)
        if cached is not None:
            return cached
        out: dict[str, str] = {}
        for node in ast.walk(fi.node):
            if not isinstance(node, ast.Assign):
                continue
            for t in node.targets:
                pairs = []
                if isinstance(t, ast.Tuple) and \
                        isinstance(node.value, ast.Tuple) and \
                        len(t.elts) == len(node.value.elts):
                    pairs = list(zip(t.elts, node.value.elts))
                else:
                    pairs = [(t, node.value)]
                for tgt, val in pairs:
                    if isinstance(tgt, ast.Name) and \
                            isinstance(val, ast.Attribute) and \
                            isinstance(val.value, ast.Name) and \
                            val.value.id == "self":
                        out[tgt.id] = val.attr
        self._local_alias_cache[fi.ref] = out
        return out

    def param_type(self, fi: FunctionInfo,
                   name: str) -> ClassInfo | None:
        """The project class a parameter's annotation names, if any."""
        args = fi.node.args
        for a in (list(args.posonlyargs) + list(args.args)
                  + list(args.kwonlyargs)):
            if a.arg != name or a.annotation is None:
                continue
            ann = a.annotation
            # unwrap "X | None" / Optional-style strings conservatively
            if isinstance(ann, ast.Constant) and \
                    isinstance(ann.value, str):
                ann_name = ann.value.split("|")[0].strip().split(".")[-1]
            elif isinstance(ann, ast.BinOp):
                left = ann.left
                ann_name = left.id if isinstance(left, ast.Name) else \
                    left.attr if isinstance(left, ast.Attribute) else None
            elif isinstance(ann, ast.Name):
                ann_name = ann.id
            elif isinstance(ann, ast.Attribute):
                ann_name = ann.attr
            else:
                ann_name = None
            if not ann_name:
                return None
            mod = self.modules[fi.rel]
            target = mod.classes.get(ann_name)
            if target is None and ann_name in mod.symbol_imports:
                dotted, sym = mod.symbol_imports[ann_name]
                m = self.module_for(dotted)
                target = m.classes.get(sym) if m else None
            if target is None:
                cands = self.classes_by_name.get(ann_name, [])
                target = cands[0] if len(cands) == 1 else None
            return target
        return None

    def fn_by_ref(self, ref: str) -> FunctionInfo | None:
        return self._fn_by_ref.get(ref)

    # -- construction --------------------------------------------------------

    @classmethod
    def from_tree(cls, root: Path | str = REPO_ROOT,
                  scan: tuple[str, ...] = DEFAULT_SCAN) -> "ProjectIndex":
        root = Path(root)
        files: dict[str, str] = {}
        for entry in scan:
            p = root / entry
            paths = [p] if p.is_file() else sorted(p.rglob("*.py"))
            for path in paths:
                files[path.relative_to(root).as_posix()] = \
                    path.read_text()
        return cls(files)

    # -- lookups -------------------------------------------------------------

    def module_for(self, dotted: str) -> ModuleInfo | None:
        rel = self._dotted_to_rel.get(dotted)
        return self.modules.get(rel) if rel else None

    def iter_modules(self, scope: tuple[str, ...] = ()
                     ) -> list[ModuleInfo]:
        if not scope:
            return list(self.modules.values())
        return [m for rel, m in self.modules.items()
                if in_scope(rel, scope)]

    def class_of(self, fi: FunctionInfo) -> ClassInfo | None:
        if fi.class_name is None:
            return None
        return self.modules[fi.rel].classes.get(fi.class_name)

    def _bases_of(self, ci: ClassInfo) -> list[ClassInfo]:
        out = []
        mod = self.modules[ci.rel]
        for base in ci.bases:
            target = mod.classes.get(base)
            if target is None and base in mod.symbol_imports:
                dotted, sym = mod.symbol_imports[base]
                m = self.module_for(dotted)
                target = m.classes.get(sym) if m else None
            if target is None:
                cands = self.classes_by_name.get(base, [])
                target = cands[0] if len(cands) == 1 else None
            if target is not None:
                out.append(target)
        return out

    def lookup_method(self, ci: ClassInfo, name: str,
                      _depth: int = 0) -> FunctionInfo | None:
        if name in ci.methods:
            return ci.methods[name]
        if _depth > 4:
            return None
        for base in self._bases_of(ci):
            hit = self.lookup_method(base, name, _depth + 1)
            if hit is not None:
                return hit
        return None

    def lock_attr_owner(self, ci: ClassInfo, attr: str,
                        _depth: int = 0) -> tuple[str, str] | None:
        """(defining class name, ctor) for a lock attribute, following
        project base classes."""
        if attr in ci.lock_attrs:
            return (ci.name, ci.lock_attrs[attr])
        if _depth > 4:
            return None
        for base in self._bases_of(ci):
            hit = self.lock_attr_owner(base, attr, _depth + 1)
            if hit is not None:
                return hit
        return None

    def attr_type(self, ci: ClassInfo, attr: str,
                  _depth: int = 0) -> ClassInfo | None:
        name = ci.attr_types.get(attr)
        if name is None and _depth <= 4:
            for base in self._bases_of(ci):
                hit = self.attr_type(base, attr, _depth + 1)
                if hit is not None:
                    return hit
            return None
        if name is None:
            return None
        mod = self.modules[ci.rel]
        target = mod.classes.get(name)
        if target is None and name in mod.symbol_imports:
            dotted, sym = mod.symbol_imports[name]
            m = self.module_for(dotted)
            target = m.classes.get(sym) if m else None
        if target is None:
            cands = self.classes_by_name.get(name, [])
            target = cands[0] if len(cands) == 1 else None
        return target

    # -- call resolution -----------------------------------------------------

    def _resolve_self_method(self, fi: FunctionInfo,
                             meth: str) -> list[FunctionInfo]:
        """``self.<meth>(...)``: a real method of the class (+ bases),
        else the handlers bound to that attribute at construction
        sites (``Ctor(..., on_message=self._on_message)``), else the
        unique-name fallback."""
        ci = self.class_of(fi)
        if ci is not None:
            hit = self.lookup_method(ci, meth)
            if hit is not None:
                return [hit]
            names = [ci.name] + list(ci.bases)
            refs: set[str] = set()
            for n in names:
                refs |= self.callback_bindings.get((n, meth), set())
            if refs:
                return [self._fn_by_ref[r] for r in sorted(refs)
                        if r in self._fn_by_ref]
        return self._unique(meth, methods_only=True)

    def resolve_call(self, fi: FunctionInfo,
                     call: ast.Call) -> list[FunctionInfo]:
        """Best-effort callee resolution, tiered:

        1. ``self.m()``        → method of the enclosing class (+ bases);
        2. ``self.attr.m()``   → method of ``attr``'s known type;
        3. ``mod.f()`` / ``f()`` → module function via import aliases /
           same-module / from-imports;
        4. unique-name fallback: exactly ONE project function carries
           the name (cross-module edges like ``conn.update_interest`` →
           ``Reactor.update_interest`` resolve here).
        """
        fn = call.func
        mod = self.modules[fi.rel]
        if isinstance(fn, ast.Name):
            hit = mod.functions.get(fn.id)
            if hit is not None:
                return [hit]
            # a local alias of a stored self-callback:
            # ``cb = self.on_closed; ...; cb(self, exc)``
            aliased = self.local_aliases(fi).get(fn.id)
            if aliased is not None and fi.class_name is not None:
                return self._resolve_self_method(fi, aliased)
            if fn.id in mod.symbol_imports:
                dotted, sym = mod.symbol_imports[fn.id]
                m = self.module_for(dotted)
                if m and sym in m.functions:
                    return [m.functions[sym]]
            return self._unique(fn.id)
        if not isinstance(fn, ast.Attribute):
            return []
        recv, meth = fn.value, fn.attr
        if isinstance(recv, ast.Name):
            if recv.id == "self" and fi.class_name is not None:
                return self._resolve_self_method(fi, meth)
            if recv.id in mod.import_aliases:
                m = self.module_for(mod.import_aliases[recv.id])
                if m and meth in m.functions:
                    return [m.functions[meth]]
                return []
            if recv.id in mod.symbol_imports:
                # from .reactor import client_reactor; from . import net
                dotted, sym = mod.symbol_imports[recv.id]
                m = self.module_for(f"{dotted}.{sym}") or \
                    self.module_for(dotted)
                if m is not None:
                    if meth in m.functions:
                        return [m.functions[meth]]
                    if sym in m.classes:
                        hit = self.lookup_method(m.classes[sym], meth)
                        return [hit] if hit else []
                return self._unique(meth, methods_only=True)
            # an annotated parameter: ``def f(self, conn: AsyncConnection)``
            pt = self.param_type(fi, recv.id)
            if pt is not None:
                hit = self.lookup_method(pt, meth)
                if hit is not None:
                    return [hit]
                refs = self.callback_bindings.get((pt.name, meth))
                if refs:
                    return [self._fn_by_ref[r] for r in sorted(refs)
                            if r in self._fn_by_ref]
                return []
            return self._unique(meth, methods_only=True)
        if isinstance(recv, ast.Attribute) and \
                isinstance(recv.value, ast.Name) and \
                recv.value.id == "self" and fi.class_name is not None:
            ci = self.class_of(fi)
            target = self.attr_type(ci, recv.attr) if ci else None
            if target is not None:
                hit = self.lookup_method(target, meth)
                if hit is not None:
                    return [hit]
        return self._unique(meth, methods_only=True)

    def _unique(self, name: str,
                methods_only: bool = False) -> list[FunctionInfo]:
        cands = self.functions_by_name.get(name, [])
        if methods_only:
            cands = [c for c in cands if c.class_name is not None]
        # dunder/tiny-verb names are everywhere: never unique-resolve
        if name.startswith("__") or len(cands) != 1:
            return []
        return cands


def in_scope(rel: str, scope: tuple[str, ...]) -> bool:
    return any(rel == s or rel.startswith(s.rstrip("/") + "/")
               for s in scope)


# -- rule registry -----------------------------------------------------------

@dataclass(frozen=True)
class Rule:
    id: str
    severity: str
    description: str
    scope: tuple[str, ...]          # () = the whole index
    check: object                   # fn(index, rule) -> list[Finding]


_RULES: dict[str, Rule] = {}


def rule(rule_id: str, *, severity: str, description: str,
         scope: tuple[str, ...] = ()):
    """Declare a rule: the decorated fn(index) yields Findings."""
    assert severity in SEVERITIES, severity
    assert rule_id not in _RULES, f"duplicate rule id {rule_id}"

    def deco(fn):
        _RULES[rule_id] = Rule(rule_id, severity, description,
                               tuple(scope), fn)
        return fn
    return deco


def all_rules() -> dict[str, Rule]:
    return dict(_RULES)


def get_rule(rule_id: str) -> Rule:
    return _RULES[rule_id]


def make_finding(r: Rule, rel: str, line: int, message: str) -> Finding:
    return Finding(r.id, rel, int(line), r.severity, message)


def run_rules(index: ProjectIndex,
              rule_ids: tuple[str, ...] | None = None) -> list[Finding]:
    out: list[Finding] = []
    for rid in sorted(rule_ids if rule_ids is not None else _RULES):
        r = _RULES[rid]
        out.extend(r.check(index))
    # dedupe (reachability rules can report one site via two paths)
    return sorted(set(out),
                  key=lambda f: (f.path, f.line, f.rule, f.message))


_default_index: ProjectIndex | None = None


def default_index(refresh: bool = False) -> ProjectIndex:
    """The whole-tree index, built once per process (rules and wrapper
    tests share it; the CLI refreshes)."""
    global _default_index
    if _default_index is None or refresh:
        _default_index = ProjectIndex.from_tree()
    return _default_index


def run_rule_on_sources(rule_id: str, sources: dict[str, str]
                        ) -> list[Finding]:
    """Run ONE rule against synthetic sources (fixture testing).  A bare
    filename is placed inside the rule's first scope directory so the
    rule's own path filter admits it."""
    r = _RULES[rule_id]
    placed: dict[str, str] = {}
    for name, text in sources.items():
        if "/" not in name and r.scope:
            anchor = next((s for s in r.scope if not s.endswith(".py")),
                          r.scope[0])
            name = name if anchor.endswith(".py") else \
                f"{anchor.rstrip('/')}/{name}"
        placed[name] = text
    return r.check(ProjectIndex(placed))


# -- baseline ----------------------------------------------------------------

BASELINE_FILE = "ceph_tpu_torch/analysis/baseline.json"


def load_baseline(path: Path | str | None = None) -> dict[tuple, str]:
    """{finding key: justification}.  Missing file = empty baseline."""
    p = Path(path) if path is not None else REPO_ROOT / BASELINE_FILE
    if not p.exists():
        return {}
    doc = json.loads(p.read_text())
    out: dict[tuple, str] = {}
    for e in doc.get("entries", []):
        out[(e["rule"], e["path"], e["message"])] = \
            e.get("justification", "")
    return out


def write_baseline(findings: list[Finding],
                   justification: str,
                   path: Path | str | None = None) -> None:
    p = Path(path) if path is not None else REPO_ROOT / BASELINE_FILE
    seen: set[tuple] = set()
    entries = []
    for f in findings:
        if f.key in seen:
            continue
        seen.add(f.key)
        entries.append({"rule": f.rule, "path": f.path,
                        "message": f.message,
                        "justification": justification})
    p.write_text(json.dumps({"version": 1, "entries": entries},
                            indent=1) + "\n")


def split_by_baseline(findings: list[Finding],
                      baseline: dict[tuple, str]
                      ) -> tuple[list[Finding], list[Finding], list[tuple]]:
    """(new, suppressed, stale baseline keys)."""
    new = [f for f in findings if f.key not in baseline]
    suppressed = [f for f in findings if f.key in baseline]
    live = {f.key for f in findings}
    stale = [k for k in baseline if k not in live]
    return new, suppressed, stale
