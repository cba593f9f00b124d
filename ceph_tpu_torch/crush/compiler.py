"""Crushmap text-format compiler/decompiler.

Analog of the reference's CrushCompiler (reference:
src/crush/CrushCompiler.{h,cc} — the ``crushtool -d``/``-c`` text format),
re-expressed as a tokenizer + recursive-descent parser over this
framework's :class:`~ceph_tpu_torch.crush.map.CrushMap`.  Format mirrored
line-for-line from the reference's decompile output
(CrushCompiler.cc:299-470):

- ``tunable <name> <value>`` lines;
- ``device <id> <name> [class <c>]``;
- ``type <id> <name>``;
- bucket blocks ``<typename> <name> { id -N; alg straw2; hash 0;
  item <name> weight <w> [pos <p>]; ... }`` with 16.16 weights printed as
  3-decimal floats (CrushCompiler.cc:85-90 print_fixedpoint — the text
  format is deliberately lossy below 0.001, exactly like the reference);
- rule blocks ``rule <name> { id N; type replicated|erasure; min_size;
  max_size; step take <name>; step choose[leaf] firstn|indep N type <t>;
  step set_*; step emit }``;
- ``choose_args <id> { { bucket_id -N  weight_set [ [ ... ] ]
  ids [ ... ] } }`` blocks (CrushCompiler.cc:214-296).

``decompile(compile_crushmap(text))`` is idempotent on normalized text;
``compile_crushmap(decompile(m))`` reproduces ``m``'s placements exactly
for weights representable at 3 decimals.
"""
from __future__ import annotations

import re

from .map import (CRUSH_BUCKET_LIST, CRUSH_BUCKET_STRAW, CRUSH_BUCKET_STRAW2,
                  CRUSH_BUCKET_TREE, CRUSH_BUCKET_UNIFORM,
                  CRUSH_RULE_CHOOSELEAF_FIRSTN, CRUSH_RULE_CHOOSELEAF_INDEP,
                  CRUSH_RULE_CHOOSE_FIRSTN, CRUSH_RULE_CHOOSE_INDEP,
                  CRUSH_RULE_EMIT, CRUSH_RULE_SET_CHOOSELEAF_STABLE,
                  CRUSH_RULE_SET_CHOOSELEAF_TRIES,
                  CRUSH_RULE_SET_CHOOSELEAF_VARY_R,
                  CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
                  CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES,
                  CRUSH_RULE_SET_CHOOSE_TRIES, CRUSH_RULE_TAKE, CrushMap)

ALG_NAMES = {CRUSH_BUCKET_UNIFORM: "uniform", CRUSH_BUCKET_LIST: "list",
             CRUSH_BUCKET_TREE: "tree", CRUSH_BUCKET_STRAW: "straw",
             CRUSH_BUCKET_STRAW2: "straw2"}
ALG_IDS = {v: k for k, v in ALG_NAMES.items()}

RULE_TYPE_NAMES = {1: "replicated", 3: "erasure"}
RULE_TYPE_IDS = {v: k for k, v in RULE_TYPE_NAMES.items()}

SET_STEPS = {
    "set_choose_tries": CRUSH_RULE_SET_CHOOSE_TRIES,
    "set_choose_local_tries": CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES,
    "set_choose_local_fallback_tries":
        CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
    "set_chooseleaf_tries": CRUSH_RULE_SET_CHOOSELEAF_TRIES,
    "set_chooseleaf_vary_r": CRUSH_RULE_SET_CHOOSELEAF_VARY_R,
    "set_chooseleaf_stable": CRUSH_RULE_SET_CHOOSELEAF_STABLE,
}
SET_STEP_NAMES = {v: k for k, v in SET_STEPS.items()}

CHOOSE_STEPS = {
    ("choose", "firstn"): CRUSH_RULE_CHOOSE_FIRSTN,
    ("choose", "indep"): CRUSH_RULE_CHOOSE_INDEP,
    ("chooseleaf", "firstn"): CRUSH_RULE_CHOOSELEAF_FIRSTN,
    ("chooseleaf", "indep"): CRUSH_RULE_CHOOSELEAF_INDEP,
}
CHOOSE_STEP_NAMES = {v: k for k, v in CHOOSE_STEPS.items()}

TUNABLE_ORDER = ["choose_local_tries", "choose_local_fallback_tries",
                 "choose_total_tries", "chooseleaf_descend_once",
                 "chooseleaf_vary_r", "chooseleaf_stable"]


def _fixed(w: int) -> str:
    """16.16 -> text (print_fixedpoint, CrushCompiler.cc:85-90)."""
    return f"{w / 0x10000:.3f}"


def _unfixed(s: str) -> int:
    return int(round(float(s) * 0x10000))


# -- decompile (CrushCompiler.cc:299-470) -------------------------------------

def _item_name(m: CrushMap, item: int) -> str:
    name = m.item_names.get(item)
    if name:
        return name
    return f"osd.{item}" if item >= 0 else f"bucket{-1 - item}"


def decompile(m: CrushMap) -> str:
    # straw(v1) buckets round-trip because compile rebuilds their straw
    # lengths via crush_calc_straw parity — but ONLY under the same
    # straw_calc_version.  Loaded reference dumps carry straws as data
    # without the tunable (crush_create defaults to v0, builder.c:1506),
    # so detect which version reproduces the stored straws and pin it in
    # the emitted tunables; refuse if neither does (silent placement
    # divergence otherwise — the v0/v1 split shows on repeated weights).
    tunables = dict(m.tunables)
    straw_buckets = [b for b in m.buckets.values()
                     if b.alg == CRUSH_BUCKET_STRAW and b.straws]
    if straw_buckets:
        from .map import calc_straw_lengths
        declared = tunables.get("straw_calc_version")
        candidates = [int(declared)] if declared is not None else [1, 0]
        scv = next(
            (v for v in candidates
             if all(b.item_weights is not None and
                    b.straws == calc_straw_lengths(b.item_weights, v)
                    for b in straw_buckets)), None)
        if scv is None:
            raise ValueError(
                "straw(v1) straw lengths match no straw_calc_version; "
                "the text form cannot reproduce them — convert to straw2")
        tunables["straw_calc_version"] = scv
    out = ["# begin crush map"]
    for t in TUNABLE_ORDER:
        out.append(f"tunable {t} {int(tunables[t])}")
    for t in sorted(set(tunables) - set(TUNABLE_ORDER)):
        out.append(f"tunable {t} {int(tunables[t])}")

    out.append("")
    out.append("# devices")
    classes = m.device_classes
    devices = {i for b in m.buckets.values() for i in b.items if i >= 0}
    devices |= {d for d in m.item_names if d >= 0}
    # placeholder names keep max_devices stable across the round trip
    # (unreferenced slots would otherwise vanish and renumber weights)
    devices |= set(range(m.max_devices))
    for i in sorted(devices):
        line = f"device {i} {_item_name(m, i)}" if i in m.item_names or \
            any(i in b.items for b in m.buckets.values()) else \
            f"device {i} device{i}"
        if i in classes:
            line += f" class {classes[i]}"
        out.append(line)

    out.append("")
    out.append("# types")
    used_types = {b.type for b in m.buckets.values()}
    type_names = dict(m.type_names)
    for t in used_types - set(type_names):
        type_names[t] = f"type{t}"       # unnamed type: synthesize so the
    for t in sorted(type_names):         # text recompiles
        out.append(f"type {t} {type_names[t]}")

    out.append("")
    out.append("# buckets")
    # the reference walks ids from -1 downward (CrushCompiler.cc:345);
    # emit children before parents so the text compiles in one pass
    emitted: set[int] = set()

    def emit_bucket(bid: int) -> None:
        if bid in emitted:
            return
        b = m.buckets[bid]
        for item in b.items:
            if item < 0 and item in m.buckets:
                emit_bucket(item)
        emitted.add(bid)
        tname = m.type_names.get(b.type, f"type{b.type}")
        out.append(f"{tname} {_item_name(m, bid)} {{")
        out.append(f"\tid {bid}\t\t# do not change unnecessarily")
        # per-class shadow ids (CrushCompiler.cc decompile_bucket: the
        # clones themselves are not dumped; their ids are recorded here
        # so a recompile reuses them)
        for c, sid in sorted(m.class_bucket.get(bid, {}).items()):
            out.append(f"\tid {sid} class {c}\t\t# do not change "
                       f"unnecessarily")
        out.append(f"\t# weight {_fixed(b.weight)}")
        out.append(f"\talg {ALG_NAMES[b.alg]}")
        out.append(f"\thash {b.hash}\t# rjenkins1")
        for j, item in enumerate(b.items):
            if b.alg == CRUSH_BUCKET_UNIFORM:
                w = b.item_weight or 0
            else:
                w = (b.item_weights or [0] * b.size)[j]
            out.append(f"\titem {_item_name(m, item)} weight {_fixed(w)}")
        out.append("}")

    for bid in sorted(m.buckets, reverse=True):     # -1, -2, ...
        if not m.is_shadow(bid):      # shadow trees rebuild on compile
            emit_bucket(bid)

    out.append("")
    out.append("# rules")
    name_of_rule = {v: k for k, v in m.rule_names.items()}
    shadow_of = {sid: (orig, c)
                 for orig, cb in m.class_bucket.items()
                 for c, sid in cb.items()}
    for ruleno in sorted(m.rules):
        rule = m.rules[ruleno]
        rname = name_of_rule.get(ruleno, f"rule{ruleno}")
        out.append(f"rule {rname} {{")
        out.append(f"\tid {ruleno}")
        rtype = getattr(rule, "type", 1)
        out.append(f"\ttype {RULE_TYPE_NAMES.get(rtype, str(rtype))}")
        out.append(f"\tmin_size {getattr(rule, 'min_size', 1)}")
        out.append(f"\tmax_size {getattr(rule, 'max_size', 10)}")
        for op, arg1, arg2 in rule.steps:
            if op == CRUSH_RULE_TAKE:
                if arg1 in shadow_of:
                    orig, c = shadow_of[arg1]
                    out.append(f"\tstep take {_item_name(m, orig)} "
                               f"class {c}")
                else:
                    out.append(f"\tstep take {_item_name(m, arg1)}")
            elif op == CRUSH_RULE_EMIT:
                out.append("\tstep emit")
            elif op in SET_STEP_NAMES:
                out.append(f"\tstep {SET_STEP_NAMES[op]} {arg1}")
            elif op in CHOOSE_STEP_NAMES:
                verb, mode = CHOOSE_STEP_NAMES[op]
                tname = m.type_names.get(arg2, str(arg2))
                out.append(f"\tstep {verb} {mode} {arg1} type {tname}")
            else:
                raise ValueError(f"cannot decompile step op {op}")
        out.append("}")

    if m.choose_args:
        out.append("")
        out.append("# choose_args")
        for set_id in sorted(m.choose_args):
            out.append(f"choose_args {set_id} {{")
            args = m.choose_args[set_id]
            for bid in sorted(args, reverse=True):
                arg = args[bid]
                out.append("  {")
                out.append(f"    bucket_id {bid}")
                wset = arg.get("weight_set")
                if wset:
                    out.append("    weight_set [")
                    for row in wset:
                        out.append("      [ " +
                                   " ".join(_fixed(w) for w in row) + " ]")
                    out.append("    ]")
                if arg.get("ids"):
                    out.append("    ids [ " +
                               " ".join(str(i) for i in arg["ids"]) + " ]")
                out.append("  }")
            out.append("}")

    out.append("")
    out.append("# end crush map")
    return "\n".join(out) + "\n"


# -- compile ------------------------------------------------------------------

_TOKEN = re.compile(r"[{}\[\]]|[^\s{}\[\]]+")


def _tokenize(text: str) -> list[str]:
    toks = []
    for line in text.splitlines():
        line = line.split("#", 1)[0]
        toks.extend(_TOKEN.findall(line))
    return toks


class _Parser:
    def __init__(self, toks: list[str]):
        self.toks = toks
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> str:
        if self.i >= len(self.toks):
            raise ValueError("unexpected end of crushmap text")
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, tok: str) -> None:
        got = self.next()
        if got != tok:
            raise ValueError(f"expected {tok!r}, got {got!r} "
                             f"(token {self.i - 1})")


def compile_crushmap(text: str) -> CrushMap:
    """Parse crushmap text into a CrushMap (CrushCompiler parse_* shape)."""
    p = _Parser(_tokenize(text))
    m = CrushMap()
    m.type_names = {}
    m.device_classes = {}
    name_to_id: dict[str, int] = {}
    next_auto_id = -1
    max_device_line = 0       # device lines pin max_devices (holes incl.)
    while p.peek() is not None:
        tok = p.next()
        if tok == "tunable":
            name, val = p.next(), int(p.next())
            m.tunables[name] = val
        elif tok == "device":
            dev_id = int(p.next())
            name = p.next()
            name_to_id[name] = dev_id
            max_device_line = max(max_device_line, dev_id + 1)
            if not re.fullmatch(r"device\d+", name):
                m.item_names[dev_id] = name
            if p.peek() == "class":
                p.next()
                m.device_classes[dev_id] = p.next()
        elif tok == "type":
            tid = int(p.next())
            m.type_names[tid] = p.next()
        elif tok == "rule":
            _parse_rule(p, m, name_to_id)
        elif tok == "choose_args":
            _parse_choose_args(p, m, name_to_id)
        elif tok in m.type_names.values():
            next_auto_id = _parse_bucket(p, m, tok, name_to_id, next_auto_id)
        else:
            raise ValueError(f"unexpected token {tok!r}")
    # materialize any reserved shadow trees no rule referenced, so the
    # class_bucket table (and its ids) survives the round trip
    for (bid, cls) in list(m._shadow_id_hints):
        if bid in m.buckets:
            m.device_class_clone(bid, cls)
    m.finalize()
    m.max_devices = max(m.max_devices, max_device_line)
    return m


def _parse_bucket(p: _Parser, m: CrushMap, tname: str, name_to_id,
                  next_auto_id: int) -> int:
    bname = p.next()
    p.expect("{")
    bid = None
    alg = CRUSH_BUCKET_STRAW2
    hash_ = 0
    items: list[int] = []
    weights: list[int] = []
    class_ids: list[tuple[int, str]] = []   # (shadow id, class) lines
    while True:
        tok = p.next()
        if tok == "}":
            break
        if tok == "id":
            val = int(p.next())
            if p.peek() == "class":       # per-class shadow id
                p.next()
                class_ids.append((val, p.next()))
            else:
                bid = val
        elif tok == "alg":
            alg = ALG_IDS[p.next()]
        elif tok == "hash":
            hash_ = int(p.next())
        elif tok == "item":
            iname = p.next()
            w = 0
            pos = len(items)
            while p.peek() in ("weight", "pos"):
                what = p.next()
                if what == "weight":
                    w = _unfixed(p.next())
                else:
                    pos = int(p.next())
            while len(items) <= pos:
                items.append(None)
                weights.append(0)
            items[pos] = item_by_name_or_fail(iname, name_to_id)
            weights[pos] = w
        else:
            raise ValueError(f"unexpected token {tok!r} in bucket {bname!r}")
    if any(i is None for i in items):
        raise ValueError(f"bucket {bname!r} has item position holes")
    if bid is None:
        while next_auto_id in m.buckets:
            next_auto_id -= 1
        bid = next_auto_id
        next_auto_id -= 1
    type_id = {v: k for k, v in m.type_names.items()}[tname]
    if alg == CRUSH_BUCKET_UNIFORM:
        uw = weights[0] if weights else 0
        m.add_bucket(alg, type_id, items, id=bid, uniform_weight=uw)
    else:
        m.add_bucket(alg, type_id, items, weights, id=bid)
    m.buckets[bid].hash = hash_
    m.set_item_name(bid, bname)
    name_to_id[bname] = bid
    for sid, cls in class_ids:
        # reserve the dumped shadow id; the clone itself is rebuilt once
        # every bucket is parsed (CrushWrapper::populate_classes with
        # old_class_bucket id reuse)
        m._shadow_id_hints[(bid, cls)] = sid
    return next_auto_id


def item_by_name_or_fail(name: str, name_to_id: dict) -> int:
    if name in name_to_id:
        return name_to_id[name]
    if re.fullmatch(r"osd\.\d+", name):
        return int(name.split(".")[1])
    raise ValueError(f"unknown item {name!r} (define it first)")


def _parse_rule(p: _Parser, m: CrushMap, name_to_id) -> None:
    rname = p.next()
    p.expect("{")
    ruleno = None
    rtype = 1
    min_size, max_size = 1, 10
    steps: list[tuple[int, int, int]] = []
    type_ids = {v: k for k, v in m.type_names.items()}
    while True:
        tok = p.next()
        if tok == "}":
            break
        if tok == "id" or tok == "ruleset":
            ruleno = int(p.next())
        elif tok == "type":
            t = p.next()
            rtype = RULE_TYPE_IDS.get(t, None)
            if rtype is None:
                rtype = int(t)
        elif tok == "min_size":
            min_size = int(p.next())
        elif tok == "max_size":
            max_size = int(p.next())
        elif tok == "step":
            verb = p.next()
            if verb == "take":
                name = p.next()
                item = item_by_name_or_fail(name, name_to_id)
                if p.peek() == "class":
                    p.next()
                    cls = p.next()
                    if item >= 0:
                        raise ValueError(
                            f"step take {name} class {cls}: class takes "
                            f"need a bucket, not a device")
                    if cls not in set(m.device_classes.values()):
                        # the reference compiler rejects unknown classes
                        # at compile time (a typo would otherwise build
                        # an empty shadow tree that maps only holes)
                        raise ValueError(
                            f"step take {name} class {cls}: device class "
                            f"{cls!r} is not assigned to any device")
                    item = m.device_class_clone(item, cls)
                steps.append((CRUSH_RULE_TAKE, item, 0))
            elif verb == "emit":
                steps.append((CRUSH_RULE_EMIT, 0, 0))
            elif verb in ("choose", "chooseleaf"):
                mode = p.next()
                n = int(p.next())
                p.expect("type")
                t = p.next()
                ttype = type_ids[t] if t in type_ids else int(t)
                steps.append((CHOOSE_STEPS[(verb, mode)], n, ttype))
            elif verb in SET_STEPS:
                steps.append((SET_STEPS[verb], int(p.next()), 0))
            else:
                raise ValueError(f"unknown rule step {verb!r}")
        else:
            raise ValueError(f"unexpected token {tok!r} in rule {rname!r}")
    ruleno = m.add_rule(steps, ruleno=ruleno)
    rule = m.rules[ruleno]
    rule.type = rtype
    rule.min_size = min_size
    rule.max_size = max_size
    m.rule_names[rname] = ruleno


def _parse_choose_args(p: _Parser, m: CrushMap, name_to_id) -> None:
    set_id = int(p.next())
    p.expect("{")
    args: dict[int, dict] = {}
    while True:
        tok = p.next()
        if tok == "}":
            break
        if tok != "{":
            raise ValueError(f"expected {{ in choose_args, got {tok!r}")
        arg: dict = {}
        bid = None
        while True:
            t2 = p.next()
            if t2 == "}":
                break
            if t2 == "bucket_id":
                bid = int(p.next())
            elif t2 == "weight_set":
                p.expect("[")
                wset = []
                while p.peek() == "[":
                    p.next()
                    row = []
                    while p.peek() != "]":
                        row.append(_unfixed(p.next()))
                    p.next()
                    wset.append(row)
                p.expect("]")
                arg["weight_set"] = wset
            elif t2 == "ids":
                p.expect("[")
                ids = []
                while p.peek() != "]":
                    ids.append(int(p.next()))
                p.next()
                arg["ids"] = ids
            else:
                raise ValueError(f"unexpected {t2!r} in choose_args")
        if bid is None:
            raise ValueError("choose_args entry missing bucket_id")
        args[bid] = arg
    m.choose_args[set_id] = args
