"""CRUSH map data model + builder.

Python analog of the reference's map structs and builder API
(reference: src/crush/crush.h:52-239, src/crush/builder.c): buckets with the
five algorithms (UNIFORM/LIST/TREE/STRAW/STRAW2), rules as (op, arg1, arg2)
step lists, and the map-level tunables.  The builder computes the derived
per-algorithm data (list sum_weights, tree node_weights) the same way the
reference does, and ``finalize`` computes ``max_devices``.

Serialisable via from_dict/to_dict — the golden tests load maps dumped by
the reference builder (tools/golden/golden_gen.c) through from_dict.
"""
from __future__ import annotations

from dataclasses import dataclass, field

# bucket algorithms (crush.h:123-191)
CRUSH_BUCKET_UNIFORM = 1
CRUSH_BUCKET_LIST = 2
CRUSH_BUCKET_TREE = 3
CRUSH_BUCKET_STRAW = 4
CRUSH_BUCKET_STRAW2 = 5

# rule step opcodes (crush.h:52-70)
CRUSH_RULE_NOOP = 0
CRUSH_RULE_TAKE = 1
CRUSH_RULE_CHOOSE_FIRSTN = 2
CRUSH_RULE_CHOOSE_INDEP = 3
CRUSH_RULE_EMIT = 4
CRUSH_RULE_CHOOSELEAF_FIRSTN = 6
CRUSH_RULE_CHOOSELEAF_INDEP = 7
CRUSH_RULE_SET_CHOOSE_TRIES = 8
CRUSH_RULE_SET_CHOOSELEAF_TRIES = 9
CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES = 10
CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES = 11
CRUSH_RULE_SET_CHOOSELEAF_VARY_R = 12
CRUSH_RULE_SET_CHOOSELEAF_STABLE = 13

CRUSH_ITEM_UNDEF = 0x7FFFFFFE   # crush.h (mapping undefined)
CRUSH_ITEM_NONE = 0x7FFFFFFF    # no item (EC positional hole)

CRUSH_HASH_RJENKINS1 = 0


@dataclass
class Bucket:
    id: int
    alg: int
    type: int
    items: list[int]
    weight: int = 0                         # 16.16 cumulative
    hash: int = CRUSH_HASH_RJENKINS1
    item_weights: list[int] | None = None   # list/straw/straw2
    sum_weights: list[int] | None = None    # list
    item_weight: int | None = None          # uniform
    num_nodes: int | None = None            # tree
    node_weights: list[int] | None = None   # tree
    straws: list[int] | None = None         # straw v1

    @property
    def size(self) -> int:
        return len(self.items)


@dataclass
class Rule:
    steps: list[tuple[int, int, int]]
    ruleno: int = -1
    # rule mask metadata (crush_rule_mask; carried for the text-format
    # round trip, reference: CrushCompiler.cc:365-377)
    type: int = 1                 # 1=replicated, 3=erasure
    min_size: int = 1
    max_size: int = 10


def calc_straw_lengths(weights: list[int], version: int = 1) -> list[int]:
    """Legacy straw(v1) straw lengths (builder.c:427 crush_calc_straw,
    transcribed exactly — including its acknowledged-flawed horizontal
    slicing — because placement bit-equality with reference-built straw
    maps is the requirement).  Honours both straw_calc_version profiles
    (crush.h:446): v1 (modern default) and the v0 legacy same-weight
    special case; they differ only for repeated or zero weights."""
    import math
    size = len(weights)
    straws = [0] * size
    if not size:
        return straws
    # builder.c's insertion sort is ascending and tie-stable
    order = sorted(range(size), key=lambda i: weights[i])
    numleft = size
    straw = 1.0
    wbelow = 0.0
    lastw = 0.0
    i = 0
    while i < size:
        if version == 0:
            if weights[order[i]] == 0:
                straws[order[i]] = 0
                i += 1
                continue
            straws[order[i]] = int(straw * 0x10000)
            i += 1
            if i == size:
                break
            if weights[order[i]] == weights[order[i - 1]]:
                continue                # same straw for equal weights
            wbelow += (weights[order[i - 1]] - lastw) * numleft
            j = i
            while j < size and weights[order[j]] == weights[order[i]]:
                numleft -= 1
                j += 1
            wnext = numleft * (weights[order[i]] - weights[order[i - 1]])
            pbelow = wbelow / (wbelow + wnext)
            straw *= math.pow(1.0 / pbelow, 1.0 / numleft)
            lastw = weights[order[i - 1]]
        else:
            if weights[order[i]] == 0:
                straws[order[i]] = 0
                i += 1
                numleft -= 1
                continue
            straws[order[i]] = int(straw * 0x10000)
            i += 1
            if i == size:
                break
            wbelow += (weights[order[i - 1]] - lastw) * numleft
            numleft -= 1
            wnext = numleft * (weights[order[i]] - weights[order[i - 1]])
            pbelow = wbelow / (wbelow + wnext)
            straw *= math.pow(1.0 / pbelow, 1.0 / numleft)
            lastw = weights[order[i - 1]]
    return straws


# optimal tunable profile (builder.c set_optimal_crush_map semantics)
OPTIMAL_TUNABLES = dict(choose_local_tries=0, choose_local_fallback_tries=0,
                        choose_total_tries=50, chooseleaf_descend_once=1,
                        chooseleaf_vary_r=1, chooseleaf_stable=1)
# legacy profile (builder.h set_legacy_crush_map doc)
LEGACY_TUNABLES = dict(choose_local_tries=2, choose_local_fallback_tries=5,
                       choose_total_tries=19, chooseleaf_descend_once=0,
                       chooseleaf_vary_r=0, chooseleaf_stable=0)


class CrushMap:
    def __init__(self, tunables: dict | None = None):
        self.buckets: dict[int, Bucket] = {}       # id (negative) -> Bucket
        self.rules: dict[int, Rule] = {}
        self.tunables = dict(OPTIMAL_TUNABLES)
        if tunables:
            self.tunables.update(tunables)
        self.max_devices = 0
        # CrushWrapper-style naming (reference: src/crush/CrushWrapper.h)
        self.type_names: dict[int, str] = {0: "osd"}
        self.item_names: dict[int, str] = {}
        self.rule_names: dict[str, int] = {}
        self.choose_args: dict[int, object] = {}
        self.device_classes: dict[int, str] = {}
        # original bucket id -> device class -> shadow bucket id
        # (CrushWrapper::class_bucket, CrushWrapper.h:1335)
        self.class_bucket: dict[int, dict[str, int]] = {}
        # (original id, class) -> shadow id reservations, installed by the
        # text compiler from 'id <sid> class <c>' lines so recompiled maps
        # keep their shadow ids (the reference's old_class_bucket reuse,
        # CrushWrapper.cc:2707)
        self._shadow_id_hints: dict[tuple[int, str], int] = {}

    # -- builder (builder.c semantics) -------------------------------------

    def add_bucket(self, alg: int, type: int, items: list[int],
                   weights: list[int] | None = None, id: int | None = None,
                   uniform_weight: int | None = None) -> int:
        if id is None:
            id = -1
            while id in self.buckets:
                id -= 1
        if id >= 0 or id in self.buckets:
            raise ValueError(f"bad bucket id {id}")
        items = [int(i) for i in items]
        b = Bucket(id=id, alg=alg, type=type, items=items)
        if alg == CRUSH_BUCKET_UNIFORM:
            if uniform_weight is None:
                uniform_weight = weights[0] if weights else 0x10000
            b.item_weight = int(uniform_weight)
            b.weight = b.item_weight * len(items)
        elif alg == CRUSH_BUCKET_LIST:
            b.item_weights = [int(w) for w in weights]
            # sum_weights[i] = sum of item_weights[j] for j <= i (builder.c
            # crush_make_list_bucket: cumulative including self)
            acc, sums = 0, []
            for w in b.item_weights:
                acc += w
                sums.append(acc)
            b.sum_weights = sums
            b.weight = acc
        elif alg == CRUSH_BUCKET_STRAW2:
            b.item_weights = [int(w) for w in weights]
            b.weight = sum(b.item_weights)
        elif alg == CRUSH_BUCKET_TREE:
            b.item_weights = [int(w) for w in weights]
            self._build_tree(b)
        elif alg == CRUSH_BUCKET_STRAW:
            b.item_weights = [int(w) for w in weights]
            self._calc_straws(b)
        else:
            raise ValueError(f"unknown bucket alg {alg}")
        self.buckets[id] = b
        return id

    def _calc_straws(self, b: Bucket) -> None:
        """Legacy straw(v1) straw lengths for the map's configured
        straw_calc_version (see :func:`calc_straw_lengths`)."""
        b.straws = calc_straw_lengths(
            b.item_weights, int(self.tunables.get("straw_calc_version", 1)))
        b.weight = sum(b.item_weights)

    @staticmethod
    def _build_tree(b: Bucket) -> None:
        """Tree bucket node table (builder.c crush_make_tree_bucket
        semantics): leaves at odd node indices, internal weights cumulative."""
        n = len(b.items)
        depth = 0
        t = 1
        while t < n:
            t <<= 1
            depth += 1
        num_nodes = 1 << (depth + 1)
        node_weights = [0] * num_nodes
        for i, w in enumerate(b.item_weights):
            node = (i << 1) + 1
            node_weights[node] = int(w)
        # propagate up: each internal node at even index sums its subtree
        for h in range(1, depth + 1):
            step = 1 << h
            for node in range(step, num_nodes, step << 1):
                lo = node - (step >> 1)
                hi = node + (step >> 1)
                node_weights[node] = node_weights[lo] + (
                    node_weights[hi] if hi < num_nodes else 0)
        b.num_nodes = num_nodes
        b.node_weights = node_weights
        b.weight = node_weights[num_nodes >> 1]

    # -- map surgery (builder.c + CrushWrapper tree ops) -------------------

    def _rebuild_bucket(self, b: Bucket) -> None:
        """Recompute a bucket's aggregate/aux arrays after its items or
        item_weights changed (builder.c crush_bucket_adjust/remove paths)."""
        if b.alg == CRUSH_BUCKET_STRAW:
            self._calc_straws(b)
            return
        if b.alg == CRUSH_BUCKET_UNIFORM:
            b.weight = (b.item_weight or 0) * len(b.items)
            return
        if b.item_weights is None and b.alg == CRUSH_BUCKET_TREE and \
                b.node_weights is not None:
            # golden dumps carry only the node table; recover the per-item
            # weights from the leaf nodes (leaves live at odd indices)
            b.item_weights = [b.node_weights[(i << 1) + 1]
                              for i in range(len(b.items))]
        if b.alg == CRUSH_BUCKET_LIST:
            acc, sums = 0, []
            for w in b.item_weights:
                acc += w
                sums.append(acc)
            b.sum_weights = sums
            b.weight = acc
        elif b.alg == CRUSH_BUCKET_TREE:
            self._build_tree(b)
        else:                       # straw2
            b.weight = sum(b.item_weights)

    def _ensure_item_weights(self, b: Bucket) -> None:
        """Tree buckets from golden dumps carry only the node table;
        recover per-item weights BEFORE any mutation touches them (a
        post-mutation recovery would read stale/misaligned leaves)."""
        if b.item_weights is None and b.alg == CRUSH_BUCKET_TREE and \
                b.node_weights is not None:
            b.item_weights = [b.node_weights[(i << 1) + 1]
                              for i in range(len(b.items))]

    def _propagate_weight(self, bucket_id: int) -> None:
        """Push a bucket's recomputed weight into its ancestors
        (CrushWrapper::adjust_item_weight's upward walk)."""
        cur = bucket_id
        while True:
            parent = self.parent_of(cur)
            if parent is None:
                return
            pb = self.buckets[parent]
            self._ensure_item_weights(pb)
            idx = pb.items.index(cur)
            if pb.item_weights is not None:
                pb.item_weights[idx] = self.buckets[cur].weight
            self._rebuild_bucket(pb)
            cur = parent

    def _check_no_cycle(self, item: int, bucket_id: int) -> None:
        """Attaching ``item`` under ``bucket_id`` must not close a loop
        (the reference's _search_item_exists/loop checks)."""
        if item >= 0:
            return
        cur = bucket_id
        while cur is not None:
            if cur == item:
                raise ValueError(
                    f"inserting {item} under {bucket_id} would create a "
                    f"bucket cycle")
            cur = self.parent_of(cur)

    def insert_item(self, item: int, weight: int, bucket_id: int) -> None:
        """Add a device/bucket to a bucket and reweight the ancestry
        (CrushWrapper::insert_item)."""
        b = self.buckets[bucket_id]
        if item in b.items:
            raise ValueError(f"item {item} already in bucket {bucket_id}")
        self._check_no_cycle(item, bucket_id)
        if b.alg == CRUSH_BUCKET_UNIFORM:
            # builder.c crush_bucket_add_item: uniform buckets reject a
            # mismatched weight (-EINVAL) instead of silently dropping it
            if b.items and int(weight) != (b.item_weight or 0):
                raise ValueError(
                    f"uniform bucket {bucket_id} holds items of weight "
                    f"{b.item_weight:#x}; cannot insert weight {weight:#x}")
            if not b.items:
                b.item_weight = int(weight)
            b.items.append(int(item))
        else:
            self._ensure_item_weights(b)
            b.items.append(int(item))
            b.item_weights.append(int(weight))
        self._rebuild_bucket(b)
        self._propagate_weight(bucket_id)
        if item >= 0:
            self.max_devices = max(self.max_devices, item + 1)

    def remove_item(self, item: int) -> None:
        """Detach an item from its parent(s) and reweight the ancestry
        (CrushWrapper::remove_item; buckets must be emptied first, like
        the reference's non-recursive remove).  A device is detached from
        EVERY containing bucket — real and per-class shadow clones alike
        — or a stale shadow entry would keep placing on it."""
        if item < 0 and item in self.buckets and self.buckets[item].items:
            raise ValueError(f"bucket {item} not empty; move or remove its "
                             f"items first")
        parents = [bid for bid, b in self.buckets.items()
                   if item in b.items]
        for parent in parents:
            pb = self.buckets[parent]
            self._ensure_item_weights(pb)
            idx = pb.items.index(item)
            pb.items.pop(idx)
            if pb.item_weights is not None:
                pb.item_weights.pop(idx)
            self._rebuild_bucket(pb)
            self._propagate_weight(parent)
        if item < 0:
            self.buckets.pop(item, None)
            for cb in self.class_bucket.values():
                for c, sid in list(cb.items()):
                    if sid == item:
                        del cb[c]
            self.class_bucket.pop(item, None)
        self.item_names.pop(item, None)
        self.device_classes.pop(item, None)

    def move_bucket(self, bucket_id: int, new_parent_id: int) -> None:
        """Re-home a bucket under a new parent, carrying its weight
        (CrushWrapper::move_bucket = detach + insert)."""
        if bucket_id not in self.buckets:
            raise ValueError(f"no bucket {bucket_id}")
        # cycle guard: the new parent must not live under the moved bucket
        cur = new_parent_id
        while cur is not None:
            if cur == bucket_id:
                raise ValueError("move would create a bucket cycle")
            cur = self.parent_of(cur)
        # validate the DESTINATION before detaching: a failed insert after
        # the detach would orphan the whole subtree
        w = self.buckets[bucket_id].weight
        dest = self.buckets[new_parent_id]
        if bucket_id in dest.items:
            raise ValueError(f"{bucket_id} already under {new_parent_id}")
        if dest.alg == CRUSH_BUCKET_UNIFORM and dest.items and \
                w != (dest.item_weight or 0):
            raise ValueError(
                f"uniform bucket {new_parent_id} holds items of weight "
                f"{dest.item_weight:#x}; cannot move in weight {w:#x}")
        parent = self.parent_of(bucket_id)
        if parent is not None:
            pb = self.buckets[parent]
            self._ensure_item_weights(pb)
            idx = pb.items.index(bucket_id)
            pb.items.pop(idx)
            if pb.item_weights is not None:
                pb.item_weights.pop(idx)
            self._rebuild_bucket(pb)
            self._propagate_weight(parent)
        self.insert_item(bucket_id, w, new_parent_id)

    def adjust_item_weight(self, item: int, weight: int) -> None:
        """Set an item's weight in its parent bucket and propagate the
        change to the root (CrushWrapper::adjust_item_weight)."""
        parent = self.parent_of(item)
        if parent is None:
            raise ValueError(f"item {item} has no parent bucket")
        pb = self.buckets[parent]
        self._ensure_item_weights(pb)
        idx = pb.items.index(item)
        if pb.alg == CRUSH_BUCKET_UNIFORM:
            pb.item_weight = int(weight)
        else:
            pb.item_weights[idx] = int(weight)
        self._rebuild_bucket(pb)
        self._propagate_weight(parent)

    def adjust_subtree_weight(self, bucket_id: int, device_weight: int
                              ) -> int:
        """Set EVERY device under ``bucket_id`` to ``device_weight`` and
        reweight the tree (CrushWrapper::adjust_subtree_weight — the
        ``crushtool --reweight-subtree`` operation).  Returns the number
        of devices changed."""
        changed = 0

        def walk(bid: int) -> None:
            nonlocal changed
            b = self.buckets[bid]
            for i, item in enumerate(b.items):
                if item >= 0:
                    if b.alg == CRUSH_BUCKET_UNIFORM:
                        b.item_weight = int(device_weight)
                    else:
                        b.item_weights[i] = int(device_weight)
                    changed += 1
                elif item in self.buckets:     # skip dangling references
                    walk(item)
                    if b.item_weights is not None:
                        b.item_weights[i] = self.buckets[item].weight
            self._rebuild_bucket(b)

        walk(bucket_id)
        self._propagate_weight(bucket_id)
        return changed

    def reweight(self) -> None:
        """Recompute every bucket weight bottom-up from the leaves
        (builder.c crush_reweight)."""
        done: set[int] = set()

        def walk(bid: int) -> None:
            if bid in done:
                return
            b = self.buckets[bid]
            for i, item in enumerate(b.items):
                if item < 0 and item in self.buckets:
                    walk(item)
                    if b.item_weights is not None:
                        b.item_weights[i] = self.buckets[item].weight
            self._rebuild_bucket(b)
            done.add(bid)

        for bid in self.buckets:
            walk(bid)

    def add_rule(self, steps: list[tuple[int, int, int]],
                 ruleno: int | None = None) -> int:
        if ruleno is None:
            ruleno = 0
            while ruleno in self.rules:
                ruleno += 1
        if ruleno in self.rules:
            raise ValueError(f"rule {ruleno} exists")
        self.rules[ruleno] = Rule(steps=[tuple(s) for s in steps],
                                  ruleno=ruleno)
        return ruleno

    def finalize(self) -> None:
        """Compute max_devices (builder.c crush_finalize)."""
        md = 0
        for b in self.buckets.values():
            for i in b.items:
                if i >= 0:
                    md = max(md, i + 1)
        self.max_devices = md

    # -- naming / convenience (CrushWrapper-shaped) ------------------------

    def set_type_name(self, type_id: int, name: str) -> None:
        self.type_names[type_id] = name

    def type_id(self, name: str) -> int:
        for t, n in self.type_names.items():
            if n == name:
                return t
        raise KeyError(f"unknown crush type {name}")

    def set_item_name(self, item: int, name: str) -> None:
        self.item_names[item] = name

    def item_id(self, name: str) -> int:
        for i, n in self.item_names.items():
            if n == name:
                return i
        raise KeyError(f"unknown crush item {name}")

    def device_weights(self) -> dict[int, int]:
        """Leaf item -> 16.16 weight from its containing bucket
        (CrushWrapper::get_item_weight semantics)."""
        out: dict[int, int] = {}
        for b in self.buckets.values():
            for i, item in enumerate(b.items):
                if item >= 0:
                    if b.item_weights is not None:
                        out[item] = b.item_weights[i]
                    elif b.item_weight is not None:
                        out[item] = b.item_weight
        return out

    def parent_of(self, item: int) -> int | None:
        """Containing bucket id (None at a root).  Devices live in BOTH
        the real hierarchy and any per-class shadow clones: the REAL
        parent wins, unless the queried item is itself a shadow bucket
        (whose parent is the enclosing shadow bucket)."""
        want_shadow = item < 0 and self.is_shadow(item)
        for bid, b in self.buckets.items():
            if item in b.items and self.is_shadow(bid) == want_shadow:
                return bid
        return None

    def get_full_location(self, item: int) -> dict[str, str]:
        """type-name -> bucket/item-name chain from item to root
        (CrushWrapper::get_full_location shape; feeds the failure
        reporter-subtree grouping, OSDMonitor.cc:2772-2820)."""
        loc: dict[str, str] = {}
        cur = item
        while True:
            parent = self.parent_of(cur)
            if parent is None:
                return loc
            b = self.buckets[parent]
            tname = self.type_names.get(b.type, str(b.type))
            loc[tname] = self.item_names.get(parent, str(parent))
            cur = parent

    # -- device-class shadow trees (CrushWrapper.cc:2648) ------------------

    def set_device_class(self, item: int, device_class: str) -> None:
        """Assign a device's class (CrushWrapper::update_device_class).
        Classes must be settled before shadow trees are cloned — a
        reassignment would leave existing clones stale, so it is refused
        (the reference rebuilds its shadow forest on the mon instead)."""
        if item < 0:
            raise ValueError("device classes apply to devices, not buckets")
        if any(self.class_bucket.values()):
            raise ValueError(
                "device classes are fixed once shadow trees exist; "
                "rebuild the map to reclassify")
        self.device_classes[item] = device_class

    def is_shadow(self, item: int) -> bool:
        """Shadow (per-class clone) buckets carry the intentionally
        invalid name '<orig>~<class>' (CrushWrapper::is_shadow_item,
        CrushWrapper.h:583)."""
        return "~" in self.item_names.get(item, "")

    def nonshadow_roots(self) -> list[int]:
        """Parentless buckets that are not per-class clones
        (CrushWrapper::find_nonshadow_roots, CrushWrapper.h:624)."""
        children = {i for b in self.buckets.values() for i in b.items
                    if i < 0}
        return sorted(b for b in self.buckets
                      if b not in children and not self.is_shadow(b))

    def device_class_clone(self, original_id: int,
                           device_class: str) -> int:
        """Clone ``original_id``'s subtree keeping only devices of
        ``device_class`` (CrushWrapper::device_class_clone,
        CrushWrapper.cc:2648 / CrushWrapper.h:1342).  The clone is named
        '<orig>~<class>' (invalid on purpose), registered in
        class_bucket, and carries per-class choose_args weight sets
        derived from the original's.  Idempotent per (bucket, class)."""
        existing = self.class_bucket.get(original_id, {}).get(device_class)
        if existing is not None:
            return existing
        name = self.item_names.get(original_id)
        if name is None:
            raise KeyError(f"bucket {original_id} has no name; "
                           f"name it before cloning per class")
        copy_name = f"{name}~{device_class}"
        for i, n in self.item_names.items():   # name_exists fast path
            if n == copy_name:
                self.class_bucket.setdefault(
                    original_id, {})[device_class] = i
                return i
        orig = self.buckets[original_id]
        self._ensure_item_weights(orig)
        items: list[int] = []
        weights: list[int] = []
        orig_pos: list[int] = []               # new item pos -> orig pos
        for i, item in enumerate(orig.items):
            if item >= 0:
                if self.device_classes.get(item) != device_class:
                    continue
                w = (orig.item_weights[i] if orig.item_weights is not None
                     else (orig.item_weight or 0))
            else:
                item = self.device_class_clone(item, device_class)
                w = self.buckets[item].weight
            items.append(item)
            weights.append(w)
            orig_pos.append(i)
        hint = self._shadow_id_hints.get((original_id, device_class))
        if orig.alg == CRUSH_BUCKET_UNIFORM:
            sid = self.add_bucket(orig.alg, orig.type, items, id=hint,
                                  uniform_weight=orig.item_weight)
        else:
            sid = self.add_bucket(orig.alg, orig.type, items, weights,
                                  id=hint)
        self.buckets[sid].hash = orig.hash
        self.item_names[sid] = copy_name
        self.class_bucket.setdefault(original_id, {})[device_class] = sid
        # per-class choose_args: device entries keep their original
        # positional weights; child-clone entries contribute the SUM of
        # their own cloned weight set per position (the reference's
        # cmap_item_weight bookkeeping, CrushWrapper.cc:2735-2773)
        for args in self.choose_args.values():
            oarg = args.get(original_id)
            ws = (oarg or {}).get("weight_set")
            if not ws:
                continue
            new_ws = []
            for s, row in enumerate(ws):
                new_row = []
                for p, item in zip(orig_pos, items):
                    if item >= 0:
                        new_row.append(row[p])
                    else:
                        carg = args.get(item)
                        cws = (carg or {}).get("weight_set")
                        new_row.append(sum(cws[s]) if cws
                                       else self.buckets[item].weight)
                new_ws.append(new_row)
            args[sid] = {"weight_set": new_ws}
        return sid

    def populate_classes(self) -> int:
        """Clone every non-shadow root for every device class in use
        (CrushWrapper::populate_classes, CrushWrapper.h:1350).  Returns
        the number of clones created."""
        classes = sorted(set(self.device_classes.values()))
        made = 0
        for root in self.nonshadow_roots():
            for c in classes:
                before = self.class_bucket.get(root, {}).get(c)
                if before is None:
                    self.device_class_clone(root, c)
                    made += 1
        return made

    def take_with_class(self, root_name: str, device_class: str) -> int:
        """Resolve 'take <root> class <c>' to the shadow bucket id,
        cloning on first use (what the reference's rule-creation paths do
        via class_bucket lookups)."""
        root = self.item_id(root_name)
        if not device_class:
            return root
        if device_class not in set(self.device_classes.values()):
            raise ValueError(
                f"device class {device_class!r} is not assigned to any "
                f"device (EINVAL, like CrushWrapper::add_simple_rule)")
        return self.device_class_clone(root, device_class)

    def add_simple_rule(self, name: str, root_name: str,
                        failure_domain: str, device_class: str = "",
                        mode: str = "firstn", num_rep: int = 0) -> int:
        """CrushWrapper::add_simple_rule semantics (CrushWrapper.h; used by
        ErasureCode::create_rule with mode='indep', ErasureCode.cc:64-83).
        With ``device_class`` the rule takes the per-class shadow tree."""
        root = self.take_with_class(root_name, device_class)
        steps = [(CRUSH_RULE_TAKE, root, 0)]
        if failure_domain == "osd" or failure_domain == "":
            op = (CRUSH_RULE_CHOOSE_INDEP if mode == "indep"
                  else CRUSH_RULE_CHOOSE_FIRSTN)
            steps.append((op, num_rep, 0))
        else:
            ftype = self.type_id(failure_domain)
            op = (CRUSH_RULE_CHOOSELEAF_INDEP if mode == "indep"
                  else CRUSH_RULE_CHOOSELEAF_FIRSTN)
            steps.append((op, num_rep, ftype))
        steps.append((CRUSH_RULE_EMIT, 0, 0))
        if name in self.rule_names:
            raise ValueError(f"rule {name!r} already exists")
        ruleno = self.add_rule(steps)
        self.rule_names[name] = ruleno
        return ruleno

    # -- (de)serialisation --------------------------------------------------

    @classmethod
    def from_dict(cls, d: dict) -> "CrushMap":
        m = cls(tunables=d.get("tunables"))
        for bd in d.get("buckets", []):
            b = Bucket(
                id=bd["id"], alg=bd["alg"], type=bd["type"],
                items=list(bd["items"]), weight=bd.get("weight", 0),
                item_weights=bd.get("item_weights"),
                sum_weights=bd.get("sum_weights"),
                item_weight=bd.get("item_weight"),
                num_nodes=bd.get("num_nodes"),
                node_weights=bd.get("node_weights"),
                straws=bd.get("straws"),
            )
            m.buckets[b.id] = b
        for rd in d.get("rules", []):
            m.rules[rd["ruleno"]] = Rule(
                steps=[tuple(s) for s in rd["steps"]], ruleno=rd["ruleno"],
                type=rd.get("type", 1), min_size=rd.get("min_size", 1),
                max_size=rd.get("max_size", 10))
        if "type_names" in d:
            m.type_names = {int(t): n for t, n in d["type_names"].items()}
        m.item_names = {int(i): n
                        for i, n in d.get("item_names", {}).items()}
        m.rule_names = dict(d.get("rule_names", {}))
        if d.get("device_classes"):
            m.device_classes = {int(i): c
                                for i, c in d["device_classes"].items()}
        if d.get("class_bucket"):
            m.class_bucket = {int(i): dict(cb)
                              for i, cb in d["class_bucket"].items()}
        for sid, args in d.get("choose_args", {}).items():
            m.choose_args[int(sid)] = {int(bid): arg
                                       for bid, arg in args.items()}
        m.max_devices = d.get("max_devices", 0)
        if not m.max_devices:
            m.finalize()
        return m

    def to_dict(self) -> dict:
        buckets = []
        for b in sorted(self.buckets.values(), key=lambda b: -b.id):
            bd = {"id": b.id, "alg": b.alg, "type": b.type,
                  "weight": b.weight, "size": b.size, "items": list(b.items)}
            for k in ("item_weights", "sum_weights", "item_weight",
                      "num_nodes", "node_weights", "straws"):
                v = getattr(b, k)
                if v is not None:
                    bd[k] = v
            buckets.append(bd)
        d = {
            "tunables": dict(self.tunables),
            "max_devices": self.max_devices,
            "buckets": buckets,
            "rules": [{"ruleno": r.ruleno, "type": r.type,
                       "min_size": r.min_size, "max_size": r.max_size,
                       "steps": [list(s) for s in r.steps]}
                      for r in sorted(self.rules.values(),
                                      key=lambda r: r.ruleno)],
            "type_names": {str(t): n for t, n in self.type_names.items()},
            "item_names": {str(i): n for i, n in self.item_names.items()},
            "rule_names": dict(self.rule_names),
        }
        if self.device_classes:
            d["device_classes"] = {str(i): c
                                   for i, c in self.device_classes.items()}
        if self.class_bucket:
            d["class_bucket"] = {str(i): dict(cb)
                                 for i, cb in self.class_bucket.items()}
        if self.choose_args:
            d["choose_args"] = {
                str(sid): {str(bid): arg for bid, arg in args.items()}
                for sid, args in self.choose_args.items()}
        return d
