"""Exact CRUSH rule interpreter (host reference implementation).

Behaviour-equal Python implementation of the reference placement engine
(reference: src/crush/mapper.c): the five bucket choose algorithms
(:105-384), probabilistic reweight rejection is_out (:424-438), depth-first
crush_choose_firstn with collision/local-retry logic (:460-651), the
breadth-first positionally-stable crush_choose_indep used by EC pools
(:652-847, leaves CRUSH_ITEM_NONE holes), and the crush_do_rule step
machine (:900-1105), including choose_args weight-set overrides for the
mgr balancer (:309-326).

Validated bit-for-bit against golden vectors produced by running the
reference C (tests/golden/crush_golden.json).  This is the oracle for the
bulk straw2 mapper in torch_mapper.py (the CUDA kernel and its plain
PyTorch version).
"""
from __future__ import annotations

from .hash import crush_hash32_2, crush_hash32_3, crush_hash32_4
from .ln import crush_ln
from .map import (CRUSH_BUCKET_LIST, CRUSH_BUCKET_STRAW, CRUSH_BUCKET_STRAW2,
                  CRUSH_BUCKET_TREE, CRUSH_BUCKET_UNIFORM, CRUSH_ITEM_NONE,
                  CRUSH_ITEM_UNDEF, CRUSH_RULE_CHOOSELEAF_FIRSTN,
                  CRUSH_RULE_CHOOSELEAF_INDEP, CRUSH_RULE_CHOOSE_FIRSTN,
                  CRUSH_RULE_CHOOSE_INDEP, CRUSH_RULE_EMIT, CRUSH_RULE_NOOP,
                  CRUSH_RULE_SET_CHOOSELEAF_STABLE,
                  CRUSH_RULE_SET_CHOOSELEAF_TRIES,
                  CRUSH_RULE_SET_CHOOSELEAF_VARY_R,
                  CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
                  CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES,
                  CRUSH_RULE_SET_CHOOSE_TRIES, CRUSH_RULE_TAKE, CrushMap,
                  Bucket)

S64_MIN = -(1 << 63)


def _div64(a: int, b: int) -> int:
    """C-style signed 64-bit division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


class _Work:
    """Per-bucket permutation state (mapper.c crush_work_bucket)."""
    __slots__ = ("perm_x", "perm_n", "perm")

    def __init__(self, size: int):
        self.perm_x = 0
        self.perm_n = 0
        self.perm = [0] * size


class Workspace:
    def __init__(self, cmap: CrushMap):
        self.work = {bid: _Work(b.size) for bid, b in cmap.buckets.items()}


# -- bucket choose methods --------------------------------------------------

def bucket_perm_choose(b: Bucket, work: _Work, x: int, r: int) -> int:
    """Random-permutation choose (mapper.c:73-131), used by uniform buckets
    and the exhaustive local-fallback search."""
    pr = r % b.size
    if work.perm_x != (x & 0xFFFFFFFF) or work.perm_n == 0:
        work.perm_x = x & 0xFFFFFFFF
        if pr == 0:
            s = crush_hash32_3(x, b.id & 0xFFFFFFFF, 0) % b.size
            work.perm[0] = s
            work.perm_n = 0xFFFF
            return b.items[s]
        work.perm = list(range(b.size))
        work.perm_n = 0
    elif work.perm_n == 0xFFFF:
        work.perm[1:] = [i for i in range(1, b.size)]
        work.perm[work.perm[0]] = 0
        work.perm_n = 1
    while work.perm_n <= pr:
        p = work.perm_n
        if p < b.size - 1:
            i = crush_hash32_3(x, b.id & 0xFFFFFFFF, p) % (b.size - p)
            if i:
                work.perm[p + i], work.perm[p] = work.perm[p], work.perm[p + i]
        work.perm_n += 1
    return b.items[work.perm[pr]]


def bucket_list_choose(b: Bucket, x: int, r: int) -> int:
    """(mapper.c:139-163): walk tail to head, hash-scaled cumulative weight."""
    for i in range(b.size - 1, -1, -1):
        w = crush_hash32_4(x, b.items[i] & 0xFFFFFFFF, r, b.id & 0xFFFFFFFF)
        w &= 0xFFFF
        w = (w * b.sum_weights[i]) >> 16
        if w < b.item_weights[i]:
            return b.items[i]
    return b.items[0]


def bucket_tree_choose(b: Bucket, x: int, r: int) -> int:
    """(mapper.c:166-226): descend the implicit binary tree by hashed weight."""

    def height(n: int) -> int:
        h = 0
        while (n & 1) == 0:
            h += 1
            n >>= 1
        return h

    n = b.num_nodes >> 1
    while not (n & 1):
        w = b.node_weights[n]
        t = (crush_hash32_4(x, n, r, b.id & 0xFFFFFFFF) * w) >> 32
        left = n - (1 << (height(n) - 1))
        if t < b.node_weights[left]:
            n = left
        else:
            n = n + (1 << (height(n) - 1))
    return b.items[n >> 1]


def bucket_straw_choose(b: Bucket, x: int, r: int) -> int:
    """straw v1 (mapper.c:231-245): scaled-straw argmax."""
    high, high_draw = 0, 0
    for i in range(b.size):
        draw = crush_hash32_3(x, b.items[i] & 0xFFFFFFFF, r) & 0xFFFF
        draw *= b.straws[i]
        if i == 0 or draw > high_draw:
            high, high_draw = i, draw
    return b.items[high]


def _straw2_weights_ids(b: Bucket, arg, position: int):
    """choose_args overrides (mapper.c:309-326)."""
    weights = b.item_weights
    ids = b.items
    if arg is not None:
        ws = arg.get("weight_set")
        if ws:
            pos = min(position, len(ws) - 1)
            weights = ws[pos]
        if arg.get("ids"):
            ids = arg["ids"]
    return weights, ids


def bucket_straw2_choose(b: Bucket, x: int, r: int, arg=None,
                         position: int = 0) -> int:
    """straw2 (mapper.c:334-384): exponential-draw argmax; draws are
    crush_ln(hash16) - 2^48 divided by the 16.16 weight."""
    weights, ids = _straw2_weights_ids(b, arg, position)
    high, high_draw = 0, 0
    for i in range(b.size):
        if weights[i]:
            u = crush_hash32_3(x, ids[i] & 0xFFFFFFFF, r) & 0xFFFF
            ln = crush_ln(u) - 0x1000000000000
            draw = _div64(ln, weights[i])
        else:
            draw = S64_MIN
        if i == 0 or draw > high_draw:
            high, high_draw = i, draw
    return b.items[high]


def crush_bucket_choose(b: Bucket, work: _Work, x: int, r: int,
                        arg=None, position: int = 0) -> int:
    """(mapper.c:387-418)"""
    assert b.size > 0
    if b.alg == CRUSH_BUCKET_UNIFORM:
        return bucket_perm_choose(b, work, x, r)
    if b.alg == CRUSH_BUCKET_LIST:
        return bucket_list_choose(b, x, r)
    if b.alg == CRUSH_BUCKET_TREE:
        return bucket_tree_choose(b, x, r)
    if b.alg == CRUSH_BUCKET_STRAW:
        return bucket_straw_choose(b, x, r)
    if b.alg == CRUSH_BUCKET_STRAW2:
        return bucket_straw2_choose(b, x, r, arg, position)
    return b.items[0]


def is_out(weights: list[int], weight_max: int, item: int, x: int) -> bool:
    """Probabilistic reweight rejection (mapper.c:424-438)."""
    if item >= weight_max:
        return True
    w = weights[item]
    if w >= 0x10000:
        return False
    if w == 0:
        return True
    return (crush_hash32_2(x, item) & 0xFFFF) >= w


# -- choose_firstn / choose_indep -------------------------------------------

def crush_choose_firstn(cmap: CrushMap, ws: Workspace, bucket: Bucket,
                        weights, weight_max, x, numrep, type, out, outpos,
                        out_size, tries, recurse_tries, local_retries,
                        local_fallback_retries, recurse_to_leaf, vary_r,
                        stable, out2, parent_r, choose_args) -> int:
    """Depth-first replica selection (mapper.c:460-651)."""
    count = out_size
    rep = 0 if stable else outpos
    while rep < numrep and count > 0:
        ftotal = 0
        skip_rep = False
        retry_descent = True
        while retry_descent:
            retry_descent = False
            in_b = bucket
            flocal = 0
            retry_bucket = True
            while retry_bucket:
                retry_bucket = False
                r = rep + parent_r + ftotal
                if in_b.size == 0:
                    reject = True
                    collide = False
                    item = 0
                else:
                    if (local_fallback_retries > 0 and
                            flocal >= (in_b.size >> 1) and
                            flocal > local_fallback_retries):
                        item = bucket_perm_choose(in_b, ws.work[in_b.id], x, r)
                    else:
                        arg = choose_args.get(in_b.id) if choose_args else None
                        item = crush_bucket_choose(in_b, ws.work[in_b.id], x, r,
                                                   arg, outpos)
                    if item >= cmap.max_devices:
                        skip_rep = True
                        break
                    if item < 0 and item not in cmap.buckets:
                        # dangling bucket reference (mapper.c bad-id guard)
                        skip_rep = True
                        break
                    itemtype = cmap.buckets[item].type if item < 0 else 0
                    if itemtype != type:
                        if item >= 0:
                            skip_rep = True
                            break
                        in_b = cmap.buckets[item]
                        retry_bucket = True
                        continue
                    collide = any(out[i] == item for i in range(outpos))
                    reject = False
                    if not collide and recurse_to_leaf:
                        if item < 0:
                            sub_r = (r >> (vary_r - 1)) if vary_r else 0
                            got = crush_choose_firstn(
                                cmap, ws, cmap.buckets[item], weights,
                                weight_max, x, 1 if stable else outpos + 1, 0,
                                out2, outpos, count, recurse_tries, 0,
                                local_retries, local_fallback_retries, False,
                                vary_r, stable, None, sub_r, choose_args)
                            if got <= outpos:
                                reject = True
                        else:
                            out2[outpos] = item
                    if not reject and not collide and itemtype == 0:
                        reject = is_out(weights, weight_max, item, x)
                if reject or collide:
                    ftotal += 1
                    flocal += 1
                    if collide and flocal <= local_retries:
                        retry_bucket = True
                    elif (local_fallback_retries > 0 and
                          flocal <= in_b.size + local_fallback_retries):
                        retry_bucket = True
                    elif ftotal < tries:
                        retry_descent = True
                    else:
                        skip_rep = True
                    if not retry_bucket:
                        break
        if not skip_rep:
            out[outpos] = item
            outpos += 1
            count -= 1
        rep += 1
    return outpos


def crush_choose_indep(cmap: CrushMap, ws: Workspace, bucket: Bucket,
                       weights, weight_max, x, left, numrep, type, out,
                       outpos, tries, recurse_tries, recurse_to_leaf, out2,
                       parent_r, choose_args) -> None:
    """Breadth-first positionally-stable selection (mapper.c:658-847)."""
    endpos = outpos + left
    for rep in range(outpos, endpos):
        out[rep] = CRUSH_ITEM_UNDEF
        if out2 is not None:
            out2[rep] = CRUSH_ITEM_UNDEF
    ftotal = 0
    while left > 0 and ftotal < tries:
        for rep in range(outpos, endpos):
            if out[rep] != CRUSH_ITEM_UNDEF:
                continue
            in_b = bucket
            while True:
                r = rep + parent_r
                if (in_b.alg == CRUSH_BUCKET_UNIFORM and
                        in_b.size % numrep == 0):
                    r += (numrep + 1) * ftotal
                else:
                    r += numrep * ftotal
                if in_b.size == 0:
                    break
                arg = choose_args.get(in_b.id) if choose_args else None
                item = crush_bucket_choose(in_b, ws.work[in_b.id], x, r,
                                           arg, outpos)
                if item >= cmap.max_devices:
                    out[rep] = CRUSH_ITEM_NONE
                    if out2 is not None:
                        out2[rep] = CRUSH_ITEM_NONE
                    left -= 1
                    break
                if item < 0 and item not in cmap.buckets:
                    # dangling bucket reference (mapper.c bad-id guard)
                    out[rep] = CRUSH_ITEM_NONE
                    if out2 is not None:
                        out2[rep] = CRUSH_ITEM_NONE
                    left -= 1
                    break
                itemtype = cmap.buckets[item].type if item < 0 else 0
                if itemtype != type:
                    if item >= 0:
                        out[rep] = CRUSH_ITEM_NONE
                        if out2 is not None:
                            out2[rep] = CRUSH_ITEM_NONE
                        left -= 1
                        break
                    in_b = cmap.buckets[item]
                    continue
                collide = any(out[i] == item for i in range(outpos, endpos))
                if collide:
                    break
                if recurse_to_leaf:
                    if item < 0:
                        crush_choose_indep(
                            cmap, ws, cmap.buckets[item], weights, weight_max,
                            x, 1, numrep, 0, out2, rep, recurse_tries, 0,
                            False, None, r, choose_args)
                        if out2 is not None and out2[rep] == CRUSH_ITEM_NONE:
                            break
                    elif out2 is not None:
                        out2[rep] = item
                if itemtype == 0 and is_out(weights, weight_max, item, x):
                    break
                out[rep] = item
                left -= 1
                break
        ftotal += 1
    for rep in range(outpos, endpos):
        if out[rep] == CRUSH_ITEM_UNDEF:
            out[rep] = CRUSH_ITEM_NONE
        if out2 is not None and out2[rep] == CRUSH_ITEM_UNDEF:
            out2[rep] = CRUSH_ITEM_NONE


# -- do_rule ---------------------------------------------------------------

def crush_do_rule(cmap: CrushMap, ruleno: int, x: int, result_max: int,
                  weights: list[int] | None = None,
                  choose_args: dict | None = None) -> list[int]:
    """The rule step machine (mapper.c:900-1105). Returns the result vector
    (EC rules contain CRUSH_ITEM_NONE holes)."""
    if ruleno not in cmap.rules:
        return []
    rule = cmap.rules[ruleno]
    if weights is None:
        weights = [0x10000] * cmap.max_devices
    weight_max = len(weights)
    ws = Workspace(cmap)

    t = cmap.tunables
    choose_tries = t["choose_total_tries"] + 1
    choose_leaf_tries = 0
    choose_local_retries = t["choose_local_tries"]
    choose_local_fallback_retries = t["choose_local_fallback_tries"]
    vary_r = t["chooseleaf_vary_r"]
    stable = t["chooseleaf_stable"]

    result: list[int] = []
    w: list[int] = []
    for op, arg1, arg2 in rule.steps:
        if op == CRUSH_RULE_TAKE:
            if (0 <= arg1 < cmap.max_devices) or arg1 in cmap.buckets:
                w = [arg1]
        elif op == CRUSH_RULE_SET_CHOOSE_TRIES:
            if arg1 > 0:
                choose_tries = arg1
        elif op == CRUSH_RULE_SET_CHOOSELEAF_TRIES:
            if arg1 > 0:
                choose_leaf_tries = arg1
        elif op == CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES:
            if arg1 >= 0:
                choose_local_retries = arg1
        elif op == CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES:
            if arg1 >= 0:
                choose_local_fallback_retries = arg1
        elif op == CRUSH_RULE_SET_CHOOSELEAF_VARY_R:
            if arg1 >= 0:
                vary_r = arg1
        elif op == CRUSH_RULE_SET_CHOOSELEAF_STABLE:
            if arg1 >= 0:
                stable = arg1
        elif op in (CRUSH_RULE_CHOOSE_FIRSTN, CRUSH_RULE_CHOOSELEAF_FIRSTN,
                    CRUSH_RULE_CHOOSE_INDEP, CRUSH_RULE_CHOOSELEAF_INDEP):
            if not w:
                continue
            firstn = op in (CRUSH_RULE_CHOOSE_FIRSTN,
                            CRUSH_RULE_CHOOSELEAF_FIRSTN)
            recurse_to_leaf = op in (CRUSH_RULE_CHOOSELEAF_FIRSTN,
                                     CRUSH_RULE_CHOOSELEAF_INDEP)
            # the reference passes o+osize / c+osize as the per-take-item
            # output base (mapper.c:1040-1075), so collision scans stay
            # local to each take item; fresh sub-arrays mirror that.
            o: list[int] = []
            c: list[int] = []
            for wi in w:
                numrep = arg1
                if numrep <= 0:
                    numrep += result_max
                    if numrep <= 0:
                        continue
                if wi >= 0 or wi not in cmap.buckets:
                    continue
                bucket = cmap.buckets[wi]
                osize = len(o)
                sub_o = [0] * (result_max - osize)
                sub_c = [0] * (result_max - osize)
                if firstn:
                    if choose_leaf_tries:
                        recurse_tries = choose_leaf_tries
                    elif t["chooseleaf_descend_once"]:
                        recurse_tries = 1
                    else:
                        recurse_tries = choose_tries
                    got = crush_choose_firstn(
                        cmap, ws, bucket, weights, weight_max, x, numrep,
                        arg2, sub_o, 0, result_max - osize, choose_tries,
                        recurse_tries, choose_local_retries,
                        choose_local_fallback_retries, recurse_to_leaf,
                        vary_r, stable, sub_c, 0, choose_args)
                else:
                    got = min(numrep, result_max - osize)
                    crush_choose_indep(
                        cmap, ws, bucket, weights, weight_max, x, got,
                        numrep, arg2, sub_o, 0, choose_tries,
                        choose_leaf_tries if choose_leaf_tries else 1,
                        recurse_to_leaf, sub_c, 0, choose_args)
                o.extend(sub_o[:got])
                c.extend(sub_c[:got])
            w = c if recurse_to_leaf else o
        elif op == CRUSH_RULE_EMIT:
            for item in w:
                if len(result) < result_max:
                    result.append(item)
            w = []
        elif op == CRUSH_RULE_NOOP:
            pass
    return result
