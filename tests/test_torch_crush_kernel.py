"""The control flow of ``csrc/crush_straw2.cu``, replayed in Python per x
and held against the plain version, bitwise.

The kernel runs one thread per x with ordinary loops that leave early:
a descent returns where it lands, a firstn rep stops at its placement, a
skip or its try limit, an indep pass walks only the positions still
undefined, and a straw2 scan skips the hash of a slot whose weight is not
positive.  Its collision scans read the x's own output row (and, for a
leaf rule, the chosen buckets in the same row of a scratch tensor).  The
replay below follows the source line by line (test code, not a second
path of the port): it must place exactly what ``straw2_map_plain`` places
and make exactly the straw2 draws the plain version counts, which is the
count ``chip_smoke.py`` turns into the kernel's bound.  Inputs come from
``np.random.default_rng(seed)``; integers, tolerance 0.
"""
import os
import re

import numpy as np
import pytest
import torch

from ceph_tpu_torch.crush import (CRUSH_BUCKET_STRAW2,
                                  CRUSH_RULE_CHOOSELEAF_FIRSTN,
                                  CRUSH_RULE_CHOOSELEAF_INDEP,
                                  CRUSH_RULE_CHOOSE_FIRSTN,
                                  CRUSH_RULE_CHOOSE_INDEP, CRUSH_RULE_EMIT,
                                  CRUSH_RULE_TAKE, CrushMap, crush_hash32_2,
                                  crush_hash32_3)
from ceph_tpu_torch.crush.torch_mapper import BulkMapper
from ceph_tpu_torch.ops import crush_kernels as CK
from ceph_tpu_torch.ops import cuda_build

M32 = 0xFFFFFFFF
SOURCE = os.path.join(cuda_build.CSRC, "crush_straw2.cu")


class KernelReplay:
    """One thread of crush_straw2_kernel<INDEP, LEAF>, in Python."""

    def __init__(self, tables: CK.Straw2Tables, reweights, shape):
        self.t = {f: getattr(tables, f).numpy() for f in
                  ("items", "hash_ids", "ws", "sizes", "types", "row_of_id",
                   "ln")}
        self.rw = np.asarray(reweights, dtype=np.int64)
        self.s = shape
        self.P, self.B, self.S = self.t["ws"].shape
        self.draws = 0

    @staticmethod
    def wrap(i, n):
        if i < 0:
            i += n
        return 0 if i < 0 else (n - 1 if i >= n else i)

    def straw2_choose(self, row, x, r, pos):
        t = self.t
        row = self.wrap(row, self.B)
        p = min(pos, self.P - 1)
        lim = min(int(t["sizes"][row]), self.S)
        best, bi = CK.S64_MIN, 0
        for i in range(lim):
            wi = int(t["ws"][p, row, i])
            if wi <= 0:
                continue
            self.draws += 1
            u = crush_hash32_3(x, int(t["hash_ids"][row, i]) & M32,
                               r & M32) & 0xFFFF
            draw = -((CK.LN_BIAS - int(t["ln"][u])) // wi)
            if draw > best:
                best, bi = draw, i
        return int(t["items"][row, bi])

    def descend(self, row, x, r, ttype, pos):
        t, s = self.t, self.s
        item = 0
        for _ in range(s.max_depth):
            item = self.straw2_choose(row, x, r, pos)
            is_bucket = item < 0
            nrow = int(t["row_of_id"][self.wrap(-1 - item, len(
                t["row_of_id"]))]) if is_bucket else 0
            ntype = int(t["types"][self.wrap(nrow, self.B)]) \
                if is_bucket else 0
            oob = not is_bucket and item >= s.max_devices
            hit = ntype == ttype and not oob
            bad = oob or (not hit and not is_bucket)
            if hit or bad:
                return item, hit, bad
            row = nrow
        return item, False, False

    def is_out(self, item, x):
        if item >= len(self.rw):
            return True
        w = int(self.rw[max(item, 0)])
        if w == 0:
            return True
        if w >= 0x10000:
            return False
        return (crush_hash32_2(x, item & M32) & 0xFFFF) >= w

    def bucket_row(self, item):
        rows = self.t["row_of_id"]
        return int(rows[self.wrap(-1 - item, len(rows))]) if item < 0 else 0

    def firstn(self, x):
        s = self.s
        res = [CK.NONE] * s.out_size
        bkt = res if not s.leaf else [None] * s.out_size
        outpos = 0
        rep = 0
        while rep < s.numrep and outpos < s.out_size:
            for ftotal in range(s.tries):
                r = rep + ftotal
                item, ok, skip = self.descend(s.root_row, x, r,
                                              s.target_type, outpos)
                if skip:
                    break
                if not ok:
                    continue
                if any(bkt[j] == item for j in range(outpos)):
                    continue
                leaf_item = item
                if s.leaf:
                    sub_r = r >> (s.vary_r - 1) if s.vary_r else 0
                    lf, lok, _ = self.descend(
                        self.bucket_row(item), x,
                        (0 if s.stable else outpos) + sub_r, 0, outpos)
                    if not lok:
                        continue
                    if any(res[j] == lf for j in range(outpos)) or \
                            self.is_out(lf, x):
                        continue
                    leaf_item = lf
                    bkt[outpos] = item
                elif s.target_type == 0 and self.is_out(item, x):
                    continue
                res[outpos] = leaf_item
                outpos += 1
                break
            rep += 1
        for j in range(outpos, s.out_size):
            res[j] = CK.NONE
        return res, outpos

    def indep(self, x):
        s = self.s
        res = [CK.UNDEF] * s.out_size
        bkt = res if not s.leaf else [CK.UNDEF] * s.out_size
        for ftotal in range(s.tries):
            if CK.UNDEF not in bkt:
                break
            for rep in range(s.out_size):
                if bkt[rep] != CK.UNDEF:
                    continue
                r = rep + s.numrep * ftotal
                item, ok, skip = self.descend(s.root_row, x, r,
                                              s.target_type, 0)
                if skip:
                    bkt[rep] = res[rep] = CK.NONE
                    continue
                if not ok or item in bkt:
                    continue
                leaf_item = item
                if s.leaf:
                    lf, lok, _ = self.descend(self.bucket_row(item), x,
                                              rep + r, 0, rep)
                    if not lok or self.is_out(lf, x):
                        continue
                    leaf_item = lf
                elif s.target_type == 0 and self.is_out(item, x):
                    continue
                bkt[rep] = item
                res[rep] = leaf_item
        return [CK.NONE if v == CK.UNDEF else v for v in res], s.out_size

    def run(self, xs):
        rows, placed = [], []
        for x in xs:
            row, n = (self.indep if self.s.indep else self.firstn)(int(x))
            rows.append(row)
            placed.append(n)
        return (np.array(rows, dtype=np.int32).reshape(len(xs), -1),
                np.array(placed, dtype=np.int32))


def _map(seed, tunables=None):
    """racks -> hosts -> osds, all straw2, weights in half-units with some
    zero, and one dangling reference (item -40 names no bucket)."""
    rng = np.random.default_rng(seed)
    cmap = CrushMap(tunables=tunables)
    osd = 0
    racks = []
    for _ in range(3):
        hosts = []
        for _ in range(3):
            n = int(rng.integers(2, 6))
            items = list(range(osd, osd + n))
            osd += n
            w = [int(rng.integers(0, 5)) * 0x8000 for _ in items]
            hosts.append(cmap.add_bucket(CRUSH_BUCKET_STRAW2, 1, items, w))
        hw = [sum(cmap.buckets[h].item_weights) for h in hosts]
        racks.append(cmap.add_bucket(CRUSH_BUCKET_STRAW2, 2, hosts, hw))
    rw = [sum(cmap.buckets[r].item_weights) for r in racks]
    root = cmap.add_bucket(CRUSH_BUCKET_STRAW2, 3, racks + [-40],
                           rw + [0x8000])
    cmap.finalize()
    return cmap, root


def _replay_against_plain(cmap, ruleno, result_max, xs, weights=None,
                          choose_args=None):
    bm = BulkMapper(cmap, device="cpu")
    shape = bm.rule_shape(ruleno, result_max)
    tables = bm.tables(choose_args)
    if weights is None:
        weights = np.full(cmap.max_devices, 0x10000, dtype=np.int64)
    rw = torch.from_numpy(np.asarray(weights, dtype=np.int64))
    stats = {}
    out, placed = CK.straw2_map_plain(torch.from_numpy(xs.astype(np.int64)),
                                      tables, rw, shape, stats=stats)
    replay = KernelReplay(tables, weights, shape)
    got, got_placed = replay.run(xs)
    assert np.array_equal(got, out.numpy())
    assert np.array_equal(got_placed, placed.numpy())
    assert replay.draws == stats["draws"] > 0
    return out.numpy()


XS = np.random.default_rng(5).integers(0, 1 << 32, size=40,
                                       dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("op,numrep,ttype,result_max", [
    (CRUSH_RULE_CHOOSELEAF_FIRSTN, 3, 1, 3),
    (CRUSH_RULE_CHOOSELEAF_FIRSTN, 4, 1, 2),     # out_size < numrep
    (CRUSH_RULE_CHOOSELEAF_INDEP, 0, 1, 4),      # numrep from result_max
    (CRUSH_RULE_CHOOSELEAF_INDEP, 5, 1, 3),      # stride keeps numrep
    (CRUSH_RULE_CHOOSE_FIRSTN, 2, 1, 2),
    (CRUSH_RULE_CHOOSE_INDEP, 4, 0, 4),
    (CRUSH_RULE_CHOOSELEAF_FIRSTN, 3, 0, 3),     # leaf over osd: plain
])
def test_replay_matches_plain(op, numrep, ttype, result_max):
    cmap, root = _map(1)
    ruleno = cmap.add_rule([(CRUSH_RULE_TAKE, root, 0), (op, numrep, ttype),
                            (CRUSH_RULE_EMIT, 0, 0)])
    rng = np.random.default_rng(2)
    weights = rng.choice([0, 0x4000, 0x8000, 0x10000, 0x18000],
                         size=cmap.max_devices)
    _replay_against_plain(cmap, ruleno, result_max, XS)
    _replay_against_plain(cmap, ruleno, result_max, XS, weights=weights)


@pytest.mark.parametrize("positions", [1, 2, 4])
def test_replay_with_choose_args(positions):
    """Weight-set positions (clamped to the last), zero weights that skip
    the hash, and hash-id overrides on the racks."""
    cmap, root = _map(3)
    rng = np.random.default_rng(positions)
    args = {}
    for bid, b in cmap.buckets.items():
        arg = {"weight_set": [[int(w * rng.choice([0, 0.5, 1.0, 1.5]))
                               for w in b.item_weights]
                              for _ in range(positions)]}
        if b.type == 2:
            arg["ids"] = [int(i) - 100 for i in b.items]
        args[bid] = arg
    for op, numrep, ttype in ((CRUSH_RULE_CHOOSELEAF_FIRSTN, 3, 1),
                              (CRUSH_RULE_CHOOSELEAF_INDEP, 4, 1)):
        ruleno = cmap.add_rule([(CRUSH_RULE_TAKE, root, 0),
                                (op, numrep, ttype),
                                (CRUSH_RULE_EMIT, 0, 0)])
        _replay_against_plain(cmap, ruleno, numrep, XS, choose_args=args)


@pytest.mark.parametrize("vary_r,stable", [(0, 0), (1, 0), (2, 1)])
def test_replay_leaf_tunables(vary_r, stable):
    """The firstn leaf walk's r = (stable ? 0 : outpos) + r >> (vary_r-1)."""
    tunables = {"choose_local_tries": 0, "choose_local_fallback_tries": 0,
                "choose_total_tries": 19, "chooseleaf_descend_once": 1,
                "chooseleaf_vary_r": vary_r, "chooseleaf_stable": stable}
    cmap, root = _map(4, tunables)
    ruleno = cmap.add_rule([(CRUSH_RULE_TAKE, root, 0),
                            (CRUSH_RULE_CHOOSELEAF_FIRSTN, 3, 1),
                            (CRUSH_RULE_EMIT, 0, 0)])
    _replay_against_plain(cmap, ruleno, 3, XS)


def test_launch_signature_matches_the_source():
    """The C entry's parameters line up with cuda_build.SIGNATURES, so the
    wrapper's ctypes call passes each argument at its width."""
    with open(SOURCE) as f:
        src = f.read()
    m = re.search(r"int crush_straw2_launch\(([^)]*)\)", src)
    params = [p.strip() for p in m.group(1).split(",")]
    argtypes = cuda_build.SIGNATURES["crush_straw2"]["crush_straw2_launch"]
    assert len(params) == len(argtypes) == 30
    for p, a in zip(params, argtypes):
        if "*" in p:
            assert a is cuda_build._P, p
        elif p.startswith("long long"):
            assert a is cuda_build._L, p
        else:
            assert p.startswith("int ") and a is cuda_build._I, p
    for name, value in (("NONE", CK.NONE), ("UNDEF", CK.UNDEF),
                        ("LN_BIAS", CK.LN_BIAS)):
        assert re.search(rf"constexpr \w+(?: \w+)? {name} = "
                         rf"(0x[0-9A-F]+)", src).group(1) == \
            hex(value).upper().replace("X", "x")
