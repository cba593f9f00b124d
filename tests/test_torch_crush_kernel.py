"""The control flow of ``csrc/crush_straw2.cu``, replayed in Python per x
and held against the plain version, bitwise.

The kernel runs one thread per x, which walks its own cursor through the
rule's attempts (firstn: the next (rep, try); indep: the next open
(pass, position)) and each attempt's outer and leaf descents, one step
of at most CHUNK slots of a bucket per iteration of its one loop.  A
straw2 choice keeps the first smallest quotient, taken through the
reciprocal table (``crush_kernels.straw2_reciprocals``) without a
division, and skips the hash of a dead slot.  The replay below follows
the source step by step (test code, not a second path of the port): it
must place exactly what ``straw2_map_plain`` places and make exactly the
straw2 draws the plain version counts, which is the count
``chip_smoke.py`` turns into the kernel's bound.  The quotient itself is
checked exhaustively over every 16-bit u.  Inputs come from
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
from ceph_tpu_torch.crush.ln import LN_TABLE_S64
from ceph_tpu_torch.crush.torch_mapper import BulkMapper
from ceph_tpu_torch.ops import crush_kernels as CK
from ceph_tpu_torch.ops import cuda_build
from ceph_tpu_torch.tools import lane_model as LM

M32 = 0xFFFFFFFF
NO_DRAW = (1 << 64) - 1
SOURCE = os.path.join(cuda_build.CSRC, "crush_straw2.cu")
with open(SOURCE) as _f:
    CHUNK = int(re.search(r"constexpr int CHUNK = (\d+);", _f.read()).group(1))


class KernelReplay:
    """One thread of crush_straw2_kernel<INDEP, LEAF>, in Python: the
    kernel's loop, one step (at most CHUNK slots of the bucket being
    chosen from) an iteration, over the lane's own attempt cursor."""

    def __init__(self, tables: CK.Straw2Tables, reweights, shape):
        self.t = {f: getattr(tables, f).numpy() for f in
                  ("items", "hash_ids", "recip", "sizes", "types",
                   "row_of_id", "ln")}
        self.rw = np.asarray(reweights, dtype=np.int64)
        self.s = shape
        self.P, self.B, self.S = self.t["recip"].shape
        self.draws = 0

    @staticmethod
    def wrap(i, n):
        if i < 0:
            i += n
        return 0 if i < 0 else (n - 1 if i >= n else i)

    def quotient(self, u, word):
        """umulhi((2^48 - ln[u]) << 15, M) >> l with 64-bit words."""
        n = (CK.LN_BIAS - int(self.t["ln"][u])) << 15
        mult = word & ((1 << CK.RECIP_SHIFT) - 1)
        return ((n * mult) >> 64) >> (word >> CK.RECIP_SHIFT)

    def start_choice(self):
        self.crow = self.wrap(self.row, self.B)
        self.p = min(self.wpos, self.P - 1)
        self.lim = min(int(self.t["sizes"][self.crow]), self.S)
        self.slot, self.bi, self.best = 0, 0, NO_DRAW

    def step(self, x):
        """Up to CHUNK slots of the choice in flight; True when done."""
        t = self.t
        for _ in range(CHUNK):
            if self.slot >= self.lim:
                break
            i, self.slot = self.slot, self.slot + 1
            word = int(t["recip"][self.p, self.crow, i])
            if word == 0:
                continue
            self.draws += 1
            u = crush_hash32_3(x, int(t["hash_ids"][self.crow, i]) & M32,
                               self.r & M32) & 0xFFFF
            q = self.quotient(u, word)
            if q < self.best:
                self.best, self.bi = q, i
        return self.slot >= self.lim

    def classify(self, item, ttype):
        t, s = self.t, self.s
        is_bucket = item < 0
        nrow = int(t["row_of_id"][self.wrap(-1 - item, len(
            t["row_of_id"]))]) if is_bucket else 0
        ntype = int(t["types"][self.wrap(nrow, self.B)]) if is_bucket else 0
        oob = not is_bucket and item >= s.max_devices
        hit = ntype == ttype and not oob
        bad = oob or (not hit and not is_bucket)
        return hit, bad, nrow

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

    def begin(self):
        """The next attempt's outer descent; False when the x is done."""
        s = self.s
        if s.indep:
            while True:
                while self.rep < s.out_size and self.bkt[self.rep] != CK.UNDEF:
                    self.rep += 1
                if self.rep < s.out_size:
                    break
                self.ftotal += 1
                if self.ftotal >= s.tries or CK.UNDEF not in self.bkt:
                    return False
                self.rep = 0
            self.r = self.rep + s.numrep * self.ftotal
            self.wpos = 0
        else:
            if self.rep >= s.numrep or self.outpos >= s.out_size:
                return False
            self.r = self.rep + self.ftotal
            self.wpos = self.outpos
        self.r_outer = self.r
        self.row, self.ttype, self.depth = s.root_row, s.target_type, 0
        self.leaf_stage = False
        self.start_choice()
        return True

    def reject(self):
        if self.s.indep:
            self.rep += 1
        else:
            self.ftotal += 1
            if self.ftotal >= self.s.tries:
                self.rep, self.ftotal = self.rep + 1, 0

    def place(self, bucket, item):
        if self.s.indep:
            self.bkt[self.rep] = bucket
            self.res[self.rep] = item
            self.rep += 1
        else:
            self.bkt[self.outpos] = bucket
            self.res[self.outpos] = item
            self.outpos += 1
            self.rep, self.ftotal = self.rep + 1, 0

    def one(self, x):
        s = self.s
        fill = CK.UNDEF if s.indep else None
        self.res = [fill] * s.out_size
        self.bkt = self.res if not s.leaf else [fill] * s.out_size
        self.rep = self.ftotal = self.outpos = 0
        active = s.tries > 0 and self.begin()
        while active:
            ok, skip, item = False, False, 0
            if self.depth < s.max_depth:
                if not self.step(x):
                    continue
                item = int(self.t["items"][self.crow, self.bi])
                ok, skip, nrow = self.classify(item, self.ttype)
                self.depth += 1
                if not ok and not skip and self.depth < s.max_depth:
                    self.row = nrow
                    self.start_choice()
                    continue
            if not self.leaf_stage:
                upto = s.out_size if s.indep else self.outpos
                if skip:
                    if s.indep:
                        self.bkt[self.rep] = self.res[self.rep] = CK.NONE
                        self.rep += 1
                    else:
                        self.rep, self.ftotal = self.rep + 1, 0
                elif not ok or item in self.bkt[:upto]:
                    self.reject()
                elif s.leaf:
                    self.leaf_stage, self.d_item = True, item
                    self.row = self.bucket_row(item)
                    if s.indep:
                        self.r, self.wpos = self.rep + self.r_outer, self.rep
                    else:
                        sub_r = (self.r_outer >> (s.vary_r - 1)
                                 if s.vary_r else 0)
                        self.r = (0 if s.stable else self.outpos) + sub_r
                        self.wpos = self.outpos
                    self.ttype, self.depth = 0, 0
                    self.start_choice()
                    continue
                elif s.target_type == 0 and self.is_out(item, x):
                    self.reject()
                else:
                    self.place(item, item)
            elif not ok or (not s.indep and item in self.res[:self.outpos]) \
                    or self.is_out(item, x):
                self.reject()
            else:
                self.place(self.d_item, item)
            active = self.begin()
        n = s.out_size if s.indep else self.outpos
        row = [CK.NONE if (v == CK.UNDEF if s.indep else j >= n) else v
               for j, v in enumerate(self.res)]
        return row, n

    def run(self, xs):
        rows, placed = [], []
        for x in xs:
            row, n = self.one(int(x))
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
    # the reciprocal table, not the weights, is the kernel's fifth input
    assert params[4] == "const void* recip"
    for name, value in (("NONE", CK.NONE), ("UNDEF", CK.UNDEF),
                        ("LN_BIAS", CK.LN_BIAS)):
        assert re.search(rf"constexpr \w+(?: \w+)? {name} = "
                         rf"(0x[0-9A-F]+)", src).group(1) == \
            hex(value).upper().replace("X", "x")
    assert int(re.search(r"constexpr int STATE_CAP = (\d+);", src).group(
        1)) == CK.STATE_CAP
    assert int(re.search(r"constexpr int RECIP_SHIFT = (\d+);", src).group(
        1)) == CK.RECIP_SHIFT


# -- the kernel's quotient ---------------------------------------------------

EDGE_WEIGHTS = [1, 2, 3, 0xFFFF, 0x10000, 0x10001, (1 << 32) - 1, 1 << 32,
                1 << 48, (1 << 48) + 1, (1 << 63) - 1]


def _umulhi64(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The high 64 bits of uint64 products, from 32-bit limbs (the
    device's __umul64hi)."""
    m32 = np.uint64(M32)
    s32 = np.uint64(32)
    al, ah, bl, bh = a & m32, a >> s32, b & m32, b >> s32
    lo_lo, hi_lo, lo_hi = al * bl, ah * bl, al * bh
    cross = (lo_lo >> s32) + (hi_lo & m32) + (lo_hi & m32)
    return ah * bh + (hi_lo >> s32) + (lo_hi >> s32) + (cross >> s32)


def _kernel_quotients(words: np.ndarray) -> np.ndarray:
    """[W, 65536] uint64: umulhi((2^48 - ln[u]) << 15, M) >> l for each
    reciprocal word, as the kernel computes it."""
    n = (np.uint64(CK.LN_BIAS) - LN_TABLE_S64.astype(np.uint64)) \
        << np.uint64(15)
    words = words.astype(np.uint64)
    mult = words & np.uint64((1 << CK.RECIP_SHIFT) - 1)
    shift = words >> np.uint64(CK.RECIP_SHIFT)
    return _umulhi64(n[None, :], mult[:, None]) >> shift[:, None]


def _test_map_weights() -> list[int]:
    ws = set()
    for seed in (1, 3, 4):
        cmap, _ = _map(seed)
        for b in cmap.buckets.values():
            ws.update(int(w) for w in b.item_weights)
    return sorted(w for w in ws if w > 0)


@pytest.mark.parametrize("source", ["maps", "edges", "random"])
def test_kernel_quotient_is_exact(source):
    """For every 16-bit u, the reciprocal table and the kernel's formula
    give (2^48 - ln[u]) // w exactly, for weights from 1 to 2^63 - 1."""
    if source == "maps":
        weights = _test_map_weights()
    elif source == "edges":
        weights = EDGE_WEIGHTS
    else:
        rng = np.random.default_rng(0)
        bits = rng.integers(1, 64, size=200)
        weights = [int(rng.integers(1 << (b - 1), (1 << b) - 1,
                                    endpoint=True)) for b in bits.tolist()]
    assert len(weights) >= 10
    w = np.asarray(weights, dtype=np.int64)
    words = CK.straw2_reciprocals(w[None, None, :],
                                  np.array([len(w)]))[0, 0]
    assert (words > 0).all()
    got = _kernel_quotients(words)
    n = (CK.LN_BIAS - LN_TABLE_S64).astype(np.uint64)
    for i, wi in enumerate(weights):
        want = n // np.uint64(wi)
        assert np.array_equal(got[i], want), wi


def test_reciprocals_mark_dead_slots():
    """A slot whose weight is not positive, or past its bucket's size,
    gets the word 0 (its hash is skipped); every other slot a word whose
    multiplier lies in [2^49, 2^50]."""
    ws = np.array([[[5, 0, -3, 7], [1 << 40, 9, 9, 9]],
                   [[6, 6, 0, 1], [2, 0, 3, 4]]], dtype=np.int64)
    sizes = np.array([4, 2])
    words = CK.straw2_reciprocals(ws, sizes)
    live = (ws > 0) & (np.arange(4)[None, None, :] < sizes[None, :, None])
    assert ((words != 0) == live).all()
    mult = words[live] & ((1 << CK.RECIP_SHIFT) - 1)
    assert ((mult >= 1 << 49) & (mult <= 1 << 50)).all()


# -- how busy a warp's lanes are (tools/lane_model.py) -----------------------

@pytest.mark.parametrize("op", [CRUSH_RULE_CHOOSELEAF_FIRSTN,
                                CRUSH_RULE_CHOOSELEAF_INDEP])
def test_cursor_keeps_lanes_busier_than_lockstep(op):
    """The lane model's choices make exactly the plain version's draws,
    and with retries (reweights) a lane walking its own attempts leaves
    fewer of the warp's slots idle than the reference's loops in step."""
    cmap, root = _map(1)
    ruleno = cmap.add_rule([(CRUSH_RULE_TAKE, root, 0), (op, 3, 1),
                            (CRUSH_RULE_EMIT, 0, 0)])
    bm = BulkMapper(cmap, device="cpu")
    weights = np.random.default_rng(2).choice(
        [0, 0x8000, 0x10000], size=cmap.max_devices)
    xs = np.unique(np.random.default_rng(6).integers(0, 1 << 32,
                                                     size=8 * LM.WARP))
    tables, shape = bm.tables(None), bm.rule_shape(ruleno, 3)
    stats = {}
    CK.straw2_map_plain(torch.from_numpy(xs), tables,
                        torch.from_numpy(weights), shape, stats=stats)
    eff = LM.lane_efficiency(LM.choices(xs, tables, weights, shape), CHUNK)
    assert LM.kernel_chunk() == CHUNK
    assert eff["useful_draws"] == stats["draws"]
    assert 0 < eff["lockstep"] < eff["cursor"] <= 1


# -- the draw's bound (tools/path_shapes.py) ---------------------------------

SASS_SAMPLE = """
\t\tFunction : kern_loop
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   LDG.E.64.CONSTANT R20, desc[UR14][R38.64] ;
        /*0020*/          LOP3.LUT R22, R2, 0x4e67c6a7, R17, 0x96, !PT ;
        /*0030*/                   IADD3 R24, -R22, R2, -R23 ;
        /*0040*/                   SHF.R.U32.HI R25, RZ, 0xd, R22 ;
        /*0050*/                   IADD3 R30, P0, R22, UR18, RZ ;
        /*0060*/                   IMAD.WIDE.U32.X R26, R41, R43, R26, P0 ;
        /*0070*/                   ISETP.GE.AND P1, PT, R32, R7, PT ;
        /*0080*/              @!P1 BRA P4, 0x10 ;
        /*0090*/          IADD3.X R43, ~R43, -0x80000000, RZ, P0, !PT ;
        /*00a0*/                   BRA 0x0 ;
\t\tFunction : kern_no_multiply
        /*0000*/                   IADD3 R1, R2, R3, R4 ;
        /*0010*/                   BRA 0x0 ;
"""


def test_draw_loop_counts_takes_the_innermost_multiply_loop():
    """The recount finds the innermost loop that holds a 64-bit high
    multiply and sorts its instructions by the pipes that can run them;
    a kernel without one has no draw loop."""
    PS = _path_shapes()
    counts = PS.draw_loop_counts(SASS_SAMPLE)
    loop = counts["kern_loop"]
    assert loop["multiplies"] == 1
    assert loop["work"] == {"alu": 2, "either": 2, "pairs": 1, "fma": 1,
                            "other": 1}
    assert loop["instructions_per_draw"] == 7
    assert loop["opcodes"]["BRA"] == 1 and "MOV" not in loop["opcodes"]
    assert loop["clocks_per_draw"] == PS.issue_floor(**loop["work"])
    assert counts["kern_no_multiply"] is None
    with pytest.raises(AssertionError, match="no draw loop"):
        PS.check_straw2_floor({"kern_no_multiply": None})
    with pytest.raises(AssertionError, match="no straw2 kernel"):
        PS.check_straw2_floor(None)
    # a loop of the recorded work passes; one instruction fewer fails
    work = dict(PS.STRAW2_DRAW_WORK)
    PS.check_straw2_floor({"k": {"clocks_per_draw": PS.issue_floor(**work)}})
    work["alu"] -= 1
    with pytest.raises(AssertionError, match="under STRAW2"):
        PS.check_straw2_floor({"k": {"clocks_per_draw":
                                     PS.issue_floor(**work)}})


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_issue_floor_is_the_least_pipe_assignment(seed):
    """The closed form equals the least, over every split of the movable
    instructions between the ALU and FMA pipes, of the longest of the
    two pipes and the issue; the recorded draw takes 35/24 SM-clocks."""
    PS = _path_shapes()
    rng = np.random.default_rng(seed)
    work = {k: int(rng.integers(0, 80)) for k in PS.STRAW2_DRAW_WORK}
    if seed == 0:
        work = dict(PS.STRAW2_DRAW_WORK)
        assert PS.issue_floor(**work) == pytest.approx(35 / 24)
    best = float("inf")
    for x in np.arange(0, work["either"] + 1e-9, 0.25):
        for y in np.arange(0, work["pairs"] + 1e-9, 1 / 3):
            alu = work["alu"] + work["either"] - x + work["pairs"] - y
            fma = work["fma"] + x + 2 * y
            issue = alu + fma + work["other"]
            best = min(best, max(alu / 64, fma / 64, issue / 128))
    assert PS.issue_floor(**work) <= best + 1e-12
    assert best - PS.issue_floor(**work) < 0.01


def _path_shapes():
    from ceph_tpu_torch.tools import path_shapes
    return path_shapes
