"""Bulk straw2 CRUSH placement on the card: one rule step over many x's.

    out[i], placed[i] = choose(take root; choose[leaf]_{firstn,indep}
                               numrep type; emit)(x = xs[i])

for a map whose buckets are all straw2, in the dense form of
``crush.torch_mapper.CompiledMap`` (items, hash ids and weight sets per
bucket row).  On a CUDA tensor :func:`straw2_map` launches the
hand-written kernel of ``csrc/crush_straw2.cu`` (built at first use by
:mod:`.cuda_build`), one thread per x that walks its own attempts, with
the quotient taken through :func:`straw2_reciprocals`; it never falls
back to anything else.  On a CPU tensor it runs :func:`straw2_map_plain`,
the plain PyTorch version: vectorized over x on int64 tensors with the
reference's bounded loops, each loop step applied only to the x's still
walking it.

Both compute exactly what the reference's vmapped chooser does (the JAX
package's ``BulkMapper._kernel``, mapper.c's straw2 rule walk with
optimal local-retry tunables):

- a straw2 draw over a bucket row is ``-((2^48 - ln(u)) // w)`` with
  ``u = hash32_3(x, hash_id, r) & 0xFFFF`` and ``w`` the weight-set entry
  of position ``min(pos, P - 1)``; slots with ``w <= 0`` or past the
  bucket's size draw S64_MIN, the first largest draw wins, and a bucket
  with no live slot returns its first item;
- ``descend`` walks exactly ``max_depth`` draws down from a row until an
  item of the target type (ok), a device above it or past
  ``max_devices`` (skip: structural), or the depth runs out (a retryable
  reject);
- firstn places up to ``out_size`` items over ``numrep`` reps, each rep
  retrying ``tries`` times from ftotal 0 (r = rep + ftotal), collisions
  checked against the items placed so far; ``placed`` is the count;
- indep fills ``out_size`` positions in passes (r = rep + numrep *
  ftotal), a skip pins the position to NONE, undefined positions end as
  NONE and ``placed`` is ``out_size``;
- with ``leaf`` the chosen bucket is descended once more to a device
  (firstn: r = (stable ? 0 : outpos) + (r >> (vary_r - 1)), position
  outpos; indep: r = rep + r, position rep), and the device must not be
  out under ``reweights`` (``is_out``);
- indep with ``leaf`` over ``target_type`` 0 (the chosen item is already
  a device) returns the reference's leaf vector, which takes each
  device that does not collide before its ``is_out`` check: a position
  whose tries run out ends on the last device rejected there (NONE only
  if none was), and one device may so end two positions.

``launches`` counts kernel launches; only a launch adds to it
(``reset_launches`` keeps the running sum in ``launches_before_reset``).
Each launch, and each plain-version call through :func:`straw2_map`, is
booked in :mod:`.launch_ledger` under :func:`straw2_key` (the JAX
package's ``traced_jit`` label, ``crush.bulk.<firstn|indep>``), with the
bytes of :func:`straw2_bytes`.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..crush.hash import crush_hash32_2_torch, crush_hash32_3_torch
from . import cuda_build, launch_ledger

S64_MIN = -(1 << 63)
LN_BIAS = 0x1000000000000          # 2^48
NONE = 0x7FFFFFFF                  # CRUSH_ITEM_NONE
UNDEF = 0x7FFFFFFE                 # CRUSH_ITEM_UNDEF
STATE_CAP = 16                     # positions of per-x state in shared memory
RECIP_SHIFT = 56                   # a reciprocal word is M | l << 56

launches = {"crush_straw2": 0}
launches_before_reset = dict.fromkeys(launches, 0)


def reset_launches() -> None:
    for name in launches:
        launches_before_reset[name] += launches[name]
        launches[name] = 0


def total_launches() -> dict:
    """Launches since the process started, resets included."""
    return {name: launches_before_reset[name] + launches[name]
            for name in launches}


@dataclass(frozen=True)
class RuleShape:
    """The run-time shape of one take/choose/emit rule on a compiled map."""
    indep: bool
    leaf: bool
    root_row: int
    numrep: int          # the rule's own (the indep retry stride)
    out_size: int        # min(numrep, result_max) when result_max is set
    target_type: int
    tries: int           # choose_total_tries + 1
    vary_r: int
    stable: int
    max_depth: int
    max_devices: int


@dataclass(frozen=True)
class Straw2Tables:
    """A compiled straw2 map on one device.  ``items``, ``hash_ids``
    [B, S] int32 (the hash runs over ``hash_ids``, the bucket returns its
    ``items``); ``ws`` [P, B, S] int64 weight sets and ``recip``, their
    :func:`straw2_reciprocals` (the kernel's quotient; the plain version
    divides by ``ws``); ``sizes``, ``types`` [B] int32; ``row_of_id`` [R]
    int32 (row of bucket id -1 - i, -1 if absent); ``ln`` [65536] int64,
    crush_ln of every 16-bit u."""
    items: torch.Tensor
    hash_ids: torch.Tensor
    ws: torch.Tensor
    recip: torch.Tensor
    sizes: torch.Tensor
    types: torch.Tensor
    row_of_id: torch.Tensor
    ln: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.items.device


def straw2_reciprocals(ws: np.ndarray, sizes: np.ndarray) -> np.ndarray:
    """The kernel's divisor table for weight sets ``ws`` [P, B, S] of
    buckets of ``sizes`` [B]: int64 words ``M | l << 56`` with
    ``2^(l-1) <= w < 2^l`` and ``M = ceil(2^(49+l) / w)``, so that
    ``(n << 15) * M >> (64 + l) == n // w`` for every ``0 <= n < 2^49``
    (the straw2 numerators ``2^48 - ln(u)``); 0 for a dead slot (weight
    <= 0, or past its bucket's size)."""
    ws = np.asarray(ws, dtype=np.int64)
    live = (ws > 0) & (np.arange(ws.shape[2])[None, None, :] <
                       np.asarray(sizes)[None, :, None])
    out = np.zeros(ws.shape, dtype=np.int64)
    weights, inv = np.unique(ws[live], return_inverse=True)
    words = []
    for w in weights.tolist():
        l = w.bit_length()
        words.append(-(-(1 << (49 + l)) // w) | l << RECIP_SHIFT)
    out[live] = np.asarray(words, dtype=np.int64)[inv]
    return out


def _wrap(idx: torch.Tensor, n: int) -> torch.Tensor:
    """An index into n rows with the reference's gather semantics: a
    negative index counts from the end, one past either end is clamped."""
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table[_wrap(idx, table.shape[0])]


# -- the plain version ---------------------------------------------------------

class _Plain:
    """The reference chooser vectorized over x (int64 throughout)."""

    def __init__(self, t: Straw2Tables, reweights: torch.Tensor,
                 shape: RuleShape):
        self.items = t.items.to(torch.int64)
        self.hash_ids = t.hash_ids.to(torch.int64)
        self.ws = t.ws
        self.sizes = t.sizes.to(torch.int64)
        self.types = t.types.to(torch.int64)
        self.row_of_id = t.row_of_id.to(torch.int64)
        self.ln = t.ln
        self.reweights = reweights
        self.s = shape
        self.slot = torch.arange(t.items.shape[1], device=t.device)
        self.draws = torch.zeros((), dtype=torch.int64, device=t.device)

    def choose(self, row, x, r, pos):
        """mapper.c's bucket_straw2_choose over rows [M] of x's [M]."""
        row = _wrap(row, self.items.shape[0])
        ws = self.ws[pos.clamp(max=self.ws.shape[0] - 1), row]
        valid = (ws > 0) & (self.slot[None, :] < self.sizes[row][:, None])
        u = crush_hash32_3_torch(x[:, None], self.hash_ids[row],
                                 r[:, None]) & 0xFFFF
        draw = -((LN_BIAS - self.ln[u]) // ws.clamp(min=1))
        draw = torch.where(valid, draw, S64_MIN)
        self.draws += valid.sum()
        return self.items[row].gather(1, draw.argmax(1, keepdim=True))[:, 0]

    def descend(self, row, x, r, ttype: int, pos):
        """-> (item, ok, skip) for each x; each step draws only for the
        x's that have not landed."""
        m = x.shape[0]
        item = torch.zeros(m, dtype=torch.int64, device=x.device)
        ok = torch.zeros(m, dtype=torch.bool, device=x.device)
        skip = torch.zeros_like(ok)
        live = torch.arange(m, device=x.device)
        row = row.clone()
        for _ in range(self.s.max_depth):
            if live.numel() == 0:
                break
            nxt = self.choose(row[live], x[live], r[live], pos[live])
            is_bucket = nxt < 0
            nrow = torch.where(is_bucket, _take(self.row_of_id, -1 - nxt), 0)
            ntype = torch.where(is_bucket, _take(self.types, nrow), 0)
            oob = ~is_bucket & (nxt >= self.s.max_devices)
            hit = (ntype == ttype) & ~oob
            bad = oob | (~hit & ~is_bucket)
            item[live] = nxt
            ok[live] = hit
            skip[live] = bad
            row[live] = nrow
            live = live[~(hit | bad)]
        return item, ok, skip

    def is_out(self, item, x):
        """mapper.c is_out: rejected under its reweight."""
        n = self.reweights.shape[0]
        w = self.reweights[item.clamp(0, n - 1)]
        h = crush_hash32_2_torch(x, item) & 0xFFFF
        return (item >= n) | (w == 0) | ((w < 0x10000) & (h >= w))

    def bucket_row(self, item):
        return torch.where(item < 0, _take(self.row_of_id, -1 - item), 0)

    def firstn(self, xs):
        s = self.s
        n, dev = xs.shape[0], xs.device
        out = torch.full((n, s.out_size), NONE, dtype=torch.int64,
                         device=dev)
        out2 = out.clone()
        outpos = torch.zeros(n, dtype=torch.int64, device=dev)
        cols = torch.arange(s.out_size, device=dev)
        for rep in range(s.numrep):
            act = torch.nonzero(outpos < s.out_size)[:, 0]
            for ftotal in range(s.tries):
                if act.numel() == 0:
                    break
                x, pos = xs[act], outpos[act]
                r = torch.full_like(x, rep + ftotal)
                item, ok, skip = self.descend(
                    torch.full_like(x, s.root_row), x, r, s.target_type, pos)
                before = cols[None, :] < pos[:, None]
                good = ok & ~((out[act] == item[:, None]) & before).any(1)
                leaf_item = item.clone()
                if s.leaf:
                    k = torch.nonzero(good)[:, 0]
                    lr = (r[k] >> (s.vary_r - 1) if s.vary_r
                          else torch.zeros_like(k))
                    if not s.stable:
                        lr = lr + pos[k]
                    lf, lok, _ = self.descend(self.bucket_row(item[k]), x[k],
                                              lr, 0, pos[k])
                    lcollide = ((out2[act[k]] == lf[:, None]) &
                                before[k]).any(1)
                    good[k] = lok & ~lcollide & ~self.is_out(lf, x[k])
                    leaf_item[k] = lf
                elif s.target_type == 0:
                    good &= ~self.is_out(item, x)
                placed = act[good]
                out[placed, outpos[placed]] = item[good]
                out2[placed, outpos[placed]] = leaf_item[good]
                outpos[placed] += 1
                act = act[~good & ~skip]
        result = out2 if s.leaf else out
        result = torch.where(cols[None, :] < outpos[:, None], result, NONE)
        return result, outpos

    def indep(self, xs):
        s = self.s
        n, dev = xs.shape[0], xs.device
        out = torch.full((n, s.out_size), UNDEF, dtype=torch.int64,
                         device=dev)
        out2 = out.clone()
        for ftotal in range(s.tries):
            if not bool((out == UNDEF).any()):
                break
            for rep in range(s.out_size):
                act = torch.nonzero(out[:, rep] == UNDEF)[:, 0]
                if act.numel() == 0:
                    continue
                x = xs[act]
                r = torch.full_like(x, rep + s.numrep * ftotal)
                item, ok, skip = self.descend(
                    torch.full_like(x, s.root_row), x, r, s.target_type,
                    torch.zeros_like(x))
                good = ok & ~(out[act] == item[:, None]).any(1)
                leaf_item = item.clone()
                if s.leaf and s.target_type == 0:
                    out2[act[good], rep] = item[good]
                    good &= ~self.is_out(item, x)
                elif s.leaf:
                    k = torch.nonzero(good)[:, 0]
                    lf, lok, _ = self.descend(self.bucket_row(item[k]), x[k],
                                              rep + r[k], 0,
                                              torch.full_like(k, rep))
                    good[k] = lok & ~self.is_out(lf, x[k])
                    leaf_item[k] = lf
                elif s.target_type == 0:
                    good &= ~self.is_out(item, x)
                out[act[skip], rep] = NONE
                out2[act[skip], rep] = NONE
                out[act[good], rep] = item[good]
                out2[act[good], rep] = leaf_item[good]
        result = out2 if s.leaf else out
        result = torch.where(result == UNDEF, NONE, result)
        return result, torch.full((n,), s.out_size, dtype=torch.int64,
                                  device=dev)


def straw2_map_plain(xs: torch.Tensor, tables: Straw2Tables,
                     reweights: torch.Tensor, shape: RuleShape,
                     stats: dict | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`straw2_map` on the tensors' device: ``xs``
    [N] integers in [0, 2^32) -> (out [N, out_size] int32, placed [N]
    int32).  ``stats``, when given, receives ``draws``: the straw2 draws
    the one-thread-per-x kernel makes for these inputs (the live slots of
    every bucket it chooses from)."""
    xs = xs.to(torch.int64) & 0xFFFFFFFF
    plain = _Plain(tables, reweights.to(torch.int64), shape)
    out, placed = plain.indep(xs) if shape.indep else plain.firstn(xs)
    if stats is not None:
        stats["draws"] = int(plain.draws)
    return out.to(torch.int32), placed.to(torch.int32)


# -- the kernel ---------------------------------------------------------------

def _as_u32_bits(xs: torch.Tensor) -> torch.Tensor:
    """Integers in [0, 2^32) as int32 holding their uint32 bit pattern."""
    xs = xs.to(torch.int64) & 0xFFFFFFFF
    return torch.where(xs >= 1 << 31, xs - (1 << 32), xs).to(
        torch.int32).contiguous()


def _check_tables(t: Straw2Tables, reweights: torch.Tensor) -> None:
    want = {"items": torch.int32, "hash_ids": torch.int32,
            "ws": torch.int64, "recip": torch.int64, "sizes": torch.int32,
            "types": torch.int32, "row_of_id": torch.int32, "ln": torch.int64}
    for name, dtype in want.items():
        v = getattr(t, name)
        if v.dtype != dtype or v.device != t.device or not v.is_contiguous():
            raise ValueError(f"straw2_map: {name} must be contiguous {dtype} "
                             f"on {t.device}")
    b, s = t.items.shape
    if t.hash_ids.shape != (b, s) or t.ws.dim() != 3 or \
            t.ws.shape[1:] != (b, s) or t.recip.shape != t.ws.shape or \
            t.sizes.shape != (b,) or \
            t.types.shape != (b,) or t.ln.shape != (1 << 16,) or \
            t.row_of_id.numel() < 1 or t.ws.shape[0] < 1:
        raise ValueError("straw2_map: tables of mismatched shapes")
    if reweights.dtype != torch.int64 or reweights.dim() != 1 or \
            reweights.numel() < 1 or reweights.device != t.device:
        raise ValueError(f"straw2_map: reweights must be int64 [L >= 1] on "
                         f"{t.device}")


def straw2_map(xs: torch.Tensor, tables: Straw2Tables,
               reweights: torch.Tensor, shape: RuleShape
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """``xs`` [N] placement seeds (integers in [0, 2^32)) -> (out
    [N, out_size] int32 with NONE holes and padding, placed [N] int32), on
    the tables' device.  CUDA tensors launch the hand kernel once on the
    current stream and add one to ``launches["crush_straw2"]``; CPU
    tensors run :func:`straw2_map_plain`; anything else raises."""
    if xs.dim() != 1 or xs.device != tables.device:
        raise ValueError(f"straw2_map: xs must be 1-D on {tables.device}")
    key = straw2_key(shape, xs.shape[0], tables, reweights)
    label = key[0]
    nbytes = straw2_bytes(xs.shape[0], shape.out_size, tables, reweights)
    if xs.device.type == "cpu":
        with launch_ledger.launch(label, key, nbytes, xs.device):
            return straw2_map_plain(xs, tables, reweights, shape)
    if not xs.is_cuda:
        raise ValueError(f"straw2_map runs on cuda or cpu, not {xs.device}")
    _check_tables(tables, reweights)
    n, s = xs.shape[0], shape
    out = torch.empty((n, s.out_size), dtype=torch.int32, device=xs.device)
    placed = torch.empty(n, dtype=torch.int32, device=xs.device)
    if n == 0:
        return out, placed
    # past STATE_CAP positions the leaf walk keeps its chosen buckets in a
    # row of its own beside the devices it returns
    scratch = torch.empty_like(out) if s.leaf and s.out_size > STATE_CAP \
        else out
    xs32 = _as_u32_bits(xs)
    t = tables
    p, b, w = t.ws.shape
    lib = cuda_build.load("crush_straw2")
    args = (xs32.data_ptr(), n, t.items.data_ptr(), t.hash_ids.data_ptr(),
            t.recip.data_ptr(), p, b, w, t.sizes.data_ptr(),
            t.types.data_ptr(), t.row_of_id.data_ptr(),
            t.row_of_id.numel(), reweights.data_ptr(), reweights.numel(),
            t.ln.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            placed.data_ptr(), int(s.indep), int(s.leaf), s.root_row,
            s.numrep, s.out_size, s.target_type, s.tries, s.vary_r,
            s.stable, s.max_depth, s.max_devices)
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        with launch_ledger.launch(label, key, nbytes, xs.device,
                                  "crush_straw2"):
            err = lib.crush_straw2_launch(*args, stream)
            if err != 0:
                raise RuntimeError(f"crush_straw2 failed: cudaError_t {err}")
            launches["crush_straw2"] += 1
    return out, placed


def straw2_key(shape: RuleShape, n: int, tables: Straw2Tables,
               reweights: torch.Tensor) -> tuple:
    """The launch ledger's key of a launch: ``crush.bulk.<kind>``, the
    shapes its bytes depend on as its matrix (the weight set [P, B, S],
    the id map's and the reweights' lengths) and [x's, positions]."""
    label = f"crush.bulk.{'indep' if shape.indep else 'firstn'}"
    return launch_ledger.launch_key(
        label, n, shape.out_size,
        (*tables.ws.shape, tables.row_of_id.numel(), reweights.numel()))


def straw2_bytes(n: int, out_size: int, tables: Straw2Tables,
                 reweights: torch.Tensor) -> int:
    """What a launch must move: the x's in, ``out`` and ``placed`` out
    (4 bytes each), and every table it reads once (one table of weights
    or reciprocals) — the bytes of ``tools/path_shapes.straw2_bound``."""
    return 4 * int(n) * (2 + int(out_size)) + reweights.numel() * 8 + sum(
        getattr(tables, f).numel() * getattr(tables, f).element_size()
        for f in ("items", "hash_ids", "sizes", "types", "row_of_id", "ln",
                  "ws"))
