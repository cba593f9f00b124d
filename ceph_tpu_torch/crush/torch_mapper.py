"""Bulk CRUSH placement: one kernel launch maps millions of PGs.

The counterpart of the reference's bulk mapping (reference:
src/osd/OSDMapMapping.{h,cc} ParallelPGMapper -- a thread pool looping
crush_do_rule per PG): here a whole pool's placement seeds go to
``ops.crush_kernels.straw2_map`` at once, which on the card launches the
hand-written kernel of ``ops/csrc/crush_straw2.cu`` (one thread per x)
and on the CPU runs its plain PyTorch version.

Scope (the production shape): maps whose buckets are all non-empty STRAW2
(the default since jewel) and rules of the form
    take <root>; choose[leaf]_{firstn,indep} <n> <type>; emit
with optimal-profile local-retry tunables (choose_local_tries=0,
choose_local_fallback_tries=0) and chooseleaf_descend_once=1 (single-try
leaf recursion).  Anything outside this envelope is rejected with
ValueError at compile/map time -- run it through the exact host
interpreter (crush.mapper) instead, which is also the oracle the kernel
and its plain version are tested against bit-for-bit.
"""
from __future__ import annotations

import collections
import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from ..common.tracer import trace_span
from ..ops import crush_kernels
from ..ops.codec import torch_device
from .ln import LN_TABLE_S64
from .map import (CRUSH_BUCKET_STRAW2, CRUSH_ITEM_NONE,
                  CRUSH_RULE_CHOOSELEAF_FIRSTN, CRUSH_RULE_CHOOSELEAF_INDEP,
                  CRUSH_RULE_CHOOSE_FIRSTN, CRUSH_RULE_CHOOSE_INDEP,
                  CRUSH_RULE_EMIT, CRUSH_RULE_TAKE, CrushMap)


@dataclass(frozen=True)
class CompiledMap:
    """Dense-array form of a straw2-only CrushMap for device kernels."""
    items: np.ndarray        # [B, S] int32 (device ids >= 0, bucket ids < 0)
    weights: np.ndarray      # [B, S] int64 (16.16 fixed point)
    sizes: np.ndarray        # [B] int32
    types: np.ndarray        # [B] int32
    row_of_id: np.ndarray    # [max_buckets] int32 (-1 if absent)
    max_devices: int
    max_depth: int
    tunables: dict

    @classmethod
    def compile(cls, cmap: CrushMap) -> "CompiledMap":
        for b in cmap.buckets.values():
            if b.alg != CRUSH_BUCKET_STRAW2:
                raise ValueError(
                    f"bucket {b.id} alg={b.alg}: the bulk path supports "
                    f"straw2 only; use the host interpreter")
            if b.size == 0:
                raise ValueError("empty buckets need the host interpreter")
        t = cmap.tunables
        if t["choose_local_tries"] or t["choose_local_fallback_tries"]:
            raise ValueError("local retry tunables need the host interpreter")
        if not t["chooseleaf_descend_once"]:
            # without descend_once the chooseleaf recursion retries inside
            # the chosen domain (recurse_tries=choose_tries, mapper.c
            # do_rule firstn branch); the kernel does a single-try descent
            raise ValueError(
                "chooseleaf_descend_once=0 needs the host interpreter")
        ids = sorted(cmap.buckets)
        nb = len(ids)
        smax = max(b.size for b in cmap.buckets.values())
        items = np.full((nb, smax), CRUSH_ITEM_NONE, dtype=np.int32)
        weights = np.zeros((nb, smax), dtype=np.int64)
        sizes = np.zeros(nb, dtype=np.int32)
        types = np.zeros(nb, dtype=np.int32)
        row_of_id = np.full(max(-i for i in ids), -1, dtype=np.int32)
        for row, bid in enumerate(ids):
            b = cmap.buckets[bid]
            items[row, :b.size] = b.items
            weights[row, :b.size] = b.item_weights
            sizes[row] = b.size
            types[row] = b.type
            row_of_id[-1 - bid] = row
        # longest bucket chain via memoized DFS (bucket ids carry no
        # ordering guarantee: Ceph assigns the root -1 and children -2...)
        depth: dict[int, int] = {}

        def bucket_depth(bid: int, seen: frozenset = frozenset()) -> int:
            if bid in depth:
                return depth[bid]
            if bid in seen:
                raise ValueError(f"bucket cycle through {bid}")
            d = 1
            for it in cmap.buckets[bid].items:
                if it < 0 and it in cmap.buckets:
                    d = max(d, bucket_depth(it, seen | {bid}) + 1)
            depth[bid] = d
            return d

        for bid in ids:
            bucket_depth(bid)
        return cls(items=items, weights=weights, sizes=sizes, types=types,
                   row_of_id=row_of_id, max_devices=cmap.max_devices,
                   max_depth=max(depth.values()), tunables=dict(t))


_KINDS = {
    CRUSH_RULE_CHOOSE_FIRSTN: (False, False),
    CRUSH_RULE_CHOOSELEAF_FIRSTN: (False, True),
    CRUSH_RULE_CHOOSE_INDEP: (True, False),
    CRUSH_RULE_CHOOSELEAF_INDEP: (True, True),
}


class BulkMapper:
    """Bulk CRUSH placement over a compiled straw2 map.

    map_rule(ruleno, xs) -> (out [N, numrep] int32 with CRUSH_ITEM_NONE
    holes/padding, placed [N] int32).  ``device`` is where it runs:
    ``"cuda"`` (the default) launches the hand kernel, ``"cpu"`` the plain
    PyTorch version.
    """

    # process-wide cache of the compiled map's tensors on each device, keyed
    # by map content: cloned/equal maps (the balancer clones per
    # optimization pass) share one upload.  LRU-bounded: reweight churn
    # produces a new digest per distinct map.  The kernel takes every shape
    # parameter at run time, so nothing is compiled per key.
    _global_cache: collections.OrderedDict | None = None
    _GLOBAL_CACHE_CAP = 16

    def __init__(self, cmap: CrushMap, device: str = "cuda"):
        cls = type(self)
        if cls._global_cache is None:
            cls._global_cache = collections.OrderedDict()
        self.cm = CompiledMap.compile(cmap)
        self.cmap = cmap
        self.device = device
        h = hashlib.sha256()
        for part in (self.cm.items.tobytes(), self.cm.weights.tobytes(),
                     self.cm.sizes.tobytes(), self.cm.types.tobytes(),
                     self.cm.row_of_id.tobytes()):
            h.update(part)
        h.update(repr(sorted(self.cm.tunables.items())).encode())
        self._digest = h.hexdigest()
        cache = cls._global_cache
        if self._digest in cache:
            cache.move_to_end(self._digest)
        else:
            cache[self._digest] = {}
            while len(cache) > cls._GLOBAL_CACHE_CAP:
                cache.popitem(last=False)
        self._cache = cache[self._digest]

    # -- choose_args compilation (mapper.c:309-326) --------------------------

    def _compile_choose_args(self, choose_args: dict | None):
        """Dense arrays for per-position weight-set overrides: ws
        [P, B, S] (position-major weights; buckets without an override
        replicate their base weights) and hash-id overrides ids [B, S]
        (``arg->ids``: alternate ids fed to the straw2 hash while the
        RETURNED item stays the bucket's own).  They are kernel inputs
        uploaded per call: the balancer's crush-compat loop mutates the
        values every iteration."""
        cm = self.cm
        if not choose_args:
            return 1, cm.weights[None, :, :], cm.items
        row_of = {bid: row for row, bid in enumerate(sorted(self.cmap.buckets))}
        P = max((len(a.get("weight_set") or [()])
                 for a in choose_args.values()), default=1) or 1
        ws = np.broadcast_to(cm.weights, (P,) + cm.weights.shape).copy()
        ids = cm.items.copy()
        for bid, arg in choose_args.items():
            row = row_of.get(bid)
            if row is None:
                continue
            size = int(cm.sizes[row])
            wset = arg.get("weight_set")
            if wset:
                for p in range(P):
                    # positions past the set reuse the LAST entry
                    # (mapper.c:318 "choose_args_index >= size -> size-1")
                    wrow = wset[min(p, len(wset) - 1)]
                    ws[p, row, :size] = np.asarray(wrow[:size],
                                                   dtype=np.int64)
            if arg.get("ids"):
                ids[row, :size] = np.asarray(arg["ids"][:size],
                                             dtype=np.int32)
        return P, ws, ids

    # -- tensors on the device ----------------------------------------------

    def _map_tensors(self, dev: torch.device) -> dict:
        """The compiled map's fixed tensors on ``dev``, uploaded once."""
        key = str(dev)
        got = self._cache.get(key)
        if got is None:
            cm = self.cm

            def up(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            got = {"items": up(cm.items), "ws": up(cm.weights[None]),
                   "recip": up(crush_kernels.straw2_reciprocals(
                       cm.weights[None], cm.sizes)),
                   "sizes": up(cm.sizes), "types": up(cm.types),
                   "row_of_id": up(cm.row_of_id), "ln": up(LN_TABLE_S64)}
            self._cache[key] = got
        return got

    def tables(self, choose_args: dict | None, device: str | None = None
               ) -> crush_kernels.Straw2Tables:
        """The kernel's tables on the mapper's device, with ``choose_args``
        (a weight set and hash-id overrides) applied."""
        dev = torch_device(device or self.device)
        fixed = self._map_tensors(dev)
        if choose_args:
            # the weight set changes on every balancer iteration: its
            # reciprocals are built with it
            _, ws, ids = self._compile_choose_args(choose_args)
            recip = crush_kernels.straw2_reciprocals(ws, self.cm.sizes)
            ws, recip, ids = (torch.from_numpy(np.ascontiguousarray(a)).to(
                dev) for a in (ws, recip, ids))
        else:
            ws, recip, ids = fixed["ws"], fixed["recip"], fixed["items"]
        return crush_kernels.Straw2Tables(
            items=fixed["items"], hash_ids=ids, ws=ws, recip=recip,
            sizes=fixed["sizes"], types=fixed["types"],
            row_of_id=fixed["row_of_id"], ln=fixed["ln"])

    def rule_shape(self, ruleno: int, result_max: int = 0
                   ) -> crush_kernels.RuleShape:
        """The kernel's run-time parameters for ``ruleno``; a rule outside
        take/choose/emit raises ValueError."""
        rule = self.cmap.rules[ruleno]
        steps = rule.steps
        if (len(steps) != 3 or steps[0][0] != CRUSH_RULE_TAKE or
                steps[2][0] != CRUSH_RULE_EMIT):
            raise ValueError("the bulk path supports take/choose/emit rules "
                             "only")
        op, arg1, arg2 = steps[1]
        if op not in _KINDS:
            raise ValueError(f"unsupported op {op} on the bulk path")
        indep, leaf = _KINDS[op]
        if leaf and arg2 == 0 and not indep:
            # chooseleaf firstn over failure-domain osd is a plain choose:
            # the reference copies the chosen device straight into the leaf
            # vector (mapper.c:592-596) and emits only the positions it
            # placed; indep keeps leaf, whose kernel emits the last device
            # a position rejected when its tries run out, as the reference
            # does
            leaf = False
        numrep = arg1
        if numrep <= 0:
            if result_max <= 0:
                raise ValueError("numrep<=0 rule needs result_max")
            numrep += result_max
        # the reference clamps only the output size; the retry stride keeps
        # the rule's numrep (crush_do_rule: out_size = min(numrep,
        # result_max-osize) while crush_choose_indep still gets numrep)
        out_size = min(numrep, result_max) if result_max else numrep
        cm = self.cm
        t = cm.tunables
        return crush_kernels.RuleShape(
            indep=indep, leaf=leaf,
            root_row=int(cm.row_of_id[-1 - steps[0][1]]),
            numrep=int(numrep), out_size=int(out_size), target_type=int(arg2),
            tries=int(t["choose_total_tries"]) + 1,
            vary_r=int(t["chooseleaf_vary_r"]),
            stable=int(t["chooseleaf_stable"]), max_depth=int(cm.max_depth),
            max_devices=int(cm.max_devices))

    # -- public API ---------------------------------------------------------

    def map_rule(self, ruleno: int, xs, reweights=None, result_max: int = 0,
                 choose_args: dict | None = None, device: str | None = None):
        """Map every x of ``xs`` (integers in [0, 2^32)) through rule
        ``ruleno``.  Host input (a list or numpy array) gives numpy
        results; a torch tensor gives tensors on the device, as they come
        from the kernel.  ``device`` overrides the mapper's own."""
        shape = self.rule_shape(ruleno, result_max)
        tables = self.tables(choose_args, device)
        dev = tables.device
        as_tensor = isinstance(xs, torch.Tensor)
        if as_tensor:
            xs_t = xs.to(dev)
        else:
            xs_t = torch.from_numpy(
                np.asarray(xs, dtype=np.int64) & 0xFFFFFFFF).to(dev)
        if reweights is None:
            reweights = np.full(self.cm.max_devices, 0x10000, dtype=np.int64)
        if not isinstance(reweights, torch.Tensor):
            reweights = torch.from_numpy(np.asarray(reweights,
                                                    dtype=np.int64))
        reweights = reweights.to(device=dev, dtype=torch.int64)
        with trace_span("crush.bulk_map", pgs=int(xs_t.shape[0]),
                        rule=int(ruleno),
                        kind="indep" if shape.indep else "firstn",
                        numrep=int(shape.numrep)):
            out, placed = crush_kernels.straw2_map(xs_t, tables, reweights,
                                                   shape)
            if not as_tensor:
                out, placed = out.cpu().numpy(), placed.cpu().numpy()
        return out, placed
