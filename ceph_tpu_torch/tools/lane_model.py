"""How busy a warp's lanes keep in two designs of the straw2 placement
kernel, from the bucket choices that placing each x takes.

The plain version (``crush_kernels.straw2_map_plain``) makes the
reference's choices in the reference's loop order: each call of its
``choose`` is one (pass or rep, try, outer or leaf stage, depth) step over
every x still making it.  Recording each call's x's, bucket slots and live
draws gives each x its own sequence of choices.  Over warps of 32
consecutive x's, the share of lane-slots that hash a live slot is then:

- ``lockstep`` (the reference's loops in every lane, in step with the
  warp; ``csrc/crush_straw2.cu`` up to PR 8): the warp runs every step
  any of its lanes makes, each as long as the longest lane's bucket;
- ``cursor`` (the kernel now): each lane walks its own choices, at most
  CHUNK slots a step; the warp's i-th step is as long as its lanes'
  longest i-th step.

A model of control flow, not a measurement: it counts neither the issue
cost of a step nor memory.  Run on the CPU, over the first PGs of
``chip_smoke.py``'s placement pools::

    python -m ceph_tpu_torch.tools.lane_model [--pgs 2048]
"""
from __future__ import annotations

import argparse
import json
import os
import re

import numpy as np
import torch

from ceph_tpu_torch.ops import crush_kernels as CK
from ceph_tpu_torch.ops import cuda_build

WARP = 32


def kernel_chunk() -> int:
    """CHUNK of csrc/crush_straw2.cu: the slots a lane scans a step."""
    with open(os.path.join(cuda_build.CSRC, "crush_straw2.cu")) as f:
        return int(re.search(r"constexpr int CHUNK = (\d+);",
                             f.read()).group(1))


class _Traced(CK._Plain):
    """The plain version, recording each choose call: its x's, and each
    x's bucket slots and live draws."""

    def __init__(self, *args):
        super().__init__(*args)
        self.calls = []

    def choose(self, row, x, r, pos):
        crow = CK._wrap(row, self.items.shape[0])
        ws = self.ws[pos.clamp(max=self.ws.shape[0] - 1), crow]
        size = self.sizes[crow]
        live = (ws > 0) & (self.slot[None, :] < size[:, None])
        self.calls.append((x.numpy().copy(),
                           size.clamp(max=self.items.shape[1]).numpy(),
                           live.sum(1).numpy()))
        return super().choose(row, x, r, pos)


def choices(xs: np.ndarray, tables: CK.Straw2Tables, reweights,
            shape: CK.RuleShape) -> list[list[tuple[int, int, int]]]:
    """Per x (distinct values in [0, 2^32)): its bucket choices in order,
    as (step of the reference's loops, slots, live draws)."""
    xs = np.asarray(xs, dtype=np.int64) & 0xFFFFFFFF
    order = np.argsort(xs)
    if len(np.unique(xs)) != len(xs):
        raise ValueError("the x's must be distinct")
    plain = _Traced(tables, torch.as_tensor(reweights, dtype=torch.int64),
                    shape)
    if shape.indep:
        plain.indep(torch.from_numpy(xs))
    else:
        plain.firstn(torch.from_numpy(xs))
    per_x = [[] for _ in xs]
    for step, (x, slots, live) in enumerate(plain.calls):
        for i, s, d in zip(order[np.searchsorted(xs[order], x)], slots,
                           live):
            per_x[i].append((step, int(s), int(d)))
    return per_x


def lane_efficiency(per_x: list, chunk: int) -> dict:
    """The share of a warp's lane-slots that hash a live slot under the
    ``lockstep`` and ``cursor`` models (a partial last warp left out)."""
    useful = lockstep = cursor = 0
    for w in range(0, len(per_x) - WARP + 1, WARP):
        warp = per_x[w:w + WARP]
        useful += sum(d for x in warp for _, _, d in x)
        longest = {}
        for x in warp:
            for step, slots, _ in x:
                longest[step] = max(longest.get(step, 0), slots)
        lockstep += WARP * sum(longest.values())
        steps = [[min(chunk, slots - k) for _, slots, _ in x
                  for k in range(0, max(slots, 1), chunk)] for x in warp]
        cursor += WARP * sum(max(lane[i] if i < len(lane) else 0
                                 for lane in steps)
                             for i in range(max(map(len, steps))))
    return {"useful_draws": useful, "lockstep": useful / lockstep,
            "cursor": useful / cursor}


def main(argv=None) -> int:
    from ceph_tpu_torch.tools import path_shapes as PS
    ap = argparse.ArgumentParser(prog="lane_model")
    ap.add_argument("--pgs", type=int, default=2048,
                    help="PGs of each placement pool (default 2048)")
    args = ap.parse_args(argv)
    pkg = PS.load_package()
    m = PS.placement_cluster(pkg, args.pgs)
    mapper = pkg.osdmap.BulkPGMapper(m, device="cpu")
    chunk = kernel_chunk()
    for pid in sorted(m.pools):
        pool = m.pools[pid]
        shape = mapper.bulk.rule_shape(pool.crush_rule, pool.size)
        for variant, (rw, ca) in PS.placement_variants(m).items():
            eff = lane_efficiency(choices(mapper.pool_pps(pool),
                                          mapper.bulk.tables(ca), rw, shape),
                                  chunk)
            print(json.dumps({"pool": pool.name, "variant": variant,
                              "xs": pool.pg_num, "chunk": chunk, **eff}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
