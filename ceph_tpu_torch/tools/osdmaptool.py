"""osdmaptool equivalent: bulk PG mapping tests and histograms.

Mirror of the reference tool's --test-map-pgs family (reference:
src/tools/osdmaptool.cc:38-40 usage, :491-610 the mapping loop, histogram
table and stddev summary) driven by the bulk straw2 mapper (one kernel
launch a pool) instead of a per-PG loop; the counts are numpy passes over
the mapping, and only the per-PG dump lines loop over PGs.  Output format matches the reference line-for-line so existing
tooling can parse it:

    pool 1 pg_num 64
    #osd   count  first  primary  c wt   wt
    osd.0  12     4      4        1.0    1.0
    ...
     in 9
     avg 21 stddev 2.1 (0.1x) (expected 4.3 0.2x))
     min osd.3 18
     max osd.7 25

CLI:  python -m ceph_tpu_torch.tools.osdmaptool MAP.json --test-map-pgs
      [--pool N] [--test-map-pgs-dump] [--test-map-pgs-dump-all]
      [--device {cuda,cpu}]
"""
from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np

from ..crush.map import CRUSH_ITEM_NONE
from ..osdmap import OSDMap, PG
from ..osdmap.bulk import BulkPGMapper


def device_crush_weights(crush) -> dict[int, int]:
    """Leaf item -> 16.16 weight (delegates to CrushMap.device_weights)."""
    return crush.device_weights()


def _dump_lines(m: OSDMap, pid: int, pm, dump_all: bool, w) -> None:
    """The per-PG lines of --test-map-pgs-dump[-all]."""
    for ps in range(m.pools[pid].pg_num):
        acting = [int(o) for o in pm.acting[ps] if o != CRUSH_ITEM_NONE]
        primary = int(pm.acting_primary[ps])
        if not dump_all:
            w(f"{pid}.{ps:x}\t{acting}\t{primary}\n")
            continue
        raw, rawp = m.pg_to_raw_osds(PG(pid, ps))
        up = [int(o) for o in pm.up[ps] if o != CRUSH_ITEM_NONE]
        upp = int(pm.up_primary[ps])
        w(f"{pid}.{ps:x} raw ({raw}, p{rawp}) up ({up}, p{upp}) "
          f"acting ({acting}, p{primary})\n")


def test_map_pgs(m: OSDMap, pool: int = -1, dump: bool = False,
                 dump_all: bool = False, out=None,
                 device: str = "cuda") -> dict:
    """The --test-map-pgs[-dump[-all]] loop (osdmaptool.cc:491-610).
    Returns the stats dict; prints the reference-format report to ``out``.
    The pools map on ``device``: ``"cuda"`` (the default) or ``"cpu"``."""
    w = out.write if out is not None else (lambda s: None)
    n = m.max_osd
    count = np.zeros(n, dtype=np.int64)
    first_count = np.zeros(n, dtype=np.int64)
    primary_count = np.zeros(n, dtype=np.int64)
    size_hist: dict[int, int] = {}
    mapper = BulkPGMapper(m, device=device)

    for pid in sorted(m.pools):
        if pool != -1 and pid != pool:
            continue
        p = m.pools[pid]
        w(f"pool {pid} pg_num {p.pg_num}\n")
        pm = mapper.map_pool(pid)
        if dump or dump_all:
            _dump_lines(m, pid, pm, dump_all and not dump, w)
        valid = pm.acting != CRUSH_ITEM_NONE
        sizes = valid.sum(axis=1)
        # the histogram's keys in the order a walk over the PGs meets them
        vals, first, hits = np.unique(sizes, return_index=True,
                                      return_counts=True)
        for i in np.argsort(first, kind="stable"):
            size_hist[int(vals[i])] = size_hist.get(int(vals[i]), 0) + \
                int(hits[i])
        np.add.at(count, pm.acting[valid], 1)
        placed = valid.any(axis=1)
        np.add.at(first_count,
                  pm.acting[placed, valid[placed].argmax(axis=1)], 1)
        prim = pm.acting_primary
        np.add.at(primary_count, prim[prim >= 0], 1)
    count = count.tolist()
    first_count = first_count.tolist()
    primary_count = primary_count.tolist()

    cw = device_crush_weights(m.crush)
    total = 0
    n_in = 0
    min_osd = max_osd = -1
    w("#osd\tcount\tfirst\tprimary\tc wt\twt\n")
    for i in range(n):
        if not m.is_in(i) or cw.get(i, 0) <= 0:
            continue
        n_in += 1
        w(f"osd.{i}\t{count[i]}\t{first_count[i]}\t{primary_count[i]}"
          f"\t{cw.get(i, 0) / 0x10000:g}\t{m.osd_weight[i] / 0x10000:g}\n")
        total += count[i]
        if count[i] and (min_osd < 0 or count[i] < count[min_osd]):
            min_osd = i
        if count[i] and (max_osd < 0 or count[i] > count[max_osd]):
            max_osd = i
    avg = total // n_in if n_in else 0
    dev = 0.0
    for i in range(n):
        if not m.is_in(i) or cw.get(i, 0) <= 0:
            continue
        dev += (avg - count[i]) ** 2
    dev = math.sqrt(dev / n_in) if n_in else 0.0
    edev = math.sqrt(total / n_in * (1.0 - 1.0 / n_in)) if n_in else 0.0
    w(f" in {n_in}\n")
    w(f" avg {avg} stddev {dev:g} ({dev / avg if avg else 0:g}x) "
      f"(expected {edev:g} {edev / avg if avg else 0:g}x))\n")
    if min_osd >= 0:
        w(f" min osd.{min_osd} {count[min_osd]}\n")
    if max_osd >= 0:
        w(f" max osd.{max_osd} {count[max_osd]}\n")
    w(f"size {json.dumps(dict(sorted(size_hist.items())))}\n")
    return {"count": count, "first": first_count, "primary": primary_count,
            "size_hist": size_hist, "in": n_in, "avg": avg, "stddev": dev,
            "min_osd": min_osd, "max_osd": max_osd, "total": total}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="osdmaptool", description=__doc__.splitlines()[0])
    ap.add_argument("mapfile", help="OSDMap as JSON (OSDMap.to_dict)")
    ap.add_argument("--test-map-pgs", action="store_true")
    ap.add_argument("--test-map-pgs-dump", action="store_true")
    ap.add_argument("--test-map-pgs-dump-all", action="store_true")
    ap.add_argument("--test-map-pg", metavar="PGID",
                    help="map one pg, e.g. 1.7")
    ap.add_argument("--pool", type=int, default=-1)
    ap.add_argument("--print", dest="do_print", action="store_true",
                    help="summarize the map")
    ap.add_argument("--upmap", metavar="OUT",
                    help="calculate pg upmap entries to balance pg layout "
                         "and write them as JSON (osdmaptool --upmap)")
    ap.add_argument("--upmap-deviation", type=float, default=1.0)
    ap.add_argument("--upmap-max", type=int, default=32,
                    help="max optimization iterations")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the bulk placement runs (cpu: the plain "
                         "PyTorch version)")
    args = ap.parse_args(argv)

    with open(args.mapfile) as f:
        m = OSDMap.from_dict(json.load(f))

    if args.do_print:
        print(f"epoch {m.epoch}")
        print(f"max_osd {m.max_osd}")
        for pid in sorted(m.pools):
            p = m.pools[pid]
            kind = "replicated" if p.type == 1 else "erasure"
            print(f"pool {pid} '{p.name}' {kind} size {p.size} "
                  f"pg_num {p.pg_num} crush_rule {p.crush_rule}")
    if args.test_map_pg:
        pool_s, ps_s = args.test_map_pg.split(".")
        pg = PG(int(pool_s), int(ps_s, 16))
        print(f" parsed '{args.test_map_pg}' -> {pg}")
        raw, rawp = m.pg_to_raw_osds(pg)
        up, upp, acting, actingp = m.pg_to_up_acting_osds(pg)
        print(f"{pg} raw ({raw}, p{rawp}) up ({up}, p{upp}) "
              f"acting ({acting}, p{actingp})")
    if args.test_map_pgs or args.test_map_pgs_dump or args.test_map_pgs_dump_all:
        test_map_pgs(m, pool=args.pool, dump=args.test_map_pgs_dump,
                     dump_all=args.test_map_pgs_dump_all, out=sys.stdout,
                     device=args.device)
    if args.upmap:
        from ..mgr import calc_pg_upmaps
        inc = calc_pg_upmaps(
            m, max_iterations=args.upmap_max,
            max_deviation=args.upmap_deviation,
            pools=None if args.pool == -1 else [args.pool],
            device=args.device)
        entries = {f"{pg.pool}.{pg.ps}": items
                   for pg, items in inc.new_pg_upmap_items.items()}
        with open(args.upmap, "w") as f:
            json.dump({"pg_upmap_items": entries}, f, indent=1)
            f.write("\n")
        print(f"wrote {len(entries)} pg_upmap_items to {args.upmap}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
