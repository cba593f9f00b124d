"""Balancer: even out PG counts with pg_upmap_items.

Mirror of the reference's upmap balancer (reference:
src/pybind/mgr/balancer/module.py upmap mode driving
``OSDMap::calc_pg_upmaps``, src/osd/OSDMap.h:1439 — iterate: find the most
overfull OSD vs its weight-proportional target, move one of its PGs to the
most underfull OSD via a ``pg_upmap_items`` entry, re-check).  Like the
reference, moves operate on the **up mapping** (raw CRUSH + upmap, no
pg_temp — temp mappings are transient recovery state) and every candidate
is applied speculatively and re-verified through the real mapping chain
before being kept: the item must actually remove ``over``, land ``under``,
keep all OSDs distinct, and preserve host-separation where the layout had
it.

Placement counting runs through the bulk mapper, one launch of the straw2
kernel per pool per iteration (the reference walks PGs on CPU threads);
the per-OSD counts and the search for a PG holding ``over`` but not
``under`` are numpy passes over the mapping, not loops over PGs.  Each
entry point takes ``device``: ``"cuda"`` (the default) or ``"cpu"`` (the
plain version).
"""
from __future__ import annotations

import numpy as np

from ..crush.map import CRUSH_ITEM_NONE
from ..osdmap import Incremental, OSDMap, PG
from ..osdmap.bulk import BulkPGMapper


def osd_deviation(m: OSDMap, pools: list[int] | None = None,
                  mapper: BulkPGMapper | None = None, device: str = "cuda"):
    """Per-OSD (count, target) from the **up** sets; target is
    weight-proportional.  Returns (counts, targets, mappings) where
    mappings is {pool_id: PoolMapping} for reuse by the move search.
    ``device`` is the mapper's when none is given."""
    counts = np.zeros(m.max_osd, dtype=np.int64)
    total_slots = 0
    if mapper is None:
        mapper = BulkPGMapper(m, device=device)
    mappings = {}
    for pid in (pools if pools is not None else sorted(m.pools)):
        pm = mapper.map_pool(pid)
        mappings[pid] = pm
        osds = pm.up[pm.up != CRUSH_ITEM_NONE]
        np.add.at(counts, osds, 1)
        total_slots += int(osds.size)
    cw = m.crush.device_weights()
    eff = np.zeros(m.max_osd)
    for o in range(m.max_osd):
        if m.is_in(o):
            eff[o] = cw.get(o, 0) * (m.osd_weight[o] / 0x10000)
    tw = eff.sum()
    targets = (eff / tw * total_slots) if tw else eff
    return counts, targets, mappings


def _host_of(m: OSDMap) -> dict[int, int]:
    host = {}
    for bid, b in m.crush.buckets.items():
        # shadow (per-class clone) hosts must not register as separate
        # physical hosts, or the upmap host-separation check would let
        # two replicas share one real host
        if m.crush.is_shadow(bid):
            continue
        if m.crush.type_names.get(b.type) == "host":
            for item in b.items:
                if item >= 0:
                    host[item] = b.id
    return host


def _try_move(work: OSDMap, pg: PG, over: int, under: int,
              host_of: dict[int, int]) -> list[tuple[int, int]] | None:
    """Build the pg_upmap_items list that moves `over` -> `under` for this
    PG, apply it speculatively, and verify through the real chain
    (the reference's try_pg_upmap + re-check).  Returns the verified items
    list, or None."""
    up_before, *_ = work.pg_to_raw_up(pg)
    real_before = [o for o in up_before if o != CRUSH_ITEM_NONE]
    if over not in real_before or under in real_before:
        return None

    raw, _ = work.pg_to_raw_osds(pg)
    items = list(work.pg_upmap_items.get(pg, []))
    if over in raw:
        # raw slot maps to `over` directly: add a fresh item
        items = [(f, t) for f, t in items if f != over] + [(over, under)]
    else:
        # `over` only appears via an existing item (f -> over): rewrite it
        rewritten = False
        for i, (f, t) in enumerate(items):
            if t == over:
                items[i] = (f, under)
                rewritten = True
                break
        if not rewritten:
            return None

    saved = work.pg_upmap_items.get(pg)
    work.pg_upmap_items[pg] = items
    up_after, *_ = work.pg_to_raw_up(pg)
    real_after = [o for o in up_after if o != CRUSH_ITEM_NONE]

    ok = (over not in real_after and under in real_after and
          len(real_after) == len(set(real_after)) and
          len(real_after) == len(real_before))
    if ok and host_of:
        hosts_before = [host_of.get(o) for o in real_before]
        if len(set(hosts_before)) == len(hosts_before):  # was host-separated
            hosts_after = [host_of.get(o) for o in real_after]
            ok = len(set(hosts_after)) == len(hosts_after)
    if not ok:
        if saved is None:
            del work.pg_upmap_items[pg]
        else:
            work.pg_upmap_items[pg] = saved
        return None
    return items


def _subtree_devices(m: OSDMap) -> dict[int, list[int]]:
    """bucket/device id -> devices under it (memoized DFS)."""
    out: dict[int, list[int]] = {}

    def walk(item: int) -> list[int]:
        if item in out:
            return out[item]
        if item >= 0:
            out[item] = [item]
        else:
            devs: list[int] = []
            for child in m.crush.buckets[item].items:
                devs.extend(walk(child))
            out[item] = devs
        return out[item]

    for bid in m.crush.buckets:
        walk(bid)
    return out


def calc_weight_set(m: OSDMap, max_iterations: int = 16, step: float = 0.4,
                    pools: list[int] | None = None,
                    device: str = "cuda") -> dict | None:
    """The balancer's crush-compat mode: build the COMPAT weight-set
    (choose_args key -1, one position) nudging every bucket item's straw2
    weight toward its subtree's PG-load target — the role
    ``do_crush_compat`` plays in the reference's balancer module
    (src/pybind/mgr/balancer/module.py) over CrushWrapper's
    ``choose_args``.  Works where upmap can't be used (pre-luminous
    clients), evaluated through the vmapped bulk mapper each iteration.

    Returns the choose_args set ({bucket_id: {"weight_set": [[...]]}}) to
    install as ``m.crush.choose_args[-1]``, or None if no improvement was
    found.
    """
    work = m.clone()
    subtree = _subtree_devices(work)
    # candidate: start from the buckets' own weights (single position)
    cand = {bid: {"weight_set": [list(b.item_weights)]}
            for bid, b in work.crush.buckets.items()}

    # the compiled tree is fixed; the weight set goes with each call
    mapper = BulkPGMapper(work, device=device)

    def evaluate():
        counts, targets, _ = osd_deviation(work, pools, mapper=mapper)
        mask = np.array([work.is_in(o) for o in range(work.max_osd)])
        dev = np.where(mask, counts - targets, 0.0)
        return counts, targets, float(np.sqrt((dev ** 2).mean()))

    work.crush.choose_args[-1] = cand
    counts, targets, best = evaluate()
    best_cand = {bid: {"weight_set": [list(a["weight_set"][0])]}
                 for bid, a in cand.items()}
    improved = False

    for _ in range(max_iterations):
        # nudge each bucket item by its subtree's load ratio
        for bid, b in work.crush.buckets.items():
            ws = cand[bid]["weight_set"][0]
            for i, item in enumerate(b.items):
                devs = subtree[item]
                c = sum(counts[d] for d in devs if d < len(counts))
                t = sum(targets[d] for d in devs if d < len(targets))
                if t <= 0 or ws[i] <= 0:
                    continue
                ratio = max(0.5, min(2.0, (t / max(c, 0.5)) ** step))
                ws[i] = max(1, int(ws[i] * ratio))
        counts, targets, rms = evaluate()
        if rms < best - 1e-9:
            best = rms
            best_cand = {bid: {"weight_set": [list(a["weight_set"][0])]}
                         for bid, a in cand.items()}
            improved = True
        else:
            break
    return best_cand if improved else None


def calc_pg_upmaps(m: OSDMap, max_iterations: int = 32,
                   max_deviation: float = 1.0,
                   pools: list[int] | None = None,
                   device: str = "cuda") -> Incremental:
    """Propose pg_upmap_items to bring every OSD within ``max_deviation``
    PGs of its target.  Returns an Incremental (possibly empty); apply with
    ``apply_incremental`` or feed to Monitor.pending."""
    work = m.clone()
    inc = Incremental()
    host_of = _host_of(work)
    pool_ids = pools if pools is not None else sorted(work.pools)
    # the compiled tree is fixed; the upmap entries apply after the map
    mapper = BulkPGMapper(work, device=device)

    for _ in range(max_iterations):
        counts, targets, mappings = osd_deviation(work, pool_ids,
                                                  mapper=mapper)
        dev = counts - targets
        mask = np.array([work.is_in(o) and work.is_up(o)
                         for o in range(work.max_osd)])
        dev_masked = np.where(mask, dev, 0.0)
        over = int(dev_masked.argmax())
        under = int(np.where(mask, dev, np.inf).argmin())
        if dev_masked[over] <= max_deviation:
            break
        moved = False
        for pid in pool_ids:
            up = mappings[pid].up
            holds = (up == over).any(axis=1) & ~(up == under).any(axis=1)
            for ps in np.flatnonzero(holds).tolist():
                pg = PG(pid, ps)
                items = _try_move(work, pg, over, under, host_of)
                if items is not None:
                    inc.new_pg_upmap_items[pg] = list(items)
                    moved = True
                    break
            if moved:
                break
        if not moved:
            break
    return inc
