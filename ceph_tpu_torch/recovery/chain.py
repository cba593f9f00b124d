"""Chained streaming repair: partial-sum pipelines over survivor OSDs.

Centralized EC repair hauls k whole chunks to the coordinating primary
(k+|missing| chunk transfers per object).  For linear codes the decode is
a sum the NETWORK can compute instead: plan a chain of survivor shards,
have each hop GF-scale its local chunk by its decode coefficient and XOR
it into a running partial sum, and forward only that accumulator to the
next hop (the RapidRAID / partial-parallel-repair pipelining idea, cf.
arXiv:1207.6744).  The last hop holds the finished chunks and pushes
them straight to the repair targets — the coordinator sees control
traffic only.

Total cluster wire stays >= k transfers (information floor: k chunks'
worth of independent data must move), but the COORDINATOR ingress drops
from ~k chunks per object to ~zero and the repaired-bytes-per-wire-byte
ratio approaches 1 for single-erasure repair, which is what unclogs a
recovering primary.

This module is the planning half: CRUSH-distance source costing, hop
ordering, and wave-batch plan assembly.  The data path lives in the OSD
shard handlers (``backend.pg_backend.OSDShard``); the coordinator-side
bookkeeping record :class:`ChainRepair` duck-types ``_RecoveryWave``'s
surface (``pending_pushes`` / ``failed`` / ``oids`` / ``on_each`` /
``at_version``) so the existing wave completion and shard-down paths
drive chains unchanged.

A copy of ``ceph_tpu.recovery.chain``.  A plan carries the device its
hops run on (:func:`leg_device`): the plugin's own tensor device when its
routing sends a call of the plan's size to the card or the CPU tensors,
else ``"numpy"``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

from ..backend import ecutil
from ..backend.ecutil import HINFO_KEY
from ..backend.memstore import GObject
from ..backend.messages import ECPartialSum
from ..common.tracer import trace_span

__all__ = ["ChainRepair", "crush_distance", "leg_device", "source_costs",
           "order_hops", "plan_chains"]

# CRUSH-distance buckets (MiniCluster's map: host = osd // osds_per_host).
# The absolute values only matter relative to each other: same-OSD beats
# same-host beats cross-host, and cross-host is lossy enough to outweigh
# a same-host pair (1 + 1 < 3).
SAME_OSD = 0
SAME_HOST = 1
CROSS_HOST = 3


def crush_distance(a: int, b: int, locations=None) -> int:
    """Topology distance between two OSD ids.  ``locations`` maps osd ->
    host bucket; without a map every remote OSD is equidistant."""
    if a == b:
        return SAME_OSD
    if locations is None:
        return SAME_HOST
    ha, hb = locations.get(a), locations.get(b)
    return SAME_HOST if ha is not None and ha == hb else CROSS_HOST


def source_costs(sources, targets, acting, locations=None) -> dict[int, int]:
    """chunk id -> min CRUSH distance from its shard to any repair target
    (the cost map ``minimum_to_decode_with_cost`` ranks by)."""
    return {c: min(crush_distance(acting[c], t, locations) for t in targets)
            for c in sources}


def order_hops(sources, targets, acting, locations=None) -> list[int]:
    """Chain order over source chunks: farthest-from-target first so the
    final (and only target-facing) hop is the nearest survivor — the
    expensive cross-host legs carry one accumulator each, and the short
    last leg fans out the finished chunks.  Ties break on chunk id for
    determinism."""
    return sorted(sources,
                  key=lambda c: (-min(crush_distance(acting[c], t, locations)
                                      for t in targets), c))


@dataclass
class ChainRepair:
    """Coordinator-side record of one in-flight partial-sum chain.

    Duck-types the ``_RecoveryWave`` surface the push-completion and
    shard-down machinery in ``ECBackend``/``PGBackend`` already drives:
    ``pending_pushes``/``failed`` feed ``_finish_wave_oid``, ``oids`` +
    ``on_each`` feed ``_wave_fallback_one``, and registration in
    ``backend._wave_pushes`` routes dead-target handling for free."""
    tid: int
    oids: dict[str, set[int]]                 # oid -> missing chunks
    on_each: object                           # callback(oid, ok)
    at_version: dict[str, int] = field(default_factory=dict)  # pg_log version
    lengths: dict[str, int] = field(default_factory=dict)     # chunk bytes
    rows: list[int] = field(default_factory=list)             # erased chunks
    hop_shards: tuple[int, ...] = ()          # chain legs, in order
    pending_pushes: dict[str, set[int]] = field(default_factory=dict)
    failed: set[str] = field(default_factory=set)
    device: str = "numpy"
    # when the plan was launched (perf_counter): its objects'
    # recovery.object start
    t0: float = field(default_factory=time.perf_counter)


def leg_device(ec_impl, nbytes: int) -> str:
    """Where a repair leg over ``nbytes`` of chunk data runs: ``"cuda"``
    or ``"cpu"`` when the plugin routes a call of that size to a tensor
    codec (a profile with no ``device`` key: the card), ``"numpy"`` when
    it routes it to the host (``device=numpy``, or ``auto`` under its
    threshold) or has no device routing at all."""
    codec = ecutil._device_codec(ec_impl, nbytes)
    if codec is not None:
        return codec.device
    router = getattr(ec_impl, "use_device", None)
    if router is None or not router(int(nbytes)):
        return "numpy"
    return "cpu" if ec_impl.device == "cpu" else "cuda"


def plan_chains(backend, batch: dict[str, set[int]], on_each) -> dict[str, set[int]]:
    """Plan partial-sum chains for a recovery wave's batch.

    Groups ``batch`` (oid -> missing chunks) by missing-signature, plans
    one chain per group, registers :class:`ChainRepair` records on the
    backend and launches the first leg.  Returns the LEFTOVER oids the
    chain path cannot serve — callers run those through the centralized
    wave/per-object machinery.  Leftover reasons: option disabled, no
    linear whole-chunk repair form (sub-chunked/clay), chain longer than
    ``osd_recovery_chain_max_len``, a down target, version skew, an oid
    already owned by another wave/op, or missing plan metadata."""
    conf = backend.cct.conf
    if not conf.get("osd_recovery_chain_enable"):
        return dict(batch)
    max_len = int(conf.get("osd_recovery_chain_max_len"))
    leftovers: dict[str, set[int]] = {}
    groups: dict[frozenset, dict[str, set[int]]] = {}
    for oid, missing in batch.items():
        if oid in backend._wave_pushes or oid in backend.recovery_ops:
            # the push slot / op slot is per-oid (one repair owner at a
            # time) — the per-object path knows how to chain behind it
            leftovers[oid] = set(missing)
        else:
            groups.setdefault(frozenset(missing), {})[oid] = set(missing)
    for sig, group in sorted(groups.items(), key=lambda kv: sorted(kv[0])):
        leftovers.update(_plan_group(backend, sig, group, on_each, max_len))
    return leftovers


def _plan_group(backend, sig: frozenset, group: dict[str, set[int]],
                on_each, max_len: int) -> dict[str, set[int]]:
    """Plan ONE chain for a missing-signature group; returns the oids it
    could not take."""
    k = backend.ec_impl.get_data_chunk_count()
    cur = backend.current_shards()
    up = backend.up_shards()
    acting = backend.acting
    locations = getattr(backend, "osd_locations", None)
    if any(acting[c] not in up for c in sig):
        return group                     # a dead target fails pre-flight
    avail = {c for c, s in enumerate(acting) if s in cur and c not in sig}
    if len(avail) < k:
        return group
    try:
        srcs = backend.ec_impl.minimum_to_decode_with_cost(
            set(sig), source_costs(avail, [acting[c] for c in sig],
                                   acting, locations))
    except IOError:
        return group
    ps = backend.ec_impl.partial_sum_coefficients(set(sig), sorted(srcs))
    if ps is None:
        return group                     # no linear whole-chunk form
    coeffs, rows = ps
    if not coeffs or len(coeffs) > max_len:
        return group
    targets = [acting[r] for r in rows]
    hop_chunks = order_hops(coeffs, targets, acting, locations)
    with trace_span("recovery.chain", owner="recovery", objects=len(group),
                    hops=len(hop_chunks)):
        return _launch(backend, group, on_each, rows, targets,
                       hop_chunks, coeffs)


def _launch(backend, group, on_each, rows, targets, hop_chunks, coeffs
            ) -> dict[str, set[int]]:
    acting = backend.acting
    leftovers: dict[str, set[int]] = {}
    oids: list[str] = []
    lengths: list[int] = []
    versions: list[int] = []
    attrs: dict[str, dict] = {}
    at_version: dict[str, int] = {}
    for oid in sorted(group):
        hinfo = backend._read_hinfo(oid)
        length = hinfo.get_total_chunk_size()
        if not length:
            leftovers[oid] = group[oid]  # absent/empty: nothing to chain
            continue
        src_attrs = _plan_attrs(backend, oid, hop_chunks)
        if src_attrs is None:
            leftovers[oid] = group[oid]
            continue
        attrs[oid] = {x: v for x, v in src_attrs.items() if x != HINFO_KEY}
        attrs[oid][HINFO_KEY] = hinfo.to_dict()
        at_version[oid] = backend.pg_log.last_version_of(oid)
        oids.append(oid)
        lengths.append(int(length))
        versions.append(int(hinfo.version))
    if not oids:
        return leftovers
    device = leg_device(backend.ec_impl, sum(lengths))
    backend.next_tid += 1
    tid = backend.next_tid
    chain = ChainRepair(tid=tid,
                        oids={o: set(group[o]) for o in oids},
                        on_each=on_each, at_version=at_version,
                        lengths=dict(zip(oids, lengths)),
                        rows=list(rows),
                        hop_shards=tuple(acting[c] for c in hop_chunks),
                        device=device)
    for oid in oids:
        chain.pending_pushes[oid] = set(targets)
        backend._wave_pushes[oid] = chain
    backend._recovery_chains[tid] = chain
    msg = ECPartialSum(from_shard=backend.whoami, tid=tid,
                       coordinator=backend.whoami, oids=oids,
                       lengths=lengths, versions=versions,
                       rows=list(rows), targets=list(targets),
                       hops=[(acting[c], c, tuple(coeffs[c]))
                             for c in hop_chunks],
                       attrs=attrs, acc=None, device=device)
    backend.bus.send(chain.hop_shards[0], msg)
    return leftovers


def _plan_attrs(backend, oid: str, hop_chunks) -> dict | None:
    """Replicated attrs from the first chain source holding a current
    copy (every hop is current by construction; mirrors the authority
    order ``_read_hinfo`` uses)."""
    from ..backend.pg_backend import shard_store
    for c in hop_chunks:
        s = backend.acting[c]
        if s not in backend.bus.handlers:
            continue
        try:
            return shard_store(backend.bus, s).getattrs(GObject(oid, s))
        except (FileNotFoundError, KeyError):
            continue
    return None
