"""Regenerating-code repair planning: d helper inner products per loss.

Chained partial-sum repair (``recovery/chain.py``) already moved the
decode into the network, but any code that repairs by DECODE still moves
>= k chunks of independent data — the information floor.  Regenerating
codes change the floor itself: a product-matrix MSR/MBR plugin
(``plugins/plugin_pm_regen.py``, arXiv:1412.3022) rebuilds a lost chunk
from ``d`` helpers that each ship one beta-byte inner product
``psi_f . stored_chunk`` instead of a whole chunk — total repair wire
d*beta, which is ~1.0x the lost bytes at the MBR point and d/alpha at
MSR, both below the k-chunk floor.

This module is the planning half (the regen sibling of
``plan_chains``): capability probing so non-regenerating codes are
untouched, CRUSH-distance helper costing via the plugin's
``minimum_to_repair``, and plan assembly.  The data path lives in the
OSD shard handlers (``backend.pg_backend.OSDShard``): one
:class:`~ceph_tpu_torch.backend.messages.ECRegenRead` primes the newcomer
with the combine matrix, d more carry each helper's projection row, and
:class:`~ceph_tpu_torch.backend.messages.ECRegenHelper` ships the
beta-streams helper -> newcomer directly, so the coordinator sees
control traffic only.

Verification-first: every leg validates against the
replicated plan hinfo (local copy present, version match, length,
chunk crc; the newcomer re-checks the COMBINED chunk's crc), and ANY
mismatch — sub-chunk misalignment, helper death, version skew — aborts
the tid to the coordinator, which falls back to the centralized
verified wave path.  :class:`RegenRepair` duck-types
:class:`~ceph_tpu_torch.recovery.chain.ChainRepair`'s coordinator surface, so
completion, abort, shard-down and version-skew re-drive all ride the
existing chain machinery.

A copy of ``ceph_tpu.recovery.regen``; each leg runs where
:func:`~ceph_tpu_torch.recovery.chain.leg_device` says.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

from ..backend.ecutil import HINFO_KEY
from ..backend.messages import ECRegenRead
from ..common.tracer import trace_span
from .chain import leg_device, source_costs

__all__ = ["RegenRepair", "plan_regens"]


@dataclass
class RegenRepair:
    """Coordinator-side record of one in-flight regenerating repair.

    Same surface as :class:`~ceph_tpu_torch.recovery.chain.ChainRepair`
    (``pending_pushes``/``failed``/``oids``/``on_each``/``at_version``/
    ``hop_shards``), registered in ``backend._recovery_chains`` +
    ``backend._wave_pushes`` so applied/abort/shard-down/version-skew
    handling is shared; ``kind`` splits the perf counters."""
    tid: int
    oids: dict[str, set[int]]                 # oid -> {lost chunk}
    on_each: object                           # callback(oid, ok)
    at_version: dict[str, int] = field(default_factory=dict)
    lengths: dict[str, int] = field(default_factory=dict)  # STORED bytes
    rows: list[int] = field(default_factory=list)          # [lost chunk]
    hop_shards: tuple[int, ...] = ()          # helper shards + newcomer
    pending_pushes: dict[str, set[int]] = field(default_factory=dict)
    failed: set[str] = field(default_factory=set)
    device: str = "numpy"
    # when the plan was launched (perf_counter): its objects'
    # recovery.object start
    t0: float = field(default_factory=time.perf_counter)
    kind: str = "regen"


def plan_regens(backend, batch: dict[str, set[int]], on_each
                ) -> dict[str, set[int]]:
    """Plan regenerating repairs for a recovery batch.

    Returns the LEFTOVER oids the regen path cannot serve — callers run
    those through chains / centralized waves.  Leftover reasons: option
    disabled, plugin not regenerating, more than one lost chunk (the
    product-matrix repair protocol is single-erasure; multi-loss decodes
    centrally), fewer than d current helpers, a down target, an oid
    already owned by another wave/op, or missing plan metadata."""
    conf = backend.cct.conf
    ec = backend.ec_impl
    probe = getattr(ec, "supports_regenerating_repair", None)
    if (not conf.get("osd_recovery_regen_enable")
            or probe is None or not probe()):
        return dict(batch)
    leftovers: dict[str, set[int]] = {}
    groups: dict[int, dict[str, set[int]]] = {}
    for oid, missing in batch.items():
        if len(missing) != 1:
            leftovers[oid] = set(missing)
        elif oid in backend._wave_pushes or oid in backend.recovery_ops:
            leftovers[oid] = set(missing)
        else:
            groups.setdefault(next(iter(missing)), {})[oid] = set(missing)
    for lost, group in sorted(groups.items()):
        leftovers.update(_plan_group(backend, lost, group, on_each))
    return leftovers


def _plan_group(backend, lost: int, group: dict[str, set[int]], on_each
                ) -> dict[str, set[int]]:
    """Plan ONE regenerating repair for a lost-chunk group; returns the
    oids it could not take."""
    ec = backend.ec_impl
    d = int(ec.d)
    alpha = int(ec.get_sub_chunk_count())
    cur = backend.current_shards()
    up = backend.up_shards()
    acting = backend.acting
    locations = getattr(backend, "osd_locations", None)
    target = acting[lost]
    if target not in up:
        return group                     # a dead newcomer fails pre-flight
    avail = {c for c, s in enumerate(acting) if s in cur and c != lost}
    if len(avail) < d:
        return group
    try:
        helpers = list(ec.minimum_to_repair(
            lost, d, source_costs(avail, [target], acting, locations)))
    except IOError:
        return group
    try:
        proj = ec.repair_projection(lost).tobytes()
        combine = ec.repair_combine(lost, helpers).tobytes()
    except (IOError, ValueError):
        return group
    with trace_span("recovery.regen", owner="recovery",
                    objects=len(group), helpers=d):
        return _launch(backend, lost, group, on_each, helpers, proj,
                       combine, alpha)


def _launch(backend, lost: int, group, on_each, helpers: list[int],
            proj: bytes, combine: bytes, alpha: int
            ) -> dict[str, set[int]]:
    from .chain import _plan_attrs
    acting = backend.acting
    target = acting[lost]
    leftovers: dict[str, set[int]] = {}
    oids: list[str] = []
    lengths: list[int] = []
    versions: list[int] = []
    attrs: dict[str, dict] = {}
    at_version: dict[str, int] = {}
    for oid in sorted(group):
        hinfo = backend._read_hinfo(oid)
        length = hinfo.get_total_chunk_size()
        if not length or length % alpha:
            leftovers[oid] = group[oid]  # absent/empty or misaligned
            continue
        src_attrs = _plan_attrs(backend, oid, helpers)
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
    repair = RegenRepair(tid=tid,
                         oids={o: set(group[o]) for o in oids},
                         on_each=on_each, at_version=at_version,
                         lengths=dict(zip(oids, lengths)),
                         rows=[lost],
                         hop_shards=tuple(acting[c] for c in helpers)
                         + (target,),
                         device=device)
    for oid in oids:
        repair.pending_pushes[oid] = {target}
        backend._wave_pushes[oid] = repair
    backend._recovery_chains[tid] = repair
    # prime the newcomer FIRST so helper streams land on a known tid
    # (arrival order across senders is still not guaranteed — the shard
    # keeps a bounded orphan stash for early streams)
    backend.bus.send(target, ECRegenRead(
        from_shard=backend.whoami, tid=tid, coordinator=backend.whoami,
        target=target, chunk=lost, sub_count=alpha, combine=combine,
        helpers=list(helpers), oids=oids, lengths=lengths,
        versions=versions, attrs=attrs, device=device))
    for h in helpers:
        backend.bus.send(acting[h], ECRegenRead(
            from_shard=backend.whoami, tid=tid,
            coordinator=backend.whoami, target=target, chunk=h,
            sub_count=alpha, proj=proj, oids=oids, lengths=lengths,
            versions=versions, attrs=attrs, device=device))
    return leftovers
