"""A stand-in for the recovery scheduler, to drive shard repair by hand.

The port has ``ECBackend``'s repair path (``start_shard_repair``,
``repair_wave``) but not yet the scheduler and reserver that pace it
(``recovery/scheduler.py`` and ``recovery/reserver.py`` of the JAX
package).  :class:`WaveScheduler` is the least of that surface: set it as
``backend.recovery_scheduler`` and a revived shard's repair runs to its
end under ``bus.deliver_all()``, in waves of ``size`` objects, with no
reservations.  :func:`replace_disk` revives a shard on an empty disk.

Both are duck-typed over the backend and the bus, so the same driver
paces the JAX package's ``ECBackend`` in the differential tests.
"""
from __future__ import annotations


class WaveScheduler:
    """A revived shard's repair starts with this object as its driver, and
    the planner's missing set goes to ``repair_wave`` in waves of ``size``
    objects; ``waves`` counts the waves started."""

    def __init__(self, size: int = 64):
        self.size = size
        self.waves = 0

    def schedule_backend(self, backend, targets) -> None:
        for shard in targets:
            backend.start_shard_repair(shard, driver=self)

    def requeue_stalled(self, backend, stalled) -> None:
        for rop in stalled:
            backend.continue_recovery_op(rop)

    def offer_work(self, backend, rop, items) -> None:
        rop.deferred = list(items)
        self._next(backend, rop)

    def _next(self, backend, rop) -> None:
        if not rop.deferred:
            return
        items = rop.deferred[:self.size]
        del rop.deferred[:self.size]
        self.waves += 1
        backend.repair_wave(rop, items,
                            on_done=lambda: self._next(backend, rop))


def replace_disk(bus, shard: int, osd_shard=None) -> None:
    """The OSD behind ``shard`` dies and comes back on an empty disk: a
    fresh ``osd_shard`` (default the port's ``OSDShard``: an empty store
    and an empty PG log) takes its bus slot, and its revival starts the
    repair through the backend's scheduler."""
    if osd_shard is None:
        from ceph_tpu_torch.backend import OSDShard as osd_shard
    bus.mark_down(shard)
    osd_shard(shard, bus)
    bus.mark_up(shard)
