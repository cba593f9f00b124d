"""FaultyStore: ObjectStore wrapper injecting EIO / torn writes / slow reads.

The store plane of the fault injector (reference territory: filestore's
EIO injection and ``bluestore_debug_inject_read_err``).  Wraps ANY store
flavour (MemStore / FileStore / BlueStoreLite / a Collection view) and
delegates everything except the two paths it faults:

- :meth:`read` — injected EIO (``errno.EIO``) or an injected slow-read
  stall of ``slow_read_ms``;
- :meth:`queue_transaction` — injected EIO before anything applies, or a
  TORN write: a strict PREFIX of the transaction's ops applies and the
  call still fails, the crash-consistency shape WAL replay and scrub
  must catch.

The wrapper is transparent to identity-insensitive callers (attribute
delegation via ``__getattr__``); ``unwrap(store)`` recovers the inner
store for teardown paths that need the real object.

The port's copy of ``ceph_tpu.failure.store``.
"""
from __future__ import annotations

import errno
import time


class FaultyStore:
    """Injecting proxy around an ObjectStore."""

    def __init__(self, store, injector, target: str = ""):
        # avoid __getattr__ recursion: set via object.__setattr__ names
        self._store = store
        self._inj = injector
        self._target = target

    # -- faulted paths -----------------------------------------------------

    def read(self, obj, offset: int = 0, length=None):
        f = self._inj.plan.store
        if self._inj.roll("store", "eio_read", f.eio_read_prob,
                          target=self._target or str(obj)):
            e = IOError(f"injected EIO reading {obj}")
            e.errno = errno.EIO
            raise e
        if self._inj.roll("store", "slow_read", f.slow_read_prob,
                          target=self._target or str(obj),
                          ms=f.slow_read_ms):
            time.sleep(f.slow_read_ms / 1000.0)
        return self._store.read(obj, offset, length)

    def queue_transaction(self, t):
        f = self._inj.plan.store
        if self._inj.roll("store", "eio_write", f.eio_write_prob,
                          target=self._target):
            e = IOError("injected EIO on transaction")
            e.errno = errno.EIO
            raise e
        if len(t.ops) > 1 and self._inj.roll(
                "store", "torn_write", f.torn_write_prob,
                target=self._target, ops=len(t.ops)):
            torn = type(t)()
            torn.ops = list(t.ops[:len(t.ops) // 2])
            self._store.queue_transaction(torn)
            e = IOError(f"injected torn write ({len(torn.ops)}/"
                        f"{len(t.ops)} ops applied)")
            e.errno = errno.EIO
            raise e
        return self._store.queue_transaction(t)

    # -- delegation --------------------------------------------------------

    def __getattr__(self, name):
        return getattr(self._store, name)

    def __repr__(self) -> str:
        return f"FaultyStore({self._store!r})"


def unwrap(store):
    """The real store behind any FaultyStore layers."""
    while isinstance(store, FaultyStore):
        store = store._store
    return store
