"""Flight recorder: snapshot everything the moment something goes wrong.

The reference keeps per-daemon ring buffers (recent log entries, historic
ops) precisely so that a crash dump carries the run-up, not just the
corpse.  This module is the cluster-wide version of that idea for the
telemetry stack: when a health check enters WARN/ERR (the
:class:`~ceph_tpu_torch.mgr.health.HealthCheckEngine` transition hook), or when
an operator asks via the ``flight dump`` admin command, the recorder
captures ONE timestamped JSON bundle holding

- the span tracer's event ring (Chrome trace-event),
- the launch telemetry registry (``jit dump``: per (kernel, launch shape)
  its first launch and launches, from ``ops/launch_ledger.py``),
- every perf-counter collection (``perf dump``),
- the device-telemetry snapshot (``common/device_telemetry.py``: the
  card's inventory and memory, over ``torch.cuda``),
- every attached source (the owning cluster attaches its health
  evaluation and stats digest),

so the question "what was the system doing when X went wrong" is
answered from the artifact alone — no reproduction required (the
BENCH_r05 lesson applied to incidents instead of benchmarks).

Bundles land in a bounded in-memory ring and, when ``out_dir`` is set,
as ``flight-<seq>-<reason>.json`` files.  Every source is exception-
guarded: the recorder runs DURING incidents, when subsystems may be in
exactly the broken state that triggered it.

A copy of ``ceph_tpu.common.flight_recorder``.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from pathlib import Path

from . import device_telemetry
from . import tracer as tracer_mod
from .context import default_context

FLIGHT_BUNDLE_VERSION = 1


def _sanitize(reason: str) -> str:
    return "".join(ch if ch.isalnum() or ch in "-_" else "_"
                   for ch in reason)[:80]


class FlightRecorder:
    """Bounded ring of diagnostic bundles + optional on-disk dumps."""

    def __init__(self, cct=None, out_dir=None, capacity: int = 8,
                 max_disk_bundles: int = 64,
                 min_repeat_interval_s: float = 300.0):
        self.cct = cct if cct is not None else default_context()
        self.out_dir = Path(out_dir) if out_dir is not None else None
        self.bundles: deque[dict] = deque(maxlen=max(1, capacity))
        # the on-disk ring is larger than the in-memory one (disk is the
        # durable evidence) but still BOUNDED: a flapping check must not
        # fill the data dir with bundles
        self.max_disk_bundles = max(max(1, capacity),
                                    int(max_disk_bundles))
        # per-reason disk cooldown: every fresh PROCESS starts with an
        # empty transition map, so a still-degraded cluster re-fires the
        # same transition on each CLI poll — without the cooldown, a
        # `watch ceph status` loop would write a bundle per poll and
        # rotate the ORIGINAL incident's evidence out of the disk ring.
        # Disk mtimes persist across processes, so this dedups there.
        self.min_repeat_interval_s = float(min_repeat_interval_s)
        self._sources: dict[str, object] = {}
        self._seq = itertools.count(1)
        self._lock = threading.Lock()
        self._owns_admin = False

    def add_source(self, name: str, fn) -> None:
        """Attach a named snapshot provider (called at dump time)."""
        with self._lock:
            self._sources[name] = fn

    # -- capture -----------------------------------------------------------

    def _recent_disk_duplicate(self, reason: str, now: float) -> bool:
        try:
            for p in self.out_dir.glob(
                    f"flight-*-{_sanitize(reason)}.json"):
                if now - p.stat().st_mtime < self.min_repeat_interval_s:
                    return True
        except Exception:
            pass
        return False

    def dump(self, reason: str = "manual", force: bool = False) -> dict:
        """Capture one bundle NOW.  Never raises: a failing source
        records its error in place of its snapshot.  The in-memory ring
        always gets the bundle; the DISK write is skipped when a bundle
        for the same reason landed within ``min_repeat_interval_s``
        (unless ``force`` — operator-requested dumps always write)."""
        seq = next(self._seq)
        bundle: dict = {
            "version": FLIGHT_BUNDLE_VERSION,
            "seq": seq,
            "reason": reason,
            "time": time.time(),
        }
        with self._lock:
            sources = dict(self._sources)
        captures = [
            ("trace", lambda: tracer_mod.default_tracer().dump()),
            ("jit", tracer_mod.jit_dump),
            ("perf", self.cct.perf.perf_dump),
            ("device", lambda: device_telemetry.refresh(self.cct)),
        ] + list(sources.items())
        for name, fn in captures:
            try:
                bundle[name] = fn()
            except Exception as e:       # incident-time: degrade, don't die
                bundle[name] = {"error": repr(e)[:200]}
        if self.out_dir is not None and not force and \
                self._recent_disk_duplicate(reason, bundle["time"]):
            bundle["path_skipped"] = (
                f"bundle for {reason!r} written within the last "
                f"{self.min_repeat_interval_s:.0f}s")
        elif self.out_dir is not None:
            try:
                self.out_dir.mkdir(parents=True, exist_ok=True)
                # timestamp + pid in the name: the seq counter restarts
                # every process, and a later run overwriting an earlier
                # run's bundle would destroy exactly the incident
                # evidence the recorder exists to preserve
                path = self.out_dir / (
                    f"flight-{int(bundle['time'])}-{os.getpid()}-"
                    f"{seq:04d}-{_sanitize(reason)}.json")
                with open(path, "w") as f:
                    json.dump(bundle, f, default=str)
                bundle["path"] = str(path)
                # bound the directory, oldest-first by mtime (the name's
                # epoch-seconds prefix is too coarse to order bundles
                # captured within the same second)
                old = sorted(self.out_dir.glob("flight-*.json"),
                             key=lambda p: p.stat().st_mtime)
                for stale in old[:-self.max_disk_bundles]:
                    stale.unlink()
            except Exception as e:
                bundle["path_error"] = repr(e)[:200]
        self.bundles.append(bundle)
        return bundle

    def list_bundles(self) -> list[dict]:
        """Bundle index (seq/reason/time/path) — the cheap view for the
        admin surface; full bundles stay in ``self.bundles``."""
        return [{k: b.get(k) for k in ("seq", "reason", "time", "path")}
                for b in self.bundles]

    # -- admin-socket surface ----------------------------------------------

    ADMIN_COMMAND = "flight dump"

    def register_admin(self, admin_socket=None) -> None:
        """Takeover-register ``flight dump`` (the pg_backend idiom: the
        newest owner of a shared command name wins; close() only
        unregisters if still the owner)."""
        sock = admin_socket if admin_socket is not None \
            else self.cct.admin_socket
        self._admin_sock = sock
        # pin ONE callable object: bound-method attribute access creates
        # a fresh object each time, which would defeat the identity check
        # close() uses to confirm it still owns the registration
        self._admin_fn = lambda reason="admin", **kw: self.dump(
            reason=reason, force=True)
        sock.unregister(self.ADMIN_COMMAND)
        sock.register(self.ADMIN_COMMAND, self._admin_fn,
                      "capture a flight-recorder bundle "
                      "(tracer + perf + health + stats snapshot)")
        self._owns_admin = True

    def close(self) -> None:
        if self._owns_admin:
            sock = self._admin_sock
            if sock.get(self.ADMIN_COMMAND) is self._admin_fn:
                sock.unregister(self.ADMIN_COMMAND)
            self._owns_admin = False
