"""Embedded time-series ring: fixed-interval round-robin archives.

The RRDtool idea embedded in the process (the reference ships this as
the mgr's ``prometheus``+external-scraper pairing; ``ceph -s`` history
otherwise dies with the terminal): every ``mgr_ts_interval`` seconds a
POINT is recorded — the stats digest, the heat tail, the wire rollup,
whatever sources are attached — into a bounded FINE ring, and every
``mgr_ts_coarse_every`` fine points are folded (mean + max per series)
into a bounded COARSE ring.  Total memory is fixed; history depth is
``capacity * (1 + coarse_every)`` intervals — classic round-robin
archive eviction, oldest first.

The ring rides every flight-recorder bundle (``timeseries`` source), so
post-hoc analysis of a soak or bench run — `tools/ts_report.py`'s
sparkline/percentile tables — needs the artifact alone, no external
scraper running at incident time.

A copy of ``ceph_tpu.mgr.timeseries``.
"""
from __future__ import annotations

import threading
import time


class TimeSeriesRing:
    """Bounded two-resolution archive of flat ``name -> value`` series."""

    def __init__(self, cct=None, interval: float | None = None,
                 capacity: int | None = None,
                 coarse_every: int | None = None, clock=time.monotonic):
        from ..common import default_context
        self.cct = cct if cct is not None else default_context()
        conf = self.cct.conf
        self.interval = float(conf.get("mgr_ts_interval")
                              if interval is None else interval)
        self.capacity = max(2, int(conf.get("mgr_ts_capacity")
                                   if capacity is None else capacity))
        self.coarse_every = max(1, int(conf.get("mgr_ts_coarse_every")
                                       if coarse_every is None
                                       else coarse_every))
        self.clock = clock
        from collections import deque
        self.fine: "deque[dict]" = deque(maxlen=self.capacity)
        self.coarse: "deque[dict]" = deque(maxlen=self.capacity)
        self._pending: list[dict] = []      # fine points awaiting fold
        self._sources: dict[str, object] = {}
        self._last_t: float | None = None
        self._lock = threading.Lock()
        self.points_recorded = 0
        self.points_skipped = 0

    def add_source(self, name: str, fn) -> None:
        """Attach a flat-series provider: ``fn() -> {key: float}``;
        series land namespaced ``<name>.<key>``."""
        with self._lock:
            self._sources[name] = fn

    # -- recording ---------------------------------------------------------

    def record(self, now: float | None = None, force: bool = False
               ) -> dict | None:
        """Record one point if at least ``interval`` has passed since the
        last one (``force`` overrides — phase boundaries in tests and
        benches).  Sources are exception-guarded: a broken provider
        zeroes its series, never the tick."""
        t = self.clock() if now is None else now
        with self._lock:
            if not force and self._last_t is not None and \
                    t - self._last_t < self.interval:
                self.points_skipped += 1
                return None
            self._last_t = t
            sources = dict(self._sources)
        point: dict = {"t": t, "wall": time.time()}
        for name, fn in sources.items():
            try:
                for k, v in (fn() or {}).items():
                    if isinstance(v, (int, float)):
                        point[f"{name}.{k}"] = round(float(v), 4)
            except Exception:            # the ring records THROUGH faults
                point[f"{name}.error"] = 1.0
        with self._lock:
            self.fine.append(point)
            self.points_recorded += 1
            self._pending.append(point)
            if len(self._pending) >= self.coarse_every:
                self.coarse.append(self._fold(self._pending))
                self._pending = []
        return point

    @staticmethod
    def _fold(points: list[dict]) -> dict:
        """mean + max per series over one coarse bucket (the RRD
        consolidation functions that matter for capacity questions)."""
        keys = {k for p in points for k in p if k not in ("t", "wall")}
        out = {"t": points[0]["t"], "wall": points[0]["wall"],
               "n": len(points)}
        for k in keys:
            vals = [p[k] for p in points if k in p]
            out[f"{k}:avg"] = round(sum(vals) / len(vals), 4)
            out[f"{k}:max"] = round(max(vals), 4)
        return out

    # -- read --------------------------------------------------------------

    def series_names(self) -> list[str]:
        with self._lock:
            return sorted({k for p in self.fine
                           for k in p if k not in ("t", "wall")})

    def series(self, name: str) -> list[tuple[float, float]]:
        """``[(t, value)]`` for one fine series (missing points skipped)."""
        with self._lock:
            return [(p["t"], p[name]) for p in self.fine if name in p]

    def dump(self) -> dict:
        """The flight-recorder source / ts_report input."""
        with self._lock:
            return {"interval_s": self.interval,
                    "capacity": self.capacity,
                    "coarse_every": self.coarse_every,
                    "recorded": self.points_recorded,
                    "fine": list(self.fine),
                    "coarse": list(self.coarse)}
