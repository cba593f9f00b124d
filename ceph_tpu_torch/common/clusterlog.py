"""Cluster log: severity-tagged cluster-wide events in a bounded ring.

Analog of the reference's ``clog`` (reference: src/common/LogClient.h —
daemons send cluster-log entries to the mon, which persists a bounded
history and streams it to ``ceph -w`` / ``ceph log last``).  The span
tracer records micro-events for machines; THIS log records the dozen
lines a human reads first in an incident: OSD up/down, health
transitions, recovery start/finish, scrub findings, throttle
saturation.

- bounded in-memory ring (``mgr_cluster_log_max`` entries);
- optional on-disk persistence as JSON-lines at ``<data_dir>/clusterlog``
  — append-only so a live ``ceph -w`` in another PROCESS can follow the
  file by offset, compacted back to the ring bound when the file grows
  past ``COMPACT_FACTOR`` times it (a bounded file, like the flight
  ring);
- an existing file is reloaded at open so the ring (and the seq
  counter) survives cluster reopens;
- :meth:`last` / :meth:`tail_since` serve ``ceph log last`` and the
  ``ceph -w`` follow loop; :meth:`dump` is the flight-recorder source,
  so a bundle alone replays the run-up.

A copy of ``ceph_tpu.common.clusterlog``.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from pathlib import Path

SEVERITIES = ("DBG", "INF", "WRN", "ERR")
_SEV_RANK = {s: i for i, s in enumerate(SEVERITIES)}

# file compaction threshold: rewrite once the file holds this many times
# the ring bound (append-only between compactions keeps `ceph -w` cheap)
COMPACT_FACTOR = 4


def format_entry(e: dict) -> str:
    """One ``ceph -w`` line: time, severity, channel, message."""
    t = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(e["time"]))
    return f"{t} {e['severity']:<3} [{e['channel']}] {e['message']}"


def read_log_file(path, n: int | None = None) -> list[dict]:
    """Parse a persisted clusterlog (JSON-lines); tolerates a torn final
    line (a concurrent append).  ``n`` keeps only the newest entries."""
    entries: list[dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    e = json.loads(line)
                except ValueError:
                    continue           # torn tail mid-append
                if isinstance(e, dict) and "message" in e:
                    entries.append(e)
    except OSError:
        return []
    return entries[-n:] if n is not None else entries


class ClusterLog:
    """Bounded, optionally persisted, severity-tagged event log."""

    def __init__(self, cct=None, path=None, capacity: int | None = None):
        from .context import default_context
        self.cct = cct if cct is not None else default_context()
        if capacity is None:
            capacity = int(self.cct.conf.get("mgr_cluster_log_max"))
        self.capacity = max(1, capacity)
        self.path = Path(path) if path is not None else None
        self.entries: deque[dict] = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self._file_lines = 0
        if self.path is not None and self.path.exists():
            persisted = read_log_file(self.path)
            old = persisted[-self.capacity:]
            self.entries.extend(old)
            self._file_lines = len(persisted)
            self._seq = max((e.get("seq", 0) for e in old), default=0)

    # -- write -------------------------------------------------------------

    def log(self, severity: str, message: str, channel: str = "cluster",
            **fields) -> dict:
        if severity not in _SEV_RANK:
            raise ValueError(f"severity {severity!r} not in {SEVERITIES}")
        with self._lock:
            self._seq += 1
            entry = {"seq": self._seq, "time": time.time(),
                     "severity": severity, "channel": channel,
                     "message": str(message)}
            if fields:
                entry.update(fields)
            self.entries.append(entry)
            if self.path is not None:
                self._persist(entry)
        return entry

    def debug(self, message: str, **kw) -> dict:
        return self.log("DBG", message, **kw)

    def info(self, message: str, **kw) -> dict:
        return self.log("INF", message, **kw)

    def warn(self, message: str, **kw) -> dict:
        return self.log("WRN", message, **kw)

    def error(self, message: str, **kw) -> dict:
        return self.log("ERR", message, **kw)

    def _persist(self, entry: dict) -> None:
        """Append one JSON line; compact the file back to the ring once
        it grows past COMPACT_FACTOR x capacity lines.  Best-effort: a
        full disk must not take the data path down with it."""
        try:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            with open(self.path, "a") as f:
                f.write(json.dumps(entry, default=str) + "\n")
            self._file_lines += 1
            if self._file_lines > self.capacity * COMPACT_FACTOR:
                import os
                tmp = self.path.with_suffix(".tmp")
                with open(tmp, "w") as f:
                    for e in self.entries:
                        f.write(json.dumps(e, default=str) + "\n")
                os.replace(tmp, self.path)
                self._file_lines = len(self.entries)
        except OSError:
            pass

    # -- read --------------------------------------------------------------

    def last(self, n: int = 20, severity: str | None = None) -> list[dict]:
        """The newest ``n`` entries (``ceph log last``), optionally at or
        above a severity floor."""
        with self._lock:
            entries = list(self.entries)
        if severity is not None:
            floor = _SEV_RANK[severity]
            entries = [e for e in entries
                       if _SEV_RANK.get(e["severity"], 1) >= floor]
        return entries[-n:] if n > 0 else []

    def tail_since(self, seq: int) -> list[dict]:
        """Entries newer than ``seq`` — the ``ceph -w`` poll step."""
        with self._lock:
            return [e for e in self.entries if e.get("seq", 0) > seq]

    def dump(self) -> list[dict]:
        """The flight-recorder source: the whole ring."""
        with self._lock:
            return list(self.entries)

    def close(self) -> None:
        """Nothing persistent to release beyond the file handles already
        closed per append; kept for the telemetry-spine teardown shape."""
