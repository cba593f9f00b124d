"""Subsystem-gated logging with a crash-dumpable ring of recent entries.

Mirror of the reference's logging core (reference: src/log/Log.cc, 449 LoC —
an async ring-buffered Log thread keeping ``m_recent`` entries that are
dumped on crash; ``dout(level)`` macros gated per-subsystem by the
gather/log levels in src/common/subsys.h).  Python logging handles the
actual IO; this layer adds the two Ceph-shaped behaviors: per-subsystem
gather levels from debug_* config options, and the bounded recent-entry
ring with ``dump_recent()``.

The port's copy of ``ceph_tpu.common.log``: the monitor logs its
failure and auto-out decisions through ``Context.dout``.
"""
from __future__ import annotations

import collections
import sys
import threading
import time
from dataclasses import dataclass


@dataclass
class Entry:
    stamp: float
    subsys: str
    level: int
    message: str

    def format(self) -> str:
        whole = int(self.stamp)
        t = time.strftime("%Y-%m-%dT%H:%M:%S", time.localtime(whole))
        usec = int((self.stamp - whole) * 1e6)   # truncate: no carry issues
        return f"{t}.{usec:06d} {self.level:2d} {self.subsys}: {self.message}"


class Log:
    """Ring-buffered logger; `should_gather` is the dout gate."""

    def __init__(self, config=None, max_recent: int = 500, file=None):
        self._config = config
        if config is not None:
            configured = config.get("log_max_recent")
            if configured is not None:      # 0 is valid: disables the ring
                max_recent = configured
        self._recent: collections.deque[Entry] = collections.deque(
            maxlen=max_recent)
        self._lock = threading.Lock()
        self._file = file
        self._levels: dict[str, int] = {}

    def set_level(self, subsys: str, level: int) -> None:
        self._levels[subsys] = level

    def level(self, subsys: str) -> int:
        if subsys in self._levels:
            return self._levels[subsys]
        if self._config is not None:
            try:
                return int(self._config.get(f"debug_{subsys}"))
            except KeyError:
                pass
        return 1

    def should_gather(self, subsys: str, level: int) -> bool:
        return level <= self.level(subsys)

    def dout(self, subsys: str, level: int, message: str) -> None:
        """The dout(level) macro: gated, ring-buffered, optionally sunk."""
        if not self.should_gather(subsys, level):
            return
        e = Entry(time.time(), subsys, level, message)
        with self._lock:
            self._recent.append(e)
        if self._file is not None:
            print(e.format(), file=self._file)

    def dump_recent(self, file=None) -> list[str]:
        """Crash-dump the ring (Log::dump_recent)."""
        with self._lock:
            lines = [e.format() for e in self._recent]
        out = file or sys.stderr
        print(f"--- begin dump of recent {len(lines)} log events ---",
              file=out)
        for line in lines:
            print(line, file=out)
        print("--- end dump of recent log events ---", file=out)
        return lines

    def recent(self) -> list[Entry]:
        with self._lock:
            return list(self._recent)
