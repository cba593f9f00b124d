"""The payload copy ledger: every remaining host copy, counted.

The zero-copy data path (ROADMAP item 2) is a claim about BYTES MOVED,
so the win has to be measured, not asserted: this module is the single
place every surviving payload copy between the socket and the device
reports to, and the place payload bytes *served* (consumed by a
dispatch handler or landed in a client callback) are tallied against.
The quotient — ``bytes_copied_per_byte_served`` — is the PR's success
metric: ~3 on the legacy pickle path (pickle + frame join + unpickle
per direction), ~1 on the sideband path (one staging copy), and the
perf gate holds the fused arm under an absolute cap so a regression
that quietly reintroduces a copy fails CI instead of a code review.

Copy *sources* are a small closed vocabulary so dashboards and tests
can pin them:

- ``pickle`` / ``join`` / ``unpickle`` — the legacy codec's three
  copies per direction (``net._encode`` pickling payload-bearing
  messages, ``frame_encode``'s segment join, ``net._decode``'s loads);
- ``staging``     — the ONE sanctioned sideband copy: wire segments
  landing in a pooled staging buffer (``msg/staging.py``);
- ``materialize`` — a staged view pinned down to owned bytes where a
  consumer outlives the buffer (client result landing);
- ``compaction`` / ``fallback`` — the stream parser's own amortized
  compaction and retained-view ``BufferError`` recovery copies, counted
  so the ratio cannot silently undercount the parser;
- ``relayout``    — host shard-major relayout on the codec pack path.

Counting rides the :mod:`instruments` kill-switch and the same
per-thread sharded cells as :mod:`perf_counters` (lock-free on the
reactor/worker hot paths); the ledger is a process-global singleton the
prometheus exporter and the stats digest read directly, the same
live-registry idiom ``wire_accounting`` uses.

A copy of ``ceph_tpu.common.copy_ledger``.  The copy points named above
are the port's messenger's (``net.py``, ``msg/parser.py``,
``msg/staging.py``); ``relayout`` has no recorder in the port.
"""
from __future__ import annotations

import threading

from . import instruments

# the closed source vocabulary (tests pin it; prometheus labels draw
# from it)
COPY_SOURCES = ("pickle", "join", "unpickle", "staging", "materialize",
                "compaction", "fallback", "relayout")

# payload-size floor shared by the sideband codec and the ledger: blobs
# under this ride the pickled control header (a 64-bit rid costs more
# to sideband than to pickle), and neither their copies nor their bytes
# count — the two sides must agree or the ratio skews
PAYLOAD_MIN = 32


class CopyLedger:
    """Sharded byte counters for payload copies vs payload bytes served."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        # folded totals (absorbed from dead/hot cells on read)
        self._copied: dict[str, int] = {s: 0 for s in COPY_SOURCES}
        self._served = 0
        self._cells: list[dict] = []

    def _cell(self) -> dict:
        c = getattr(self._local, "cell", None)
        if c is None:
            c = {"served": 0}
            self._local.cell = c
            with self._lock:
                self._cells.append(c)
        return c

    # -- hot path --------------------------------------------------------

    def count_copy(self, source: str, nbytes: int) -> None:
        """One payload copy of ``nbytes`` attributed to ``source``."""
        if nbytes <= 0 or not instruments.enabled():
            return
        cell = self._cell()
        cell[source] = cell.get(source, 0) + int(nbytes)

    def count_served(self, nbytes: int) -> None:
        """``nbytes`` of payload reached its consumer (dispatch handler
        or client completion) — the denominator."""
        if nbytes <= 0 or not instruments.enabled():
            return
        self._cell()["served"] += int(nbytes)

    # -- read side -------------------------------------------------------

    def _fold_locked(self) -> None:
        for cell in self._cells:
            for k in list(cell):
                v = cell[k]
                if not v:
                    continue
                cell[k] = 0
                if k == "served":
                    self._served += v
                else:
                    self._copied[k] = self._copied.get(k, 0) + v

    def snapshot(self) -> dict:
        with self._lock:
            self._fold_locked()
            copied = dict(self._copied)
            served = self._served
        total = sum(copied.values())
        return {"copied": copied, "copied_total": total,
                "served": served,
                "copies_per_byte": (total / served) if served else 0.0}

    def copies_per_byte(self) -> float:
        return self.snapshot()["copies_per_byte"]

    def reset(self) -> None:
        """Zero everything (bench arms snapshot a clean window)."""
        with self._lock:
            self._fold_locked()
            self._copied = {s: 0 for s in COPY_SOURCES}
            self._served = 0


_LEDGER = CopyLedger()


def ledger() -> CopyLedger:
    """The process-global ledger (live-registry accessor the prometheus
    ``_copy_gauges`` family and the stats digest read)."""
    return _LEDGER


def count_copy(source: str, nbytes: int) -> None:
    _LEDGER.count_copy(source, nbytes)


def count_served(nbytes: int) -> None:
    _LEDGER.count_served(nbytes)
