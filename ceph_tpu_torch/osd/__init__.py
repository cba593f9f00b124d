"""OSD-side subsystems copied from ``ceph_tpu.osd``: the dmClock op-class
queue, the per-PG operation log, and (imported from their modules) the
OSD daemon (``osd_daemon``), the primary's op engine
(``primary_log_pg``), its op vectors (``osd_ops``), hit sets
(``hit_set``) and the peering statechart (``peering``)."""
from .mclock import (BG_RECOVERY, BG_SCRUB, CLIENT_OP, ClientInfo,
                     MClockOpClassQueue, MClockQueue)
from .pg_log import OP_DELETE, OP_MODIFY, PGLog, PGLogEntry, dedup_latest

__all__ = ["BG_RECOVERY", "BG_SCRUB", "CLIENT_OP", "ClientInfo",
           "MClockOpClassQueue", "MClockQueue", "OP_DELETE", "OP_MODIFY",
           "PGLog", "PGLogEntry", "dedup_latest"]
