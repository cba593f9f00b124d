"""OSD-side pieces copied from ``ceph_tpu.osd``: the dmClock op-class
queue the serving engine orders admitted ops by, and the per-PG
operation log."""
from .mclock import (BG_RECOVERY, BG_SCRUB, CLIENT_OP, ClientInfo,
                     MClockOpClassQueue, MClockQueue)
from .pg_log import OP_DELETE, OP_MODIFY, PGLog, PGLogEntry, dedup_latest

__all__ = ["BG_RECOVERY", "BG_SCRUB", "CLIENT_OP", "ClientInfo",
           "MClockOpClassQueue", "MClockQueue", "OP_DELETE", "OP_MODIFY",
           "PGLog", "PGLogEntry", "dedup_latest"]
