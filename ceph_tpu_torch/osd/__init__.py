"""OSD-side scheduling copied from ``ceph_tpu.osd``: the dmClock op-class
queue the serving engine orders admitted ops by."""
from .mclock import (BG_RECOVERY, BG_SCRUB, CLIENT_OP, ClientInfo,
                     MClockOpClassQueue, MClockQueue)

__all__ = ["BG_RECOVERY", "BG_SCRUB", "CLIENT_OP", "ClientInfo",
           "MClockOpClassQueue", "MClockQueue"]
