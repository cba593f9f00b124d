"""Client library: the librados/Objecter layer (SURVEY.md §1 layer 8).

The Objecter computes op targets from the CLIENT's own (possibly stale)
OSDMap, stamps every op with its epoch, and resends when the map moves —
mirroring src/osdc/Objecter.cc op_submit :2257 / _calc_target :2786.

The port's copy of ``ceph_tpu.client``."""
from .objecter import Objecter

__all__ = ["Objecter"]
