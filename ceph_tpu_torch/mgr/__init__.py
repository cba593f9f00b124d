"""Manager modules: the balancer (SURVEY.md section 2.4 mgr).

The reference runs it as a Python module inside ceph-mgr
(src/pybind/mgr/balancer); here it is library functions over OSDMap --
the same decision logic, emitted as OSDMap incrementals, with placement
counted through the bulk straw2 mapper."""
from .balancer import calc_pg_upmaps, calc_weight_set, osd_deviation

__all__ = ["calc_pg_upmaps", "calc_weight_set", "osd_deviation"]
