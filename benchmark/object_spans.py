"""The recovery cell's per-object readers: a stage's spans over the
objects the profiled window recovered.

The PG backend closes one ``recovery.object`` span for each object it
brings back to full redundancy, from the object's dispatch in a wave,
chain or per-object op to the commit of its last push
(``ceph_tpu_torch/backend/pg_backend.py``).  :func:`per_object_ms` sums
stages' spans inside the profiled window (``program_spans.py``) and
divides by the window's ``recovery.object`` spans, as ``op_spans.py``
divides by client ops.
"""
from __future__ import annotations

from benchmark import program_spans

#: the span each recovered object closes on its PG's primary
OBJECT_SPAN = "recovery.object"


def per_object_ms(run, *names: str) -> float | None:
    """The spans of ``names`` in the window, their seconds summed, over
    its recovered objects, in ms (None: no window, no object, or none of
    the spans)."""
    window = program_spans.read(run)
    if window is None:
        return None
    objects = len(window.spans.get(OBJECT_SPAN, ()))
    totals = [t for t in (window.seconds_in(n) for n in names)
              if t is not None]
    if not totals or not objects:
        return None
    return sum(totals) / objects * 1e3
