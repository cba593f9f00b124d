"""The cluster cell's per-op readers: a stage's spans over the client ops
the profiled window ran.

The OSD daemon opens one ``osd.op`` span for each client op it runs
(``ceph_tpu_torch/osd/osd_daemon.py``).  :func:`per_op_ms` sums one
stage's spans inside the profiled window (``program_spans.py``) and
divides by the window's ``osd.op`` spans.  The cluster cell's loop runs
inside the window and drains before it closes, so every ``osd.op`` of
the window lies whole inside it.
"""
from __future__ import annotations

from benchmark import program_spans

#: the span each client op opens on its primary OSD
OP_SPAN = "osd.op"


def per_op_ms(run, name: str) -> float | None:
    """The ``name`` spans' seconds in the window over its client ops, in
    ms (None: no window, no op, or no such span)."""
    window = program_spans.read(run)
    if window is None:
        return None
    ops = len(window.spans.get(OP_SPAN, ()))
    total = window.seconds_in(name)
    if total is None or not ops:
        return None
    return total / ops * 1e3
