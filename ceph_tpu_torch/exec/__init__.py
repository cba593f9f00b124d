"""Serving subsystem, ported from ``ceph_tpu.exec``: admission throttles,
dmClock-ordered queues, the deadline-driven op coalescer that fuses
concurrent submissions into single device dispatches through the CUDA
codec pipeline (``ops/pipeline.py``), and completion futures/finishers —
the reference's ``Throttle``/``WorkQueue``/``Finisher`` trio rebuilt
around inference-style dynamic batching.

Entry point: :class:`ServingEngine` (``submit_encode``/``submit_decode``),
driven by :func:`~ceph_tpu_torch.exec.workload.closed_loop` or
``open_loop`` for measurement."""
from .throttle import Throttle, ThrottleFull
from .finisher import Finisher
from .batcher import BatchFuture, dispatch_batch
from .engine import ServingEngine, live_engines

__all__ = [
    "Throttle", "ThrottleFull", "Finisher", "BatchFuture",
    "dispatch_batch", "ServingEngine", "live_engines",
]
