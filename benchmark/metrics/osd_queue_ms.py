"""osd_queue_ms: a client op's wait in its primary OSD's mClock queue,
from enqueue to dequeue (the daemon's ``osd.queue_wait`` spans), summed
over the profiled window per client op (``op_spans.py``)."""
from benchmark import op_spans


def read(run):
    return op_spans.per_op_ms(run, "osd.queue_wait")
