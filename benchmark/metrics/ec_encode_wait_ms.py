"""ec_encode_wait_ms: a write parked in ECBackend's encode stage, from
handing its encode to the serving engine to taking the result (the
``ec.encode_wait`` spans), summed over the profiled window per client op
(``op_spans.py``)."""
from benchmark import op_spans


def read(run):
    return op_spans.per_op_ms(run, "ec.encode_wait")
